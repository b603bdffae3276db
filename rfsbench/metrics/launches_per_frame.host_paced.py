"""`launches_per_frame` in the cells whose frame the host paces (they report
`fps.host_paced`, whose bound follows their wider spread)."""

from .launches_per_frame import read  # noqa: F401
