"""`frame_mfu` in the cells whose frame the host paces (they report
`fps.host_paced`, whose bound follows their wider spread)."""

from .frame_mfu import read  # noqa: F401
