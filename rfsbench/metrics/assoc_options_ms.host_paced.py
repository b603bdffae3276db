"""`assoc_options_ms` in the cells whose frame the host paces (they report
`fps.host_paced`, whose bound follows their wider spread)."""

from .assoc_options_ms import read  # noqa: F401
