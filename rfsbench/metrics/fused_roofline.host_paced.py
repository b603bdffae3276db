"""`fused_roofline` in the cells whose frame the host paces (they report
`fps.host_paced`, whose bound follows their wider spread)."""

from .fused_roofline import read  # noqa: F401
