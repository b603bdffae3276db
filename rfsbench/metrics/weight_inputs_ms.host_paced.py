"""`weight_inputs_ms` in the cells whose frame the host paces (they report
`fps.host_paced`, whose bound follows their wider spread)."""

from .weight_inputs_ms import read  # noqa: F401
