"""The forward kernel's share of its roofline, coarse and fine pass
(raybench/readers.py:fwd_roofline_pct)."""

from raybench.readers import fwd_roofline_pct as read  # noqa: F401
