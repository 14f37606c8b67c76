"""Share of the traced stretch in which no operation ran on the card, the
mean over the ranks (raybench/readers.py:idle_pct)."""

from raybench.readers import idle_pct as read  # noqa: F401
