"""Device operations a training step's captured graph runs: those
correlated with the replays launched in the traced stretch, over its steps
(raybench/program.py:ops_per_step)."""

from raybench.program import ops_per_step as read  # noqa: F401
