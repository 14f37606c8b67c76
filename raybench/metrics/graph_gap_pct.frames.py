"""The card's idle time inside the replays of the port's CUDA graphs
(utils/graphs.py:CapturedProgram), as a share of the traced stretch, the mean
over the ranks (raybench/program.py:graph_gap_pct). At most the idle share;
the rest of that lies between replays, on the host's side."""

from raybench.program import graph_gap_pct as read  # noqa: F401
