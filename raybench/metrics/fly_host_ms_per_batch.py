"""The port's own host time per fly batch (ops/flythrough.py:FlyBatch.host_frames
less its wait for the frames), in ms (raybench/program.py:fly_host_ms_per_batch)."""

from raybench.program import fly_host_ms_per_batch as read  # noqa: F401
