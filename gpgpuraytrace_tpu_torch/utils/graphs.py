"""A program run as one CUDA graph: the port's counterpart of a JAX program
compiled once and called many times (``ops/fit.py:StepChunk``'s chunk of
fit steps, ``ops/flythrough.py:FlyBatch``'s batch of frames,
``parallel/sharded.py``'s row-band training step)."""

from __future__ import annotations

from typing import Callable

import torch

from gpgpuraytrace_tpu_torch.utils.profiling import span


class CapturedProgram:
    """``fn() -> tensor`` on the card as one CUDA graph, by PyTorch's rule
    for a capture.

    The first call runs ``fn`` eagerly on a side stream: PyTorch's warm-up
    before a capture, the kernels' build, and what a first call creates
    lazily (Adam's state, NCCL's communicator at the first collective). The
    second call captures ``fn`` into the graph (which runs nothing) and
    replays it, as does every later call. A call returns what ``fn``
    returned: the warm-up's own result, then the graph's output, which the
    next replay overwrites (``captured`` says which). ``fn`` reads its
    inputs by address: they are updated in place, never replaced, and
    nothing in it may sync the host. Nothing falls back: a capture that
    fails raises. ``fn`` must not refer to the object that holds this
    program: that cycle would keep the graph alive until the garbage
    collector runs. ``capture()`` captures without replaying, for a caller
    that times the replay alone. ``close()`` releases the graph; a graph
    that holds NCCL collectives must be released before its process group
    is destroyed (NCCL's communicator waits for every such graph to go).

    Under a profiler the warm-up, the capture and each replay are spans
    (``utils/profiling.py:span``): ``graph.replay`` holds the replay's
    ``cudaGraphLaunch`` alone, whose correlation id the graph's device
    operations carry in the trace."""

    def __init__(self, fn: Callable[[], torch.Tensor], device: torch.device):
        self.fn = fn
        self.device = device
        self.calls = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def close(self) -> None:
        """Release the graph and its output (a later call captures anew)."""
        self.graph = self.out = None

    def capture(self) -> None:
        """Capture ``fn`` into the graph, which runs nothing (after the first
        call's warm-up; once captured, nothing)."""
        if self.graph is not None:
            return
        self.graph = torch.cuda.CUDAGraph()
        # "thread_local": another thread may make calls that a capture
        # forbids, as NCCL's watchdog thread does when it queries the events
        # of earlier collectives.
        with (span("gpgpuraytrace_tpu_torch.graph.capture"),
              torch.cuda.graph(self.graph, capture_error_mode="thread_local")):
            self.out = self.fn()

    def __call__(self):
        self.calls += 1
        stream = torch.cuda.current_stream(self.device)
        if self.calls == 1:
            with span("gpgpuraytrace_tpu_torch.graph.warmup"):
                side = torch.cuda.Stream(self.device)
                side.wait_stream(stream)
                with torch.cuda.stream(side):
                    out = self.fn()
                stream.wait_stream(side)
                out.record_stream(stream)
            return out
        self.capture()
        with span("gpgpuraytrace_tpu_torch.graph.replay"):
            self.graph.replay()
        return self.out
