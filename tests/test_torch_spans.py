"""The port's spans (``utils/profiling.py:span``), on the CPU: nothing made
while no profiler records; under one, ``FlyBatch.host_frames`` off the card
writes its batch span with the copy and the wait nested inside it to the
exported Chrome trace; every span the port names carries its prefix. The
graph's own spans and their place on the device's clock are held on the card
(tests/test_torch_cuda.py)."""

import ast
import json
import pathlib

import torch
from torch.profiler import ProfilerActivity, profile

import gpgpuraytrace_tpu_torch
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops.flythrough import FlyBatch
from gpgpuraytrace_tpu_torch.utils import profiling

PREFIX = "gpgpuraytrace_tpu_torch."
SPANS = {PREFIX + n for n in ("graph.warmup", "graph.capture", "graph.replay", "fly.batch",
                              "fly.load", "fly.to_host", "fly.wait")}


def test_span_without_a_profiler_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a = profiling.span(PREFIX + "fly.batch")
    assert a is profiling.span(PREFIX + "graph.replay")
    with a as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span(PREFIX + "fly.batch") is not a
    assert profiling.span(PREFIX + "fly.batch") is a


def test_fly_batch_off_the_card_writes_its_spans(tmp_path):
    scene = default_scene(2, device="cpu")
    cfg = RenderConfig(height=16, width=24, max_steps=16, num_octaves=2)
    program = FlyBatch(scene, cfg, 2)
    times = torch.arange(2, dtype=torch.float32) / 30.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frames = program.host_frames(scene, times, 2)
    assert frames.shape == (2, 16, 24, 3)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert set(spans) == {PREFIX + "fly.batch", PREFIX + "fly.to_host", PREFIX + "fly.wait"}
    assert all(len(v) == 1 for v in spans.values())
    (b0, b1), = spans[PREFIX + "fly.batch"]
    (c0, c1), = spans[PREFIX + "fly.to_host"]
    (w0, w1), = spans[PREFIX + "fly.wait"]
    assert b0 <= c0 <= c1 <= w0 <= w1 <= b1


def span_names(tree: ast.AST) -> list:
    """The first argument of every call of ``span`` in a module: a string
    constant, or the node itself where it is not one."""
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
                and getattr(node.func, "id", getattr(node.func, "attr", None)) == "span"):
            arg = node.args[0] if node.args else None
            out.append(arg.value if isinstance(arg, ast.Constant) else arg)
    return out


def test_every_span_of_the_port_carries_its_prefix():
    root = pathlib.Path(gpgpuraytrace_tpu_torch.__file__).parent
    names = []
    for path in sorted(root.rglob("*.py")):
        names += span_names(ast.parse(path.read_text(), str(path)))
    assert all(isinstance(n, str) and n.startswith(PREFIX) for n in names), names
    assert set(names) == SPANS
