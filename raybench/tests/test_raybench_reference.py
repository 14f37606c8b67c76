"""The reference against the port's plain path at toy size on the CPU, and
what the reference and the command may import."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest
import torch

from raybench import core, scene as sc
from raybench.reference import terrain as ref

VALUES = core.read_json(core.root() / "raybench/configs/terrain6-512.json")["scene"]
RENDER = {**core.read_json(core.root() / "raybench/configs/terrain6-512.json")["render"],
          "height": 48, "width": 64, "max_steps": 64}


def test_reference_frame_matches_the_port_plain_path():
    from gpgpuraytrace_tpu_torch.kernels.trace import render_kernel_raw

    color, t, hit = render_kernel_raw(sc.port_scene(VALUES, "cpu"), sc.render_config(RENDER))
    tr = ref.trace(sc.ref_scene(VALUES, "cpu"), sc.render_spec(RENDER))
    assert (tr.hit == hit).float().mean() > 0.999
    assert (tr.color - color).abs().mean() < 1e-5
    assert (tr.color - color).abs().le(2e-3).float().mean() > 0.999
    assert tr.steps > tr.pixels and 0 < tr.hits < tr.pixels
    assert tr.coarse_pixels == (48 // 8 + 2) * (64 // 8)


def test_reference_bands_make_the_frame():
    spec = sc.render_spec(RENDER)
    whole = ref.trace(sc.ref_scene(VALUES, "cpu"), spec)
    parts = [ref.trace(sc.ref_scene(VALUES, "cpu"), spec, r0, 16) for r0 in (0, 16, 32)]
    assert torch.equal(torch.cat([p.color for p in parts]), whole.color)
    assert sum(p.steps for p in parts) == whole.steps


def test_reference_gradient_matches_the_port_plain_path():
    from gpgpuraytrace_tpu_torch.ops import fit as F
    from gpgpuraytrace_tpu_torch.ops.render import render

    cfg, spec = sc.render_config(RENDER), sc.render_spec(RENDER)
    with torch.no_grad():
        target = render(sc.port_scene(VALUES, "cpu"), cfg)
    start = sc.perturbed(VALUES, 5, 0.15)
    scene = sc.port_scene(start, "cpu")
    params = F.partition_scene(scene)
    F.pixel_loss(scene, cfg, target).backward()
    names = [n for n, p in scene.named_parameters() if p.requires_grad]
    loss, grads = ref.loss_and_grads(sc.ref_scene(start, "cpu"), spec, target, names)
    blocked = ref.loss_and_grads(sc.ref_scene(start, "cpu"), spec, target, names, 16)[1]
    for n, p in zip(names, params):
        scale = max(float(grads[n].norm()), 1e-6)
        assert float((p.grad - grads[n]).norm()) / scale < 5e-3, n
        assert float((blocked[n] - grads[n]).norm()) / scale < 1e-5, n


def test_adam_matches_torch():
    p = torch.tensor([0.3, -1.0, 2.0])
    g = [torch.tensor([0.1, -0.2, 1e-4]), torch.tensor([0.05, 0.3, -2e-4])]
    mine = ref.Adam({"x": p.clone()}, 5e-3)
    q = p.clone().requires_grad_()
    opt = torch.optim.Adam([q], lr=5e-3, betas=(0.9, 0.999), eps=1e-8)
    for gi in g:
        mine.step({"x": gi})
        q.grad = gi.clone()
        opt.step()
    assert torch.allclose(mine.params["x"], q.detach(), rtol=0, atol=1e-7)


def imports_of(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for path in (core.PKG / "reference").glob("*.py"):
        assert imports_of(path) <= {"__future__", "dataclasses", "math", "torch"}, path


def test_no_file_of_the_benchmark_imports_jax():
    for path in core.PKG.rglob("*.py"):
        assert not imports_of(path) & set(core.FORBIDDEN), path


def test_a_run_holds_no_jax_module():
    code = ("import sys, runpy; sys.argv = ['raybench.run', '--workload', 'fit512', "
            "'--seed', '4', '--seconds', '0.05', '--device', 'cpu', '--override', "
            "'{\"render\": {\"height\": 16, \"width\": 16, \"max_steps\": 16}}'];\n"
            "from raybench import run, core\n"
            "rc = run.main(sys.argv[1:])\n"
            "print('HELD', core.forbidden_modules(), rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(core.root()),
                          capture_output=True, text=True, timeout=300)
    assert "HELD [] 0" in proc.stdout, proc.stderr[-2000:]


@pytest.mark.parametrize("names, held", [
    (["jax", "jax.numpy", "torch"], ["jax"]),
    (["gpgpuraytrace_tpu.ops", "numpy"], ["gpgpuraytrace_tpu"]),
    (["gpgpuraytrace_tpu_torch.ops", "jaxtyping", "flaxen"], []),
])
def test_forbidden_modules_compares_whole_top_level_names(names, held):
    assert core.forbidden_modules(names) == held
