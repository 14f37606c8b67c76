"""The CUDA trace kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips without CUDA. Imports nothing of JAX, so
on a machine without jax run it without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

chip_smoke.py makes the same comparisons at 512x512.
"""

import dataclasses

import pytest
import torch

from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

torch.set_num_threads(2)

CFG = RenderConfig(height=64, width=128, max_steps=64, num_octaves=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def frac_within(a, b, atol):
    return ((a - b).abs() <= atol).float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"march_eps_scale": 4.0}, {"prime_ds": 0}],
                         ids=["default", "residual_verdict", "unprimed"])
def test_cuda_kernel_matches_plain_version(cuda, kw):
    cfg = dataclasses.replace(CFG, **kw)
    scene = default_scene(3, device=cuda)
    before = ktrace.trace_frame.launches
    color, t, hit = ktrace.render_kernel_raw(scene, cfg)
    torch.cuda.synchronize()
    assert ktrace.trace_frame.launches == before + (2 if cfg.prime_ds else 1)
    with torch.no_grad():
        prime = None
        if cfg.prime_ds:
            ccfg = coarse_prime_cfg(cfg)
            pc, seed = pack_scene(scene, ccfg.height, ccfg.width, -1.0)
            _, t_c, _ = ktrace.trace_frame(pc, seed, ccfg, cfg.height // cfg.prime_ds + 2)
            prime = prime_from_coarse(t_c, cfg)
        packed, seed = pack_scene(scene, cfg.height, cfg.width)
        ref_c, ref_t, ref_hit = ktrace.trace_frame_reference(packed, seed, cfg, cfg.height, prime)
    kc = color.permute(2, 0, 1)
    # Grazing rays are chaotic (2e-3 on 99.9%); FMA contraction and rsqrtf
    # move the bulk's rounding (1e-4 on 99%, not the CPU suite's 1e-5).
    assert frac_within(kc, ref_c, 2e-3) >= 0.999
    assert frac_within(kc, ref_c, 1e-4) >= 0.99
    assert (hit.float() == ref_hit).float().mean().item() > 0.995
    both = hit & (ref_hit > 0.5)
    assert frac_within(t[both], ref_t[both], 5e-2) >= 0.999


@pytest.mark.cuda
def test_cuda_wrapper_rejects_cpu_mix(cuda):
    scene = default_scene(3, device=cuda)
    packed, seed = pack_scene(scene, CFG.height, CFG.width)
    cfg = dataclasses.replace(CFG, prime_ds=0)
    with pytest.raises(ValueError, match="inputs on"):
        ktrace.trace_frame(packed.detach(), seed.cpu(), cfg, CFG.height)


def within_bwd_tolerance(got, ref):
    """Every entry within rtol 1e-3 plus 1e-4 of the largest: the sums run
    over the pixels in another order, and the kernel's rsqrtf, expf and FMA
    contraction round differently from torch."""
    return bool(((got - ref).abs() <= 1e-3 * ref.abs() + 1e-4 * ref.abs().max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"prime_ds": 0}], ids=["primed", "unprimed"])
def test_cuda_bwd_kernel_matches_plain_version(cuda, kw):
    cfg = dataclasses.replace(CFG, **kw)
    scene = default_scene(3, device=cuda)
    _, t, hit = ktrace.render_kernel_raw(scene, cfg)
    packed, seed = pack_scene(scene, cfg.height, cfg.width)
    packed, hit = packed.detach(), hit.float()
    g = torch.randn(3, cfg.height, cfg.width, generator=torch.Generator().manual_seed(0))
    g = g.to(cuda)
    before = ktrace.trace_frame_bwd.launches
    a = ktrace.trace_frame_bwd(packed, seed, cfg, cfg.height, t, hit, g)
    b = ktrace.trace_frame_bwd(packed, seed, cfg, cfg.height, t, hit, g)
    ref = ktrace.trace_bwd_reference(packed, seed, cfg, cfg.height, t, hit, g)
    torch.cuda.synchronize()
    assert ktrace.trace_frame_bwd.launches == before + 2
    assert torch.equal(a, b)  # no atomics: bitwise repeatable
    assert torch.isfinite(a).all() and within_bwd_tolerance(a, ref)


@pytest.mark.cuda
def test_cuda_kernel_bwd_matches_plain_reshade(cuda):
    grads = []
    for kernel_bwd in (True, False):
        scene = default_scene(3, device=cuda)
        img = ktrace.render_kernel(scene, dataclasses.replace(CFG, kernel_bwd=kernel_bwd))
        torch.mean(img * torch.cos(img)).backward()
        grads.append({n: p.grad for n, p in scene.named_parameters() if p.grad is not None})
    assert grads[0].keys() >= grads[1].keys() >= {"noise.amplitudes", "camera.yaw"}
    for name, ref in grads[1].items():
        assert within_bwd_tolerance(grads[0][name], ref), name
