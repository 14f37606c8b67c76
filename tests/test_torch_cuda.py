"""The CUDA trace kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU and nvcc; skips without CUDA. Imports nothing of JAX, so
on a machine without jax run it without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

chip_smoke.py makes the same comparison at 512x512.
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
