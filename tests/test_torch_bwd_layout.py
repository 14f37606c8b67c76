"""The backward trace kernel's wrapper on the CPU: the cotangent layouts it
takes and the copy ``_KernelRender.backward`` no longer makes. The kernel
itself is held to these on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import dataclasses

import pytest
import torch

from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

torch.set_num_threads(2)

H, W = 64, 128
CFG = RenderConfig(height=H, width=W, max_steps=64, num_octaves=3)
VOL = {"volumetric": True, "step_relax": None}


def saved(cfg):
    """(packed, seed, t, hit) of the plain path's frame of ``cfg``."""
    scene = default_scene(cfg.num_octaves, volumetric=cfg.volumetric, device="cpu")
    _, t, hit = ktrace.render_kernel_raw(scene, cfg)
    packed, seed = pack_scene(scene, cfg.height, cfg.width)
    return packed.detach(), seed, t[None], hit.float()[None]


@pytest.mark.parametrize("kw", [{}, VOL], ids=["heightfield", "volumetric"])
def test_bwd_takes_the_permuted_cotangent(kw):
    """g as the permute(0, 3, 1, 2) view of a contiguous (B, h, W, 3) tensor
    (the layout of a colour cotangent) gives the contiguous input's result
    bit for bit."""
    cfg = dataclasses.replace(CFG, **kw)
    packed, seed, t, hit = saved(cfg)
    g_hw3 = torch.randn(1, H, W, 3, generator=torch.Generator().manual_seed(0))
    view = g_hw3.permute(0, 3, 1, 2)
    assert not view.is_contiguous()
    got = ktrace.trace_frames_bwd(packed, seed, cfg, H, t, hit, view)
    want = ktrace.trace_frames_bwd(packed, seed, cfg, H, t, hit, view.contiguous())
    assert torch.equal(got, want) and got.abs().max() > 0


@pytest.mark.parametrize("layout", ["transposed", "strided", "strided_hw3", "broadcast"])
def test_bwd_rejects_other_layouts(layout):
    """Every other non-contiguous g raises the ValueError of the kernels'
    input checks."""
    g = {
        "transposed": lambda: torch.zeros(1, 3, W, H).transpose(2, 3),
        "strided": lambda: torch.zeros(1, 3, H, 2 * W)[..., ::2],
        "strided_hw3": lambda: torch.zeros(1, H, W, 6)[..., ::2].permute(0, 3, 1, 2),
        "broadcast": lambda: torch.zeros(1, 1, H, W).expand(1, 3, H, W),
    }[layout]()
    assert g.shape == (1, 3, H, W) and not g.is_contiguous()
    packed, seed = pack_scene(default_scene(3, device="cpu"), H, W)
    t, hit = torch.ones(1, H, W), torch.zeros(1, H, W)
    with pytest.raises(ValueError, match="contiguous"):
        ktrace.trace_frames_bwd(packed.detach(), seed, CFG, H, t, hit, g)


@pytest.mark.parametrize("octaves, kw", [(2, {}), (3, VOL)], ids=["heightfield", "volumetric"])
def test_kernel_render_passes_the_cotangent_without_a_copy(monkeypatch, octaves, kw):
    """fit's pixel loss through render_kernel: _KernelRender.backward hands
    trace_frames_bwd the colour cotangent's own storage as a (1, 3, h, W)
    view (a batch of one block), not a copy."""
    cfg = dataclasses.replace(CFG, num_octaves=octaves, **kw)
    scene = default_scene(octaves, volumetric=cfg.volumetric, device="cpu")
    seen, cotangent = [], []
    real = ktrace.trace_frames_bwd

    def spy(packed, seed, cfg_, local_height, t, hit, g):
        seen.append(g)
        return real(packed, seed, cfg_, local_height, t, hit, g)

    monkeypatch.setattr(ktrace, "trace_frames_bwd", spy)
    img = ktrace.render_kernel(scene, cfg)
    img.register_hook(cotangent.append)
    target = torch.full_like(img, 0.5)
    torch.mean((img - target) * (img - target)).backward()
    (g,) = seen
    assert g.shape == (1, 3, H, W)
    assert g.data_ptr() == cotangent[0].data_ptr()
    assert g.is_contiguous() or g.permute(0, 2, 3, 1).is_contiguous()
    assert scene.noise.amplitudes.grad.abs().max() > 0
