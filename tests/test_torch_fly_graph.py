"""The flythrough batch as one program (``ops/flythrough.py:FlyBatch``) and
the tonemap-and-quantize kernel's plain version (``kernels/quantize.py``), on
the CPU. The CUDA graph and the kernel run only on the card:
tests/test_torch_cuda.py and chip_smoke.py phase 30 hold them there.

Contracts:

* ``tonemap_quantize_reference`` against the JAX package's
  ``(clip(tonemap(img), 0, 1) * 255 + 0.5).astype(uint8)`` on seeded colours
  (zeros, large values, values a few ulps either side of every level's
  rounding edge, and a spread): every value within 1 level and at least
  99.9% equal (measured on this suite's CPU: all 121,800 values equal; both
  sides round each step in float32, so they can differ only where their
  powf rounds otherwise);
* ``quantize`` is that plain version on a CPU tensor, with no launch;
* ``fly_frames`` with a short last batch (7 frames in batches of 4) against
  the JAX package's ``fly_frames`` on its Pallas kernels in interpret mode,
  both terrains, default and compact, at 32x64, 3 octaves: uint8 within 1
  level on 99.9% of values (tests/test_torch_batch.py's contract), and each
  frame bit for bit ``render_frame_uint8`` of its time;
* frames handed out stay as they were after later batches, with the
  program's output buffer overwritten by every batch, as a CUDA graph's is;
* ``FlyBatch`` off the card: no graph, no launches, eager batches of the
  frames left; a program of another batch size or config is refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops.flythrough import fly_frames as jax_fly_frames
from gpgpuraytrace_tpu.ops.shade import tonemap as jax_tonemap
from gpgpuraytrace_tpu_torch.kernels.quantize import (
    tonemap_quantize, tonemap_quantize_reference,
)
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops import flythrough as fly
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy

torch.set_num_threads(2)

H, W, OCT, MAX_STEPS = 32, 64, 3, 48
KW = {"height": H, "width": W, "max_steps": MAX_STEPS, "num_octaves": OCT}
TERRAINS = ("heightfield", "volumetric")
MODES = {"default": {}, "compact": {"march_mode": "compact", "compact_budget": 16}}


def edge_colours(rng) -> np.ndarray:
    """Linear colours at every level's rounding edge: tonemap(x) * 255 + 0.5
    = k + 0.5 for k = 0 .. 255 (x = c / (1 - c), c = (k / 255) ** 2.2), and 3
    float32 ulps either side of each; zeros; large values; a uniform spread
    over [0, 4) and a log spread to 1e6."""
    k = np.arange(256, dtype=np.float64)
    c = (k / 255.0) ** 2.2
    with np.errstate(divide="ignore"):
        x = np.where(c < 1.0, c / (1.0 - c), 1e30).astype(np.float32)
    edges = [x]
    for _ in range(3):
        edges.append(np.nextafter(edges[-1], np.float32(np.inf)))
    down = [x]
    for _ in range(3):
        down.append(np.nextafter(down[-1], np.float32(0.0)))
    special = np.array([0.0, 0.0, 1e-30, 1e-7, 1.0, 1e3, 1e6, 1e30, 3e38], np.float32)
    spread = rng.uniform(0.0, 4.0, 60_000).astype(np.float32)
    logs = (10.0 ** rng.uniform(-6.0, 6.0, 60_000)).astype(np.float32)
    return np.concatenate([*edges, *down[1:], special, spread, logs])


def jax_quantize(img: np.ndarray) -> np.ndarray:
    """The JAX package's batch program's last step
    (gpgpuraytrace_tpu/ops/flythrough.py:51-52)."""
    out = (jnp.clip(jax_tonemap(jnp.asarray(img)), 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
    return np.asarray(out)


def test_tonemap_quantize_reference_matches_jax():
    vals = edge_colours(np.random.default_rng(12))
    vals = vals[: len(vals) // 3 * 3].reshape(-1, 1, 3)
    got = tonemap_quantize_reference(torch.from_numpy(vals)).numpy()
    ref = jax_quantize(vals)
    assert got.dtype == np.uint8 and got.shape == ref.shape == vals.shape
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    share = (diff == 0).mean()
    assert share >= 0.999, f"{100 * share:.4f}% equal"
    assert got[0, 0, 0] == 0 and got[-1].max() <= 255


def test_quantize_is_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(rng.uniform(0.0, 3.0, (2, 3, H, W)).astype(np.float32))
    view = planes.permute(0, 2, 3, 1)  # how render_frames_raw hands the batch over
    before = tonemap_quantize.launches
    got = fly.quantize(view)
    assert torch.equal(got, tonemap_quantize_reference(view.contiguous()))
    assert got.shape == (2, H, W, 3) and got.dtype == torch.uint8
    assert tonemap_quantize.launches == before  # no kernel off the card


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("terrain", TERRAINS)
def test_fly_frames_short_last_batch_matches_jax(terrain, mode):
    vol = terrain == "volumetric"
    kw = dict(KW, **MODES[mode])
    cfg = RenderConfig(**kw, volumetric=vol)
    js = jax_default_scene(OCT, volumetric=vol)
    flat, _ = jax.tree_util.tree_flatten_with_path(js)
    scene = scene_from_numpy({".".join(p.name for p in path): np.asarray(leaf)
                              for path, leaf in flat}, device="cpu")
    got = list(fly.fly_frames(scene, cfg, 7, batch=4))
    ref = list(jax_fly_frames(js, JaxConfig(**kw, volumetric=vol, use_pallas=True,
                                             interpret=True), 7, batch=4))
    assert [i for i, _ in got] == [i for i, _ in ref] == list(range(7))
    times = torch.arange(7, dtype=torch.float32) / 30.0
    for (i, a), (_, b) in zip(got, ref):
        assert a.shape == (H, W, 3) and a.dtype == np.uint8
        diff = np.abs(a.astype(np.int16) - np.asarray(b).astype(np.int16))
        assert (diff <= 1).mean() >= 0.999, f"frame {i}"
        assert np.array_equal(a, fly.render_frame_uint8(scene, cfg, times[i]).numpy()), i
    jax.clear_caches()


def test_frames_handed_out_survive_later_batches():
    scene = default_scene(OCT, device="cpu")
    cfg = RenderConfig(**KW)
    kept = []
    for i, frame in fly.fly_frames(scene, cfg, 6, batch=2):
        kept.append((i, frame, frame.copy()))
    assert [i for i, _, _ in kept] == list(range(6))
    for i, frame, copy in kept:
        assert np.array_equal(frame, copy), i
    assert not np.array_equal(kept[0][1], kept[5][1])


def test_frames_survive_a_reused_output_buffer(monkeypatch):
    """A program whose output buffer every batch overwrites (a CUDA graph's
    is): each yielded frame keeps its own batch's values."""
    buffer = torch.zeros(2, 4, 5, 3, dtype=torch.uint8)
    calls = []

    def frames(self, scene, times):
        calls.append(len(calls))
        buffer.fill_(10 * len(calls))
        buffer[1] += 1
        return buffer[: len(times)]

    monkeypatch.setattr(fly.FlyBatch, "frames", frames)
    scene = default_scene(OCT, device="cpu")
    kept = list(fly.fly_frames(scene, RenderConfig(**KW), 5, batch=2))
    assert len(calls) == 3
    assert [int(f[0, 0, 0]) for _, f in kept] == [10, 11, 20, 21, 30]


def test_fly_batch_off_the_card_is_the_eager_batch():
    scene = default_scene(OCT, device="cpu")
    cfg = RenderConfig(**KW)
    program = fly.FlyBatch(scene, cfg, 4)
    assert not program.graphed
    frames = list(fly.fly_frames(scene, cfg, 6, batch=4, program=program))
    assert program.calls == 2 and program.replays == 0 and program.busy() is None
    assert not program.launches  # plain versions: no kernel launched
    times = torch.arange(6, dtype=torch.float32) / 30.0
    batch = fly.render_batch_uint8(scene, cfg, times[4:]).numpy()
    assert np.array_equal(np.stack([f for _, f in frames[4:]]), batch)
    for other in (fly.FlyBatch(scene, cfg, 2),
                  fly.FlyBatch(scene, dataclasses.replace(cfg, max_steps=32), 4)):
        with pytest.raises(ValueError, match="program renders batches"):
            next(fly.fly_frames(scene, cfg, 6, batch=4, program=other))
