"""The flythrough of the PyTorch port (``ops/flythrough.py``) and its command
line (``cli.py fly`` and ``tweaks``), on the CPU.

Contracts: ``flythrough_camera`` equals JAX's at 5 times within 1e-6;
``fly_frames`` (5 frames, batch 2) against JAX's: uint8 values within 1 level
on 99.9% of values (each side marches its own frame; the kernel path's plain
version here, JAX's XLA path there); every frame equals ``render`` plus
tonemap plus quantization of its camera bit for bit; compact frames equal
unprimed chunked ones bit for bit; a tweak file changes the next batch.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops.flythrough import fly_frames as jax_fly_frames
from gpgpuraytrace_tpu.ops.flythrough import flythrough_camera as jax_flythrough_camera
from gpgpuraytrace_tpu_torch import cli
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene, default_scene
from gpgpuraytrace_tpu_torch.ops.flythrough import fly_frames, flythrough_camera
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.ops.shade import tonemap
from gpgpuraytrace_tpu_torch.utils.tweak import apply_tweaks

torch.set_num_threads(2)

KW = {"height": 64, "width": 128, "max_steps": 48, "num_octaves": 3}
CFG = RenderConfig(**KW)


def test_flythrough_camera_matches_jax():
    scene = default_scene(3, device="cpu")
    js = jax_default_scene(3)
    for t in (0.0, 0.5, 1.7, 4.0, 33.3):
        cam = flythrough_camera(scene, t)
        ref = jax_flythrough_camera(js, np.float32(t))
        np.testing.assert_allclose(cam.position.detach().numpy(), np.asarray(ref.position),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(cam.yaw.detach().numpy(), np.asarray(ref.yaw), rtol=0,
                                   atol=1e-6)
        assert cam is not scene.camera
    assert torch.equal(scene.camera.position.detach(), torch.tensor([0.0, 8.0, -14.0]))


def test_fly_frames_match_jax():
    got = list(fly_frames(default_scene(3, device="cpu"), CFG, 5, batch=2))
    ref = list(jax_fly_frames(jax_default_scene(3), JaxConfig(**KW, use_pallas=False), 5,
                              batch=2))
    assert [i for i, _ in got] == [i for i, _ in ref] == list(range(5))
    for (i, a), (_, b) in zip(got, ref):
        assert a.dtype == np.uint8 and a.shape == (64, 128, 3)
        diff = np.abs(a.astype(np.int16) - np.asarray(b).astype(np.int16))
        within = (diff <= 1).mean()
        assert within >= 0.999, f"frame {i}: {100 * within:.3f}% within 1 level"
    jax.clear_caches()


def _quantized(scene, cfg, t):
    cam = flythrough_camera(scene, t)
    with torch.no_grad():
        img = tonemap(render(Scene(scene.noise, cam, scene.materials), cfg))
    return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).numpy()


@pytest.mark.parametrize("terrain", ["heightfield", "volumetric"])
def test_fly_frames_equal_render_and_compact_equals_chunked(terrain):
    cfg = dataclasses.replace(CFG, volumetric=terrain == "volumetric", prime_ds=0)
    scene = default_scene(3, volumetric=cfg.volumetric, device="cpu")
    frames = list(fly_frames(scene, cfg, 5, batch=2))
    compact = list(fly_frames(scene, dataclasses.replace(cfg, march_mode="compact",
                                                          compact_budget=16), 5, batch=2))
    for (i, a), (_, c) in zip(frames, compact):
        t = torch.arange(5, dtype=torch.float32)[i] / 30.0
        assert np.array_equal(a, _quantized(scene, cfg, t)), i
        assert np.array_equal(a, c), i


def test_on_batch_applies_tweaks_to_the_next_batch():
    scene = default_scene(3, device="cpu")
    seen = []

    def on_batch(s):
        seen.append(float(s.noise.height_scale.detach()))
        return apply_tweaks(s, {"noise.height_scale": 3.0})[0] if len(seen) == 2 else s

    cfg = dataclasses.replace(CFG, height=32, width=64, prime_ds=0)
    tweaked = list(fly_frames(scene, cfg, 6, batch=2, on_batch=on_batch))
    plain = list(fly_frames(scene, cfg, 6, batch=2))
    assert seen == [6.0, 6.0, 3.0]
    for (i, a), (_, b) in zip(tweaked, plain):
        assert np.array_equal(a, b) == (i < 2), i


def test_cli_fly_and_tweaks(tmp_path, capsys):
    common = ["--device", "cpu", "--size", "64x32", "--octaves", "2", "--max-steps", "64"]
    tweak = tmp_path / "live.json"
    cli.main(["tweaks", *common, "-o", str(tweak)])
    template = json.loads(tweak.read_text())
    assert template["noise.height_scale"] == 6.0 and len(template) == 23
    template["noise.height_scale"] = 3.0
    template["noise.no_such_leaf"] = 1.0
    tweak.write_text(json.dumps(template))
    out_png, out_rgb = tmp_path / "png", tmp_path / "rgb"
    cli.main(["fly", *common, "--frames", "3", "--batch", "2", "--tweak", str(tweak),
              "-o", str(out_png)])
    cli.main(["fly", *common, "--frames", "3", "--batch", "2", "--format", "rgb",
              "--march-mode", "compact", "-o", str(out_rgb)])
    printed = capsys.readouterr().out
    applied = [line for line in printed.splitlines() if line.startswith("tweaks applied: ")]
    assert len(applied) == 1 and "noise.height_scale" in applied[0].split(": ")[1].split(", ")
    assert "tweak rejected (unknown name or bad shape): noise.no_such_leaf" in printed
    assert printed.count("flythrough: 3 frames 64x32") == 2
    assert sorted(os.listdir(out_png)) == [f"frame_000{i}.png" for i in range(3)]
    for i in range(3):
        assert (out_png / f"frame_000{i}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert (out_rgb / f"frame_000{i}.rgb").stat().st_size == 64 * 32 * 3


def test_cli_fly_on_cuda_raises_without_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fly", "--device", "cuda", "--size", "64", "--frames", "1",
                  "-o", str(tmp_path / "f")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["tweaks", "--device", "cuda", "-o", str(tmp_path / "t.json")])
