"""Scenes and render settings from a configuration file, for both sides: the
port's ``Scene`` and ``RenderConfig``, and the reference's dict of tensors
and ``RenderSpec``. The benchmark makes every input here and hands the same
values to both."""

from __future__ import annotations

import operator

import numpy as np
import torch

from raybench.reference.terrain import RenderSpec

NOISE = ("amplitudes", "lacunarity", "height_scale", "height_offset", "horizontal_scale",
         "seed", "warp_amplitude", "warp_frequency")
CAMERA = ("position", "yaw", "pitch", "fov_y")
SPEC_KEYS = ("height", "width", "num_octaves", "max_steps", "t_min", "t_max", "hit_eps",
             "step_relax", "step_floor_t", "march_chunk", "newton_iters", "prime_ds",
             "prime_margin")


def render_config(render: dict, **changes):
    """The port's ``RenderConfig`` of a configuration's ``render`` block."""
    from gpgpuraytrace_tpu_torch.models.scene import RenderConfig

    return RenderConfig(**{**render, **changes})


def render_spec(render: dict, **changes) -> RenderSpec:
    """The reference's ``RenderSpec`` of the same block."""
    merged = {**render, **changes}
    return RenderSpec(**{k: merged[k] for k in SPEC_KEYS if k in merged})


def port_scene(values: dict, device):
    """The port's ``Scene`` holding ``values`` (dotted leaf names)."""
    from gpgpuraytrace_tpu_torch.models.scene import Camera, Materials, NoiseParams, Scene

    def part(prefix, names):
        return {n: values[f"{prefix}.{n}"] for n in names if f"{prefix}.{n}" in values}

    mats = {k.split(".", 1)[1]: v for k, v in values.items() if k.startswith("materials.")}
    return Scene(NoiseParams(**part("noise", NOISE), device=device),
                 Camera(**part("camera", CAMERA), device=device),
                 Materials(device=device, **mats))


def ref_scene(values: dict, device) -> dict:
    """The reference's scene: float32 tensors by dotted name, the seed an
    int."""
    out = {}
    for k, v in values.items():
        out[k] = int(v) if k == "noise.seed" else torch.as_tensor(
            np.asarray(v, np.float32), device=device)
    return out


def leaves(scene, names) -> dict:
    """Detached copies of a port scene's leaves ``names``."""
    return {n: operator.attrgetter(n)(scene).detach().clone() for n in names}


def host_values(tensors: dict) -> dict:
    """Tensors as plain values for ``ref_scene``."""
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in tensors.items()}


def perturbed(values: dict, seed: int, rel: float) -> dict:
    """The fit's start: the fBm amplitudes scaled by 1 + rel·U(-1, 1) and the
    camera's yaw and pitch nudged by rel·0.2·N(0, 1) and rel·0.1·N(0, 1),
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    amps = np.asarray(values["noise.amplitudes"], np.float32)
    out = dict(values)
    out["noise.amplitudes"] = (amps * (1.0 + rel * rng.uniform(-1.0, 1.0, amps.shape))
                               ).astype(np.float32)
    z = rng.standard_normal(2)
    out["camera.yaw"] = np.float32(values["camera.yaw"] + rel * 0.2 * z[0])
    out["camera.pitch"] = np.float32(values["camera.pitch"] + rel * 0.1 * z[1])
    return out
