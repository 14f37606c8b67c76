"""Scene <-> flat numpy dict, keyed by dotted leaf name.

This is how scene values carry between the JAX package and the port (and to
and from files) without either package importing the other: the keys are the
JAX package's pytree leaf names (``noise.amplitudes``, ``camera.position``,
``materials.sun_dir``, ...), which are also the dotted names of the port's
``Scene`` parameters and buffers.
"""

from __future__ import annotations

import numpy as np

from gpgpuraytrace_tpu_torch.models.scene import (
    MATERIAL_FIELDS, Camera, Materials, NoiseParams, Scene,
)

_NOISE_FIELDS = (
    "amplitudes", "lacunarity", "height_scale", "height_offset",
    "horizontal_scale", "seed", "warp_amplitude", "warp_frequency",
)
_CAMERA_FIELDS = ("position", "yaw", "pitch", "fov_y")
LEAF_NAMES = (
    tuple(f"noise.{k}" for k in _NOISE_FIELDS)
    + tuple(f"camera.{k}" for k in _CAMERA_FIELDS)
    + tuple(f"materials.{k}" for k in MATERIAL_FIELDS)
)


def scene_from_numpy(named: dict[str, np.ndarray], device="cuda") -> Scene:
    """Build a ``Scene`` on ``device`` (the card by default; without CUDA
    that raises, so pass ``device="cpu"``) from ``{dotted name: array}``.

    Floats are cast to float32 and the seed to int32; the key set must be
    exactly ``LEAF_NAMES``.
    """
    missing = set(LEAF_NAMES) - set(named)
    extra = set(named) - set(LEAF_NAMES)
    if missing or extra:
        raise ValueError(
            f"scene dict: missing {sorted(missing)}, unexpected {sorted(extra)}"
        )

    def part(prefix, fields):
        return {k: np.asarray(named[f"{prefix}.{k}"]) for k in fields}

    return Scene(
        noise=NoiseParams(**part("noise", _NOISE_FIELDS), device=device),
        camera=Camera(**part("camera", _CAMERA_FIELDS), device=device),
        materials=Materials(device=device, **part("materials", MATERIAL_FIELDS)),
    )


def scene_to_numpy(scene: Scene) -> dict[str, np.ndarray]:
    """``{dotted name: numpy array}`` of every parameter and buffer."""
    tensors = dict(scene.named_parameters())
    tensors.update(scene.named_buffers())
    return {name: tensors[name].detach().cpu().numpy() for name in LEAF_NAMES}
