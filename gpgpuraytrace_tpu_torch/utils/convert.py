"""Scene <-> flat numpy dict, keyed by dotted leaf name.

This is how scene values carry between the JAX package and the port (and to
and from files) without either package importing the other: the keys are the
JAX package's pytree leaf names (``noise.amplitudes``, ``camera.position``,
``materials.sun_dir``, ...), which are also the dotted names of the port's
``Scene`` parameters and buffers.
"""

from __future__ import annotations

from typing import Callable

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


def fit_state_from_jax(npz, trainable: Callable[[str], bool] | None = None
                       ) -> dict[str, np.ndarray]:
    """The JAX package's fit checkpoint (``save_fit_state`` of
    ``(train_leaves, ScaleByAdamState(count, mu, nu))``: keys
    ``s{i:04d}|0.{leaf}``, ``|1.0.count``, ``|1.0.mu.{leaf}``,
    ``|1.0.nu.{leaf}``) as the arrays of the port's
    (``utils/checkpoint.py``): write them with ``np.savez`` and resume from
    that file. ``npz`` is a path or what ``np.load`` returned for one.

    Leaf i is the i-th float name of ``LEAF_NAMES`` that ``trainable``
    accepts (default: ``ops/fit.py:default_trainable``), the order both
    packages partition a scene in. optax's one ``count`` (int32) becomes
    every parameter's ``step`` (float32, exact), ``mu`` its ``exp_avg`` and
    ``nu`` its ``exp_avg_sq``; values are copied bit for bit."""
    if trainable is None:
        from gpgpuraytrace_tpu_torch.ops.fit import default_trainable as trainable
    data = npz if hasattr(npz, "files") else np.load(npz)
    by_path = {k.split("|", 1)[1]: data[k] for k in data.files if k.startswith("s")}
    names = [n for n in LEAF_NAMES if n != "noise.seed" and trainable(n)]
    leaves = sorted(int(p[2:]) for p in by_path if p.startswith("0."))
    if leaves != list(range(len(names))):
        raise ValueError(f"JAX checkpoint has {len(leaves)} trainable leaves, the port's "
                         f"trainable set {names}")
    count = np.float32(by_path["1.0.count"])
    n = len(names)
    out = {}
    for i, name in enumerate(names):
        out[f"s{i:04d}|{name}"] = by_path[f"0.{i}"]
        for k, (field, value) in enumerate((
                ("step", np.asarray(count, np.float32)),
                ("exp_avg", by_path[f"1.0.mu.{i}"]),
                ("exp_avg_sq", by_path[f"1.0.nu.{i}"]))):
            out[f"s{n + 3 * i + k:04d}|adam.{name}.{field}"] = value
    out["meta_step"] = np.asarray(data["meta_step"], np.int64)
    out["meta_losses"] = np.asarray(data["meta_losses"], np.float64)
    return out
