"""Checkpoint and resume for the fit loop (counterpart of
``gpgpuraytrace_tpu/utils/checkpoint.py``): flat ``.npz`` files.

``save_pytree`` / ``load_pytree`` hold a whole ``Scene``: every parameter
and buffer, keyed ``{i:04d}|{dotted name}`` in ``utils/convert.py:LEAF_NAMES``
order, which are the keys the JAX package's ``save_pytree`` writes for its
scene, so either package reads the other's file.

``save_fit_state`` / ``load_fit_state`` hold one state of the fit loop. Keys:

* ``s{i:04d}|{name}``, i = 0 .. P-1: the P trainable parameters, in
  ``ops/fit.py:partition_scene`` order, by dotted name;
* ``s{j:04d}|adam.{name}.{field}``, j = P + 3·i + k for field k of
  (``step``, ``exp_avg``, ``exp_avg_sq``): ``torch.optim.Adam``'s state of
  parameter i (``step`` float32, 0-d);
* ``meta_step`` (int64): the steps taken; ``meta_losses`` (float64): the
  loss of every step so far.

torch's Adam keeps its state per parameter, where optax keeps one tree
(``utils/convert.py:fit_state_from_jax`` maps the JAX package's file onto
these keys). The write is atomic: a ``.tmp`` file, then ``os.replace``, so
a run killed mid-save leaves the previous checkpoint whole.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from gpgpuraytrace_tpu_torch.models.scene import Scene
from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES

ADAM_FIELDS = ("step", "exp_avg", "exp_avg_sq")


def _scene_tensors(scene: Scene) -> dict[str, torch.Tensor]:
    tensors = dict(scene.named_parameters())
    tensors.update(scene.named_buffers())
    return {name: tensors[name] for name in LEAF_NAMES}


def _atomic_savez(path: str, arrays: dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _checked(key: str, arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype and device; shapes must match."""
    if arr.shape != tuple(like.shape):
        raise ValueError(f"leaf {key}: shape {arr.shape} != expected {tuple(like.shape)}")
    return torch.from_numpy(np.asarray(arr)).to(dtype=like.dtype, device=like.device)


def save_pytree(path: str, scene: Scene) -> None:
    """Save every parameter and buffer of ``scene`` to ``path`` (.npz)."""
    np.savez(path, **{f"{i:04d}|{name}": _numpy(x)
                      for i, (name, x) in enumerate(_scene_tensors(scene).items())})


def load_pytree(path: str, like: Scene) -> Scene:
    """A copy of ``like`` holding the values saved by ``save_pytree``
    (``like`` is left as it is). Names and shapes must match; values take
    ``like``'s dtypes and device."""
    data = np.load(path)
    keys = sorted(data.files, key=lambda k: int(k.split("|", 1)[0]))
    names = [k.split("|", 1)[1] for k in keys]
    if names != list(LEAF_NAMES):
        raise ValueError(f"checkpoint leaves {names}, expected {list(LEAF_NAMES)}")
    out = copy.deepcopy(like)
    with torch.no_grad():
        for key, x in zip(keys, _scene_tensors(out).values()):
            x.copy_(_checked(key, data[key], x))
    return out


def save_fit_state(path: str, params: dict[str, torch.nn.Parameter],
                   opt: torch.optim.Adam, step: int, losses: list[float]) -> None:
    """Checkpoint one fit-loop state: the trainable parameters (``params``,
    by dotted name in ``partition_scene`` order), Adam's state of each, the
    step counter and the loss history. Every parameter must have Adam state
    (save after a step)."""
    arrays = {f"s{i:04d}|{name}": _numpy(p) for i, (name, p) in enumerate(params.items())}
    n = len(params)
    for i, (name, p) in enumerate(params.items()):
        state = opt.state.get(p)
        if not state:
            raise ValueError(f"{name} has no Adam state: save after an optimizer step")
        for k, field in enumerate(ADAM_FIELDS):
            arrays[f"s{n + 3 * i + k:04d}|adam.{name}.{field}"] = _numpy(state[field])
    arrays["meta_step"] = np.asarray(step, np.int64)
    arrays["meta_losses"] = np.asarray(losses, np.float64)
    _atomic_savez(path, arrays)


def load_fit_state(path: str, params: dict[str, torch.nn.Parameter],
                   opt: torch.optim.Adam) -> tuple[int, list[float]]:
    """Restore a ``save_fit_state`` checkpoint into ``params`` (in place)
    and ``opt``'s state; returns (step, losses).

    ``params`` and ``opt`` are built as in the run that saved it (same
    trainable names, ``ops/fit.py:make_optimizer`` on the same device).
    Restored values are bitwise the saved ones. ``step`` takes the dtype
    and device Adam gives it: a CPU tensor, or one on the parameters'
    device under ``capturable``."""
    data = np.load(path)
    keys = sorted((k for k in data.files if k.startswith("s")),
                  key=lambda k: int(k[1:].split("|", 1)[0]))
    n = len(params)
    want = [f"s{i:04d}|{name}" for i, name in enumerate(params)] + [
        f"s{n + 3 * i + k:04d}|adam.{name}.{field}"
        for i, name in enumerate(params) for k, field in enumerate(ADAM_FIELDS)]
    if keys != want:
        raise ValueError(f"checkpoint keys {keys}, expected {want}")
    capturable = {id(p): g["capturable"] for g in opt.param_groups for p in g["params"]}
    with torch.no_grad():
        for i, (name, p) in enumerate(params.items()):
            p.copy_(_checked(keys[i], data[keys[i]], p))
            step_like = torch.zeros((), dtype=torch.float32,
                                    device=p.device if capturable[id(p)] else "cpu")
            likes = (step_like, p, p)
            opt.state[p] = {
                field: _checked(keys[n + 3 * i + k], data[keys[n + 3 * i + k]], like)
                for k, (field, like) in enumerate(zip(ADAM_FIELDS, likes))}
    return int(data["meta_step"]), [float(x) for x in data["meta_losses"]]
