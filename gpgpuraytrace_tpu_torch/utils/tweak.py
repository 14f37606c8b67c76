"""Live tweak variables: edit scene parameters while a flythrough runs
(counterpart of ``gpgpuraytrace_tpu/utils/tweak.py``).

A watched JSON file of dotted leaf names (``utils/convert.py:LEAF_NAMES``)
and values, re-read whenever its mtime changes; the running ``fly`` applies
it before its next batch of frames:

    # terminal 1
    python -m gpgpuraytrace_tpu_torch.cli fly --frames 9999 --tweak live.json -o frames/
    # terminal 2: edit live.json; the next batch of frames picks it up
    {"noise.height_scale": 8.0, "materials.fog_density": 0.03,
     "materials.sun_dir": [0.2, 0.8, 0.1]}

The file's keys and values are the JAX package's. Unknown names, values of
the wrong shape and malformed JSON are reported and skipped: a live-editing
loop never stops the renderer.
"""

from __future__ import annotations

import copy
import json
import operator
import os
from typing import Any

import numpy as np
import torch

from gpgpuraytrace_tpu_torch.models.scene import Scene
from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES


def _leaf(scene: Scene, name: str) -> torch.Tensor:
    return operator.attrgetter(name)(scene)


def scene_variables(scene: Scene) -> dict[str, Any]:
    """{dotted name: Python value} of every leaf (the differentiable ones
    and the integer seed): the full menu of tweakables."""
    out: dict[str, Any] = {}
    for name in LEAF_NAMES:
        v = _leaf(scene, name).detach().cpu()
        out[name] = v.tolist() if v.ndim else v.item()
    return out


def write_template(path: str, scene: Scene) -> None:
    """Write the scene's current values as an editable tweak file."""
    with open(path, "w") as f:
        json.dump(scene_variables(scene), f, indent=2, sort_keys=True)
        f.write("\n")


def apply_tweaks(scene: Scene, tweaks: dict[str, Any]) -> tuple[Scene, list[str]]:
    """Apply {dotted name: value} overrides to a copy of ``scene``: (the
    copy, the rejected names). A value is cast to its leaf's dtype and
    reshaped to its shape; an unknown name or a value that does not fit is
    rejected (reported, not raised). ``scene`` itself is left as it is."""
    rejected: list[str] = []
    updates: dict[str, np.ndarray] = {}
    for name, value in tweaks.items():
        if name not in LEAF_NAMES:
            rejected.append(name)
            continue
        old = _leaf(scene, name)
        dtype = torch.empty((), dtype=old.dtype).numpy().dtype
        try:
            updates[name] = np.asarray(value, dtype=dtype).reshape(tuple(old.shape))
        except (TypeError, ValueError):
            rejected.append(name)
    out = copy.deepcopy(scene)
    with torch.no_grad():
        for name, value in updates.items():
            leaf = _leaf(out, name)
            leaf.copy_(torch.from_numpy(value).to(leaf.device))
    return out, rejected


class TweakWatcher:
    """mtime-polling watcher of a tweak JSON file.

    ``poll()`` returns the parsed overrides when the file has appeared or
    changed since the last poll, else None. Malformed JSON returns None and
    keeps the previous mtime, so a half-saved file is read again at its next
    change. A missing file is fine: it can be created while the loop runs.
    """

    def __init__(self, path: str):
        self.path = path
        self._mtime: float | None = None

    def poll(self) -> dict[str, Any] | None:
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return None
        if mtime == self._mtime:
            return None
        try:
            with open(self.path) as f:
                tweaks = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if not isinstance(tweaks, dict):
            return None
        self._mtime = mtime
        return tweaks
