"""The fly batch's load (``kernels/load.py:FlyLoad``) on the CPU: its
argument block and the checks made before a launch. The launch runs only on
the card: tests/test_torch_cuda.py holds it there.

Contracts:

* the argument block is ``csrc/load.cu``'s layout: a 472-byte head, then the
  times, 4096 bytes in all; its destinations are the copy's leaves in
  ``LEAF_NAMES`` order, each with its count of values, and the times' buffer;
* a batch of 1 to ``MAX_TIMES`` frames fits it, one more would overflow the
  block and raises ``ValueError`` naming the limit, as does none;
* ``sources`` gives the caller's leaves' pointers in ``LEAF_NAMES`` order,
  a deep copy's its own and an edit in place the same; a leaf of another
  dtype or shape, not contiguous, or on another device raises
  ``ValueError`` naming it; the leaves are checked once while the caller
  hands over the same tensors at the same addresses, again for a deep copy
  or a leaf replaced, and at every call while one is refused; times of
  another shape raise before any launch;
* a scene whose leaf is a plain tensor attribute (``ops/fd_check.py``) gives
  its leaves as a scene of parameters does;
* ``ops/flythrough.py:launch_counts`` counts the load as ``fly_load``, and
  ``cli.py fly --batch`` takes 1 to ``MAX_TIMES`` frames.
"""

import copy
import ctypes
import operator

import argparse

import pytest
import torch

from gpgpuraytrace_tpu_torch import cli

from gpgpuraytrace_tpu_torch.kernels import load as kload
from gpgpuraytrace_tpu_torch.models.scene import default_scene
from gpgpuraytrace_tpu_torch.ops.fd_check import scene_with
from gpgpuraytrace_tpu_torch.ops.flythrough import launch_counts
from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES


def copy_load(octaves=6, batch=4, volumetric=False):
    scene = default_scene(octaves, volumetric=volumetric, device="cpu")
    return scene, kload.FlyLoad(scene, torch.zeros(batch))


def leaves(scene):
    return [operator.attrgetter(name)(scene) for name in LEAF_NAMES]


@pytest.mark.parametrize("octaves, volumetric", [(6, False), (3, False), (6, True)])
def test_argument_block_follows_leaf_names(octaves, volumetric):
    scene, load = copy_load(octaves, volumetric=volumetric)
    args = load.args
    assert ctypes.sizeof(kload.LoadArgs) == kload.PARAM_BYTES == 4096
    assert kload.LoadArgs.times.offset == ctypes.sizeof(kload._Head) == 472
    assert kload.MAX_TIMES == 906
    assert len(args.dst) == len(args.src) == len(args.count) == len(LEAF_NAMES) == 23
    for k, (name, x) in enumerate(zip(LEAF_NAMES, leaves(scene))):
        assert args.dst[k] == x.data_ptr(), name
        assert args.count[k] == x.numel(), name
    assert args.count[LEAF_NAMES.index("noise.amplitudes")] == octaves
    assert args.count[LEAF_NAMES.index("camera.position")] == 3
    assert sum(args.count) == octaves + 42
    assert args.times_dst == load.times.data_ptr() and args.batch == 4


@pytest.mark.parametrize("batch", [0, kload.MAX_TIMES + 1, 4096])
def test_a_batch_beyond_the_block_raises(batch):
    assert ctypes.sizeof(kload._Head) + 4 * (kload.MAX_TIMES + 1) > kload.PARAM_BYTES
    with pytest.raises(ValueError, match=f"1 to {kload.MAX_TIMES}"):
        kload.check_batch(batch)
    with pytest.raises(ValueError, match=f"1 to {kload.MAX_TIMES}"):
        copy_load(batch=batch)


def test_the_largest_batch_fits():
    _, load = copy_load(batch=kload.MAX_TIMES)
    assert load.args.batch == kload.MAX_TIMES


def test_sources_are_the_callers_leaves():
    scene, load = copy_load()
    other = copy.deepcopy(scene)
    ptrs = load.sources(other)
    assert ptrs == [x.data_ptr() for x in leaves(other)]
    assert not set(ptrs) & {x.data_ptr() for x in leaves(scene)}
    with torch.no_grad():
        other.noise.amplitudes.mul_(1.05)
    assert load.sources(other) == ptrs


def test_a_leaf_is_checked_where_it_is_new(monkeypatch):
    scene, load = copy_load()
    checked = []
    check = load._check
    monkeypatch.setattr(load, "_check", lambda leaves: checked.append(1) or check(leaves))
    other = copy.deepcopy(scene)
    for _ in range(3):
        load.sources(other)
    with torch.no_grad():
        other.noise.amplitudes.mul_(1.05)
    load.sources(other)
    assert len(checked) == 1
    load.sources(copy.deepcopy(other))
    assert len(checked) == 2
    other.camera.yaw = torch.nn.Parameter(other.camera.yaw.detach().double())
    with pytest.raises(ValueError, match=r"camera\.yaw"):
        load.sources(other)
    with pytest.raises(ValueError, match=r"camera\.yaw"):
        load.sources(other)
    assert len(checked) == 4


def _float64(s):
    s.noise.amplitudes = torch.nn.Parameter(s.noise.amplitudes.detach().double())


def _short(s):
    s.noise.amplitudes = torch.nn.Parameter(s.noise.amplitudes.detach()[:5].clone())


def _strided(s):
    s.camera.position = torch.nn.Parameter(torch.zeros(3, 2)[:, 0])


def _seed_int64(s):
    s.noise.seed = s.noise.seed.long()


def _framed(s):
    s.camera.yaw = torch.nn.Parameter(torch.zeros(1))


BAD = {"float64": (_float64, "noise.amplitudes"), "shape": (_short, "noise.amplitudes"),
       "strided": (_strided, "camera.position"), "seed_int64": (_seed_int64, "noise.seed"),
       "framed": (_framed, "camera.yaw")}


@pytest.mark.parametrize("case", sorted(BAD))
def test_a_leaf_unlike_the_copy_raises(case):
    edit, name = BAD[case]
    before = kload.FlyLoad.launches
    scene, load = copy_load()
    other = copy.deepcopy(scene)
    edit(other)
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        load.sources(other)
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        load(other, torch.zeros(4))
    assert kload.FlyLoad.launches == before


def test_times_of_another_shape_raise():
    before = kload.FlyLoad.launches
    scene, load = copy_load()
    for times in (torch.zeros(3), torch.zeros(4, 1)):
        with pytest.raises(ValueError, match="takes times of shape"):
            load(scene, times)
    assert kload.FlyLoad.launches == before


def test_a_plain_tensor_leaf_is_read_like_a_parameter():
    scene, load = copy_load()
    other = scene_with(scene, "noise.height_scale", torch.tensor(7.0))
    assert not isinstance(other.noise.height_scale, torch.nn.Parameter)
    assert load.sources(other) == [x.data_ptr() for x in leaves(other)]
    assert kload._leaves(other)[LEAF_NAMES.index("noise.height_scale")] is other.noise.height_scale


def test_launch_counts_count_the_load(monkeypatch):
    monkeypatch.setattr(kload.FlyLoad, "launches", 7)
    assert launch_counts()["fly_load"] == 7


@pytest.mark.parametrize("batch", [1, 4, kload.MAX_TIMES])
def test_cli_takes_a_batch_the_load_holds(batch):
    assert cli._fly_batch(str(batch)) == batch


@pytest.mark.parametrize("batch", [0, kload.MAX_TIMES + 1])
def test_cli_refuses_a_batch_beyond_the_load(batch, capsys):
    with pytest.raises(argparse.ArgumentTypeError, match=f"1 to {kload.MAX_TIMES}"):
        cli._fly_batch(str(batch))
    with pytest.raises(SystemExit) as exit_:
        cli.main(["fly", "--device", "cpu", "--batch", str(batch), "--frames", "1"])
    assert exit_.value.code == 2
    assert f"1 to {kload.MAX_TIMES}" in capsys.readouterr().err
