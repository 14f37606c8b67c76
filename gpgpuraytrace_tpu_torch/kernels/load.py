"""A flythrough batch's inputs onto the card in one launch (``csrc/load.cu``):
the caller's scene leaves and the batch's times into the private copy that
``ops/flythrough.py:FlyBatch``'s captured CUDA graph reads by address.

* ``FlyLoad(scene, times)`` takes the private copy (``scene``'s leaves and
  the (batch,) ``times`` buffer, all on one CUDA device) as the
  destinations, fixed for its life; a batch whose times do not fit the
  argument block (``MAX_TIMES``) raises ``ValueError``.
* a call ``(scene, times)`` checks the caller's leaves (``LEAF_NAMES``: float32,
  the seed int32, contiguous, on the copy's device and of its shapes; else
  ``ValueError`` naming the leaf: nothing is cast; a leaf is checked again
  only where it is another tensor or lies elsewhere than at the last call)
  and launches ``fly_load_kernel`` once on the current stream, with the
  leaves' pointers (read at every call) and the times' values in its
  argument block. The caller's scene is never written.
  ``FlyLoad.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from gpgpuraytrace_tpu_torch.models.scene import Scene
from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES

# The argument block's size (csrc/load.cu:kParamBytes): the 4 KB of kernel
# parameters that every CUDA target takes.
PARAM_BYTES = 4096


# The getters of the scene's leaves, in ``LEAF_NAMES`` order.
_GETTERS = tuple(map(operator.attrgetter, LEAF_NAMES))


class _Head(ctypes.Structure):
    """``csrc/load.cu:FlyLoadHead``: each leaf's source and destination
    pointer and its count of 32-bit values, the times' destination and the
    batch."""

    _fields_ = [
        ("src", ctypes.c_void_p * len(LEAF_NAMES)),
        ("dst", ctypes.c_void_p * len(LEAF_NAMES)),
        ("times_dst", ctypes.c_void_p),
        ("count", ctypes.c_int * len(LEAF_NAMES)),
        ("batch", ctypes.c_int),
    ]


# The most times a batch takes: what the argument block holds after its head
# (csrc/load.cu:kMaxTimes).
MAX_TIMES = (PARAM_BYTES - ctypes.sizeof(_Head)) // ctypes.sizeof(ctypes.c_float)


class LoadArgs(ctypes.Structure):
    """``csrc/load.cu:FlyLoadArgs``: the head, then the batch's times."""

    _fields_ = [*_Head._fields_, ("times", ctypes.c_float * MAX_TIMES)]


@functools.cache
def _library() -> ctypes.CDLL:
    from gpgpuraytrace_tpu_torch.kernels.build import load_library

    lib = load_library()
    lib.fly_load_launch.argtypes = [ctypes.POINTER(LoadArgs), ctypes.c_int, ctypes.c_void_p]
    lib.fly_load_launch.restype = ctypes.c_int
    lib.trace_error_string.argtypes = [ctypes.c_int]
    lib.trace_error_string.restype = ctypes.c_char_p
    return lib


def _leaves(scene: Scene) -> list[torch.Tensor]:
    """``scene``'s leaves in ``LEAF_NAMES`` order."""
    return [get(scene) for get in _GETTERS]


def check_batch(batch: int) -> None:
    """ValueError unless ``batch`` times fit the argument block."""
    if not 1 <= batch <= MAX_TIMES:
        raise ValueError(f"FlyLoad: a batch of {batch} frames; the kernel's {PARAM_BYTES}-byte "
                         f"argument block holds the times of 1 to {MAX_TIMES}")


class FlyLoad:
    """The private copy ``scene`` and ``times`` as the destinations of
    ``fly_load_kernel`` (module docstring).

    The check is cheap where the caller hands over the leaves it handed over
    before: a leaf is checked when it is another tensor object than at the
    last call, or its data lies elsewhere, and those last leaves are held
    until the next call. (An in-place change of a leaf's metadata that keeps
    its object and its address, such as ``resize_`` to fewer values, is not
    checked again: the kernel then copies the copy's count of values from
    that address, within the leaf's storage.)"""

    launches = 0

    def __init__(self, scene: Scene, times: torch.Tensor):
        check_batch(times.numel())
        if times.dim() != 1 or times.dtype != torch.float32 or not times.is_contiguous():
            raise ValueError(f"FlyLoad: the copy's times must be a contiguous float32 vector, got "
                             f"{times.dtype} of shape {tuple(times.shape)}")
        self.leaves = _leaves(scene)
        self.times = times
        self.index = times.get_device()
        self.args = LoadArgs(times_dst=times.data_ptr(), batch=times.numel())
        for k, (name, x) in enumerate(zip(LEAF_NAMES, self.leaves)):
            if x.element_size() != 4 or not x.is_contiguous() or x.device != times.device:
                raise ValueError(f"FlyLoad: the copy's {name} is {x.dtype} on {x.device}, "
                                 f"strides {x.stride()}")
            self.args.dst[k] = x.data_ptr()
            self.args.count[k] = x.numel()
        self._seen: list[torch.Tensor] = []
        self._ptrs: list[int] = []

    def _check(self, leaves: list[torch.Tensor]) -> None:
        """ValueError naming the first of ``leaves`` unlike the copy's leaf."""
        for name, x, want in zip(LEAF_NAMES, leaves, self.leaves):
            if (x.dtype is not want.dtype or x.shape != want.shape
                    or x.get_device() != self.index or not x.is_contiguous()):
                raise ValueError(
                    f"FlyLoad: {name} must be contiguous {want.dtype} of shape "
                    f"{tuple(want.shape)} on {want.device}, got {x.dtype} of shape "
                    f"{tuple(x.shape)}, strides {x.stride()}, on {x.device}")

    def sources(self, scene: Scene) -> list[int]:
        """The data pointers of ``scene``'s leaves in ``LEAF_NAMES`` order,
        each checked against the copy's leaf (ValueError naming the leaf)."""
        leaves = _leaves(scene)
        ptrs = list(map(torch.Tensor.data_ptr, leaves))
        if ptrs != self._ptrs or not all(map(operator.is_, leaves, self._seen)):
            self._check(leaves)
            self._seen, self._ptrs = leaves, ptrs
        return ptrs

    def __call__(self, scene: Scene, times: torch.Tensor) -> None:
        """Load ``scene``'s leaves and ``times`` (host values; a device
        tensor is read back first) into the copy: one launch on the current
        stream."""
        if times.shape != self.times.shape:
            raise ValueError(f"FlyLoad: a batch of {self.args.batch} frames takes times of shape "
                             f"{tuple(self.times.shape)}, got {tuple(times.shape)}")
        self.args.src[:] = self.sources(scene)
        self.args.times[:self.args.batch] = times.tolist()
        lib = _library()
        # The raw handle of the current stream, as torch.cuda.current_stream(i).cuda_stream
        # gives it, without making a Stream object.
        err = lib.fly_load_launch(ctypes.byref(self.args), self.index,
                                  torch._C._cuda_getCurrentRawStream(self.index))
        if err != 0:
            raise RuntimeError(f"fly_load kernel launch failed: CUDA error {err} "
                               f"({lib.trace_error_string(err).decode()})")
        FlyLoad.launches += 1
