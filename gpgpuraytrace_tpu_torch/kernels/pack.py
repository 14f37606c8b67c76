"""Scene packing on the card: the scene's leaves -> the packed scalar rows
that the trace kernels read (``utils/packing.py``'s layout and offsets), and
the rows' cotangent -> the leaves' gradients, one kernel launch each
(``csrc/pack.cu``).

* ``pack_frames`` is the wrapper: the rows of a batch of cameras, one per
  frame, or of one camera over a batch of evenly spaced row blocks (a
  row-band rank's interleaved stripes: a ROW0 per frame), and where
  ``coarse`` asks for them the coarse prime pass's rows, which differ only
  in the aspect and ROW0. On CUDA leaves it launches
  ``pack_kernel`` once for both, through an autograd Function whose
  backward is ``pack_vjp``: one launch of ``pack_vjp_kernel``, which writes
  each float leaf's gradient into a tensor of its own. The coarse rows carry
  no gradient. On CPU leaves it runs the plain version,
  ``utils/packing.py:pack_scenes``, and autograd pulls back through its ops.
  ``.launches`` on each counts its kernel's launches. A CUDA leaf never
  takes the plain version: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gpgpuraytrace_tpu_torch.models.scene import Camera, Scene
from gpgpuraytrace_tpu_torch.ops.camera import Cameras
from gpgpuraytrace_tpu_torch.utils import packing as pk
from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES

# The most frames one batch takes: the trace kernels' CUDA grid's y
# (csrc/trace_march.cuh:kMaxFrames).
MAX_FRAMES = 65535
# The float leaves in the order csrc/pack.cu:Leaf numbers them.
FLOAT_LEAVES = tuple(name for name in LEAF_NAMES if name != "noise.seed")
_VEC3 = frozenset(("camera.position", "materials.sun_dir", "materials.sun_color",
                   "materials.ambient_color", "materials.albedo_low", "materials.albedo_high",
                   "materials.snow_color", "materials.fog_color", "materials.sky_zenith",
                   "materials.sky_horizon"))


class PackLeaves(ctypes.Structure):
    """``csrc/pack.cu:PackLeaves``: each float leaf's pointer, its gradient's
    (null: not wanted) and its frame stride in floats (0: shared)."""

    _fields_ = [
        ("value", ctypes.c_void_p * len(FLOAT_LEAVES)),
        ("grad", ctypes.c_void_p * len(FLOAT_LEAVES)),
        ("frame_stride", ctypes.c_int * len(FLOAT_LEAVES)),
    ]


class PackConfig(ctypes.Structure):
    """``csrc/pack.cu:PackConfig``: frame b's ROW0 is row0 + b·row0_step."""

    _fields_ = [
        ("frames", ctypes.c_int),
        ("num_octaves", ctypes.c_int),
        ("aspect", ctypes.c_float),
        ("row0", ctypes.c_float),
        ("coarse_aspect", ctypes.c_float),
        ("coarse_row0", ctypes.c_float),
        ("row0_step", ctypes.c_float),
        ("coarse_row0_step", ctypes.c_float),
    ]


@functools.cache
def _library() -> ctypes.CDLL:
    from gpgpuraytrace_tpu_torch.kernels.build import load_library

    lib = load_library()
    lib.pack_launch.argtypes = [PackLeaves, PackConfig, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.pack_launch.restype = ctypes.c_int
    lib.pack_vjp_launch.argtypes = [PackLeaves, PackConfig, ctypes.c_void_p, ctypes.c_void_p]
    lib.pack_vjp_launch.restype = ctypes.c_int
    lib.trace_error_string.argtypes = [ctypes.c_int]
    lib.trace_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({lib.trace_error_string(err).decode()})")


def _unit(name: str, octaves: int) -> int:
    """Floats of one frame's value of the leaf ``name``."""
    if name == "noise.amplitudes":
        return octaves
    return 3 if name in _VEC3 else 1


def _leaves(scene: Scene, cameras: Camera | Cameras) -> list[torch.Tensor]:
    """The float leaves in ``FLOAT_LEAVES`` order, the camera's from ``cameras``."""
    out = []
    for name in FLOAT_LEAVES:
        part, field = name.split(".")
        out.append(getattr(cameras if part == "camera" else getattr(scene, part), field))
    return out


def _spacing(row0s: tuple[float, ...]) -> tuple[float, float]:
    """(first, step) of evenly spaced first rows (step 0 for one that every
    frame shares), as the kernel rounds frame b's: float32(first) +
    b·float32(step) equal to float32(row0s[b]) for every b (whole rows below
    2^24 always are); else ValueError."""
    first = torch.tensor(row0s[0], dtype=torch.float32)
    step = torch.tensor(row0s[1] - row0s[0] if len(row0s) > 1 else 0.0, dtype=torch.float32)
    got = first + torch.arange(len(row0s), dtype=torch.float32) * step
    if not torch.equal(got, torch.tensor(row0s, dtype=torch.float32)):
        raise ValueError(f"pack_frames: a row0 per frame must be evenly spaced, got {row0s}")
    return float(first), float(step)


def _layout(leaves: list[torch.Tensor], seed: torch.Tensor,
            rows: int = 1) -> tuple[int, int, list[int]]:
    """Checks the leaves and returns (frames, octaves, frame strides): a
    camera leaf holds one value per frame (a leading frame axis) or one that
    every frame shares; every other leaf is shared. ``rows`` is the count of
    first rows: one that every frame shares, or one per frame."""
    octaves = leaves[0].numel()
    lead, per_frame = set(), []
    if rows > 1:
        lead.add(rows)
    for name, x in zip(FLOAT_LEAVES, leaves):
        if x.device != seed.device:
            raise ValueError(f"pack_frames: {name} is on {x.device}, noise.seed on {seed.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"pack_frames: {name} must be contiguous float32, got {x.dtype} "
                             f"of strides {x.stride()}")
        unit = (_unit(name, octaves),) if name in _VEC3 or name == "noise.amplitudes" else ()
        framed = name.startswith("camera.") and x.dim() == len(unit) + 1
        if framed:
            lead.add(x.shape[0])
        if x.shape[framed:] != unit:
            raise ValueError(f"pack_frames: {name} has shape {tuple(x.shape)}")
        per_frame.append(framed)
    if len(lead) > 1:
        raise ValueError(f"pack_frames: the camera leaves and row0 hold {sorted(lead)} frames")
    frames = lead.pop() if lead else 1
    if not 1 <= frames <= MAX_FRAMES:
        raise ValueError(f"pack_frames: {frames} cameras; a batch holds 1 to {MAX_FRAMES}")
    strides = [_unit(name, octaves) if framed else 0
               for name, framed in zip(FLOAT_LEAVES, per_frame)]
    return frames, octaves, strides


def pack_frames(scene: Scene, cameras: Camera | Cameras, height: int, width: int, row0=0.0,
                coarse: tuple | None = None):
    """The packed rows of ``scene`` seen from each camera of ``cameras``:
    (packed float32 (B, AMPS + octaves), the coarse rows of the same shape or
    None, seed int32 (1, 1)), B the frames of ``cameras`` (1 for a
    ``Camera``). ``height``/``width`` are the full image's, ``row0`` the
    first row of the block being rendered, or a sequence of B evenly spaced
    first rows, one per frame (B blocks of one ``Camera``: a rank's stripes);
    ``coarse`` (height, width, row0) asks for the coarse prime pass's rows
    too, its row0 a number or a sequence in the same way. Row b is bit for
    bit the row of a batch of one with camera b and row0 b. On the card
    the kernel reads the leaves by pointer, so a CUDA graph that captured
    this call packs what they hold at each replay."""
    leaves = _leaves(scene, cameras)
    seed = scene.noise.seed.to(torch.int32).reshape(1, 1)
    frames, octaves, strides = _layout(leaves, seed, len(pk.row0s(row0)))
    if seed.device.type == "cpu":
        packed = _plain_rows(scene, cameras, height, width, row0)
        with torch.no_grad():
            rows = None if coarse is None else _plain_rows(scene, cameras, *coarse)
        return packed, rows, seed
    ch, cw, crow0 = coarse or (height, width, row0)
    (first, step), (cfirst, cstep) = (_spacing(pk.row0s(r)) for r in (row0, crow0))
    cfg = PackConfig(frames=frames, num_octaves=octaves, aspect=width / height, row0=first,
                     coarse_aspect=cw / ch, coarse_row0=cfirst, row0_step=step,
                     coarse_row0_step=cstep)
    packed, rows = _Pack.apply(cfg, strides, coarse is not None, *leaves)
    return packed, rows, seed


pack_frames.launches = 0


def _plain_rows(scene, cameras, height, width, row0) -> torch.Tensor:
    packed, _ = pk.pack_scenes(scene, cameras, height, width, row0)
    return packed.reshape(-1, packed.shape[-1])


def _struct(leaves, strides, grads=()) -> PackLeaves:
    s = PackLeaves()
    for k, x in enumerate(leaves):
        s.value[k] = x.data_ptr()
        s.frame_stride[k] = strides[k]
    for k, g in enumerate(grads):
        s.grad[k] = None if g is None else g.data_ptr()
    return s


def _launch(leaves, strides, cfg: PackConfig, coarse: bool):
    lib = _library()
    dev = leaves[0].device
    out = torch.empty((cfg.frames, pk.AMPS + cfg.num_octaves), dtype=torch.float32, device=dev)
    rows = torch.empty_like(out) if coarse else None
    with torch.cuda.device(dev):
        err = lib.pack_launch(_struct(leaves, strides), cfg, out.data_ptr(),
                              None if rows is None else rows.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "pack")
    pack_frames.launches += 1
    return out, rows


def pack_vjp(leaves, strides, cfg: PackConfig, gbar: torch.Tensor, needs) -> list:
    """The gradient of every leaf that ``needs`` marks (None for the others)
    from the rows' cotangent ``gbar`` (frames, AMPS + octaves) on the card,
    each in a tensor of its own: one launch of ``pack_vjp_kernel``."""
    gbar = gbar.contiguous()
    if (gbar.shape != (cfg.frames, pk.AMPS + cfg.num_octaves) or gbar.dtype != torch.float32
            or gbar.device != leaves[0].device or gbar.device.type != "cuda"):
        raise ValueError(f"pack_vjp: the cotangent is {tuple(gbar.shape)} {gbar.dtype} on "
                         f"{gbar.device}, the rows ({cfg.frames}, {pk.AMPS + cfg.num_octaves}) "
                         f"float32 on the leaves' CUDA device")
    lib = _library()
    grads = [torch.empty_like(x) if need else None for x, need in zip(leaves, needs)]
    with torch.cuda.device(gbar.device):
        err = lib.pack_vjp_launch(_struct(leaves, strides, grads), cfg, gbar.data_ptr(),
                                  torch.cuda.current_stream(gbar.device).cuda_stream)
    _raise_on(lib, err, "pack_vjp")
    pack_vjp.launches += 1
    return grads


pack_vjp.launches = 0


class _Pack(torch.autograd.Function):
    """``pack_frames``' rows from CUDA leaves (``pack_kernel``); the
    backward pulls the fine rows' cotangent back onto the leaves that need
    it (``pack_vjp``)."""

    @staticmethod
    def forward(ctx, cfg, strides, coarse, *leaves):
        ctx.set_materialize_grads(False)
        ctx.cfg, ctx.strides = cfg, strides
        ctx.save_for_backward(*leaves)
        packed, rows = _launch(leaves, strides, cfg, coarse)
        if rows is not None:
            ctx.mark_non_differentiable(rows)
        return packed, rows

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _):
        needs = ctx.needs_input_grad[3:]
        if g is None or not any(needs):
            return (None,) * (3 + len(needs))
        grads = pack_vjp(ctx.saved_tensors, ctx.strides, ctx.cfg, g, needs)
        return (None,) * 3 + tuple(grads)
