"""The trace kernels: the forward (raygen -> primed sphere-trace march ->
Newton polish -> shade), compaction's two phases, and the backward (output
cotangent -> packed scene-parameter cotangent), each for a full frame or a
row band.

Counterparts of ``gpgpuraytrace_tpu/kernels/trace.py``: ``_trace_kernel``
with its launcher ``_render_pallas_raw``; ``_trace_phase1_kernel`` and
``_trace_phase2_kernel`` with their glue ``_render_compact_raw``; and
``_trace_bwd_kernel`` with ``_backward_pallas`` and the custom VJP
``render_pallas_cfg``. The forward runs every variant of ``_trace_kernel``:
``march_mode`` "chunked" (primed or not), "fixed" (no early exit) and "lod"
(a certified coarse-field phase before the fine march), each with or without
``march_bf16`` (bf16 blend math in the march field), the ``march_eps_scale``
residual verdict and the ``debug_steps`` executed-step counter, on the
heightfield and on the volumetric terrain (the 3D fBm warp).
``march_mode="compact"`` runs two kernels: phase 1 marches every ray for
``compact_budget`` steps and lists the pixel ids of the rays still marching
in its first ``n_alive`` slots (``n_alive`` stays on the device: no host
sync); phase 2 resumes those rays, a pair of lanes per ray on persistent
warps, and writes each result in place. The variants change only where the
march stops, so one backward serves them all; under ``march_bf16`` its march
channel pulls back through the bf16 field, as JAX's does. The pieces:

* ``trace_frame``, ``trace_phase1``, ``trace_phase2`` and
  ``trace_frame_bwd`` are the wrappers. Each validates its inputs, launches
  its hand-written CUDA kernel (``csrc/trace_fwd.cu``,
  ``csrc/trace_compact.cu``, ``csrc/trace_bwd.cu``) on CUDA tensors, and
  runs its plain version on CPU tensors. ``.launches`` counts kernel
  launches (``trace_frame``'s, a ``Counter`` by instantiation, the two
  phases included). A CUDA input never falls back to the plain version: a
  failed build or launch raises.
* ``trace_frames``, ``trace_phase1s``, ``trace_phase2s`` and
  ``trace_frames_bwd`` are the same for a batch of B frames of one scene (a
  row of packed scalars per frame, a leading B on every per-pixel input and
  output): one launch for the batch (the kernels' frame axis; the JAX
  package's ``vmap`` over its kernels), each frame bit for bit its one-frame
  launch. The forward's batch is one pool of tiles, which the resident warps
  share whatever the frame, so frames that march unevenly (a row-band
  rank's stripes) keep the card full. Their launches count in
  ``trace_frame.launches`` and ``trace_frame_bwd.launches``, as "+frames"
  instantiations when B > 1 (a batch of one runs the one-frame kernel).
* The forward kernel (and phase 1) runs one thread per pixel, a warp per
  ``WARP_TILE`` (4x8) tile of pixels, on persistent warps: the grid is what
  fits on the card at once, and each warp takes its next tile from a counter
  in a two-int32 scratch buffer the wrapper keeps per device and stream (the
  last warp to finish sets it back to 0); a frame of few tiles (the 66x64 coarse prime pass) runs
  1-warp blocks, spread over all SMs. ``warp_tile_pixels`` is its tile ->
  pixel map. Which warp runs a pixel changes no output bit.
* Compaction's phase 2 runs a group of 2 lanes per survivor (16 per warp):
  lane k evaluates the field's items k, k + 2, ... (the heightfield's
  octaves, then the volumetric warp's), and both lanes sum them in item
  order, as the one-pass kernel does (the map and each sum's order are
  stated in csrc/trace_compact.cu's header). Its groups are persistent and
  take their next slot from a counter in the same per-stream scratch as the
  forward's tiles, up to ``n_alive``, read on the device; a warp polishes
  and shades its groups' finished rays together, one per group per round.
* The backward kernel runs a warp per group of 128 consecutive pixels,
  each lane four of them in turn, its column sums in the warp's slice of
  shared memory, into one partial sum per column and group (the map and
  the order of every sum are stated in csrc/trace_bwd.cu's header). A
  second launch sums the groups and folds the frequency columns into the
  lacunarity's. The order of every sum is fixed by the frame's shape, so
  the gradient is the same bit for bit from run to run. Its scratch (the partial sums and the second stage's
  counter, left at 0) is kept per device and stream, as the forward's, and
  ``g`` may be the (h, W, 3) colour cotangent's view, read in place.
* ``trace_frame_reference``, ``trace_phase1_reference``,
  ``trace_phase2_reference`` and ``trace_bwd_reference`` are the plain
  PyTorch versions of exactly what the kernels compute, written against the
  same packed scalar vector; ``trace_frames_reference``,
  ``trace_phase1s_reference`` and ``trace_phase2s_reference`` run them frame
  by frame over a batch.
* ``render_kernel_raw`` renders a frame, a band, or a rank's stripes of
  one camera (a sequence of first rows, ``parallel/mesh.py:stripes``) as
  one batch through ``trace_frames`` (the scene packed once by
  ``kernels/pack.py:pack_frames``, whose one launch writes the coarse
  pass's rows and the full pass's, a row per stripe; coarse depth-prime
  pass, prime map, full pass; or compaction's two phases; one block runs
  the one-frame kernels) and returns its (t, hit) too, and the per-lane
  step counts with
  ``debug_steps``; it builds no autograd graph. ``tile_steps`` and
  ``warp_steps`` reduce those counts to what a (tile_h, 128) TPU tile and a
  warp of the CUDA kernel execute; ``warp_tile_pixels`` is the kernel's
  map from a warp's tile to its pixels.
* ``render_frames_raw`` renders a batch of frames of one scene, one per
  camera, through ``trace_frames``: the packing of every frame, then both
  passes of the batch (or compaction's two phases), one launch each.
* ``render_kernel`` is the differentiable render of the kernel path, its
  blocks as ``render_kernel_raw``'s: its backward is ``trace_frames_bwd``
  (``cfg.kernel_bwd``), whose packed-vector cotangents ``kernels/pack.py``'s
  VJP kernel pulls back onto the scene's leaves in one launch, or autograd
  through the plain re-shade at the saved (t, hit).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import operator

import torch

from gpgpuraytrace_tpu_torch.kernels import pack as kpack
from gpgpuraytrace_tpu_torch.kernels.pack import MAX_FRAMES
from gpgpuraytrace_tpu_torch.models.scene import (
    MARCH_CHUNK_DEFAULT, RenderConfig, Scene,
)
from gpgpuraytrace_tpu_torch.ops.camera import Cameras
from gpgpuraytrace_tpu_torch.ops.field import WARP_GAIN, WARP_LACUNARITY, warp_tail
from gpgpuraytrace_tpu_torch.ops.march import (
    _BWD_DENOM_MIN, _DENOM_EPS, _PRIME_PREV_PULLBACK, _RESIDUAL_SLACK,
    check_prime_band, coarse_prime_cfg, prime_from_coarse,
)
from gpgpuraytrace_tpu_torch.ops.noise import fbm2, fbm2_value, fbm3, fbm3_value
from gpgpuraytrace_tpu_torch.ops.shade import _smoothstep
from gpgpuraytrace_tpu_torch.utils import packing as pk
from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES

MAX_OCTAVES = 16  # keep in sync with csrc/field.cuh
MAX_WARP_OCTAVES = 8  # the kernels loop over warp octaves; octave 8 weighs 0.5^7
# The forward kernels' march modes (csrc/trace_march.cuh:MarchMode).
MARCH_MODES = {"chunked": 0, "fixed": 1, "lod": 2, "compact": 3}
TILE_W = 128  # the TPU kernel's tile width (lanes)
WARP = 32  # threads of a warp
# The pixels a warp of the forward kernel traces: a (rows, cols) tile
# (csrc/trace_fwd.cu:kTileRows, kTileCols; ``warp_tile_pixels`` maps them).
WARP_TILE = (4, 8)


class TraceConfig(ctypes.Structure):
    """The forward kernels' config, passed by value
    (csrc/trace_march.cuh:TraceConfig); ``budget`` and ``phase`` are
    compaction's (the phase's march steps; 1 or 2, else 0)."""

    _fields_ = [
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("local_h", ctypes.c_int),
        ("max_steps", ctypes.c_int),
        ("num_octaves", ctypes.c_int),
        ("newton_iters", ctypes.c_int),
        ("t_min", ctypes.c_float),
        ("t_max", ctypes.c_float),
        ("hit_eps", ctypes.c_float),
        ("march_eps_scale", ctypes.c_float),
        ("step_relax", ctypes.c_float),
        ("step_floor_t", ctypes.c_float),
        ("primed", ctypes.c_int),
        ("volumetric", ctypes.c_int),
        ("warp_octaves", ctypes.c_int),
        ("march_mode", ctypes.c_int),
        ("bf16", ctypes.c_int),
        ("budget", ctypes.c_int),
        ("phase", ctypes.c_int),
    ]


class TraceBwdConfig(ctypes.Structure):
    """The backward kernel's config (csrc/trace_bwd.cu:TraceBwdConfig)."""

    _fields_ = [
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("local_h", ctypes.c_int),
        ("num_octaves", ctypes.c_int),
        ("volumetric", ctypes.c_int),
        ("warp_octaves", ctypes.c_int),
        ("bf16", ctypes.c_int),  # 1: the march channel pulls back through the bf16 field
        # g[c][pixel] at c * g_channel_stride + pixel * g_pixel_stride
        ("g_channel_stride", ctypes.c_int),
        ("g_pixel_stride", ctypes.c_int),
    ]


def _check_supported(cfg: RenderConfig) -> None:
    if cfg.march_mode not in MARCH_MODES:
        raise ValueError(
            f"march_mode={cfg.march_mode!r} must be one of {sorted(MARCH_MODES)}"
        )
    if not 1 <= cfg.num_octaves <= MAX_OCTAVES:
        raise ValueError(
            f"num_octaves={cfg.num_octaves} must be in [1, {MAX_OCTAVES}]"
        )
    if cfg.volumetric and not 1 <= cfg.warp_octaves <= MAX_WARP_OCTAVES:
        raise ValueError(
            f"warp_octaves={cfg.warp_octaves} must be in [1, {MAX_WARP_OCTAVES}]"
        )


def _frames(packed: torch.Tensor) -> tuple[int]:
    """A batch's leading shape (B,): ``packed``'s rows, 1 to ``MAX_FRAMES``."""
    if packed.dim() != 2:
        raise ValueError(f"packed must be (frames, n_params), got {tuple(packed.shape)}")
    if not 1 <= packed.shape[0] <= MAX_FRAMES:
        raise ValueError(f"a batch of {packed.shape[0]} frames: one launch takes 1 to "
                         f"{MAX_FRAMES} (MAX_FRAMES, the CUDA grid's y)")
    return (packed.shape[0],)


def _check_tensors(packed, seed, cfg, local_height, named, permuted=(), lead=()) -> None:
    """Raise on anything the kernels do not take. ``named`` maps a name to
    (tensor, required shape) for the per-pixel inputs; those named in
    ``permuted`` may also be the ``permute(2, 0, 1)`` view of a contiguous
    (h, W, 3) tensor (of a batch: the ``permute(0, 3, 1, 2)`` view of a
    contiguous (B, h, W, 3)). ``lead`` is () for one frame, (B,) for a batch
    of B, whose ``packed`` has a row per frame."""
    _check_supported(cfg)
    n_params = pk.AMPS + cfg.num_octaves
    rows = lead[0] if lead else 1
    if packed.dtype != torch.float32 or packed.shape != (rows, n_params):
        raise ValueError(
            f"packed must be float32 ({rows}, {n_params}), got {packed.dtype} "
            f"{tuple(packed.shape)}"
        )
    if seed.dtype != torch.int32 or seed.shape != (1, 1):
        raise ValueError(
            f"seed must be int32 (1, 1), got {seed.dtype} {tuple(seed.shape)}"
        )
    if local_height < 1 or cfg.width < 1:
        raise ValueError(f"empty frame: {local_height} x {cfg.width}")
    for name, (x, shape) in named.items():
        if x.dtype != torch.float32 or x.shape != shape:
            raise ValueError(
                f"{name} must be float32 {shape}, got {x.dtype} {tuple(x.shape)}"
            )
    for name, x in {"packed": packed, "seed": seed,
                    **{name: x for name, (x, _) in named.items()}}.items():
        if x.device != packed.device:
            raise ValueError(f"inputs on {x.device} and {packed.device}")
        if not x.is_contiguous():
            if name not in permuted:
                raise ValueError("trace kernel inputs must be contiguous")
            if not x.permute(*range(len(lead)), -2, -1, -3).is_contiguous():
                raise ValueError(f"trace kernel inputs must be contiguous ({name}: or the "
                                 f"permute(2, 0, 1) view of a contiguous (h, W, 3) tensor)")


def _check_inputs(packed, seed, cfg, local_height, t0_prime, debug_steps, lead=()) -> None:
    """Raise on anything the forward kernel does not take (``lead`` as for
    ``_check_tensors``)."""
    if debug_steps and cfg.march_mode == "compact":
        raise ValueError(
            "debug_steps is not supported for march_mode='compact' (two "
            "kernels; the TPU kernel counts one tile march)"
        )
    if bool(cfg.prime_ds) != (t0_prime is not None):
        raise ValueError(
            f"t0_prime must be given exactly when cfg primes "
            f"(prime_ds={cfg.prime_ds})"
        )
    shape = (*lead, local_height, cfg.width)
    named = {} if t0_prime is None else {"t0_prime": (t0_prime, shape)}
    _check_tensors(packed, seed, cfg, local_height, named, lead=lead)
    for x in [packed] + ([] if t0_prime is None else [t0_prime]):
        if x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                "trace_frame is forward only: for gradients render through "
                "kernels.trace.render_kernel, whose backward is trace_frame_bwd"
            )


def trace_frame(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                local_height: int, t0_prime: torch.Tensor | None = None,
                debug_steps: bool = False):
    """Trace ``local_height`` rows of the frame ``cfg`` describes.

    ``packed`` (1, AMPS + octaves) float32 and ``seed`` (1, 1) int32 come from
    ``kernels/pack.py:pack_scene`` (its ``row0`` places the band);
    ``t0_prime`` is the (local_height, width) march-start map when
    ``cfg.prime_ds`` is set. Returns (color (3, h, w), t (h, w),
    hit (h, w) float 0/1), and with ``debug_steps`` a fourth result: the
    int32 (h, w) count of march iterations each lane executed while active,
    the one that detects a hit or an escape included (fixed mode: every lane
    ``max_steps``; lod: the fine phase only). ``march_mode="compact"`` runs
    ``trace_phase1`` and ``trace_phase2``. CUDA inputs
    launch the CUDA kernels; CPU inputs run ``trace_frame_reference``.
    """
    _check_inputs(packed, seed, cfg, local_height, t0_prime, debug_steps)
    if packed.device.type == "cpu":
        return trace_frame_reference(packed, seed, cfg, local_height, t0_prime,
                                     debug_steps)
    if packed.device.type != "cuda":
        raise RuntimeError(f"trace_frame: unsupported device {packed.device}")
    if cfg.march_mode == "compact":
        return _compact(trace_phase1, trace_phase2, packed, seed, cfg, local_height)
    return _launch(packed, seed, cfg, local_height, t0_prime, debug_steps, ())


# Launches of the CUDA kernels by instantiation (``variant_name``, and
# ``phase_name`` for compaction's two; the batched wrappers' too); the total
# is ``trace_frame.launches.total()``.
trace_frame.launches = collections.Counter()


def trace_frames(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                 local_height: int, t0_prime: torch.Tensor | None = None,
                 debug_steps: bool = False):
    """``trace_frame`` over a batch of B frames of one scene, one launch for
    them all: ``packed`` (B, AMPS + octaves) from ``kernels/pack.py:pack_scenes``
    (a row per frame; ``seed`` (1, 1) theirs), ``t0_prime`` (B,
    local_height, width); results with a leading B, (color (B, 3, h, w), t,
    hit (B, h, w)[, steps]), frame b bit for bit ``trace_frame`` of row b.
    ``march_mode="compact"`` runs ``trace_phase1s`` and ``trace_phase2s``
    once each. B is 1 to ``MAX_FRAMES``; a larger batch raises ValueError.
    CUDA inputs launch the kernel's frame axis (blockIdx.y); CPU inputs run
    ``trace_frames_reference``."""
    lead = _frames(packed)
    _check_inputs(packed, seed, cfg, local_height, t0_prime, debug_steps, lead)
    if packed.device.type == "cpu":
        return trace_frames_reference(packed, seed, cfg, local_height, t0_prime, debug_steps)
    if packed.device.type != "cuda":
        raise RuntimeError(f"trace_frames: unsupported device {packed.device}")
    if cfg.march_mode == "compact":
        return _compact(trace_phase1s, trace_phase2s, packed, seed, cfg, local_height)
    return _launch(packed, seed, cfg, local_height, t0_prime, debug_steps, lead)


def variant_name(cfg: RenderConfig, debug_steps: bool = False, frames: int = 1) -> str:
    """The forward kernel's instantiation a launch with ``cfg`` runs:
    the march mode, then "+bf16" and "+debug_steps" where set, and
    "+frames" for a batch of more than one frame."""
    return (cfg.march_mode + ("+bf16" if cfg.march_bf16 else "")
            + ("+debug_steps" if debug_steps else "") + ("+frames" if frames > 1 else ""))


def phase_name(cfg: RenderConfig, phase: int, frames: int = 1) -> str:
    """The launch count's key of compaction's phase 1 or 2:
    "compact:phase1", "compact+bf16:phase2", "compact+frames:phase1", ..."""
    return f"{variant_name(cfg, frames=frames)}:phase{phase}"


def _compact(phase1, phase2, packed, seed, cfg, local_height):
    """Compaction's frame: phase 1, then phase 2 in place on its outputs."""
    color, t, hit, _, prev, ids, n_alive = phase1(packed, seed, cfg, local_height)
    phase2(packed, seed, cfg, local_height, n_alive, ids, prev, color, t, hit)
    return color, t, hit


def _kernel_config(cfg: RenderConfig, local_height: int, primed: bool = False,
                   budget: int = 0, phase: int = 0) -> TraceConfig:
    return TraceConfig(
        height=cfg.height, width=cfg.width, local_h=local_height,
        max_steps=cfg.max_steps, num_octaves=cfg.num_octaves,
        newton_iters=cfg.newton_iters, t_min=cfg.t_min, t_max=cfg.t_max,
        hit_eps=cfg.hit_eps, march_eps_scale=cfg.march_eps_scale,
        step_relax=cfg.step_relax, step_floor_t=cfg.step_floor_t, primed=int(primed),
        volumetric=int(cfg.volumetric), warp_octaves=cfg.warp_octaves,
        march_mode=MARCH_MODES[cfg.march_mode], bf16=int(cfg.march_bf16),
        budget=budget, phase=phase,
    )


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library with its functions' signatures, once per process."""
    from gpgpuraytrace_tpu_torch.kernels.build import load_library

    lib = load_library()
    lib.trace_fwd_launch.argtypes = [ctypes.c_void_p] * 12 + [
        TraceConfig, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.trace_fwd_launch.restype = ctypes.c_int
    lib.trace_compact_launch.argtypes = [ctypes.c_void_p] * 9 + [
        TraceConfig, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.trace_compact_launch.restype = ctypes.c_int
    lib.trace_bwd_scratch_floats.argtypes = [TraceBwdConfig, ctypes.c_int]
    lib.trace_bwd_scratch_floats.restype = ctypes.c_int
    lib.trace_bwd_launch.argtypes = [ctypes.c_void_p] * 7 + [
        TraceBwdConfig, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.trace_bwd_launch.restype = ctypes.c_int
    lib.trace_error_string.argtypes = [ctypes.c_int]
    lib.trace_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.trace_error_string(err).decode()})"
        )


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


# The kernels' scratch buffers by (device index, stream): the forward
# kernel's tile counters (phase 2's slot counters too) and the backward's
# partial sums.
_TILE_SCRATCH: dict[tuple[int, int, int], torch.Tensor] = {}
_BWD_SCRATCH: dict[tuple[int, int, int], torch.Tensor] = {}


def _stream_scratch(table: dict, dev, stream: int, numel: int, dtype: torch.dtype,
                    counters: int) -> torch.Tensor:
    """A kernel's scratch for a launch on ``stream`` (``dev``'s current
    stream, as a handle): at least ``numel`` elements, the first
    ``counters`` of them zeros when made and left at 0 by every launch (the
    rest the kernel writes before it reads). Made once per device, stream and
    count of counters (launches on one stream never overlap, so kernels that
    leave their counters at 0 may share one; a batch's counters may lie where
    a smaller batch's sums do), made anew larger when a launch needs more,
    and kept in ``table``; inside a CUDA graph's capture a new one for each
    launch, its counters zeroed by the graph."""
    capturing = torch.cuda.is_current_stream_capturing()
    key = (dev.index, stream, counters)
    scratch = None if capturing else table.get(key)
    if scratch is None or scratch.numel() < numel:
        scratch = torch.empty(numel, dtype=dtype, device=dev)
        scratch[:counters].zero_()
        if not capturing:
            table[key] = scratch
    return scratch


def _tile_scratch(dev, stream: int, frames: int = 1) -> torch.Tensor:
    """The forward kernel's scratch, which compaction's phase 2 shares: two
    int32 per frame, the counter from which the forward's warps take their
    tiles (phase 2's ray groups their slots) and the count of warps (blocks)
    done."""
    return _stream_scratch(_TILE_SCRATCH, dev, stream, 2 * frames, torch.int32, 2 * frames)


def _launch(packed, seed, cfg, local_height, t0_prime, debug_steps, lead):
    """The forward kernel over ``lead`` frames: () one, (B,) a batch."""
    lib = _library()
    dev = packed.device
    frames = lead[0] if lead else 1
    hw = (*lead, local_height, cfg.width)
    color = torch.empty((*lead, 3, local_height, cfg.width), dtype=torch.float32, device=dev)
    t = torch.empty(hw, dtype=torch.float32, device=dev)
    hit = torch.empty(hw, dtype=torch.float32, device=dev)
    steps = torch.empty(hw, dtype=torch.int32, device=dev) if debug_steps else None
    kcfg = _kernel_config(cfg, local_height, primed=t0_prime is not None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.trace_fwd_launch(
            packed.data_ptr(), seed.data_ptr(), _ptr(t0_prime), color.data_ptr(),
            t.data_ptr(), hit.data_ptr(), _ptr(steps), None, None, None, None,
            _tile_scratch(dev, stream, frames).data_ptr(), kcfg, frames, stream,
        )
    _raise_on(lib, err, "trace_fwd")
    trace_frame.launches[variant_name(cfg, debug_steps, frames)] += 1
    return (color, t, hit) if steps is None else (color, t, hit, steps)


def _check_compact(packed, seed, cfg, local_height, named, lead=()) -> None:
    if cfg.march_mode != "compact":
        raise ValueError(f"march_mode={cfg.march_mode!r}: the compaction phases "
                         f"run only under march_mode='compact'")
    _check_tensors(packed, seed, cfg, local_height, named, lead=lead)


def trace_phase1(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                 local_height: int):
    """Compaction's phase 1 (``cfg.march_mode == "compact"``): the unprimed
    chunked march of every ray for ``cfg.compact_budget`` steps, then polish
    and shade. Returns (color (3, h, w), t, hit, alive, prev, ids, n_alive):
    (h, w) float32 planes, ``alive`` 1 where the ray is still marching
    (polished and shaded as a miss here; ``trace_phase2`` resumes it),
    ``prev`` its last advancing sample (the polish's bracket); ``ids``
    (h·w,) int32 lists the pixel ids of the rays still marching in its first
    ``n_alive`` slots ((1,) int32, on the device), the rest unset. CUDA
    inputs launch the kernel (``csrc/trace_fwd.cu``, mode compact), which
    lists the survivors in the order its warps reach the list; CPU inputs run
    ``trace_phase1_reference``, which lists them in pixel order."""
    _check_compact(packed, seed, cfg, local_height, {})
    if packed.device.type == "cpu":
        return trace_phase1_reference(packed, seed, cfg, local_height)
    if packed.device.type != "cuda":
        raise RuntimeError(f"trace_phase1: unsupported device {packed.device}")
    return _launch_phase1(packed, seed, cfg, local_height, ())


def trace_phase1s(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                  local_height: int):
    """``trace_phase1`` over a batch of B frames, one launch: ``packed`` (B,
    AMPS + octaves); results with a leading B, ``ids`` (B, h·w) frame b's
    survivors in its first ``n_alive[b]`` slots, ``n_alive`` (B,) int32 on
    the device. CPU inputs run ``trace_phase1s_reference``."""
    lead = _frames(packed)
    _check_compact(packed, seed, cfg, local_height, {}, lead)
    if packed.device.type == "cpu":
        return trace_phase1s_reference(packed, seed, cfg, local_height)
    if packed.device.type != "cuda":
        raise RuntimeError(f"trace_phase1s: unsupported device {packed.device}")
    return _launch_phase1(packed, seed, cfg, local_height, lead)


def _launch_phase1(packed, seed, cfg, local_height, lead):
    lib = _library()
    dev = packed.device
    frames = lead[0] if lead else 1
    hw = (*lead, local_height, cfg.width)
    color = torch.empty((*lead, 3, local_height, cfg.width), dtype=torch.float32, device=dev)
    t, hit, alive, prev = (torch.empty(hw, dtype=torch.float32, device=dev)
                           for _ in range(4))
    ids = torch.empty((*lead, local_height * cfg.width), dtype=torch.int32, device=dev)
    n_alive = torch.empty(frames, dtype=torch.int32, device=dev)  # zeroed by the launch
    kcfg = _kernel_config(cfg, local_height, budget=cfg.compact_budget, phase=1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.trace_fwd_launch(
            packed.data_ptr(), seed.data_ptr(), None, color.data_ptr(), t.data_ptr(),
            hit.data_ptr(), None, alive.data_ptr(), prev.data_ptr(), ids.data_ptr(),
            n_alive.data_ptr(), _tile_scratch(dev, stream, frames).data_ptr(), kcfg, frames,
            stream,
        )
    _raise_on(lib, err, "trace_fwd (compact phase 1)")
    trace_frame.launches[phase_name(cfg, 1, frames)] += 1
    return color, t, hit, alive, prev, ids, n_alive


def _check_phase2(packed, seed, cfg, local_height, n_alive, ids, prev, color, t,
                  hit, lead=()) -> None:
    hw = (*lead, local_height, cfg.width)
    color_shape = (*lead, 3, local_height, cfg.width)
    _check_compact(packed, seed, cfg, local_height, {
        "prev": (prev, hw), "color": (color, color_shape), "t": (t, hw), "hit": (hit, hw)},
        lead)
    for name, x, shape in (("n_alive", n_alive, (lead[0] if lead else 1,)),
                           ("ids", ids, (*lead, local_height * cfg.width))):
        if x.dtype != torch.int32 or x.shape != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != packed.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {packed.device}")


def trace_phase2(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                 local_height: int, n_alive: torch.Tensor, ids: torch.Tensor,
                 prev: torch.Tensor, color: torch.Tensor, t: torch.Tensor,
                 hit: torch.Tensor) -> None:
    """Compaction's phase 2: resume, for ``cfg.max_steps -
    cfg.compact_budget`` more steps, the march of the pixel in each of the
    first ``n_alive`` slots of ``ids`` (``trace_phase1``'s list of the rays
    still marching) from phase 1's ``t`` and ``prev``, polish and shade it,
    and write its colour, t and hit in place into phase 1's ``color``, ``t``
    and ``hit``. The slots' order changes no output. CUDA inputs launch the
    kernel (``csrc/trace_compact.cu``): a group of 2 lanes marches each
    listed ray, lane k evaluating its field's items k, k + 2, ... (the
    heightfield's octaves, then the volumetric warp's), both lanes summing
    them in item order; persistent groups take their first slot in turn
    round the blocks, then the next from a counter in ``_tile_scratch``'s
    per-stream buffer, left at 0, until the slots reach ``n_alive``, read on
    the device (no host sync); each warp polishes and shades its groups'
    finished rays together. CPU inputs run ``trace_phase2_reference``."""
    args = (n_alive, ids, prev, color, t, hit)
    _check_phase2(packed, seed, cfg, local_height, *args)
    if packed.device.type == "cpu":
        trace_phase2_reference(packed, seed, cfg, local_height, *args)
        return
    if packed.device.type != "cuda":
        raise RuntimeError(f"trace_phase2: unsupported device {packed.device}")
    _launch_phase2(packed, seed, cfg, local_height, args, 1)


def trace_phase2s(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                  local_height: int, n_alive: torch.Tensor, ids: torch.Tensor,
                  prev: torch.Tensor, color: torch.Tensor, t: torch.Tensor,
                  hit: torch.Tensor) -> None:
    """``trace_phase2`` over a batch of B frames, one launch, on
    ``trace_phase1s``' outputs (a leading B on each; ``n_alive`` (B,)): each
    frame's listed rays resume from its own list, in place. CPU inputs run
    ``trace_phase2s_reference``."""
    lead = _frames(packed)
    args = (n_alive, ids, prev, color, t, hit)
    _check_phase2(packed, seed, cfg, local_height, *args, lead)
    if packed.device.type == "cpu":
        trace_phase2s_reference(packed, seed, cfg, local_height, *args)
        return
    if packed.device.type != "cuda":
        raise RuntimeError(f"trace_phase2s: unsupported device {packed.device}")
    _launch_phase2(packed, seed, cfg, local_height, args, lead[0])


def _launch_phase2(packed, seed, cfg, local_height, args, frames):
    lib = _library()
    dev = packed.device
    kcfg = _kernel_config(cfg, local_height, budget=cfg.max_steps - cfg.compact_budget,
                          phase=2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.trace_compact_launch(
            packed.data_ptr(), seed.data_ptr(), *(x.data_ptr() for x in args),
            _tile_scratch(dev, stream, frames).data_ptr(), kcfg, frames, stream,
        )
    _raise_on(lib, err, "trace_compact (compact phase 2)")
    trace_frame.launches[phase_name(cfg, 2, frames)] += 1


def _check_bwd_inputs(packed, seed, cfg, local_height, t, hit, g, lead=()) -> None:
    hw = (local_height, cfg.width)
    _check_tensors(packed, seed, cfg, local_height,
                   {"t": (t, (*lead, *hw)), "hit": (hit, (*lead, *hw)),
                    "g": (g, (*lead, 3, *hw))}, permuted=("g",), lead=lead)


def trace_frame_bwd(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                    local_height: int, t: torch.Tensor, hit: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """Backward of ``trace_frame``'s colour at its saved (t, hit).

    ``packed``, ``seed``, ``cfg`` and ``local_height`` as for
    ``trace_frame``; ``t`` and ``hit`` (local_height, width) float32 are its
    outputs, ``g`` (3, local_height, width) float32 the cotangent of its
    colour planes: contiguous, or the ``permute(2, 0, 1)`` view of a
    contiguous (local_height, width, 3) tensor (the kernel reads either
    layout, so the caller need not copy). Returns the packed-vector cotangent (1, AMPS + octaves):
    the shade channel at the saved t plus the implicit-function march
    channel, summed over the pixels. CUDA inputs launch the CUDA kernel;
    CPU inputs run ``trace_bwd_reference``."""
    _check_bwd_inputs(packed, seed, cfg, local_height, t, hit, g)
    if packed.device.type == "cpu":
        return trace_bwd_reference(packed, seed, cfg, local_height, t, hit, g)
    if packed.device.type != "cuda":
        raise RuntimeError(f"trace_frame_bwd: unsupported device {packed.device}")
    return _launch_bwd(packed.detach(), seed, cfg, local_height, t, hit, g, 1)


# Launches of the CUDA backward kernel by instantiation: "bwd", and
# "bwd+bf16" (the march channel through the bf16 field) under march_bf16;
# "+frames" for a batch of more than one frame (``trace_frames_bwd``).
trace_frame_bwd.launches = collections.Counter()


def trace_frames_bwd(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                     local_height: int, t: torch.Tensor, hit: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """``trace_frame_bwd`` over a batch of B frames of one scene, one launch
    of each of its two stages for them all: ``packed`` (B, AMPS + octaves)
    and ``seed`` as for ``trace_frames``, ``t`` and ``hit`` (B, h, W) its
    outputs, ``g`` (B, 3, h, W) contiguous or the ``permute(0, 3, 1, 2)``
    view of a contiguous (B, h, W, 3). Returns the packed-vector cotangent of
    each frame, (B, AMPS + octaves), row b bit for bit ``trace_frame_bwd`` of
    frame b (the kernels' frame axis, blockIdx.y; a batch of one runs the
    one-frame kernels). CUDA inputs launch the CUDA kernels; CPU inputs run
    ``trace_frames_bwd_reference``."""
    lead = _frames(packed)
    _check_bwd_inputs(packed, seed, cfg, local_height, t, hit, g, lead)
    if packed.device.type == "cpu":
        return trace_frames_bwd_reference(packed, seed, cfg, local_height, t, hit, g)
    if packed.device.type != "cuda":
        raise RuntimeError(f"trace_frames_bwd: unsupported device {packed.device}")
    return _launch_bwd(packed.detach(), seed, cfg, local_height, t, hit, g, lead[0])


def _launch_bwd(packed, seed, cfg, local_height, t, hit, g, frames):
    lib = _library()
    dev = packed.device
    n_pix = local_height * cfg.width
    # (channel, pixel) strides within a frame: contiguous (3, h, W), else the
    # view of (h, W, 3); frames lie 3·n_pix apart either way.
    g_strides = (n_pix, 1) if g.is_contiguous() else (1, 3)
    kcfg = TraceBwdConfig(height=cfg.height, width=cfg.width, local_h=local_height,
                          num_octaves=cfg.num_octaves, volumetric=int(cfg.volumetric),
                          warp_octaves=cfg.warp_octaves, bf16=int(cfg.march_bf16),
                          g_channel_stride=g_strides[0], g_pixel_stride=g_strides[1])
    pbar = torch.empty((frames, pk.AMPS + cfg.num_octaves), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # Its first floats hold the second stage's counters (an int32 per frame).
        scratch = _stream_scratch(_BWD_SCRATCH, dev, stream,
                                  lib.trace_bwd_scratch_floats(kcfg, frames), torch.float32,
                                  frames)
        err = lib.trace_bwd_launch(
            packed.data_ptr(), seed.data_ptr(), t.data_ptr(), hit.data_ptr(),
            g.data_ptr(), scratch.data_ptr(), pbar.data_ptr(), kcfg, frames, stream,
        )
    _raise_on(lib, err, "trace_bwd")
    trace_frame_bwd.launches[("bwd+bf16" if cfg.march_bf16 else "bwd")
                             + ("+frames" if frames > 1 else "")] += 1
    return pbar


# --- the plain PyTorch version ------------------------------------------------
# Each helper takes ``sc(k)``, a 0-d float32 scalar of the packed vector, and
# mirrors the TPU kernel's helper of the same name in
# gpgpuraytrace_tpu/kernels/trace.py.


def _raygen_rc(sc, cfg: RenderConfig, rows, cols):
    rows = rows + sc(pk.ROW0)
    ndc_x = (cols + 0.5) * (2.0 / cfg.width) - 1.0
    ndc_y = 1.0 - (rows + 0.5) * (2.0 / cfg.height)
    sx = sc(pk.TANFOV) * sc(pk.ASPECT) * ndc_x
    sy = sc(pk.TANFOV) * ndc_y
    d = [sc(pk.FWD + k) + sx * sc(pk.RIGHT + k) + sy * sc(pk.UP + k) for k in range(3)]
    inv = torch.rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    o = tuple(sc(pk.POS + k) for k in range(3))
    return o, tuple(dk * inv for dk in d)


def _envelope(sc, cfg: RenderConfig):
    """Certified terrain upper bound (plus the volumetric warp's tail) plus
    hit_eps."""
    amps_abs = torch.zeros((), dtype=torch.float32, device=sc(0).device)
    for k in range(cfg.num_octaves):
        amps_abs = amps_abs + torch.abs(sc(pk.AMPS + k))
    env = sc(pk.HEIGHT_OFFSET) + torch.abs(sc(pk.HEIGHT_SCALE)) * amps_abs
    if cfg.volumetric:
        env = env + torch.abs(sc(pk.WARP_AMP)) * warp_tail(cfg.warp_octaves)
    return env + cfg.hit_eps


def _envelope_entry(sc, cfg: RenderConfig, dy):
    """March start: rays above the envelope fast-forward to it, or miss at
    once heading up. Returns (t0, active0, env)."""
    env = _envelope(sc, cfg)
    oy = sc(pk.POS + 1)
    t_enter = (env - oy) / torch.where(dy < 0.0, dy, torch.ones_like(dy))
    above = oy > env
    t_min = torch.full_like(dy, cfg.t_min)
    t_max = torch.full_like(dy, cfg.t_max)
    t0 = torch.where(above & (dy < 0.0), torch.clamp(t_enter, cfg.t_min, cfg.t_max), t_min)
    t0 = torch.where(above & (dy >= 0.0), t_max, t0)
    return t0, t0 < cfg.t_max, env


def _field_fns(sc, packed, seed, cfg: RenderConfig, o, d, bf16: bool = False):
    """(field_grad_at, field_at) along the rays at distance t; ``bf16``
    gives the value-only march field bf16 blend math (``cfg.march_bf16``:
    the forward's march only; the polish, the shade and the backward
    evaluate the float32 field)."""
    ox, oy, oz = o
    dx, dy, dz = d
    hs = sc(pk.HORIZONTAL_SCALE)
    lac = sc(pk.LACUNARITY)
    h_off = sc(pk.HEIGHT_OFFSET)
    h_scale = sc(pk.HEIGHT_SCALE)
    amps = packed[0, pk.AMPS:pk.AMPS + cfg.num_octaves]
    w_amp, w_freq = sc(pk.WARP_AMP), sc(pk.WARP_FREQ)
    warp = (cfg.warp_octaves, WARP_LACUNARITY, WARP_GAIN, seed)

    def field_grad_at(t):
        """f, its gradient (gx, gy, gz) and the terrain height h."""
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        n, nx, nz = fbm2(px * hs, pz * hs, amps, lac, seed)
        h = h_off + h_scale * n
        scale = h_scale * hs
        f, gx, gy, gz = py - h, -scale * nx, torch.ones_like(h), -scale * nz
        if cfg.volumetric:
            n3, nx3, ny3, nz3 = fbm3(px * w_freq, py * w_freq, pz * w_freq, *warp)
            f = f - w_amp * n3
            gx = gx - w_amp * w_freq * nx3
            gy = gy - w_amp * w_freq * ny3
            gz = gz - w_amp * w_freq * nz3
        return f, gx, gy, gz, h

    def field_at(t):
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        n = fbm2_value(px * hs, pz * hs, amps, lac, seed, bf16)
        f = py - (h_off + h_scale * n)
        if cfg.volumetric:
            f = f - w_amp * fbm3_value(px * w_freq, py * w_freq, pz * w_freq, *warp)
        return f

    return field_grad_at, field_at


def _shade_from_grads(sc, t, hit, d, grads):
    """Colour planes (c0, c1, c2): shaded terrain where ``hit``, else sky."""
    dx, dy, dz = d
    gx, gy, gz, h = grads
    ninv = torch.rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    nx_, ny_, nz_ = gx * ninv, gy * ninv, gz * ninv
    lx, ly, lz = (sc(pk.SUN_DIR + k) for k in range(3))
    up_amount = torch.clamp(dy, 0.0, 1.0)
    cos_sun = torch.clamp(dx * lx + dy * ly + dz * lz, 0.0, 1.0)
    c2 = cos_sun * cos_sun
    c4 = c2 * c2
    c8 = c4 * c4
    c16 = c8 * c8
    c64 = c16 * c16 * c16 * c16
    c512 = c64 * c64 * c64 * c64 * c64 * c64 * c64 * c64
    sun_term = 0.25 * c64 + 1.5 * c512
    steep = _smoothstep(0.85, 0.55, ny_)
    snow = _smoothstep(sc(pk.SNOW_HEIGHT), sc(pk.SNOW_HEIGHT) + 1.0, h) * (1.0 - steep)
    diffuse = torch.clamp(nx_ * lx + ny_ * ly + nz_ * lz, 0.0, 1.0)
    sky_fill = 0.5 + 0.5 * ny_
    fog = 1.0 - torch.exp(-sc(pk.FOG_DENSITY) * t)
    out = []
    for ch in range(3):
        sky = (
            sc(pk.SKY_HORIZON + ch)
            + (sc(pk.SKY_ZENITH + ch) - sc(pk.SKY_HORIZON + ch)) * up_amount
            + sun_term * sc(pk.SUN_COLOR + ch)
        )
        albedo = sc(pk.ALBEDO_LOW + ch) + (sc(pk.ALBEDO_HIGH + ch) - sc(pk.ALBEDO_LOW + ch)) * steep
        albedo = albedo + (sc(pk.SNOW_COLOR + ch) - albedo) * snow
        light = sc(pk.SUN_COLOR + ch) * diffuse + sc(pk.AMBIENT + ch) * sky_fill
        surf = albedo * light
        fog_tint = 0.5 * (sc(pk.FOG_COLOR + ch) + sky)
        surf = surf + (fog_tint - surf) * fog
        out.append(torch.where(hit, surf, sky))
    return out


def _pixel_grid(h: int, w: int, dev):
    """Band-local (rows, cols) float32 pixel indices, each (h, w)."""
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    return rows, cols


def _coarse_field(sc, packed, seed, cfg: RenderConfig, o, d):
    """(field_coarse_at, margin) of the lod march's phase 1 (JAX
    ``_coarse_field_fn``): the value-only float32 field over the first
    k = max(1, (octaves + 1) // 2) octaves and, when volumetric,
    wo = max(1, warp_octaves - 1) warp octaves; ``margin`` bounds what the
    skipped octaves can add (every noise value lies in [-1, 1]), so
    f_coarse - margin <= f_full everywhere. Float32, summed in JAX's order."""
    k = max(1, (cfg.num_octaves + 1) // 2)
    wo = max(1, cfg.warp_octaves - 1)
    skipped = torch.zeros((), dtype=torch.float32, device=packed.device)
    for i in range(k, cfg.num_octaves):
        skipped = skipped + torch.abs(sc(pk.AMPS + i))
    margin = torch.abs(sc(pk.HEIGHT_SCALE)) * skipped
    if cfg.volumetric:
        tail = float(sum(WARP_GAIN**i for i in range(wo, cfg.warp_octaves)))
        margin = margin + torch.abs(sc(pk.WARP_AMP)) * tail
    coarse = dataclasses.replace(cfg, num_octaves=k, warp_octaves=wo)
    return _field_fns(sc, packed, seed, coarse, o, d)[1], margin


def _lod_park(field_coarse_at, margin, cfg: RenderConfig, t, active, oy, dy, env):
    """Phase 1 of the lod march (``_trace_kernel``'s lod branch): step by
    relax·(f_coarse - margin) while that exceeds max(margin/2, hit_eps·t),
    so no step can pass a surface of the full field; rays that climb out of
    the envelope heading up jump to t_max. Returns the parked t."""
    park_eps = 0.5 * margin
    t_max = torch.full_like(t, cfg.t_max)
    chunk = cfg.march_chunk or MARCH_CHUNK_DEFAULT
    for s in range(cfg.max_steps):
        if s % chunk == 0 and not bool(active.any()):
            break
        fl = field_coarse_at(t) - margin
        go = active & (fl > torch.maximum(park_eps, cfg.hit_eps * t))
        escape = go & (oy + t * dy > env) & (dy >= 0.0)
        go = go & ~escape
        t_new = torch.minimum(torch.where(go, t + cfg.step_relax * fl, t), t_max)
        t = torch.where(escape, t_max, t_new)
        active = go & (t < cfg.t_max)
    return t


def _march(field_at, cfg: RenderConfig, t, prev_t, active, oy, dy, env,
           n_steps: int | None = None):
    """The fine march (``_tile_trace``'s march_step) for ``n_steps`` steps
    (``cfg.max_steps`` by default): (t, prev_t, hit, active, steps),
    ``active`` the lanes still marching after the last step, ``steps`` the
    int32 count of iterations each lane ran while active. The chunked, lod
    and compact modes stop when no lane is active at a chunk boundary, where
    the CUDA kernel stops per thread; fixed runs all the steps and counts
    them for every lane. A finished lane never changes state, so all give the
    same t and hit."""
    n_steps = cfg.max_steps if n_steps is None else n_steps
    t_max = torch.full_like(t, cfg.t_max)
    hit = torch.zeros_like(active)
    steps = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    eps_m = cfg.hit_eps * cfg.march_eps_scale
    fixed = cfg.march_mode == "fixed"
    chunk = cfg.march_chunk or MARCH_CHUNK_DEFAULT
    for s in range(n_steps):
        if not fixed and s % chunk == 0 and not bool(active.any()):
            break
        steps += active
        f = field_at(t)
        is_hit = active & (f < eps_m * t)
        advance = active & ~is_hit
        escape = advance & (oy + t * dy > env) & (dy >= 0.0)
        advance = advance & ~escape
        step = torch.clamp(cfg.step_relax * f, min=cfg.hit_eps)
        if cfg.step_floor_t > 0.0:
            step = torch.maximum(step, cfg.step_floor_t * t)
        t_new = torch.minimum(torch.where(advance, t + step, t), t_max)
        t_new = torch.where(escape, t_max, t_new)
        prev_t = torch.where(advance, t, prev_t)
        hit = hit | is_hit
        active = advance & (t_new < cfg.t_max)
        t = t_new
    if fixed:
        steps.fill_(n_steps)
    return t, prev_t, hit, active, steps


def _polish_and_shade(sc, cfg: RenderConfig, field_grad_at, d, t, prev_t, hit):
    """The bracketed safeguarded-Newton polish of the hits from their march
    bracket [prev_t, t] (the first iteration also sets the bracket's upper
    bound from the local descent rate, +25% margin), the final field
    evaluation with the residual verdict, and the shade: (color (3, h, w),
    t, hit float 0/1)."""
    dx, dy, dz = d
    one = torch.ones_like(t)

    def refine(x, lo, hi, f, gx, gy, gz):
        denom = gx * dx + gy * dy + gz * dz
        safe = torch.abs(denom) > _DENOM_EPS
        newton = x - torch.where(safe, f / torch.where(safe, denom, one), 0.0)
        lo = torch.where(f > 0.0, x, lo)
        hi = torch.where(f <= 0.0, x, hi)
        x_new = torch.minimum(torch.maximum(newton, lo), torch.clamp(hi, max=cfg.t_max))
        return torch.where(hit & safe, torch.clamp(x_new, min=cfg.t_min), x), lo, hi

    f0, gx0, gy0, gz0, _ = field_grad_at(t)
    down0 = torch.clamp(-(gx0 * dx + gy0 * dy + gz0 * dz), min=_BWD_DENOM_MIN)
    hi = t + torch.clamp(f0, min=0.0) / down0 * 1.25 + cfg.hit_eps
    x, lo, hi = refine(t, prev_t, hi, f0, gx0, gy0, gz0)
    for _ in range(cfg.newton_iters - 1):
        f, gx, gy, gz, _ = field_grad_at(x)
        x, lo, hi = refine(x, lo, hi, f, gx, gy, gz)
    t = torch.where(hit, x, t)

    f_fin, gx, gy, gz, hgt = field_grad_at(t)
    if cfg.march_eps_scale != 1.0:
        hit = hit & (f_fin < _RESIDUAL_SLACK * cfg.hit_eps * t)
    colors = _shade_from_grads(sc, t, hit, d, (gx, gy, gz, hgt))
    return torch.stack(colors), t, hit.to(torch.float32)


def _frame_rays(packed, seed, cfg: RenderConfig, local_height: int):
    """The frame's rays and march setup: (sc, o, d, env, t0, active0,
    field_grad_at, field_at), unprimed (the sky-envelope entry)."""

    def sc(k):
        return packed[0, k]

    o, d = _raygen_rc(sc, cfg, *_pixel_grid(local_height, cfg.width, packed.device))
    t, active, env = _envelope_entry(sc, cfg, d[1])
    field_grad_at, field_at = _field_fns(sc, packed, seed[0, 0], cfg, o, d, cfg.march_bf16)
    return sc, o, d, env, t, active, field_grad_at, field_at


@torch.no_grad()
def trace_frame_reference(packed: torch.Tensor, seed: torch.Tensor,
                          cfg: RenderConfig, local_height: int,
                          t0_prime: torch.Tensor | None = None,
                          debug_steps: bool = False):
    """Plain PyTorch version of the trace kernel, on any device; same
    arguments and results as ``trace_frame``.

    Vectorized over pixels, with the TPU kernel's whole-frame chunked exit
    (every ``march_chunk`` steps) where the CUDA kernel exits per thread:
    finished lanes never change state, so both give the same result.
    ``march_mode="compact"`` runs the two phases' plain versions."""
    _check_inputs(packed, seed, cfg, local_height, t0_prime, debug_steps)
    if cfg.march_mode == "compact":
        return _compact(trace_phase1_reference, trace_phase2_reference, packed, seed,
                        cfg, local_height)
    sc, o, d, env, t, active, field_grad_at, field_at = _frame_rays(
        packed, seed, cfg, local_height)
    oy = o[1]
    prev_t = t
    if t0_prime is not None:
        t = torch.maximum(t, t0_prime)
        active = active & (t < cfg.t_max)
        prev_t = torch.clamp(t * _PRIME_PREV_PULLBACK, min=cfg.t_min)
    if cfg.march_mode == "lod":
        coarse = _coarse_field(sc, packed, seed[0, 0], cfg, o, d)
        t = _lod_park(*coarse, cfg, t, active, oy, d[1], env)
        active, prev_t = t < cfg.t_max, t
    t, prev_t, hit, _, steps = _march(field_at, cfg, t, prev_t, active, oy, d[1], env)
    out = _polish_and_shade(sc, cfg, field_grad_at, d, t, prev_t, hit)
    return out + (steps,) if debug_steps else out


@torch.no_grad()
def trace_phase1_reference(packed: torch.Tensor, seed: torch.Tensor,
                           cfg: RenderConfig, local_height: int):
    """Plain PyTorch version of compaction's phase 1, on any device; same
    arguments and results as ``trace_phase1``: the one-pass march for
    ``compact_budget`` steps, polished and shaded (rays still marching have
    no hit yet, so they shade as sky), and the rays still marching listed in
    pixel order (the slots past them hold 0)."""
    _check_compact(packed, seed, cfg, local_height, {})
    sc, o, d, env, t, active, field_grad_at, field_at = _frame_rays(
        packed, seed, cfg, local_height)
    t, prev_t, hit, alive, _ = _march(field_at, cfg, t, t, active, o[1], d[1], env,
                                      cfg.compact_budget)
    color, t, hit_f = _polish_and_shade(sc, cfg, field_grad_at, d, t, prev_t, hit)
    listed = alive.reshape(-1).nonzero()[:, 0].to(torch.int32)
    ids = torch.zeros(alive.numel(), dtype=torch.int32, device=alive.device)
    ids[:listed.numel()] = listed
    n_alive = torch.tensor([listed.numel()], dtype=torch.int32, device=alive.device)
    return color, t, hit_f, alive.to(torch.float32), prev_t, ids, n_alive


@torch.no_grad()
def trace_phase2_reference(packed: torch.Tensor, seed: torch.Tensor,
                           cfg: RenderConfig, local_height: int, n_alive: torch.Tensor,
                           ids: torch.Tensor, prev: torch.Tensor, color: torch.Tensor,
                           t: torch.Tensor, hit: torch.Tensor) -> None:
    """Plain PyTorch version of compaction's phase 2, on any device; same
    arguments and in-place results as ``trace_phase2``.

    It resumes the march over the whole frame with the listed pixels as the
    resume mask (the others never move) and then writes the listed pixels
    only. So each pixel is computed at its own place in frame-shaped tensors,
    as ``trace_frame_reference`` computes it, and a resumed ray gets exactly
    the one-pass march's result whatever its slot."""
    _check_phase2(packed, seed, cfg, local_height, n_alive, ids, prev, color, t, hit)
    sc, o, d, env, _, _, field_grad_at, field_at = _frame_rays(
        packed, seed, cfg, local_height)
    sel = ids[:int(n_alive.item())].long()
    resume = torch.zeros(t.numel(), dtype=torch.bool, device=t.device)
    resume[sel] = True
    t2, prev2, hit2, _, _ = _march(field_at, cfg, t.clone(), prev, resume.view(t.shape),
                                   o[1], d[1], env, cfg.max_steps - cfg.compact_budget)
    color2, t2, hit2 = _polish_and_shade(sc, cfg, field_grad_at, d, t2, prev2, hit2)
    color.view(3, -1)[:, sel] = color2.reshape(3, -1)[:, sel]
    for out, new in ((t, t2), (hit, hit2)):
        out.view(-1)[sel] = new.reshape(-1)[sel]


@torch.no_grad()
def trace_frames_reference(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                           local_height: int, t0_prime: torch.Tensor | None = None,
                           debug_steps: bool = False):
    """Plain version of ``trace_frames``: ``trace_frame_reference`` of each
    frame (row of ``packed``, plane of ``t0_prime``), stacked."""
    lead = _frames(packed)
    _check_inputs(packed, seed, cfg, local_height, t0_prime, debug_steps, lead)
    outs = [trace_frame_reference(packed[b:b + 1], seed, cfg, local_height,
                                  None if t0_prime is None else t0_prime[b], debug_steps)
            for b in range(lead[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


@torch.no_grad()
def trace_phase1s_reference(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                            local_height: int):
    """Plain version of ``trace_phase1s``: ``trace_phase1_reference`` of
    each frame, stacked (``n_alive`` (B,))."""
    lead = _frames(packed)
    _check_compact(packed, seed, cfg, local_height, {}, lead)
    outs = [trace_phase1_reference(packed[b:b + 1], seed, cfg, local_height)
            for b in range(lead[0])]
    *planes, n_alive = (torch.stack(x) for x in zip(*outs))
    return (*planes, n_alive.reshape(-1))


@torch.no_grad()
def trace_phase2s_reference(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                            local_height: int, n_alive: torch.Tensor, ids: torch.Tensor,
                            prev: torch.Tensor, color: torch.Tensor, t: torch.Tensor,
                            hit: torch.Tensor) -> None:
    """Plain version of ``trace_phase2s``: ``trace_phase2_reference`` of
    each frame, in place on its planes."""
    lead = _frames(packed)
    _check_phase2(packed, seed, cfg, local_height, n_alive, ids, prev, color, t, hit, lead)
    for b in range(lead[0]):
        trace_phase2_reference(packed[b:b + 1], seed, cfg, local_height, n_alive[b:b + 1],
                               ids[b], prev[b], color[b], t[b], hit[b])


def tile_steps(steps: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """The march steps each (tile_h, 128) tile of the TPU kernel executes,
    from per-lane counts (h, w): a (grid_h, grid_w) int32 array, equal to
    ``_render_pallas_raw(..., debug_steps=True)``'s. A tile runs whole
    chunks until its longest lane is done, so chunked and lod read
    ceil(tile max / chunk)·chunk; fixed reads ``max_steps``."""
    h, w = steps.shape
    th = cfg.tile_h
    gh, gw = -(-h // th), -(-w // TILE_W)
    padded = steps.new_zeros((gh * th, gw * TILE_W))
    padded[:h, :w] = steps
    tile_max = padded.reshape(gh, th, gw, TILE_W).amax(dim=(1, 3))
    if cfg.march_mode == "fixed":
        return torch.full_like(tile_max, cfg.max_steps)
    chunk = cfg.march_chunk or MARCH_CHUNK_DEFAULT
    return (tile_max + chunk - 1) // chunk * chunk


def warp_tile_pixels(local_height: int, width: int) -> torch.Tensor:
    """The forward kernel's tile -> pixel map (csrc/trace_fwd.cu): an int64
    (n_tiles, 32) array whose row k holds, lane by lane, the band-local
    pixel id (row * width + col) that a warp traces when it takes tile k,
    or -1 where the lane falls past the band's last row or column. Tiles
    are WARP_TILE (rows, cols), numbered row-major over the band; lane l
    takes row l // cols and column l % cols of its tile."""
    rows, cols = WARP_TILE
    tiles_x, tiles_y = -(-width // cols), -(-local_height // rows)
    tile = torch.arange(tiles_x * tiles_y)[:, None]
    lane = torch.arange(WARP)[None, :]
    row = (tile // tiles_x) * rows + lane // cols
    col = (tile % tiles_x) * cols + lane % cols
    return torch.where((row < local_height) & (col < width), row * width + col, -1)


def warp_steps(steps: torch.Tensor) -> torch.Tensor:
    """The march steps each warp of the CUDA kernel executes per tile it
    takes, from per-lane counts (h, w): the maximum over each tile of
    ``warp_tile_pixels`` (masked lanes count 0), flat, int32, in tile
    order."""
    flat = torch.cat([steps.reshape(-1), steps.new_zeros(1)])  # id -1: the 0
    ids = warp_tile_pixels(*steps.shape).to(steps.device)
    return flat[ids].amax(dim=1)


def trace_bwd_reference(packed: torch.Tensor, seed: torch.Tensor,
                        cfg: RenderConfig, local_height: int, t: torch.Tensor,
                        hit: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel, on any device; same
    arguments and result as ``trace_frame_bwd``.

    Two channels, as the TPU kernel's ``_trace_bwd_kernel`` computes them:
    the VJP of raygen + shade at the saved t with respect to the packed
    scalars and t (autograd of the forward's own helpers), then the
    implicit-function march channel: scale = -t̄ / min(∇f·d, -1e-2) at hits,
    pulled back through one value-only field evaluation at the saved t."""
    _check_bwd_inputs(packed, seed, cfg, local_height, t, hit, g)
    g = g.contiguous()  # either layout gives the same sums
    hitb = hit > 0.5
    grid = _pixel_grid(local_height, cfg.width, packed.device)
    with torch.enable_grad():
        th = packed.detach().clone().requires_grad_()
        t_ = t.detach().clone().requires_grad_()

        def sc(k):
            return th[0, k]

        o, d = _raygen_rc(sc, cfg, *grid)
        field_grad_at, _ = _field_fns(sc, th, seed[0, 0], cfg, o, d)
        # The march channel pulls back through the march's own field: bf16
        # under march_bf16 (autograd rounds each bf16 cotangent), as JAX's
        # _trace_bwd_kernel does; the shade channel stays float32.
        _, field_at = _field_fns(sc, th, seed[0, 0], cfg, o, d, cfg.march_bf16)
        _, gx, gy, gz, hgt = field_grad_at(t_)
        colors = _shade_from_grads(sc, t_, hitb, d, (gx, gy, gz, hgt))
        th_bar, t_bar = torch.autograd.grad(colors, (th, t_), grad_outputs=tuple(g),
                                            retain_graph=True)
        # March channel: ∇f·d at the saved hit is a forward value here.
        denom = torch.clamp((gx * d[0] + gy * d[1] + gz * d[2]).detach(),
                            max=-_BWD_DENOM_MIN)
        scale = torch.where(hitb, -t_bar / denom, torch.zeros_like(t_bar))
        (th_bar2,) = torch.autograd.grad(field_at(t.detach()), th, grad_outputs=scale)
    return th_bar + th_bar2


def trace_frames_bwd_reference(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                               local_height: int, t: torch.Tensor, hit: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
    """Plain version of ``trace_frames_bwd``: ``trace_bwd_reference`` of
    each frame, stacked into (B, AMPS + octaves)."""
    lead = _frames(packed)
    _check_bwd_inputs(packed, seed, cfg, local_height, t, hit, g, lead)
    return torch.cat([trace_bwd_reference(packed[b:b + 1], seed, cfg, local_height, t[b],
                                          hit[b], g[b]) for b in range(lead[0])])


def _packs(scene: Scene, cameras, cfg: RenderConfig, row0=0.0):
    """``kernels/pack.py:pack_frames`` for ``cfg``: (the rows of the frame
    or band at ``row0``, or of each stripe where ``row0`` is a sequence of
    first rows, the rows of its coarse prime pass or None when ``cfg`` does
    not prime, seed), one launch for both on the card."""
    coarse = None
    if cfg.prime_ds:
        ccfg = coarse_prime_cfg(cfg)
        coarse = (ccfg.height, ccfg.width,
                  tuple(r / cfg.prime_ds - 1.0 for r in pk.row0s(row0)))
    return kpack.pack_frames(scene, cameras, cfg.height, cfg.width, row0, coarse)


@torch.no_grad()
def _prime(coarse, seed, cfg: RenderConfig, row0s: tuple[float, ...], rows: int):
    """The kernel path's depth-prime maps (None when ``cfg`` does not prime,
    so ``coarse`` is None), (B, rows, W), one per frame of ``coarse``: of the
    block of ``rows`` rows from its first row in ``row0s`` (one that every
    frame shares: a band, or whole frames of a batch of cameras; or one per
    frame: a rank's stripes), the coarse pass at 1/ds resolution with one
    halo row above and below the block (row row0/ds - 1, height rows/ds + 2,
    its rows ``coarse`` from ``_packs``), all frames in one ``trace_frames``
    launch, turned into the prime maps."""
    if coarse is None:
        return None
    for r in row0s:
        check_prime_band(cfg, r, rows)
    _, t_c, _ = trace_frames(coarse, seed, coarse_prime_cfg(cfg), rows // cfg.prime_ds + 2)
    return prime_from_coarse(t_c, cfg)


@torch.no_grad()
def _prime_map(scene: Scene, cfg: RenderConfig, row0, local_height: int):
    """The (local_height, W) prime map of the band at ``row0``, packed
    here (None when ``cfg`` does not prime)."""
    _, coarse, seed = _packs(scene, scene.camera, cfg, row0)
    t0p = _prime(coarse, seed, cfg, pk.row0s(row0), local_height)
    return None if t0p is None else t0p[0]


@torch.no_grad()
def render_kernel_raw(scene: Scene, cfg: RenderConfig, row0=0.0,
                      local_height: int | None = None, debug_steps: bool = False):
    """Render a full frame, a row band or a rank's stripes (``row0`` a
    sequence of first rows, splitting ``local_height`` evenly) through
    ``trace_frames``: (color (h, W, 3), t (h, W), hit bool (h, W)), the
    stripes' rows one after another, plus the fine pass's per-lane step
    counts with ``debug_steps``.

    The scene packs once (``_packs``: the coarse and the fine rows, a row
    per block); with ``cfg.prime_ds`` it first traces the coarse depth-prime
    pass (``_prime``) and then the blocks from it: two launches of the trace
    kernel (the one-frame kernel for one block)."""
    row0s, rows = pk.row_blocks(row0, local_height, cfg.height)
    packed, coarse, seed = _packs(scene, scene.camera, cfg, row0s)
    t0p = _prime(coarse, seed, cfg, row0s, rows)
    color, t, hit_f, *steps = trace_frames(packed, seed, cfg, rows, t0p, debug_steps)
    return (_stacked(color.permute(0, 2, 3, 1)), _stacked(t), _stacked(hit_f) > 0.5,
            *map(_stacked, steps))


def _stacked(x: torch.Tensor) -> torch.Tensor:
    """A batch's (B, h, W, ...) as its frames' rows one after another,
    (B·h, W, ...): a view where one frame is."""
    return x.reshape(-1, *x.shape[2:])


@torch.no_grad()
def _prime_maps(scene: Scene, cameras: Cameras, cfg: RenderConfig):
    """``_prime`` of the batch of whole frames packed here, (B, H, W)."""
    _, coarse, seed = _packs(scene, cameras, cfg)
    return _prime(coarse, seed, cfg, (0.0,), cfg.height)


@torch.no_grad()
def render_frames_raw(scene: Scene, cameras: Cameras, cfg: RenderConfig):
    """Render a batch of full frames of ``scene``, frame b from camera b of
    ``cameras`` (``ops/camera.py:Cameras``), through ``trace_frames``: (color
    (B, H, W, 3), t (B, H, W), hit bool (B, H, W)), frame b bit for bit
    ``render_kernel_raw`` of the scene with camera b. The counterpart of the
    body of the JAX package's ``_make_batch_render`` (``jit(vmap(render))``):
    every frame's coarse and fine rows in one pack launch, the coarse prime
    pass of every frame in one launch, the prime maps, then the fine pass of
    every frame in one launch (compaction: phase 1 and phase 2 once each).
    ``cfg.supersample`` k > 1 traces at k× resolution and box-downsamples
    each frame's colour as ``ops/render.py:render`` does; t and hit stay at
    the traced resolution. Builds no autograd graph."""
    ss = cfg.supersample
    if ss > 1:
        from gpgpuraytrace_tpu_torch.ops.render import box_downsample

        hi_cfg = dataclasses.replace(cfg, height=cfg.height * ss, width=cfg.width * ss,
                                     supersample=1)
        color, t, hit = render_frames_raw(scene, cameras, hi_cfg)
        return torch.stack([box_downsample(c, ss) for c in color]), t, hit
    packed, coarse, seed = _packs(scene, cameras, cfg)
    t0p = _prime(coarse, seed, cfg, (0.0,), cfg.height)
    color, t, hit_f = trace_frames(packed, seed, cfg, cfg.height, t0p)
    return color.permute(0, 2, 3, 1), t, hit_f > 0.5


def _float_leaves(scene: Scene) -> list[torch.Tensor]:
    """The scene's leaves (by dotted name, ``utils/convert.py:LEAF_NAMES``)
    that require grad; a leaf replaced by a plain tensor
    (``ops/fd_check.py:scene_with``) counts too."""
    leaves = (operator.attrgetter(name)(scene) for name in LEAF_NAMES)
    return [x for x in leaves if x.requires_grad]


class _KernelRender(torch.autograd.Function):
    """Colour (B·h, W, 3) of B blocks of ``rows`` rows (a band, or a rank's
    stripes) from ``trace_frames`` at ``packed``, their rows one block after
    another; the backward pulls the cotangent back at the saved (t, hit):
    onto ``packed`` by ``trace_frames_bwd`` (cfg.kernel_bwd), else onto
    ``leaves`` by autograd through ``render_from_checkpoint`` of each block.
    Either way autograd carries it on to the scene's parameters (through
    ``kernels/pack.py``'s VJP, which sums the blocks' rows, or directly).
    One block launches the one-frame kernels."""

    @staticmethod
    def forward(ctx, scene, cfg, row0s, rows, t0p, seed, packed, *leaves):
        color, t, hit = trace_frames(packed, seed, cfg, rows, t0p)
        ctx.scene, ctx.cfg, ctx.row0s, ctx.rows = scene, cfg, row0s, rows
        ctx.save_for_backward(packed, seed, t, hit, *leaves)
        return _stacked(color.permute(0, 2, 3, 1))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        packed, seed, t, hit, *leaves = ctx.saved_tensors
        cfg = ctx.cfg
        none = (None,) * 6
        if cfg.kernel_bwd:
            # The kernel reads g's (B, h, W, 3) layout as it is; any other
            # (a broadcast cotangent, say) is copied.
            g = g.reshape(len(ctx.row0s), ctx.rows, cfg.width, 3)
            gp = g.permute(0, 3, 1, 2)
            if not (gp.is_contiguous() or g.is_contiguous()):
                gp = gp.contiguous()
            pbar = trace_frames_bwd(packed, seed, cfg, ctx.rows, t, hit, gp)
            return none + (pbar,) + (None,) * len(leaves)
        from gpgpuraytrace_tpu_torch.ops.render import render_from_checkpoint

        with torch.enable_grad():
            img = torch.cat([render_from_checkpoint(ctx.scene, cfg, t[b], hit[b] > 0.5, r,
                                                    ctx.rows)
                             for b, r in enumerate(ctx.row0s)])
            bars = torch.autograd.grad(img, leaves, grad_outputs=g, allow_unused=True)
        return none + (None,) + bars


def render_kernel(scene: Scene, cfg: RenderConfig, row0=0.0,
                  local_height: int | None = None) -> torch.Tensor:
    """Differentiable render through the trace kernels: (h, W, 3) linear RGB
    (counterpart of ``render_pallas``) of the frame, the band of
    ``local_height`` rows at ``row0``, or where ``row0`` is a sequence of
    first rows, the stripes that split ``local_height`` rows evenly, their
    rows one stripe after another. The forward is ``render_kernel_raw``'s
    two launches after one pack launch (a row per stripe); the prime map
    carries no gradient, the packed rows carry it to the scene's leaves:
    backward one launch pair and one VJP launch, which sums the stripes'
    cotangents."""
    row0s, rows = pk.row_blocks(row0, local_height, cfg.height)
    packed, coarse, seed = _packs(scene, scene.camera, cfg, row0s)
    t0p = _prime(coarse, seed, cfg, row0s, rows)
    leaves = () if cfg.kernel_bwd else _float_leaves(scene)
    return _KernelRender.apply(scene, cfg, row0s, rows, t0p, seed, packed, *leaves)
