"""The trace kernels: the forward (raygen -> primed sphere-trace march ->
Newton polish -> shade) and the backward (output cotangent -> packed
scene-parameter cotangent), each for a full frame or a row band.

Counterparts of ``gpgpuraytrace_tpu/kernels/trace.py``: ``_trace_kernel``
with its launcher ``_render_pallas_raw``, and ``_trace_bwd_kernel`` with
``_backward_pallas`` and the custom VJP ``render_pallas_cfg``. The pieces:

* ``trace_frame`` and ``trace_frame_bwd`` are the wrappers. Each validates
  its inputs, launches its hand-written CUDA kernel (``csrc/trace_fwd.cu``,
  ``csrc/trace_bwd.cu``) on CUDA tensors, and runs its plain version on CPU
  tensors. ``.launches`` counts kernel launches. A CUDA input never falls
  back to the plain version: a failed build or launch raises.
* ``trace_frame_reference`` and ``trace_bwd_reference`` are the plain
  PyTorch versions of exactly what the kernels compute, written against the
  same packed scalar vector.
* ``render_kernel_raw`` renders a frame through ``trace_frame`` (coarse
  depth-prime pass, prime map, full pass) and returns its (t, hit) too; it
  builds no autograd graph.
* ``render_kernel`` is the differentiable render of the kernel path: its
  backward is ``trace_frame_bwd`` (``cfg.kernel_bwd``) or autograd through
  the plain re-shade at the saved (t, hit).
"""

from __future__ import annotations

import ctypes
import operator

import torch

from gpgpuraytrace_tpu_torch.models.scene import (
    MARCH_CHUNK_DEFAULT, RenderConfig, Scene,
)
from gpgpuraytrace_tpu_torch.ops.field import check_heightfield
from gpgpuraytrace_tpu_torch.ops.march import (
    _BWD_DENOM_MIN, _DENOM_EPS, _PRIME_PREV_PULLBACK, _RESIDUAL_SLACK,
    check_prime_band, coarse_prime_cfg, prime_from_coarse,
)
from gpgpuraytrace_tpu_torch.ops.noise import fbm2, fbm2_value
from gpgpuraytrace_tpu_torch.ops.shade import _smoothstep
from gpgpuraytrace_tpu_torch.utils import packing as pk
from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES

MAX_OCTAVES = 16  # keep in sync with csrc/field.cuh


class TraceConfig(ctypes.Structure):
    """The kernel's config, passed by value (csrc/trace_fwd.cu:TraceConfig)."""

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
    ]


class TraceBwdConfig(ctypes.Structure):
    """The backward kernel's config (csrc/trace_bwd.cu:TraceBwdConfig)."""

    _fields_ = [
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("local_h", ctypes.c_int),
        ("num_octaves", ctypes.c_int),
    ]


def _check_supported(cfg: RenderConfig) -> None:
    check_heightfield(cfg.volumetric)
    if cfg.march_mode != "chunked":
        raise NotImplementedError(
            f"march_mode={cfg.march_mode!r} is not ported to the trace kernel "
            f"yet (ROADMAP.md, TPU kernels still to port); use march_mode='chunked'"
        )
    if cfg.march_bf16:
        raise NotImplementedError(
            "march_bf16 is not ported to the trace kernel yet (ROADMAP.md, "
            "TPU kernels still to port)"
        )
    if not 1 <= cfg.num_octaves <= MAX_OCTAVES:
        raise ValueError(
            f"num_octaves={cfg.num_octaves} must be in [1, {MAX_OCTAVES}]"
        )


def _check_tensors(packed, seed, cfg, local_height, named) -> None:
    """Raise on anything the kernels do not take. ``named`` maps a name to
    (tensor, required shape) for the per-pixel inputs."""
    _check_supported(cfg)
    n_params = pk.AMPS + cfg.num_octaves
    if packed.dtype != torch.float32 or packed.shape != (1, n_params):
        raise ValueError(
            f"packed must be float32 (1, {n_params}), got {packed.dtype} "
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
    for x in [packed, seed] + [x for x, _ in named.values()]:
        if x.device != packed.device:
            raise ValueError(f"inputs on {x.device} and {packed.device}")
        if not x.is_contiguous():
            raise ValueError("trace kernel inputs must be contiguous")


def _check_inputs(packed, seed, cfg, local_height, t0_prime) -> None:
    """Raise on anything the forward kernel does not take."""
    if bool(cfg.prime_ds) != (t0_prime is not None):
        raise ValueError(
            f"t0_prime must be given exactly when cfg primes "
            f"(prime_ds={cfg.prime_ds})"
        )
    shape = (local_height, cfg.width)
    named = {} if t0_prime is None else {"t0_prime": (t0_prime, shape)}
    _check_tensors(packed, seed, cfg, local_height, named)
    for x in [packed] + ([] if t0_prime is None else [t0_prime]):
        if x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                "trace_frame is forward only: for gradients render through "
                "kernels.trace.render_kernel, whose backward is trace_frame_bwd"
            )


def trace_frame(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                local_height: int, t0_prime: torch.Tensor | None = None):
    """Trace ``local_height`` rows of the frame ``cfg`` describes.

    ``packed`` (1, AMPS + octaves) float32 and ``seed`` (1, 1) int32 come from
    ``utils.packing.pack_scene`` (its ``row0`` places the band);
    ``t0_prime`` is the (local_height, width) march-start map when
    ``cfg.prime_ds`` is set. Returns (color (3, h, w), t (h, w),
    hit (h, w) float 0/1). CUDA inputs launch the CUDA kernel; CPU inputs
    run ``trace_frame_reference``.
    """
    _check_inputs(packed, seed, cfg, local_height, t0_prime)
    if packed.device.type == "cpu":
        return trace_frame_reference(packed, seed, cfg, local_height, t0_prime)
    if packed.device.type != "cuda":
        raise RuntimeError(f"trace_frame: unsupported device {packed.device}")
    return _launch(packed, seed, cfg, local_height, t0_prime)


trace_frame.launches = 0


def _library() -> ctypes.CDLL:
    from gpgpuraytrace_tpu_torch.kernels.build import load_library

    lib = load_library()
    lib.trace_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [
        TraceConfig, ctypes.c_void_p,
    ]
    lib.trace_fwd_launch.restype = ctypes.c_int
    lib.trace_bwd_scratch_floats.argtypes = [TraceBwdConfig]
    lib.trace_bwd_scratch_floats.restype = ctypes.c_int
    lib.trace_bwd_launch.argtypes = [ctypes.c_void_p] * 7 + [
        TraceBwdConfig, ctypes.c_void_p,
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


def _launch(packed, seed, cfg, local_height, t0_prime):
    lib = _library()
    dev = packed.device
    h, w = local_height, cfg.width
    color = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    t = torch.empty((h, w), dtype=torch.float32, device=dev)
    hit = torch.empty((h, w), dtype=torch.float32, device=dev)
    kcfg = TraceConfig(
        height=cfg.height, width=w, local_h=h, max_steps=cfg.max_steps,
        num_octaves=cfg.num_octaves, newton_iters=cfg.newton_iters,
        t_min=cfg.t_min, t_max=cfg.t_max, hit_eps=cfg.hit_eps,
        march_eps_scale=cfg.march_eps_scale, step_relax=cfg.step_relax,
        step_floor_t=cfg.step_floor_t, primed=int(t0_prime is not None),
    )
    with torch.cuda.device(dev):
        err = lib.trace_fwd_launch(
            packed.data_ptr(), seed.data_ptr(),
            None if t0_prime is None else t0_prime.data_ptr(),
            color.data_ptr(), t.data_ptr(), hit.data_ptr(), kcfg,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "trace_fwd")
    trace_frame.launches += 1
    return color, t, hit


def _check_bwd_inputs(packed, seed, cfg, local_height, t, hit, g) -> None:
    hw = (local_height, cfg.width)
    _check_tensors(packed, seed, cfg, local_height,
                   {"t": (t, hw), "hit": (hit, hw), "g": (g, (3, *hw))})


def trace_frame_bwd(packed: torch.Tensor, seed: torch.Tensor, cfg: RenderConfig,
                    local_height: int, t: torch.Tensor, hit: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """Backward of ``trace_frame``'s colour at its saved (t, hit).

    ``packed``, ``seed``, ``cfg`` and ``local_height`` as for
    ``trace_frame``; ``t`` and ``hit`` (local_height, width) float32 are its
    outputs, ``g`` (3, local_height, width) float32 the cotangent of its
    colour planes. Returns the packed-vector cotangent (1, AMPS + octaves):
    the shade channel at the saved t plus the implicit-function march
    channel, summed over the pixels. CUDA inputs launch the CUDA kernel;
    CPU inputs run ``trace_bwd_reference``."""
    _check_bwd_inputs(packed, seed, cfg, local_height, t, hit, g)
    if packed.device.type == "cpu":
        return trace_bwd_reference(packed, seed, cfg, local_height, t, hit, g)
    if packed.device.type != "cuda":
        raise RuntimeError(f"trace_frame_bwd: unsupported device {packed.device}")
    return _launch_bwd(packed.detach(), seed, cfg, local_height, t, hit, g)


trace_frame_bwd.launches = 0


def _launch_bwd(packed, seed, cfg, local_height, t, hit, g):
    lib = _library()
    dev = packed.device
    kcfg = TraceBwdConfig(height=cfg.height, width=cfg.width, local_h=local_height,
                          num_octaves=cfg.num_octaves)
    partial = torch.empty(lib.trace_bwd_scratch_floats(kcfg), dtype=torch.float32,
                          device=dev)
    pbar = torch.empty((1, pk.AMPS + cfg.num_octaves), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.trace_bwd_launch(
            packed.data_ptr(), seed.data_ptr(), t.data_ptr(), hit.data_ptr(),
            g.data_ptr(), partial.data_ptr(), pbar.data_ptr(), kcfg,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "trace_bwd")
    trace_frame_bwd.launches += 1
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
    """Certified terrain upper bound plus hit_eps."""
    amps_abs = torch.zeros((), dtype=torch.float32, device=sc(0).device)
    for k in range(cfg.num_octaves):
        amps_abs = amps_abs + torch.abs(sc(pk.AMPS + k))
    env = sc(pk.HEIGHT_OFFSET) + torch.abs(sc(pk.HEIGHT_SCALE)) * amps_abs
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


def _field_fns(sc, packed, seed, cfg: RenderConfig, o, d):
    """(field_grad_at, field_at) along the rays at distance t."""
    ox, oy, oz = o
    dx, dy, dz = d
    hs = sc(pk.HORIZONTAL_SCALE)
    lac = sc(pk.LACUNARITY)
    h_off = sc(pk.HEIGHT_OFFSET)
    h_scale = sc(pk.HEIGHT_SCALE)
    amps = packed[0, pk.AMPS:pk.AMPS + cfg.num_octaves]

    def field_grad_at(t):
        """f, its gradient (gx, gy, gz) and the terrain height h."""
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        n, nx, nz = fbm2(px * hs, pz * hs, amps, lac, seed)
        h = h_off + h_scale * n
        scale = h_scale * hs
        return py - h, -scale * nx, torch.ones_like(h), -scale * nz, h

    def field_at(t):
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        n = fbm2_value(px * hs, pz * hs, amps, lac, seed)
        return py - (h_off + h_scale * n)

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


@torch.no_grad()
def trace_frame_reference(packed: torch.Tensor, seed: torch.Tensor,
                          cfg: RenderConfig, local_height: int,
                          t0_prime: torch.Tensor | None = None):
    """Plain PyTorch version of the trace kernel, on any device; same
    arguments and results as ``trace_frame``.

    Vectorized over pixels, with the TPU kernel's whole-frame chunked exit
    (every ``march_chunk`` steps) where the CUDA kernel exits per thread:
    finished lanes never change state, so both give the same result."""
    _check_inputs(packed, seed, cfg, local_height, t0_prime)

    def sc(k):
        return packed[0, k]

    o, d = _raygen_rc(sc, cfg, *_pixel_grid(local_height, cfg.width, packed.device))
    dx, dy, dz = d
    oy = sc(pk.POS + 1)
    t, active, env = _envelope_entry(sc, cfg, dy)
    prev_t = t
    if t0_prime is not None:
        t = torch.maximum(t, t0_prime)
        active = active & (t < cfg.t_max)
        prev_t = torch.clamp(t * _PRIME_PREV_PULLBACK, min=cfg.t_min)
    field_grad_at, field_at = _field_fns(sc, packed, seed[0, 0], cfg, o, d)
    t_max = torch.full_like(t, cfg.t_max)
    hit = torch.zeros_like(active)
    eps_m = cfg.hit_eps * cfg.march_eps_scale

    chunk = cfg.march_chunk or MARCH_CHUNK_DEFAULT
    for _ in range(-(-cfg.max_steps // chunk)):
        if not bool(active.any()):
            break
        for _ in range(chunk):
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

    # Bracketed safeguarded-Newton polish; the first iteration also sets the
    # bracket's upper bound from the local descent rate (+25% margin).
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
    hitb = hit > 0.5
    grid = _pixel_grid(local_height, cfg.width, packed.device)
    with torch.enable_grad():
        th = packed.detach().clone().requires_grad_()
        t_ = t.detach().clone().requires_grad_()

        def sc(k):
            return th[0, k]

        o, d = _raygen_rc(sc, cfg, *grid)
        field_grad_at, field_at = _field_fns(sc, th, seed[0, 0], cfg, o, d)
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


def _prime_map(scene: Scene, cfg: RenderConfig, row0, local_height: int):
    """The kernel path's depth-prime map (None when ``cfg`` does not prime):
    the coarse pass at 1/ds resolution with one halo row above and below the
    band (row row0/ds - 1, height h/ds + 2), traced by ``trace_frame`` and
    turned into the prime map."""
    if not cfg.prime_ds:
        return None
    check_prime_band(cfg, row0, local_height)
    ds = cfg.prime_ds
    with torch.no_grad():
        _, t_c, _ = render_kernel_raw(
            scene, coarse_prime_cfg(cfg), row0 / ds - 1.0, local_height // ds + 2
        )
        return prime_from_coarse(t_c, cfg)


@torch.no_grad()
def render_kernel_raw(scene: Scene, cfg: RenderConfig, row0=0.0,
                      local_height: int | None = None):
    """Render a full frame or a row band through ``trace_frame``:
    (color (h, W, 3), t (h, W), hit bool (h, W)).

    With ``cfg.prime_ds`` it first traces the coarse depth-prime pass
    (``_prime_map``) and then traces the band from it: two launches per
    frame."""
    h = cfg.height if local_height is None else local_height
    t0p = _prime_map(scene, cfg, row0, h)
    packed, seed = pk.pack_scene(scene, cfg.height, cfg.width, row0)
    color, t, hit_f = trace_frame(packed, seed, cfg, h, t0p)
    return color.permute(1, 2, 0), t, hit_f > 0.5


def _float_leaves(scene: Scene) -> list[torch.Tensor]:
    """The scene's leaves (by dotted name, ``utils/convert.py:LEAF_NAMES``)
    that require grad; a leaf replaced by a plain tensor
    (``ops/fd_check.py:scene_with``) counts too."""
    leaves = (operator.attrgetter(name)(scene) for name in LEAF_NAMES)
    return [x for x in leaves if x.requires_grad]


class _KernelRender(torch.autograd.Function):
    """Colour (h, W, 3) from ``trace_frame`` at ``packed``; the backward
    pulls the cotangent back at the saved (t, hit): onto ``packed`` by
    ``trace_frame_bwd`` (cfg.kernel_bwd), else onto ``leaves`` by autograd
    through ``render_from_checkpoint``. Either way autograd carries it on to
    the scene's parameters (through ``pack_scene``, or directly)."""

    @staticmethod
    def forward(ctx, scene, cfg, row0, local_height, t0p, seed, packed, *leaves):
        color, t, hit = trace_frame(packed, seed, cfg, local_height, t0p)
        ctx.scene, ctx.cfg, ctx.row0, ctx.local_height = scene, cfg, row0, local_height
        ctx.save_for_backward(packed, seed, t, hit, *leaves)
        return color.permute(1, 2, 0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        packed, seed, t, hit, *leaves = ctx.saved_tensors
        cfg = ctx.cfg
        none = (None,) * 6
        if cfg.kernel_bwd:
            gp = g.permute(2, 0, 1).contiguous()
            pbar = trace_frame_bwd(packed, seed, cfg, ctx.local_height, t, hit, gp)
            return none + (pbar,) + (None,) * len(leaves)
        from gpgpuraytrace_tpu_torch.ops.render import render_from_checkpoint

        with torch.enable_grad():
            img = render_from_checkpoint(ctx.scene, cfg, t, hit > 0.5, ctx.row0,
                                         ctx.local_height)
            bars = torch.autograd.grad(img, leaves, grad_outputs=g, allow_unused=True)
        return none + (None,) + bars


def render_kernel(scene: Scene, cfg: RenderConfig, row0=0.0,
                  local_height: int | None = None) -> torch.Tensor:
    """Differentiable render through the trace kernels: (h, W, 3) linear RGB
    (counterpart of ``render_pallas``). The forward is ``render_kernel_raw``'s
    two launches; the prime map carries no gradient."""
    h = cfg.height if local_height is None else local_height
    t0p = _prime_map(scene, cfg, row0, h)
    packed, seed = pk.pack_scene(scene, cfg.height, cfg.width, row0)
    leaves = () if cfg.kernel_bwd else _float_leaves(scene)
    return _KernelRender.apply(scene, cfg, row0, h, t0p, seed, packed, *leaves)
