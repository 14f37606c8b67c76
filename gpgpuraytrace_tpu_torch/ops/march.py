"""Adaptive-step sphere-trace march, differentiable (counterpart of
``gpgpuraytrace_tpu/ops/march.py``).

Per pixel: advance t <- t + max(relax·f, hit_eps, floor·t) until f < eps·t
(hit), the ray climbs out of the terrain envelope heading up (certain miss)
or t reaches t_max, then polish hits with a bracketed Newton iteration on
the analytic field gradient.

The march is not differentiated step by step. ``march``, ``march_primed``
and ``march_from_saved`` are ``torch.autograd.Function``s whose backward is
the implicit-function VJP at the hit distance: f(o + t·d; θ) = 0 gives
∂t = -(∂f/∂θ·∂θ + ∇f·(∂o + t·∂d)) / (∇f·d), see ``_march_bwd_core``.
"""

from __future__ import annotations

import dataclasses
import types

import torch
import torch.nn.functional as F

from gpgpuraytrace_tpu_torch.models.scene import NoiseParams, RenderConfig
from gpgpuraytrace_tpu_torch.ops.field import envelope_height, field, field_and_grad

_DENOM_EPS = 1e-4
# Lower bound on the descent rate -∇f·d used for the polish bracket.
_BWD_DENOM_MIN = 1e-2
# Depth priming: bracket lower bound for lanes that hit on their first
# primed sample. Keep in sync with kernels/trace.py.
_PRIME_PREV_PULLBACK = 0.9
# Residual hit verdict (march_eps_scale != 1): a polished hit must satisfy
# f < _RESIDUAL_SLACK·hit_eps·t. Keep in sync with kernels/trace.py.
_RESIDUAL_SLACK = 2.0


def coarse_prime_cfg(cfg: RenderConfig) -> RenderConfig:
    """The depth-prime coarse-pass config: 1/ds resolution, one Newton
    iteration, and a ds-scaled step floor. Shared by the kernel path and
    the plain path so both march the same coarse pass."""
    ds = cfg.prime_ds
    return dataclasses.replace(
        cfg,
        height=cfg.height // ds,
        width=cfg.width // ds,
        prime_ds=0,
        newton_iters=1,
        step_floor_t=cfg.step_floor_t * ds,
    )


def check_prime_band(cfg: RenderConfig, row0, local_height: int | None) -> None:
    """A primed row band must cover whole coarse rows: ``prime_ds`` divides
    its height and its first row."""
    ds = cfg.prime_ds
    h = cfg.height if local_height is None else local_height
    if ds and (h % ds or float(row0) % ds):
        raise ValueError(
            f"prime_ds={ds} must divide the band's local height {h} and "
            f"first row {row0} (row bands must stay whole coarse rows)"
        )


def prime_from_coarse(t_c_ext: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Full-resolution march-start map from a coarse-pass t image.

    ``t_c_ext`` carries one halo row above and one below the band's coarse
    rows. Each fine ray starts at ``prime_margin`` × the minimum t of its
    3×3 coarse neighbourhood (+inf padding at the sides: ``max_pool2d`` of
    −t pads with −inf); a neighbourhood that all reached t_max primes to
    t_max. ``cfg`` is the fine config."""
    m = -F.max_pool2d(-t_c_ext[None, None], 3, stride=1, padding=1)[0, 0, 1:-1, :]
    t_max = torch.full_like(m, cfg.t_max)
    tp = torch.where(m >= cfg.t_max, t_max, m * cfg.prime_margin)
    tp = torch.clamp(tp, cfg.t_min, cfg.t_max)
    ds = cfg.prime_ds
    return tp.repeat_interleave(ds, dim=0).repeat_interleave(ds, dim=1)


def _march_loop(cfg: RenderConfig, ray_o, ray_d, noise: NoiseParams,
                t0_prime=None):
    """Raw march: returns (t, hit, steps_used).

    A Python loop with a global early exit once no lane is active: finished
    lanes never change state, so exiting early is exact. ``t0_prime`` starts
    each ray at max(envelope entry, prime map)."""
    shape = ray_o.shape[:-1]
    oy = ray_o[..., 1]
    dy = ray_d[..., 1]
    f32 = dict(dtype=torch.float32, device=ray_d.device)

    # Sky-envelope skip: no surface exists above env, so a ray starting
    # above it fast-forwards to it (or misses at once if heading up), and a
    # ray above it heading up is done.
    env = envelope_height(noise, cfg.volumetric, cfg.warp_octaves) + cfg.hit_eps
    inf = torch.full(shape, float("inf"), **f32)
    one = torch.ones(shape, **f32)
    t_enter = torch.where(dy < 0.0, (env - oy) / torch.where(dy < 0.0, dy, one), inf)
    t0 = torch.where(
        oy > env,
        torch.clamp(t_enter, cfg.t_min, cfg.t_max),
        torch.full(shape, cfg.t_min, **f32),
    )
    prev0 = t0
    if t0_prime is not None:
        t0 = torch.maximum(t0, t0_prime)
        prev0 = torch.clamp(t0 * _PRIME_PREV_PULLBACK, min=cfg.t_min)
    t, prev_t = t0, prev0
    hit = torch.zeros(shape, dtype=torch.bool, device=ray_d.device)
    active = t0 < cfg.t_max
    steps = torch.zeros(shape, dtype=torch.int32, device=ray_d.device)
    t_max = torch.full(shape, cfg.t_max, **f32)
    eps_m = cfg.hit_eps * cfg.march_eps_scale

    for _ in range(cfg.max_steps):
        if not bool(active.any()):
            break
        p = ray_o + t[..., None] * ray_d
        f = field(p, noise, cfg.volumetric, cfg.warp_octaves)
        is_hit = active & (f < eps_m * t)
        advance = active & ~is_hit
        escape = advance & (p[..., 1] > env) & (dy >= 0.0)
        advance = advance & ~escape
        step = torch.clamp(cfg.step_relax * f, min=cfg.hit_eps)
        if cfg.step_floor_t > 0.0:
            step = torch.maximum(step, cfg.step_floor_t * t)
        t_new = torch.where(advance, t + step, torch.where(escape, t_max, t))
        prev_t = torch.where(advance, t, prev_t)
        t = torch.minimum(t_new, t_max)
        hit = hit | is_hit
        active = advance & (t_new < cfg.t_max)
        steps = steps + advance.to(torch.int32)

    # Bracketed safeguarded-Newton polish at hits: the bracket [prev_t, hi]
    # holds the crossing (hi is the first Newton estimate with 25% margin);
    # steps are clamped into the bracket, which tightens by sign.
    lo = prev_t
    hi = t_max
    x = t
    for k in range(cfg.newton_iters):
        p = ray_o + x[..., None] * ray_d
        f, grad = field_and_grad(p, noise, cfg.volumetric, cfg.warp_octaves)
        denom = torch.sum(grad * ray_d, dim=-1)
        down = torch.clamp(-denom, min=_BWD_DENOM_MIN)
        if k == 0:
            hi = x + torch.clamp(f, min=0.0) / down * 1.25 + cfg.hit_eps
        safe = torch.abs(denom) > _DENOM_EPS
        newton = x - torch.where(safe, f / torch.where(safe, denom, one), 0.0)
        lo = torch.where(f > 0.0, x, lo)
        hi = torch.where(f <= 0.0, x, hi)
        x_new = torch.minimum(torch.maximum(newton, lo), torch.clamp(hi, max=cfg.t_max))
        x = torch.where(hit & safe, torch.clamp(x_new, min=cfg.t_min), x)
    t = torch.where(hit, x, t)
    if cfg.march_eps_scale != 1.0:
        p = ray_o + t[..., None] * ray_d
        f_fin = field(p, noise, cfg.volumetric, cfg.warp_octaves)
        hit = hit & (f_fin < _RESIDUAL_SLACK * cfg.hit_eps * t)
    return t, hit, steps


def _noise_leaves(noise: NoiseParams) -> tuple[torch.Tensor, ...]:
    """The float tensors the heightfield reads, in ``_noise_view`` order."""
    return (noise.amplitudes, noise.lacunarity, noise.height_scale,
            noise.height_offset, noise.horizontal_scale)


def _noise_view(leaves, seed) -> types.SimpleNamespace:
    """Stand-in for ``NoiseParams`` over the given tensors (the field reads
    attributes only)."""
    amplitudes, lacunarity, height_scale, height_offset, horizontal_scale = leaves
    return types.SimpleNamespace(
        amplitudes=amplitudes, lacunarity=lacunarity, height_scale=height_scale,
        height_offset=height_offset, horizontal_scale=horizontal_scale, seed=seed,
    )


def _march_bwd_core(cfg: RenderConfig, ray_o, ray_d, leaves, seed, t, hit, ct_t):
    """Implicit-function VJP: cotangent on t -> (ō, d̄, noise leaf bars).

    At a hit, f(o + t·d; θ) = 0, so t̄ pulls back as ``scale`` =
    -t̄ / (∇f·d) through f itself: θ̄ = scale·∂f/∂θ, ō = scale·∇f,
    d̄ = scale·t·∇f. Only downward crossings are hits, so ∇f·d is clamped
    to at most -_BWD_DENOM_MIN and carries no gradient. Misses get none."""
    p = (ray_o + t[..., None] * ray_d).detach()
    with torch.enable_grad():
        req = [x.detach().requires_grad_() for x in leaves]
        f, grad_p = field_and_grad(p, _noise_view(req, seed), cfg.volumetric,
                                   cfg.warp_octaves)
        grad_p = grad_p.detach()
        denom = torch.clamp(torch.sum(grad_p * ray_d, dim=-1), max=-_BWD_DENOM_MIN)
        scale = torch.where(hit, -ct_t / denom, torch.zeros_like(ct_t))
        leaf_bars = torch.autograd.grad(f, req, grad_outputs=scale, allow_unused=True)
    o_bar = scale[..., None] * grad_p
    d_bar = (scale * t)[..., None] * grad_p
    return o_bar, d_bar, leaf_bars


class _March(torch.autograd.Function):
    """(t, hit) with the implicit-function backward. ``saved`` is None to
    march (from ``t0_prime`` when given), or a saved (t, hit) checkpoint to
    return as it is. The prime map and the checkpoint carry no gradient:
    they say where the march starts or ended, not where the surface is."""

    @staticmethod
    def forward(ctx, cfg, seed, t0_prime, saved, ray_o, ray_d, *leaves):
        if saved is None:
            t, hit, _ = _march_loop(cfg, ray_o, ray_d, _noise_view(leaves, seed),
                                    t0_prime)
        else:
            t, hit = saved[0].clone(), saved[1].clone()
        ctx.cfg, ctx.seed = cfg, seed
        ctx.save_for_backward(ray_o, ray_d, t, hit, *leaves)
        ctx.mark_non_differentiable(hit)
        return t, hit

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct_t, _ct_hit):
        ray_o, ray_d, t, hit, *leaves = ctx.saved_tensors
        o_bar, d_bar, leaf_bars = _march_bwd_core(
            ctx.cfg, ray_o, ray_d, leaves, ctx.seed, t, hit, ct_t
        )
        return (None, None, None, None, o_bar, d_bar, *leaf_bars)


def march(cfg: RenderConfig, ray_o, ray_d, noise: NoiseParams):
    """Differentiable sphere trace: (t, hit) per pixel."""
    return _March.apply(cfg, noise.seed, None, None, ray_o, ray_d,
                        *_noise_leaves(noise))


def march_primed(cfg: RenderConfig, ray_o, ray_d, noise: NoiseParams, t0_prime):
    """Depth-primed differentiable sphere trace from the coarse-pass prime
    map ``t0_prime``, which carries no gradient: the Newton polish finds the
    same root from any start outside the surface."""
    return _March.apply(cfg, noise.seed, t0_prime, None, ray_o, ray_d,
                        *_noise_leaves(noise))


def march_from_saved(cfg: RenderConfig, ray_o, ray_d, noise: NoiseParams,
                     t_saved, hit_saved):
    """Checkpoint-resume march: returns the saved (t, hit) (the per-pixel
    checkpoint of the trace kernel) without marching; its backward is the
    same implicit-function VJP as ``march``'s."""
    return _March.apply(cfg, noise.seed, None, (t_saved, hit_saved), ray_o, ray_d,
                        *_noise_leaves(noise))
