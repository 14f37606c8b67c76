"""The plain reference of the volumetric terrain: float32 PyTorch, one tensor
operation at a time, on any device.

The field is f(p) = p.y - h(p.x, p.z) - wa·fbm3(wf·p): the heightfield of
``terrain.py`` less a 3D fBm warp of amplitude wa ("noise.warp_amplitude")
at frequency wf ("noise.warp_frequency"), which gives overhangs. fbm3 sums
``warp_octaves`` octaves of 3D gradient noise, octave i at frequency 2^i
with weight 0.5^i, hashed with seed + 101 + i; 3D gradient noise hashes the
eight corners of its lattice cell to one of 12 cube-edge gradients, blends
their dot products with the quintic fade and scales by 1/√2. The envelope
gains |wa|·Σ 0.5^i; the normal is the whole field's gradient, while snow
still reads the heightfield's h.

It imports nothing of the program: the heightfield, the noise hash, the
camera, the rays, Adam and the tonemap come from ``terrain.py``, and this
file holds the warp and its own march, polish, prime, shade and fit that
call the volumetric field. Departures from the program, none of them in
what is computed: the 3D noise's value and gradient are sums over the eight
corners of product weights (the program blends by lerps along each axis),
and the gradient of the warp's value with respect to wa and wf, and the
normal's, are autograd's through these formulas (the program's backward
kernel evaluates the warp's Hessian by hand). Both round differently from
the program in the last bits.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import terrain as base

F32 = base.F32
_C2 = base._i32(0xC2B2AE35)
_INV_SQRT2 = 0.7071067811865476
_WARP_SEED_OFFSET = 101
_WARP_LACUNARITY = 2.0
_WARP_GAIN = 0.5


@dataclasses.dataclass(frozen=True)
class RenderSpec(base.RenderSpec):
    """``terrain.RenderSpec`` with the warp's octave count."""

    warp_octaves: int = 2


# --- 3D noise --------------------------------------------------------------


def _gradient3(h):
    """One of the 12 cube-edge directions (two components ±1, one 0): hash
    bits 4-5 pick the zero component (3 counts as 0), bits 0 and 1 the
    signs of the other two in axis order."""
    h = base._lsr(h, 16)
    zsel = (h >> 4) & 3
    zero = torch.where(zsel == 3, torch.zeros_like(zsel), zsel)
    s1 = ((h & 1) * 2 - 1).to(F32)
    s2 = (((h >> 1) & 1) * 2 - 1).to(F32)
    gx = torch.where(zero == 0, torch.zeros_like(s1), s1)
    gy = torch.where(zero == 1, torch.zeros_like(s1), torch.where(zero == 0, s1, s2))
    gz = torch.where(zero == 2, torch.zeros_like(s2), s2)
    return gx, gy, gz


def noise3(x, y, z, seed: int, derivs: bool):
    """3D gradient noise: value, and with ``derivs`` its d/dx, d/dy, d/dz.
    Corner c of the cell is (c & 1, c >> 1 & 1, c >> 2) along (x, y, z);
    its weight is the product over the axes of the fade u (corner at 1) or
    1 - u (corner at 0)."""
    p = (x, y, z)
    lo = [torch.floor(q) for q in p]
    frac = [q - q0 for q, q0 in zip(p, lo)]
    fade = [f * f * f * (f * (f * 6.0 - 15.0) + 10.0) for f in frac]
    dfade = [30.0 * f * f * (f * (f - 2.0) + 1.0) for f in frac]
    keys = (base._KX, base._KY, base._KZ)
    cell = sum(q0.to(torch.int32) * k for q0, k in zip(lo, keys)) + base._i32(seed * _C2)
    value = torch.zeros_like(x)
    grad = [torch.zeros_like(x) for _ in range(3)]
    for c in range(8):
        bits = (c & 1, (c >> 1) & 1, c >> 2)
        g = _gradient3(base._mix(cell + base._i32(sum(b * k for b, k in zip(bits, keys)))))
        dot = sum(g[a] * (frac[a] - bits[a]) for a in range(3))
        w = [fade[a] if bits[a] else 1.0 - fade[a] for a in range(3)]
        weight = w[0] * w[1] * w[2]
        value = value + weight * dot
        if derivs:
            for a in range(3):
                b, e = (k for k in range(3) if k != a)
                dw = dfade[a] if bits[a] else -dfade[a]
                grad[a] = grad[a] + dw * w[b] * w[e] * dot + weight * g[a]
    if not derivs:
        return value * _INV_SQRT2
    return (value * _INV_SQRT2, *(d * _INV_SQRT2 for d in grad))


def fbm3(x, y, z, octaves: int, seed: int, derivs: bool):
    """Σ_i 0.5^i · noise3(2^i · (x, y, z), seed + 101 + i); with ``derivs``
    also its gradient."""
    value = torch.zeros_like(x)
    grad = [torch.zeros_like(x) for _ in range(3)]
    freq, amp = 1.0, 1.0
    for i in range(octaves):
        out = noise3(x * freq, y * freq, z * freq, base._i32(seed + _WARP_SEED_OFFSET + i),
                     derivs)
        if derivs:
            n, *d = out
            grad = [g + amp * freq * di for g, di in zip(grad, d)]
        else:
            n = out
        value = value + amp * n
        freq, amp = freq * _WARP_LACUNARITY, amp * _WARP_GAIN
    return (value, *grad) if derivs else value


# --- field -----------------------------------------------------------------


def _warp_args(p, scene: dict, spec: RenderSpec):
    wf = scene["noise.warp_frequency"]
    return (p[..., 0] * wf, p[..., 1] * wf, p[..., 2] * wf, spec.warp_octaves,
            int(scene["noise.seed"]))


def field(p, scene: dict, spec: RenderSpec):
    """f(p) = p.y - h(p.x, p.z) - wa·fbm3(wf·p): above the terrain where
    positive."""
    return base.field(p, scene, spec) - scene["noise.warp_amplitude"] * fbm3(
        *_warp_args(p, scene, spec), False)


def field_grad(p, scene: dict, spec: RenderSpec):
    """(f, ∇f (..., 3), the heightfield's h) at p: the heightfield's
    gradient less wa·wf·∇fbm3."""
    f, grad, h = base.field_grad(p, scene, spec)
    n, nx, ny, nz = fbm3(*_warp_args(p, scene, spec), True)
    wa = scene["noise.warp_amplitude"]
    wawf = wa * scene["noise.warp_frequency"]
    return f - wa * n, grad - wawf * torch.stack([nx, ny, nz], dim=-1), h


def envelope(scene: dict, spec: RenderSpec):
    """No surface lies above this height: the heightfield's bound plus
    |wa|·Σ_i 0.5^i (every noise3 value is within ±1)."""
    tail = sum(_WARP_GAIN ** i for i in range(spec.warp_octaves))
    return base.envelope(scene, spec) + torch.abs(scene["noise.warp_amplitude"]) * tail


# --- march -----------------------------------------------------------------


def _march(o, d, scene, spec: RenderSpec, t_prime=None):
    """Sphere-trace every ray: (t, t before the last advance, hit, steps)."""
    oy, dy = o[..., 1], d[..., 1]
    env = envelope(scene, spec) + spec.hit_eps
    t_min = torch.full_like(dy, spec.t_min)
    t_max = torch.full_like(dy, spec.t_max)
    down = dy < 0.0
    enter = torch.clamp((env - oy) / torch.where(down, dy, torch.ones_like(dy)),
                        spec.t_min, spec.t_max)
    t = torch.where(oy > env, torch.where(down, enter, t_max), t_min)
    prev = t
    if t_prime is not None:
        t = torch.maximum(t, t_prime)
        prev = torch.clamp(t * base._PRIME_PULLBACK, min=spec.t_min)
    active = t < spec.t_max
    hit = torch.zeros_like(active)
    steps = torch.zeros(t.shape, dtype=torch.int64, device=t.device)
    for s in range(spec.max_steps):
        if s % spec.march_chunk == 0 and not bool(active.any()):
            break
        steps += active
        p = o + t[..., None] * d
        f = field(p, scene, spec)
        found = active & (f < spec.hit_eps * t)
        go = active & ~found
        escape = go & (p[..., 1] > env) & (dy >= 0.0)
        go = go & ~escape
        step = torch.maximum(torch.clamp(spec.step_relax * f, min=spec.hit_eps),
                             spec.step_floor_t * t)
        t_new = torch.where(escape, t_max, torch.minimum(torch.where(go, t + step, t), t_max))
        prev = torch.where(go, t, prev)
        hit = hit | found
        active = go & (t_new < spec.t_max)
        t = t_new
    return t, prev, hit, steps


def _polish(o, d, t, prev, hit, scene, spec: RenderSpec):
    """Bracketed, safeguarded Newton on f along the ray at the hits."""
    lo, x = prev, t
    hi = None
    for k in range(spec.newton_iters):
        f, grad, _ = field_grad(o + x[..., None] * d, scene, spec)
        slope = torch.sum(grad * d, dim=-1)
        if k == 0:
            hi = x + torch.clamp(f, min=0.0) / torch.clamp(-slope, min=base._DESCENT_MIN) \
                * 1.25 + spec.hit_eps
        safe = torch.abs(slope) > base._DENOM_EPS
        newton = x - torch.where(safe, f / torch.where(safe, slope, torch.ones_like(slope)),
                                 torch.zeros_like(f))
        lo = torch.where(f > 0.0, x, lo)
        hi = torch.where(f <= 0.0, x, hi)
        nxt = torch.minimum(torch.maximum(newton, lo), torch.clamp(hi, max=spec.t_max))
        x = torch.where(hit & safe, torch.clamp(nxt, min=spec.t_min), x)
    return torch.where(hit, x, t)


def _prime(scene, spec: RenderSpec, row0: float, rows: int):
    """The fine march's start map from the coarse pass over the band's
    coarse rows and one halo row above and below (``terrain._prime``'s
    rule): (map (rows, W), coarse steps, hits, pixels)."""
    ds = spec.prime_ds
    cs = spec.coarse()
    o, d = base.rays(scene, cs.height, cs.width, row0 / ds - 1.0, rows // ds + 2)
    t, prev, hit, steps = _march(o, d, scene, cs)
    t = _polish(o, d, t, prev, hit, scene, cs)
    inf = torch.full((t.shape[0], 1), math.inf, dtype=F32, device=t.device)
    padded = torch.cat([inf, t, inf], dim=1)
    w = t.shape[1]
    least = padded[:, 0:w]
    for k in (1, 2):
        least = torch.minimum(least, padded[:, k:k + w])
    least = torch.minimum(torch.minimum(least[:-2], least[1:-1]), least[2:])
    start = torch.where(least >= spec.t_max, torch.full_like(least, spec.t_max),
                        least * spec.prime_margin)
    start = torch.clamp(start, spec.t_min, spec.t_max)
    start = start.repeat_interleave(ds, dim=0).repeat_interleave(ds, dim=1)
    return start, int(steps.sum()), int(hit.sum()), t.numel()


# --- shading ---------------------------------------------------------------


def shade(o, d, t, hit, scene: dict, spec: RenderSpec):
    """Linear RGB (..., 3) as ``terrain.shade``, the normal from the whole
    field's gradient and the snow from the heightfield's h."""
    s = scene
    p = o + t[..., None] * d
    _, grad, h = field_grad(p, s, spec)
    normal = grad / torch.sqrt(torch.sum(grad * grad, dim=-1, keepdim=True) + 1e-12)
    sun = s["materials.sun_dir"] / torch.sqrt(torch.sum(s["materials.sun_dir"] ** 2) + 1e-12)
    up = torch.clamp(d[..., 1], 0.0, 1.0)[..., None]
    sky = s["materials.sky_horizon"] + (s["materials.sky_zenith"] - s["materials.sky_horizon"]) * up
    cos_sun = torch.clamp(torch.sum(d * sun, dim=-1), 0.0, 1.0)
    sky = sky + (0.25 * cos_sun ** 64 + 1.5 * cos_sun ** 512)[..., None] * s["materials.sun_color"]
    steep = base._smoothstep(0.85, 0.55, normal[..., 1])
    albedo = (s["materials.albedo_low"]
              + (s["materials.albedo_high"] - s["materials.albedo_low"]) * steep[..., None])
    snow = (base._smoothstep(s["materials.snow_height"], s["materials.snow_height"] + 1.0, h)
            * (1.0 - steep))
    albedo = albedo + (s["materials.snow_color"] - albedo) * snow[..., None]
    diffuse = torch.clamp(torch.sum(normal * sun, dim=-1), 0.0, 1.0)
    fill = 0.5 + 0.5 * normal[..., 1]
    surface = albedo * (s["materials.sun_color"] * diffuse[..., None]
                        + s["materials.ambient_color"] * fill[..., None])
    fog = (1.0 - torch.exp(-s["materials.fog_density"] * t))[..., None]
    surface = surface + (0.5 * (s["materials.fog_color"] + sky) - surface) * fog
    return torch.where(hit[..., None], surface, sky)


# --- frames ----------------------------------------------------------------


@torch.no_grad()
def trace(scene: dict, spec: RenderSpec, row0: float = 0.0,
          rows: int | None = None) -> base.Trace:
    """Rows [row0, row0 + rows) of the frame, primed when ``spec`` primes,
    with the work the march did (``terrain.Trace``)."""
    rows = spec.height if rows is None else rows
    o, d = base.rays(scene, spec.height, spec.width, row0, rows)
    prime, cs, ch, cp = None, 0, 0, 0
    if spec.prime_ds:
        prime, cs, ch, cp = _prime(scene, spec, row0, rows)
    t, prev, hit, steps = _march(o, d, scene, spec, prime)
    t = _polish(o, d, t, prev, hit, scene, spec)
    color = shade(o, d, t, hit, scene, spec)
    return base.Trace(color, t, hit, int(steps.sum()), int(hit.sum()), t.numel(), cs, ch, cp)


def render_grad(scene: dict, spec: RenderSpec, tr: base.Trace, row0: float = 0.0):
    """The colour of a traced band as a function of the scene's tensors,
    the hit distance moving by the implicit-function derivative
    (``terrain.render_grad`` on this field)."""
    o, d = base.rays(scene, spec.height, spec.width, row0, tr.t.shape[0])
    t_hit = tr.t.detach()
    p = o + t_hit[..., None] * d
    f = field(p, scene, spec)
    with torch.no_grad():
        _, grad, _ = field_grad(p, scene, spec)
        slope = torch.clamp(torch.sum(grad * d, dim=-1), max=-base._DESCENT_MIN)
    t = torch.where(tr.hit, t_hit - (f - f.detach()) / slope, t_hit)
    return shade(o, d, t, tr.hit, scene, spec)


def loss_and_grads(scene: dict, spec: RenderSpec, target: torch.Tensor, names,
                   block_rows: int | None = None):
    """Mean squared pixel error against ``target`` (H, W, 3) and its gradient
    by leaf ``names``, in blocks of ``block_rows`` rows: (loss, {name:
    grad})."""
    block = spec.height if block_rows is None else block_rows
    leaves = {n: scene[n].detach().clone().requires_grad_() for n in names}
    s = {**scene, **leaves}
    total = torch.zeros((), dtype=F32, device=target.device)
    grads = {n: torch.zeros_like(v) for n, v in leaves.items()}
    for row0 in range(0, spec.height, block):
        rows = min(block, spec.height - row0)
        tr = trace({k: v.detach() if torch.is_tensor(v) else v for k, v in s.items()},
                   spec, float(row0), rows)
        diff = render_grad(s, spec, tr, float(row0)) - target[row0:row0 + rows]
        part = torch.sum(diff * diff) / (spec.height * spec.width * 3)
        for n, g in zip(leaves, torch.autograd.grad(part, list(leaves.values()))):
            grads[n] += g
        total = total + part.detach()
    return total, grads


def frame(scene: dict, spec: RenderSpec, block_rows: int | None = None) -> torch.Tensor:
    """The whole frame's colour (H, W, 3), traced in blocks of ``block_rows``
    rows."""
    block = spec.height if block_rows is None else block_rows
    return torch.cat([trace(scene, spec, float(r0), min(block, spec.height - r0)).color
                      for r0 in range(0, spec.height, block)])


def fit(scene: dict, spec: RenderSpec, target: torch.Tensor, names, lr: float, steps: int,
        block_rows: int | None = None) -> dict:
    """``steps`` Adam steps (``terrain.Adam``) toward ``target`` on the
    leaves ``names``: each step's loss, the first gradient and each leaf's
    change."""
    adam = base.Adam({n: scene[n].clone() for n in names}, lr)
    losses, first = [], None
    for _ in range(steps):
        loss, grads = loss_and_grads({**scene, **adam.params}, spec, target, names, block_rows)
        losses.append(float(loss))
        first = grads if first is None else first
        adam.step(grads)
    return {"losses": losses, "grad": first,
            "change": {n: adam.params[n] - scene[n] for n in names}}
