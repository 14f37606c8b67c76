"""The plain reference of the terrain ray-marcher: float32 PyTorch, one
tensor operation at a time, on any device.

It imports nothing of the program. It was written from the same
definitions the program implements (the lattice hash and gradient noise,
the fBm heightfield, the depth-primed sphere-trace march with its bracketed
Newton polish, Lambert shading with sky and fog, Reinhard tonemap and the
uint8 quantize) and is kept frozen here, so that a change to the program is
judged against a fixed yardstick.

A scene is a dict of float32 tensors keyed by the program's dotted leaf
names ("noise.amplitudes", "camera.yaw", ...) plus the int "noise.seed". A
render config is a plain dict (``RenderSpec``).

The gradient is autograd's: the march runs without a graph, and the hit
distance re-enters it as t = t_hit - (f - stop_grad(f)) / stop_grad(∇f·d),
the implicit-function derivative of f(o + t·d; θ) = 0 at the hit, so the
colour's gradient flows through shading and through where the ray ends.
"""

from __future__ import annotations

import dataclasses
import math

import torch

F32 = torch.float32


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


_C1 = _i32(0x85EBCA6B)
_KX = _i32(0x8DA6B343)
_KZ = _i32(0xD8163841)
_KY = _i32(0xCB1AB31F)
_KXZ = _i32(_KX + _KZ)
_INV_SQRT5 = 0.4472135954999579
_OCTAVE_ROT = 2.3999632297286535
_PRIME_PULLBACK = 0.9
_DENOM_EPS = 1e-4
_DESCENT_MIN = 1e-2


@dataclasses.dataclass(frozen=True)
class RenderSpec:
    """What a frame is: its size, the march and the depth prime."""

    height: int
    width: int
    num_octaves: int = 6
    max_steps: int = 128
    t_min: float = 0.05
    t_max: float = 200.0
    hit_eps: float = 1e-3
    step_relax: float = 1.0
    step_floor_t: float = 4e-3
    march_chunk: int = 8
    newton_iters: int = 3
    prime_ds: int = 8
    prime_margin: float = 0.95

    def coarse(self) -> "RenderSpec":
        """The depth prime's coarse pass: 1/ds of each side, one Newton
        iteration, the step floor ds times wider, itself unprimed."""
        ds = self.prime_ds
        return dataclasses.replace(self, height=self.height // ds, width=self.width // ds,
                                   prime_ds=0, newton_iters=1,
                                   step_floor_t=self.step_floor_t * ds)


# --- noise ---------------------------------------------------------------


def _lsr(h, k):
    return (h >> k) & ((1 << (32 - k)) - 1)


def _mix(h):
    h = h ^ _lsr(h, 16)
    return h * _C1


def _gradient(h):
    """One of 8 directions (±1, ±2) or (±2, ±1) from a corner hash."""
    h = _lsr(h, 16)
    s1 = ((h & 1) * 2 - 1).to(F32)
    s2 = (((h >> 1) & 1) * 2 - 1).to(F32)
    c = ((h >> 2) & 1).to(F32)
    return s1 * (1.0 + c), s2 * (2.0 - c)


def _noise2(x, z, seed, derivs: bool):
    """2D gradient noise with a quintic fade: value, and with ``derivs``
    its d/dx and d/dz."""
    x0, z0 = torch.floor(x), torch.floor(z)
    fx, fz = x - x0, z - z0
    base = x0.to(torch.int32) * _KX + z0.to(torch.int32) * _KZ + _i32(seed * _KY)
    g = [_gradient(_mix(base + k)) for k in (0, _KX, _KZ, _KXZ)]
    (ax, az), (bx, bz), (cx, cz), (dx, dz) = g
    n00 = ax * fx + az * fz
    n10 = bx * (fx - 1.0) + bz * fz
    n01 = cx * fx + cz * (fz - 1.0)
    n11 = dx * (fx - 1.0) + dz * (fz - 1.0)
    u = fx * fx * fx * (fx * (fx * 6.0 - 15.0) + 10.0)
    v = fz * fz * fz * (fz * (fz * 6.0 - 15.0) + 10.0)
    k1, k2, k3 = n10 - n00, n01 - n00, n00 - n10 - n01 + n11
    value = (n00 + u * k1 + v * k2 + u * v * k3) * _INV_SQRT5
    if not derivs:
        return value
    du = 30.0 * fx * fx * (fx * (fx - 2.0) + 1.0)
    dv = 30.0 * fz * fz * (fz * (fz - 2.0) + 1.0)
    gx = ax + u * (bx - ax) + v * (cx - ax) + u * v * (ax - bx - cx + dx)
    gz = az + u * (bz - az) + v * (cz - az) + u * v * (az - bz - cz + dz)
    return (value, (gx + du * (k1 + k3 * v)) * _INV_SQRT5,
            (gz + dv * (k2 + k3 * u)) * _INV_SQRT5)


def fbm(x, z, scene: dict, num_octaves: int, derivs: bool):
    """Σ_i amp_i · noise2(R_i (x, z) · lacunarity^i, seed + i), R_i a
    rotation by i golden angles; with ``derivs`` also d/dx and d/dz."""
    amps = scene["noise.amplitudes"]
    lac = scene["noise.lacunarity"]
    seed = int(scene["noise.seed"])
    value = torch.zeros_like(x)
    ddx = torch.zeros_like(x)
    ddz = torch.zeros_like(x)
    freq = torch.ones((), dtype=F32, device=x.device)
    for i in range(num_octaves):
        c, s = math.cos(_OCTAVE_ROT * i), math.sin(_OCTAVE_ROT * i)
        cf, sf = c * freq, s * freq
        out = _noise2(cf * x - sf * z, sf * x + cf * z, _i32(seed + i), derivs)
        if derivs:
            n, nx, nz = out
            ddx = ddx + amps[i] * freq * (c * nx + s * nz)
            ddz = ddz + amps[i] * freq * (-s * nx + c * nz)
        else:
            n = out
        value = value + amps[i] * n
        freq = freq * lac
    return (value, ddx, ddz) if derivs else value


# --- field -----------------------------------------------------------------


def field(p, scene: dict, spec: RenderSpec):
    """f(p) = p.y - h(p.x, p.z): above the terrain where positive."""
    hs = scene["noise.horizontal_scale"]
    n = fbm(p[..., 0] * hs, p[..., 2] * hs, scene, spec.num_octaves, False)
    return p[..., 1] - (scene["noise.height_offset"] + scene["noise.height_scale"] * n)


def field_grad(p, scene: dict, spec: RenderSpec):
    """(f, ∇f (..., 3), terrain height h) at p."""
    hs = scene["noise.horizontal_scale"]
    scale = scene["noise.height_scale"]
    n, nx, nz = fbm(p[..., 0] * hs, p[..., 2] * hs, scene, spec.num_octaves, True)
    h = scene["noise.height_offset"] + scale * n
    grad = torch.stack([-scale * hs * nx, torch.ones_like(h), -scale * hs * nz], dim=-1)
    return p[..., 1] - h, grad, h


def envelope(scene: dict, spec: RenderSpec):
    """No surface lies above this height (every octave is within ±1)."""
    return (scene["noise.height_offset"] + torch.abs(scene["noise.height_scale"])
            * torch.sum(torch.abs(scene["noise.amplitudes"][:spec.num_octaves])))


# --- camera ----------------------------------------------------------------


def camera_basis(yaw, pitch):
    """(forward, right, up) of a camera, world up +y."""
    cy, sy, cp, sp = torch.cos(yaw), torch.sin(yaw), torch.cos(pitch), torch.sin(pitch)
    forward = torch.stack([sy * cp, sp, cy * cp])
    right = torch.stack([cy, torch.zeros_like(cy), -sy])
    up = torch.linalg.cross(forward, right)
    return forward, right, up


def rays(scene: dict, height: int, width: int, row0: float, rows: int):
    """Origins and unit directions (rows, width, 3) of pixel centres of
    rows [row0, row0 + rows) of a height x width frame."""
    dev = scene["camera.position"].device
    r = torch.arange(rows, dtype=F32, device=dev) + row0
    c = torch.arange(width, dtype=F32, device=dev)
    ndc_y = -((r + 0.5) / height * 2.0 - 1.0)
    ndc_x = (c + 0.5) / width * 2.0 - 1.0
    forward, right, up = camera_basis(scene["camera.yaw"], scene["camera.pitch"])
    tan = torch.tan(0.5 * scene["camera.fov_y"])
    d = (forward + (tan * (width / height) * ndc_x)[None, :, None] * right
         + (tan * ndc_y)[:, None, None] * up)
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    o = scene["camera.position"].expand(rows, width, 3)
    return o, d


# --- march -----------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """A traced band: colour (h, W, 3), polished t, hit mask, and the work
    the march did: useful steps per pixel summed (a step runs while the
    pixel is still marching, the one that finds its hit or escape
    included) and the hits polished, for the fine pass and the coarse
    pass that primed it."""

    color: torch.Tensor
    t: torch.Tensor
    hit: torch.Tensor
    steps: int = 0
    hits: int = 0
    pixels: int = 0
    coarse_steps: int = 0
    coarse_hits: int = 0
    coarse_pixels: int = 0


def _march(o, d, scene, spec: RenderSpec, t_prime=None):
    """Sphere-trace every ray: (t, t before the last advance, hit, steps)."""
    oy, dy = o[..., 1], d[..., 1]
    env = envelope(scene, spec) + spec.hit_eps
    t_min = torch.full_like(dy, spec.t_min)
    t_max = torch.full_like(dy, spec.t_max)
    down = dy < 0.0
    enter = torch.clamp((env - oy) / torch.where(down, dy, torch.ones_like(dy)),
                        spec.t_min, spec.t_max)
    above = oy > env
    t = torch.where(above, torch.where(down, enter, t_max), t_min)
    prev = t
    if t_prime is not None:
        t = torch.maximum(t, t_prime)
        prev = torch.clamp(t * _PRIME_PULLBACK, min=spec.t_min)
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
            hi = x + torch.clamp(f, min=0.0) / torch.clamp(-slope, min=_DESCENT_MIN) * 1.25 \
                + spec.hit_eps
        safe = torch.abs(slope) > _DENOM_EPS
        newton = x - torch.where(safe, f / torch.where(safe, slope, torch.ones_like(slope)),
                                 torch.zeros_like(f))
        lo = torch.where(f > 0.0, x, lo)
        hi = torch.where(f <= 0.0, x, hi)
        nxt = torch.minimum(torch.maximum(newton, lo), torch.clamp(hi, max=spec.t_max))
        x = torch.where(hit & safe, torch.clamp(nxt, min=spec.t_min), x)
    return torch.where(hit, x, t)


def _prime(scene, spec: RenderSpec, row0: float, rows: int):
    """The fine march's start map from the coarse pass over the band's
    coarse rows and one halo row above and below: each pixel starts at
    prime_margin x the least t of its 3x3 coarse neighbourhood, or at t_max
    where all of it missed. Returns (map (rows, W), coarse steps, hits,
    pixels)."""
    ds = spec.prime_ds
    cs = spec.coarse()
    o, d = rays(scene, cs.height, cs.width, row0 / ds - 1.0, rows // ds + 2)
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


def _smoothstep(lo, hi, x):
    u = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    return u * u * (3.0 - 2.0 * u)


def shade(o, d, t, hit, scene: dict, spec: RenderSpec):
    """Linear RGB (..., 3): the terrain lit by the sun and the sky's fill,
    fogged toward the sky with distance, or the sky where the ray missed."""
    s = scene
    p = o + t[..., None] * d
    _, grad, h = field_grad(p, s, spec)
    normal = grad / torch.sqrt(torch.sum(grad * grad, dim=-1, keepdim=True) + 1e-12)
    sun = s["materials.sun_dir"] / torch.sqrt(torch.sum(s["materials.sun_dir"] ** 2) + 1e-12)
    up = torch.clamp(d[..., 1], 0.0, 1.0)[..., None]
    sky = s["materials.sky_horizon"] + (s["materials.sky_zenith"] - s["materials.sky_horizon"]) * up
    cos_sun = torch.clamp(torch.sum(d * sun, dim=-1), 0.0, 1.0)
    sky = sky + (0.25 * cos_sun ** 64 + 1.5 * cos_sun ** 512)[..., None] * s["materials.sun_color"]
    steep = _smoothstep(0.85, 0.55, normal[..., 1])
    albedo = (s["materials.albedo_low"]
              + (s["materials.albedo_high"] - s["materials.albedo_low"]) * steep[..., None])
    snow = (_smoothstep(s["materials.snow_height"], s["materials.snow_height"] + 1.0, h)
            * (1.0 - steep))
    albedo = albedo + (s["materials.snow_color"] - albedo) * snow[..., None]
    diffuse = torch.clamp(torch.sum(normal * sun, dim=-1), 0.0, 1.0)
    fill = 0.5 + 0.5 * normal[..., 1]
    surface = albedo * (s["materials.sun_color"] * diffuse[..., None]
                        + s["materials.ambient_color"] * fill[..., None])
    fog = (1.0 - torch.exp(-s["materials.fog_density"] * t))[..., None]
    surface = surface + (0.5 * (s["materials.fog_color"] + sky) - surface) * fog
    return torch.where(hit[..., None], surface, sky)


def tonemap(color):
    """Reinhard, then display gamma 1 / 2.2."""
    return torch.clamp(color / (1.0 + color), 0.0, 1.0) ** (1.0 / 2.2)


def quantize(color):
    """Linear RGB to display uint8: tonemap, x 255, round half up."""
    return (torch.clamp(tonemap(color), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


# --- frames ----------------------------------------------------------------


@torch.no_grad()
def trace(scene: dict, spec: RenderSpec, row0: float = 0.0, rows: int | None = None) -> Trace:
    """Rows [row0, row0 + rows) of the frame, primed when ``spec`` primes."""
    rows = spec.height if rows is None else rows
    o, d = rays(scene, spec.height, spec.width, row0, rows)
    prime, cs, ch, cp = None, 0, 0, 0
    if spec.prime_ds:
        prime, cs, ch, cp = _prime(scene, spec, row0, rows)
    t, prev, hit, steps = _march(o, d, scene, spec, prime)
    t = _polish(o, d, t, prev, hit, scene, spec)
    color = shade(o, d, t, hit, scene, spec)
    return Trace(color, t, hit, int(steps.sum()), int(hit.sum()), t.numel(), cs, ch, cp)


def render_grad(scene: dict, spec: RenderSpec, tr: Trace, row0: float = 0.0):
    """The colour of a traced band as a function of the scene's tensors
    (those that require grad carry it): shading at the traced hit, with the
    hit distance moving by the implicit-function derivative."""
    rows = tr.t.shape[0]
    o, d = rays(scene, spec.height, spec.width, row0, rows)
    t_hit = tr.t.detach()
    p = o + t_hit[..., None] * d
    f = field(p, scene, spec)
    with torch.no_grad():
        _, grad, _ = field_grad(p, scene, spec)
        slope = torch.clamp(torch.sum(grad * d, dim=-1), max=-_DESCENT_MIN)
    t = torch.where(tr.hit, t_hit - (f - f.detach()) / slope, t_hit)
    return shade(o, d, t, tr.hit, scene, spec)


def loss_and_grads(scene: dict, spec: RenderSpec, target: torch.Tensor, names,
                   block_rows: int | None = None):
    """Mean squared pixel error of the render against ``target`` (H, W, 3)
    and its gradient with respect to the leaves ``names``, in blocks of
    ``block_rows`` rows (whole coarse rows when primed) so that a large frame
    fits: (loss, {name: grad})."""
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


def flythrough_camera(scene: dict, time_s: torch.Tensor) -> dict:
    """The scene with its camera moved along the fly path to ``time_s``:
    drift (2 sin 0.15t, 0.8 sin 0.23t, 3t) and a yaw sweep 0.12 sin 0.2t."""
    t = time_s.to(F32)
    offset = torch.stack([2.0 * torch.sin(0.15 * t), 0.8 * torch.sin(0.23 * t), 3.0 * t])
    return {**scene, "camera.position": scene["camera.position"] + offset,
            "camera.yaw": scene["camera.yaw"] + 0.12 * torch.sin(0.2 * t)}


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) on a dict of
    tensors."""

    def __init__(self, params: dict, lr: float):
        self.params, self.lr, self.n = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, grads: dict) -> None:
        self.n += 1
        c1, c2 = 1.0 - 0.9 ** self.n, 1.0 - 0.999 ** self.n
        for k, g in grads.items():
            self.m[k] = 0.9 * self.m[k] + 0.1 * g
            self.v[k] = 0.999 * self.v[k] + 0.001 * g * g
            m_hat, v_hat = self.m[k] / c1, self.v[k] / c2
            self.params[k] = self.params[k] - self.lr * m_hat / (torch.sqrt(v_hat) + 1e-8)


def frame(scene: dict, spec: RenderSpec, block_rows: int | None = None) -> torch.Tensor:
    """The whole frame's colour (H, W, 3), traced in blocks of ``block_rows``
    rows (whole coarse rows when primed)."""
    block = spec.height if block_rows is None else block_rows
    return torch.cat([trace(scene, spec, float(r0), min(block, spec.height - r0)).color
                      for r0 in range(0, spec.height, block)])


def fit(scene: dict, spec: RenderSpec, target: torch.Tensor, names, lr: float, steps: int,
        block_rows: int | None = None) -> dict:
    """``steps`` Adam steps of the fit toward ``target`` on the leaves
    ``names``: each step's loss, the first gradient and each leaf's change."""
    adam = Adam({n: scene[n].clone() for n in names}, lr)
    losses, first = [], None
    for _ in range(steps):
        loss, grads = loss_and_grads({**scene, **adam.params}, spec, target, names, block_rows)
        losses.append(float(loss))
        first = grads if first is None else first
        adam.step(grads)
    return {"losses": losses, "grad": first,
            "change": {n: adam.params[n] - scene[n] for n in names}}
