"""Scene parameters as ``nn.Module``s, and the static ``RenderConfig``.

Counterpart of ``gpgpuraytrace_tpu/models/scene.py``. Every float scene
quantity is an ``nn.Parameter`` (0-d for scalars), the integer lattice seed an
int32 buffer, so ``scene.to(device)`` moves the whole scene and the dotted
names of ``named_parameters()`` / ``named_buffers()`` are the JAX package's
pytree leaf names (``noise.amplitudes``, ``camera.position``, ...).

Static facts (image size, march step counts, octave count) live in
``RenderConfig``, a frozen dataclass with the JAX package's fields, defaults
and resolution rules, with ``use_pallas`` renamed ``use_kernel``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

# Default march-chunk length of the chunked march; RenderConfig validates the
# effective chunk (march_chunk=0 means this value) against max_steps.
MARCH_CHUNK_DEFAULT = 8


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises
    (nothing falls back to the CPU: pass ``device="cpu"`` for that)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: CUDA is not available (no GPU, or a "
            f"CPU-only torch); pass device='cpu' to run on the CPU"
        )
    return device


def _param(value, device) -> nn.Parameter:
    return nn.Parameter(
        torch.as_tensor(np.array(value, np.float32), device=device)
    )


class NoiseParams(nn.Module):
    """Terrain field parameters; ``amplitudes`` are the per-octave fBm
    weights. ``warp_*`` drive the volumetric mode."""

    def __init__(
        self,
        amplitudes,
        lacunarity,
        height_scale,
        height_offset,
        horizontal_scale,
        seed=7,
        warp_amplitude=0.0,
        warp_frequency=0.25,
        device="cuda",
    ):
        super().__init__()
        device = check_device(device)
        self.amplitudes = _param(amplitudes, device)
        self.lacunarity = _param(lacunarity, device)
        self.height_scale = _param(height_scale, device)
        self.height_offset = _param(height_offset, device)
        self.horizontal_scale = _param(horizontal_scale, device)
        self.register_buffer(
            "seed", torch.as_tensor(np.array(seed, np.int32), device=device)
        )
        self.warp_amplitude = _param(warp_amplitude, device)
        self.warp_frequency = _param(warp_frequency, device)


class Camera(nn.Module):
    """Flythrough camera: position (3,), yaw, pitch, vertical fov (radians)."""

    def __init__(self, position, yaw, pitch, fov_y, device="cuda"):
        super().__init__()
        device = check_device(device)
        self.position = _param(position, device)
        self.yaw = _param(yaw, device)
        self.pitch = _param(pitch, device)
        self.fov_y = _param(fov_y, device)


MATERIAL_FIELDS = (
    "sun_dir", "sun_color", "ambient_color", "albedo_low", "albedo_high",
    "snow_color", "snow_height", "fog_color", "fog_density", "sky_zenith",
    "sky_horizon",
)


class Materials(nn.Module):
    """Lighting, material and atmosphere constants (see MATERIAL_FIELDS)."""

    def __init__(self, device="cuda", **values):
        super().__init__()
        device = check_device(device)
        if set(values) != set(MATERIAL_FIELDS):
            raise ValueError(
                f"Materials needs exactly {MATERIAL_FIELDS}, got {sorted(values)}"
            )
        for name in MATERIAL_FIELDS:
            setattr(self, name, _param(values[name], device))


class Scene(nn.Module):
    """Full parameter set: params -> image is a pure function of it."""

    def __init__(self, noise: NoiseParams, camera: Camera, materials: Materials):
        super().__init__()
        self.noise = noise
        self.camera = camera
        self.materials = materials


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings, hashable. Same fields, defaults and
    ``__post_init__`` resolution as the JAX package's ``RenderConfig``
    (``gpgpuraytrace_tpu/models/scene.py``, where each field's measured
    rationale is written down), except: ``use_pallas`` is ``use_kernel``
    (the hand-written CUDA kernels vs the plain PyTorch path),
    ``pallas_bwd`` is ``kernel_bwd`` (the kernel path's backward: True runs
    the fused backward kernel, False autograd through the plain re-shade at
    the saved hit distances), and ``interpret`` does not exist.

    The kernel path runs ``march_mode`` "chunked", "fixed", "lod" and
    "compact" (two-phase ray compaction, phase 1 marching
    ``compact_budget`` steps), each with or without ``march_bf16``, on the
    heightfield and on the volumetric terrain (``warp_octaves`` in 1..8).
    The plain op-by-op path
    (``use_kernel=False``) marches chunked in float32 whatever these say, as
    the JAX package's XLA path does. ``fixed``, ``lod`` and ``compact``
    frames are unprimed (no coarse pass): ``prime_ds`` resolves to 0 for
    them. ``tile_h`` is the TPU kernel's tile height, kept so configs carry
    across and for ``kernels/trace.py:tile_steps``; the CUDA kernel runs one
    thread per pixel.
    """

    height: int = 512
    width: int = 512
    max_steps: int = 128
    t_min: float = 0.05
    t_max: float = 200.0
    hit_eps: float = 1e-3  # hit when f(p) < hit_eps * t
    step_relax: float | None = None  # None: 1.0 heightfield, 0.9 volumetric
    num_octaves: int = 6
    use_kernel: bool = True
    kernel_bwd: bool = True
    march_mode: str = "chunked"  # "chunked" | "fixed" | "lod" | "compact"
    volumetric: bool = False
    warp_octaves: int = 2
    tile_h: int = 16
    newton_iters: int = 3
    compact_budget: int = 32
    march_chunk: int = 8
    march_eps_scale: float = 1.0
    step_floor_t: float = 4e-3
    prime_ds: int | None = None  # None: 8 when eligible, else 0
    prime_margin: float = 0.95
    supersample: int = 1
    march_bf16: bool = False

    def __post_init__(self) -> None:
        if self.step_relax is None:
            object.__setattr__(
                self, "step_relax", 0.9 if self.volumetric else 1.0
            )
        if self.march_chunk < 0:
            raise ValueError(f"march_chunk={self.march_chunk} must be >= 0")
        if self.newton_iters < 1:
            raise ValueError(
                f"newton_iters={self.newton_iters} must be >= 1 (the march "
                f"always runs one polish pass; use march_eps_scale for "
                f"preview-quality speed instead)"
            )
        effective_chunk = self.march_chunk or MARCH_CHUNK_DEFAULT
        chunked = self.use_kernel and self.march_mode in (
            "chunked", "lod", "compact",
        )
        if chunked and self.max_steps % effective_chunk != 0:
            raise ValueError(
                f"march_chunk={self.march_chunk} (effective "
                f"{effective_chunk}) must divide max_steps={self.max_steps} "
                f"(the chunked march runs whole chunks; a remainder would "
                f"exceed max_steps)"
            )
        if self.prime_ds is None:
            ds = 8
            eligible = (
                self.height % ds == 0
                and self.width % ds == 0
                and self.height >= 8 * ds
                and self.width >= 8 * ds
            )
            object.__setattr__(self, "prime_ds", ds if eligible else 0)
        if self.prime_ds and self.march_mode != "chunked":
            # Non-chunked modes own their march-start logic; resolve to off
            # so dataclasses.replace(cfg, march_mode=...) keeps working.
            object.__setattr__(self, "prime_ds", 0)
        if self.prime_ds:
            if self.prime_ds < 2:
                raise ValueError(
                    f"prime_ds={self.prime_ds} must be 0 (off) or >= 2"
                )
            if self.height % self.prime_ds or self.width % self.prime_ds:
                raise ValueError(
                    f"prime_ds={self.prime_ds} must divide height="
                    f"{self.height} and width={self.width} (the coarse "
                    f"prime image upsamples by integer repeat)"
                )
            if not (0.0 < self.prime_margin <= 1.0):
                raise ValueError(
                    f"prime_margin={self.prime_margin} must be in (0, 1]"
                )
        if self.use_kernel and self.march_mode == "compact":
            b = self.compact_budget
            if not (0 < b < self.max_steps) or b % effective_chunk != 0:
                raise ValueError(
                    f"compact_budget={b} must be a whole number of "
                    f"march chunks ({effective_chunk}) in (0, "
                    f"max_steps={self.max_steps})"
                )


def default_scene(
    num_octaves: int = 6, volumetric: bool = False, device="cuda"
) -> Scene:
    """The canonical terrain scene (same values as the JAX package's
    ``default_scene``); ``device`` places every parameter: the card by
    default, which raises without CUDA (pass ``device="cpu"``)."""
    amps = np.asarray([0.5 ** i for i in range(num_octaves)], np.float32)
    noise = NoiseParams(
        amplitudes=amps,
        lacunarity=2.0,
        height_scale=6.0,
        height_offset=0.0,
        horizontal_scale=0.05,
        seed=7,
        warp_amplitude=1.2 if volumetric else 0.0,
        warp_frequency=0.3,
        device=device,
    )
    camera = Camera(
        position=[0.0, 8.0, -14.0],
        yaw=0.0,
        pitch=-0.28,
        fov_y=1.0471976,  # 60 degrees
        device=device,
    )
    materials = Materials(
        device=device,
        sun_dir=[0.45, 0.6, 0.25],
        sun_color=[1.0, 0.92, 0.78],
        ambient_color=[0.18, 0.22, 0.30],
        albedo_low=[0.22, 0.34, 0.14],
        albedo_high=[0.38, 0.34, 0.30],
        snow_color=[0.92, 0.94, 0.98],
        snow_height=4.0,
        fog_color=[0.62, 0.68, 0.80],
        fog_density=0.012,
        sky_zenith=[0.20, 0.38, 0.72],
        sky_horizon=[0.72, 0.80, 0.92],
    )
    return Scene(noise=noise, camera=camera, materials=materials)
