"""Scene -> flat float32 scalar vector read by the trace kernel
(counterpart of ``gpgpuraytrace_tpu/utils/packing.py``, same offsets).

The camera basis is derived once per frame here; the kernel reads every
scene scalar from this vector, which stays on the device.
"""

from __future__ import annotations

import torch

from gpgpuraytrace_tpu_torch.models.scene import Scene
from gpgpuraytrace_tpu_torch.ops.camera import camera_basis

POS = 0  # 3: camera position
FWD = 3  # 3: camera forward
RIGHT = 6  # 3: camera right
UP = 9  # 3: camera up
TANFOV = 12  # tan(fov_y / 2)
ASPECT = 13  # width / height
LACUNARITY = 14
HEIGHT_SCALE = 15
HEIGHT_OFFSET = 16
HORIZONTAL_SCALE = 17
SUN_DIR = 18  # 3 (normalized)
SUN_COLOR = 21  # 3
AMBIENT = 24  # 3
ALBEDO_LOW = 27  # 3
ALBEDO_HIGH = 30  # 3
SNOW_COLOR = 33  # 3
SNOW_HEIGHT = 36
FOG_COLOR = 37  # 3
FOG_DENSITY = 40
SKY_ZENITH = 41  # 3
SKY_HORIZON = 44  # 3
ROW0 = 47  # first image row of this block (row-band offset)
WARP_AMP = 48  # volumetric 3D warp amplitude
WARP_FREQ = 49  # volumetric 3D warp base frequency
AMPS = 50  # num_octaves amplitudes


def pack_scene(scene: Scene, height: int, width: int, row0=0.0):
    """Returns (packed float32 (1, AMPS + octaves), seed int32 (1, 1)) on the
    scene's device. ``height``/``width`` are the full image dims; ``row0``
    is the first row of the block being rendered."""
    fwd, right, up = camera_basis(scene.camera)
    m = scene.materials
    n = scene.noise
    dev = m.sun_dir.device
    sun = m.sun_dir * torch.rsqrt(torch.sum(m.sun_dir * m.sun_dir) + 1e-12)

    def scalar(v):
        # Filled on the device: a host-to-device copy would sync the host and
        # is not allowed while a stream is capturing a CUDA graph.
        return torch.full((1,), v, dtype=torch.float32, device=dev)

    parts = [
        scene.camera.position, fwd, right, up,
        torch.tan(0.5 * scene.camera.fov_y), scalar(width / height),
        n.lacunarity, n.height_scale, n.height_offset, n.horizontal_scale,
        sun, m.sun_color, m.ambient_color, m.albedo_low, m.albedo_high,
        m.snow_color, m.snow_height, m.fog_color, m.fog_density,
        m.sky_zenith, m.sky_horizon,
        scalar(row0), n.warp_amplitude, n.warp_frequency, n.amplitudes,
    ]
    packed = torch.cat([p.to(torch.float32).reshape(-1) for p in parts])
    seed = n.seed.to(torch.int32).reshape(1, 1)
    return packed[None, :], seed
