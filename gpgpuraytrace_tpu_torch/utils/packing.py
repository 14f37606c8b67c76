"""Scene -> flat float32 scalar vector read by the trace kernel
(counterpart of ``gpgpuraytrace_tpu/utils/packing.py``, same offsets).

The trace kernels read every scene scalar from this vector, a row per frame.
On the card the rows are packed by a kernel (``kernels/pack.py``, from
``csrc/pack.cu``), which derives each frame's camera basis, ``tan(fov/2)``
and the normalised sun direction on the device and pulls the rows' cotangent
back onto the leaves. The functions here are that kernel's plain version and
run on CPU tensors only: a leaf on another device raises. ``pack_scenes``
packs one scene for a batch of cameras, or for one camera over several row
blocks (a row-band rank's interleaved stripes): a row per frame.
"""

from __future__ import annotations

import operator

import torch

from gpgpuraytrace_tpu_torch.models.scene import Camera, Scene
from gpgpuraytrace_tpu_torch.ops.camera import Cameras, camera_basis
from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES

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


def row0s(row0) -> tuple[float, ...]:
    """The first rows of the row blocks being rendered, as floats: one
    (``row0`` a number), which every frame of a batch shares, or one per
    frame (``row0`` a sequence: a row-band rank's stripes of one camera).
    Every layer that takes a ``row0`` reads it through this."""
    return tuple(float(r) for r in row0) if isinstance(row0, (tuple, list)) else (float(row0),)


def row_blocks(row0, local_height: int | None, height: int) -> tuple[tuple[float, ...], int]:
    """(the blocks' first rows, the rows of each) of ``local_height`` rows
    (default ``height``, the whole frame) rendered from ``row0``: one block,
    or the stripes of a sequence of first rows, which split them evenly."""
    rows = row0s(row0)
    h = height if local_height is None else local_height
    if h % len(rows):
        raise ValueError(f"{h} rows do not split evenly into {len(rows)} stripes")
    return rows, h // len(rows)


def pack_scene(scene: Scene, height: int, width: int, row0=0.0):
    """Returns (packed float32 (1, AMPS + octaves), seed int32 (1, 1)) on the
    scene's device. ``height``/``width`` are the full image dims; ``row0``
    is the first row of the block being rendered."""
    packed, seed = pack_scenes(scene, scene.camera, height, width, row0)
    return packed[None, :], seed


def pack_scenes(scene: Scene, cameras: Camera | Cameras, height: int, width: int,
                row0=0.0):
    """``pack_scene`` of ``scene`` seen from each camera of ``cameras``:
    (packed float32 (B, AMPS + octaves), seed int32 (1, 1)) for a batch of B
    cameras, row b bit for bit ``pack_scene`` of the scene with frame b's
    camera (the camera columns are computed for all frames at once, entry by
    entry as for one; the scene's other scalars are packed once); a single
    ``Camera`` gives (AMPS + octaves,). ``row0`` is one first row for every
    frame, or a sequence of B, frame b's block starting at row ``row0[b]``
    (with a single ``Camera``: B rows of the one camera)."""
    leaves = [cameras.position, cameras.yaw, cameras.pitch, cameras.fov_y]
    leaves += [operator.attrgetter(name)(scene) for name in LEAF_NAMES
               if not name.startswith("camera.")]
    if any(x.device.type != "cpu" for x in leaves):
        raise ValueError("utils/packing.py packs CPU tensors only; a CUDA scene packs with "
                         "kernels/pack.py's pack_frames, pack_scene or pack_scenes")
    return _pack_scenes(scene, cameras, height, width, row0)


def _pack_scenes(scene: Scene, cameras: Camera | Cameras, height: int, width: int, row0):
    """``pack_scenes``' arithmetic, op by op on the leaves' device; the port
    packs CUDA leaves with the kernel, which tests/test_torch_cuda.py holds
    to this on the card bit for bit."""
    fwd, right, up = camera_basis(cameras)
    tan = torch.tan(0.5 * cameras.fov_y)
    per_frame = row0s(row0)
    rows = (len(per_frame),) if len(per_frame) > 1 else ()
    lead = torch.broadcast_shapes(cameras.position.shape[:-1], fwd.shape[:-1], tan.shape, rows)
    cam = [x.to(torch.float32).expand(*lead, 3)
           for x in (cameras.position, fwd, right, up)]
    cam.append(tan.to(torch.float32).expand(lead)[..., None])
    m = scene.materials
    n = scene.noise
    dev = m.sun_dir.device
    sun = m.sun_dir * torch.rsqrt(torch.sum(m.sun_dir * m.sun_dir) + 1e-12)

    def scalar(v):
        # Filled on the device: a host-to-device copy would sync the host and
        # is not allowed while a stream is capturing a CUDA graph.
        return torch.full((1,), v, dtype=torch.float32, device=dev)

    parts = [
        scalar(width / height),
        n.lacunarity, n.height_scale, n.height_offset, n.horizontal_scale,
        sun, m.sun_color, m.ambient_color, m.albedo_low, m.albedo_high,
        m.snow_color, m.snow_height, m.fog_color, m.fog_density,
        m.sky_zenith, m.sky_horizon,
        scalar(0.0), n.warp_amplitude, n.warp_frequency, n.amplitudes,
    ]
    rest = torch.cat([p.to(torch.float32).reshape(-1) for p in parts])
    packed = torch.cat([*cam, rest.expand(*lead, -1)], dim=-1)
    # Each frame's first row (or the one they share), filled as the scalars are.
    packed[..., ROW0] = torch.cat([scalar(r) for r in per_frame])
    seed = n.seed.to(torch.int32).reshape(1, 1)
    return packed, seed
