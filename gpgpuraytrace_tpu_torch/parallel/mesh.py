"""Row bands over a process group (counterpart of
``gpgpuraytrace_tpu/parallel/mesh.py``).

The frame's rows split evenly over every rank of one ``torch.distributed``
group, h = height / world size rows each. ``band`` is the contiguous split
the JAX package uses: rank r's rows [r·h, (r + 1)·h). A rank of the port
renders its h rows as interleaved stripes instead (``stripes``): the frame
cut into stripes of S rows, dealt round-robin, rank r taking stripes r,
r + N, r + 2N, ... of N ranks. A camera that looks at the horizon puts sky
in the top rows and the longest marches just below the horizon; with one
contiguous band each, the rank that holds the horizon sets every step's
time, while every rank's stripes sample the whole frame, and keep doing so
as a trained camera moves. S comes from the shape alone (``stripe_rows``);
a rank of few rows keeps one stripe, its band. Scene parameters are
replicated; parameter gradients are summed with ``all_reduce``
(``parallel/sharded.py``). The group runs NCCL for CUDA ranks and gloo on
the CPU. NCCL puts one rank on each card: a rank binds the card of its
``LOCAL_RANK`` (``rank_device``), so a machine with one card runs a group of
world size 1.
"""

from __future__ import annotations

import collections
import os

import torch
import torch.distributed as dist

from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, check_device


def backend_for(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: int, world_size: int) -> torch.device:
    """The device ``rank`` of ``world_size`` runs on. A CPU device, or a CUDA
    device with an index, is taken as given. A CUDA device without one maps
    the rank to a card of this machine: ``cuda:{LOCAL_RANK}`` when the
    environment sets ``LOCAL_RANK`` (a job over several machines), else
    ``cuda:{rank}`` (a job on one machine). NCCL puts one rank on each card,
    so a rank without a card of its own raises ``ValueError``."""
    device = check_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    cards = torch.cuda.device_count()
    if "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
        if index >= cards:
            raise ValueError(f"LOCAL_RANK {index} needs card {index}, but this machine "
                             f"has {cards}: NCCL puts one rank on each card")
        return torch.device("cuda", index)
    if world_size > cards:
        raise ValueError(f"a group of {world_size} ranks on one machine needs {world_size} "
                         f"cards, but this machine has {cards}: NCCL puts one rank on each "
                         f"card (set LOCAL_RANK for a job over several machines)")
    return torch.device("cuda", rank)


def initialize_distributed(device="cuda", init_method: str | None = None,
                           world_size: int | None = None, rank: int | None = None) -> bool:
    """Join the process group over every rank, on ``device``'s backend
    (``backend_for``), a CUDA rank bound to its own card (``rank_device``).
    ``world_size``, ``rank`` and ``init_method`` default to the environment
    (``WORLD_SIZE``, ``RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT`` through
    ``env://``). Does nothing and returns False when the group is already up
    or the job is a single process (no world size given, and none above 1
    in the environment); True when it made the group."""
    if dist.is_initialized():
        return False
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        if world_size <= 1:
            return False
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    device = rank_device(device, rank, world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device.index)
    dist.init_process_group(backend_for(device), init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def all_reduce(t: torch.Tensor) -> None:
    """Sum ``t`` over every rank, in place (``dist.all_reduce``), counted in
    ``all_reduce.launches``. As with the kernels' launch counters, a CUDA
    graph's capture counts its all-reduces once and a replay counts
    nothing."""
    all_reduce.launches["sum"] += 1
    dist.all_reduce(t)


all_reduce.launches = collections.Counter()


# The least rows of a stripe, and the least stripes a rank splits into (else
# it keeps its band): S = 36 at 4K over 4 ranks (prime_ds 4). Of the card's
# readings of S = 36, 60 and 108 there (each rank's step alone, the slowest
# rank 1.131, 1.154 and 1.158 ms against 1.345 for the bands, PERF.md) the
# least; smaller stripes cost more halo rows in the coarse pass.
STRIPE_ROWS = 32
MIN_STRIPES = 2


def band(cfg: RenderConfig, rank: int | None = None,
         world_size: int | None = None) -> tuple[float, int]:
    """(row0, local_height) of ``rank``'s contiguous band (default: this
    process's): the JAX package's split, which ``scripts/torch_mesh_bands.py``
    times. A rank renders the same count of rows as its stripes
    (``stripes``), so the bands' rows summed over the ranks are the whole
    frame either way: a count of work per rank over the bands (a roofline's)
    sums to the frame's. The height must divide evenly; a primed config
    (``prime_ds``) needs bands of whole coarse rows too, which ``render``
    checks (``ops/march.py:check_prime_band``)."""
    r, n = world()
    rank = r if rank is None else rank
    world_size = n if world_size is None else world_size
    if cfg.height % world_size:
        raise ValueError(f"image height {cfg.height} must divide evenly over "
                         f"{world_size} ranks")
    local_height = cfg.height // world_size
    return float(rank * local_height), local_height


def stripe_rows(cfg: RenderConfig, world_size: int) -> int:
    """S, the rows of a stripe of each of ``world_size`` ranks' h =
    height / world size: the least multiple of ``prime_ds`` (of 1 when
    unprimed) that divides h and is at least ``STRIPE_ROWS``, so that every
    stripe is whole coarse rows; h itself (one stripe, the band) where no
    such S gives ``MIN_STRIPES`` stripes or more, and for a group of one."""
    h = cfg.height // world_size
    q = cfg.prime_ds or 1
    if world_size > 1:
        for s in range(q, h // MIN_STRIPES + 1, q):
            if s >= STRIPE_ROWS and h % s == 0:
                return s
    return h


def stripes(cfg: RenderConfig, rank: int | None = None,
            world_size: int | None = None) -> tuple[tuple[float, ...], int]:
    """(the first rows of ``rank``'s stripes in order, S) (default: this
    process's): stripes of S = ``stripe_rows`` rows dealt round-robin, rank r
    of N taking stripes r, r + N, ..., whose first rows are (j·N + r)·S. The
    ranks' stripes tile the frame once; one stripe is the rank's band."""
    r, n = world()
    rank = r if rank is None else rank
    world_size = n if world_size is None else world_size
    _, h = band(cfg, rank, world_size)
    s = stripe_rows(cfg, world_size)
    return tuple(float((j * world_size + rank) * s) for j in range(h // s)), s
