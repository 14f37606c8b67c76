"""Row bands over a process group (counterpart of
``gpgpuraytrace_tpu/parallel/mesh.py``).

The frame's rows split evenly over every rank of one ``torch.distributed``
group: rank r renders rows [r·h, (r + 1)·h), h = height / world size. Scene
parameters are replicated; parameter gradients are summed with
``all_reduce`` (``parallel/sharded.py``). The group runs NCCL for CUDA
ranks and gloo on the CPU. NCCL puts one rank on each card: a rank binds the
card of its ``LOCAL_RANK`` (``rank_device``), so a machine with one card
runs a group of world size 1.
"""

from __future__ import annotations

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


def band(cfg: RenderConfig, rank: int | None = None,
         world_size: int | None = None) -> tuple[float, int]:
    """(row0, local_height) of ``rank``'s band (default: this process's).
    The height must divide evenly; a primed config (``prime_ds``) needs
    bands of whole coarse rows too, which ``render`` checks
    (``ops/march.py:check_prime_band``)."""
    r, n = world()
    rank = r if rank is None else rank
    world_size = n if world_size is None else world_size
    if cfg.height % world_size:
        raise ValueError(f"image height {cfg.height} must divide evenly over "
                         f"{world_size} ranks")
    local_height = cfg.height // world_size
    return float(rank * local_height), local_height
