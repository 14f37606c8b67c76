"""Benchmark: rays per second of the forward and backward pass at 512x512,
6 octaves (counterpart of the JAX package's root ``bench.py``). Prints one
JSON line.

    python -m gpgpuraytrace_tpu_torch.bench              # 512², 6 octaves, K = 40, on the card
    python -m gpgpuraytrace_tpu_torch.bench --mesh 4     # row-band scaling over 1, 2, 4 cards
    python -m gpgpuraytrace_tpu_torch.cli bench --device cpu --size 32x16 --octaves 2 --iters 4

The workload (``bench.py:96-122``): ``default_scene(octaves)`` rendered with
``RenderConfig(height, width, max_steps=128, num_octaves=octaves)`` (the
default march, primed), every float parameter trainable, the loss
``mean(img * img)``. Step i sets every parameter to its base value plus
1e-6·(salt + i) and adds the loss and the sum of every gradient to an
accumulator. The salt and the step counter live on the device, and the
parameters are overwritten in place from their saved base values, so a CUDA
graph of steps reads them by address and touches no host.

The timing (``bench.py:124-170``, ``utils/timing.py``): K = max(iters, 4);
after one warm-up run of K steps, T(K) and T(1) are each the least of 3
runs, and a step takes (T(K) − T(1)) / (K − 1): the fixed cost of a call
cancels. On the card the headline times CUDA graphs of 1 and of K steps,
captured before timing, each replay on the host clock up to
``torch.cuda.synchronize()``; beside it the same slope over an eager loop
(``rays_per_sec_eager``), what an eager training loop pays. The headline is
the lower middle of 3 such measurements, all three kept in ``detail``.
``vs_baseline`` divides it by the plain path (``use_kernel=False``) on the
same device: eager, with its own K (``PLAIN_K``) and one measurement, since a
plain step takes seconds.

In the same run, first, the parity gate (``parity_gate``: the kernel path
against the plain path on both terrains, ``scripts/tpu_parity.py``); after
the timing, what was timed is checked (``detail.checks``): each graph
replayed at a fixed salt against the eager loop at that salt, bit for bit
(``graph_check``), and one step of the kernel path against the plain
path's (``step_check``); then the march statistics (``march_block``,
``bench.py:183-224``).

Nothing is substituted: there is no retry, no recorded measurement, no CPU
run in place of the card, and no headline from the plain path. Whatever fails
raises. ``main`` exits 1 when the parity gate or a check fails (after
printing the JSON) or when anything raises.

``run_bench_mesh(n)`` (``bench.py:539-617``): the row-band training step over
1, 2, 4, ... n ranks (``parallel/worker.py --time-k``, one rank per card over
NCCL, or gloo ranks on the CPU when asked), as CUDA graphs of 1 and K steps
with their all-reduces captured, and the parallel efficiency eff(n) =
rps(n) / (n · rps(1)), the eager loop's beside it. Fewer cards than n raise,
and so do bands a primed config cannot split into whole coarse rows (4K
over 4 ranks at ``prime_ds`` 8), before any rank starts.

    python -m gpgpuraytrace_tpu_torch.bench --mesh 2 --size 3840x2160   # config 5 at N = 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch

from gpgpuraytrace_tpu_torch.kernels.trace import render_kernel_raw, tile_steps, warp_steps
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, check_device, default_scene
from gpgpuraytrace_tpu_torch.ops.fit import partition_scene
from gpgpuraytrace_tpu_torch.ops.march import check_prime_band
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.parallel.mesh import band
from gpgpuraytrace_tpu_torch.parallel.sharded import step_launches
from gpgpuraytrace_tpu_torch.utils.profiling import march_stats
from gpgpuraytrace_tpu_torch.utils.timing import (
    SALT_CHECK, FwdBwdSteps, grad_sum, lower_middle, measure, measure_kernel,
)

MAX_STEPS = 128
# K of the headline (bench.py:690-697), of each rank's slope in the scaling
# harness, and of the plain path's one measurement (a plain step takes
# seconds at 512x512).
BENCH_K, MESH_K, PLAIN_K = 40, 8, 4
# The parity gate: its frame and octaves as bench.py runs it (bench.py:339,
# scripts/tpu_parity.py:112-113), and its contract (:88-102).
PARITY_SIZE, PARITY_OCTAVES, PARITY_MAX_STEPS = 128, 6, 96
PARITY_PIXEL_ATOL, PARITY_FRAC, PARITY_MEAN = 5e-3, 0.995, 2e-4
PARITY_GRAD_RTOL, PARITY_GRAD_ATOL = 5e-4, 1e-6
# One bench step of the kernel path against the plain path's, at
# tests/test_torch_bwd.py:133-145's bounds of a gradient entry: the
# amplitudes' at AMP_RTOL, AMP_ATOL; any other leaf's at GRAD_RTOL plus
# GRAD_ATOL_REL of the leaf's largest entry; the loss at LOSS_RTOL.
AMP_RTOL, AMP_ATOL, GRAD_RTOL, GRAD_ATOL_REL, LOSS_RTOL = 5e-3, 1e-5, 2.5e-2, 1e-3, 1e-4
EFF_TARGET = 0.80  # run_bench_mesh's vs_baseline: eff(n) / 0.80
WORKER = "gpgpuraytrace_tpu_torch.parallel.worker"


def _every_leaf(name: str) -> bool:
    return True


def bench_steps(scene, cfg: RenderConfig) -> FwdBwdSteps:
    """The bench workload on ``scene``: every float parameter trainable, the
    loss ``mean(img * img)`` of ``render(scene, cfg)``, the parameters
    named."""
    names = [n for n, _ in scene.named_parameters()]
    params = partition_scene(scene, trainable=_every_leaf)

    def loss_and_grads():
        img = render(scene, cfg)
        loss = torch.mean(img * img)
        return loss, torch.autograd.grad(loss, params, materialize_grads=True)

    return FwdBwdSteps(params, loss_and_grads, names)


def grad_bound(name: str, ref: torch.Tensor) -> torch.Tensor:
    """The bound of each entry of the gradient ``name`` against ``ref``
    (tests/test_torch_bwd.py:133-145)."""
    ref = ref.double().abs()
    if name == "noise.amplitudes":
        return AMP_ATOL + AMP_RTOL * ref
    return GRAD_ATOL_REL * ref.max() + GRAD_RTOL * ref


def step_check(kernel: FwdBwdSteps, plain: FwdBwdSteps) -> dict:
    """One bench step of the kernel path against the plain path's, both at
    ``SALT_CHECK``: the loss within ``LOSS_RTOL``, every gradient entry
    within its bound (``grad_bound``; ``worst_leaf_share`` is the largest
    error as a share of its bound, and ``worst_leaf`` its leaf), and the
    accumulator (loss plus the sum of every gradient) within the sum of all
    those bounds."""
    terms = []
    for steps in (kernel, plain):
        steps.salt.fill_(SALT_CHECK)
        steps.step_i.zero_()
        loss, grads = steps.terms()
        with torch.no_grad():
            acc = (loss.detach() + grad_sum(grads)).item()
        terms.append((loss.item(), acc, [g.detach() for g in grads]))
    (loss_k, acc_k, grads_k), (loss_p, acc_p, grads_p) = terms
    bound = LOSS_RTOL * abs(loss_p)
    worst, worst_leaf = 0.0, None
    for name, gk, gp in zip(plain.names, grads_k, grads_p):
        b = grad_bound(name, gp)
        bound += b.sum().item()
        share = ((gk.double() - gp.double()).abs() / b).max().item()
        if share >= worst:
            worst, worst_leaf = share, name
    err, loss_err = abs(acc_k - acc_p), abs(loss_k - loss_p)
    return {"salt": SALT_CHECK, "acc_kernel": acc_k, "acc_plain": acc_p, "acc_err": err,
            "acc_bound": bound, "loss_kernel": loss_k, "loss_plain": loss_p,
            "worst_leaf": worst_leaf, "worst_leaf_share": worst,
            "ok": err <= bound and worst <= 1.0 and loss_err <= LOSS_RTOL * abs(loss_p)}


def failures(result: dict) -> list[str]:
    """What failed in a benchmark record: the parity gate, or a check of
    ``detail.checks`` (one that could not run here is None)."""
    out = [] if result.get("parity", "ok") == "ok" else [f"parity: {result['parity']}"]
    for name, check in result.get("detail", {}).get("checks", {}).items():
        if check is not None and not check["ok"]:
            out.append(f"{name}: {json.dumps(check)}")
    return out


def bench_config(height: int, width: int, octaves: int, use_kernel: bool = True) -> RenderConfig:
    return RenderConfig(height=height, width=width, max_steps=MAX_STEPS, num_octaves=octaves,
                        use_kernel=use_kernel)


def march_block(height: int, width: int, octaves: int, device) -> dict:
    """March statistics at the bench config (``bench.py:183-224``): the plain
    stats march (``utils/profiling.py:march_stats``, from the plain path's
    prime map) gives the hit rate, useful steps per ray (mean, p99), the
    lanes that ran out of steps and the histogram. On the card, the forward
    kernel's ``debug_steps`` counter adds the steps it executed per ray:
    ``executed_steps_per_ray_kernel`` as the reference counts them, each
    lane at its TPU 16x128 tile's steps (``kernels/trace.py:tile_steps``),
    and ``executed_steps_per_ray_kernel_warp_tile`` at its 4x8 warp tile's
    (``warp_steps``), the tile the card runs; each over the useful steps is
    a divergence tax."""
    scene = default_scene(octaves, device=device)
    s = march_stats(scene, bench_config(height, width, octaves, use_kernel=False))
    out = {k: s[k] for k in ("hit_rate", "steps_mean", "steps_p99", "exhausted_lanes",
                             "histogram")}
    if device.type == "cuda":
        cfg = bench_config(height, width, octaves)
        *_, lanes = render_kernel_raw(scene, cfg, debug_steps=True)
        tile = tile_steps(lanes, cfg).double().mean().item()
        warp = warp_steps(lanes).double().mean().item()
        out.update(executed_steps_per_ray_kernel=tile,
                   divergence_tax_kernel=tile / s["steps_mean"],
                   executed_steps_per_ray_kernel_warp_tile=warp,
                   divergence_tax_kernel_warp_tile=warp / s["steps_mean"])
    return out


def parity_verdict(mode: str, img_kernel: torch.Tensor, img_plain: torch.Tensor,
                   grads_kernel: dict, grads_plain: dict) -> str:
    """The parity gate's comparison (``scripts/tpu_parity.py:88-102``): ""
    when it holds, else what failed. Images: more than 99.5% of pixels with
    a max-channel difference under 5e-3, and the mean error under 2e-4.
    Gradients of every leaf: kernel backward against the plain re-shade at
    rtol 5e-4, atol 1e-6."""
    fails = []
    d = (img_kernel - img_plain).abs()
    frac = (d.amax(dim=-1) < PARITY_PIXEL_ATOL).double().mean().item()
    mean = d.double().mean().item()
    if not frac > PARITY_FRAC:
        fails.append(f"{mode}: image parity {frac:.4f} <= {PARITY_FRAC}")
    if not mean < PARITY_MEAN:
        fails.append(f"{mode}: image mean err {mean:.2e} >= {PARITY_MEAN}")
    for name, gk in grads_kernel.items():
        close = torch.isclose(gk, grads_plain[name], rtol=PARITY_GRAD_RTOL,
                              atol=PARITY_GRAD_ATOL)
        if not bool(close.all()):
            fails.append(f"{mode}: {name} kernel_bwd gradient off at "
                         f"{int((~close).sum())} of {close.numel()} entries (rtol "
                         f"{PARITY_GRAD_RTOL}, atol {PARITY_GRAD_ATOL})")
    return "; ".join(fails)


def _image_and_grads(scene, cfg: RenderConfig):
    names = [n for n, _ in scene.named_parameters()]
    params = partition_scene(scene, trainable=_every_leaf)
    img = render(scene, cfg)
    loss = torch.mean(img * torch.cos(img))
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return img.detach(), dict(zip(names, grads))


def parity_check(volumetric: bool, size: int, octaves: int, device) -> str:
    """``scripts/tpu_parity.py:check`` on one terrain: ``parity_verdict`` of
    the kernel path's image against the plain path's, and of its gradients
    (kernel backward) against ``kernel_bwd=False``'s, at size², ``max_steps``
    96, step relax 0.9 on the volumetric terrain."""
    mode = "volumetric" if volumetric else "heightfield"
    cfg = RenderConfig(height=size, width=size, max_steps=PARITY_MAX_STEPS, num_octaves=octaves,
                       volumetric=volumetric, step_relax=0.9 if volumetric else 1.0)
    scene = default_scene(octaves, volumetric=volumetric, device=device)
    img_kernel, grads_kernel = _image_and_grads(scene, cfg)
    _, grads_plain = _image_and_grads(scene, dataclasses.replace(cfg, kernel_bwd=False))
    with torch.no_grad():
        img_plain = render(scene, dataclasses.replace(cfg, use_kernel=False))
    return parity_verdict(mode, img_kernel, img_plain, grads_kernel, grads_plain)


def parity_gate(size: int = 128, octaves: int = 6, device="cuda") -> str:
    """The same-run parity gate (``bench.py:323``, ``scripts/tpu_parity.py``):
    the heightfield at ``octaves`` and the volumetric terrain at
    min(octaves, 4). "ok", or "fail: " and what failed."""
    device = check_device(device)
    fails = [f for f in (parity_check(False, size, octaves, device),
                         parity_check(True, size, min(octaves, 4), device)) if f]
    return "fail: " + "; ".join(fails) if fails else "ok"


def bench_device(device) -> torch.device:
    """``device`` checked (a CUDA device without CUDA raises), a CUDA one
    with its index."""
    device = check_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_info(device: torch.device) -> dict:
    """The card's name, its power limit as ``nvidia-smi`` gives it (None
    where ``nvidia-smi`` cannot say) and the number of cards; on the CPU
    ``{"name": "cpu", "power_limit": None, "count": 1}``."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None, "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={device.index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        power = smi.stdout.strip() if smi.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        power = None
    return {"name": torch.cuda.get_device_name(device), "power_limit": power,
            "count": torch.cuda.device_count()}


def run_bench(size=(512, 512), octaves: int = 6, iters: int = BENCH_K,
              device="cuda") -> dict:
    """The benchmark's JSON record (``bench.py:run_bench``): the parity gate,
    the kernel path's fwd+bwd rays/s (the headline), the plain path's (eager,
    K = ``PLAIN_K``, one measurement), the checks of what was timed
    (``detail.checks``: ``graph_check`` and ``step_check``) and the march
    statistics, at ``size`` = (height, width). On the card
    ``detail.seconds.library`` is the kernels' build (or the load of a
    library built before) and ``kernel_build_s`` the first bench step,
    the counterpart of the reference's ``compile_s``, with the library
    loaded."""
    device = bench_device(device)
    h, w = size
    k = max(iters, 4)
    seconds = {}
    if device.type == "cuda":
        from gpgpuraytrace_tpu_torch.kernels.trace import _library

        t0 = time.perf_counter()
        _library()  # the kernels' build, or the load of a library built before
        seconds["library"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parity = parity_gate(PARITY_SIZE, PARITY_OCTAVES, device)
    seconds["parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernel_steps = bench_steps(default_scene(octaves, device=device), bench_config(h, w, octaves))
    kern = measure_kernel(kernel_steps, k, h * w, step_launches)
    seconds["kernel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain_steps = bench_steps(default_scene(octaves, device=device),
                              bench_config(h, w, octaves, use_kernel=False))
    plain = measure(lambda n, salt: plain_steps.timed(lambda: plain_steps.run(n), salt),
                    PLAIN_K, h * w)
    seconds["plain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks = {"graph_vs_eager": kern["graph_check"],
              "kernel_vs_plain": step_check(kernel_steps, plain_steps)}
    seconds["checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    march = march_block(h, w, octaves, device)
    seconds["march"] = time.perf_counter() - t0
    head = lower_middle(kern["measurements"])
    eager = lower_middle(kern["eager"])
    detail = {
        "kernel": head["rays_per_sec"],
        "kernel_ms_per_step": head["ms_per_step"],
        "kernel_rays_per_sec_wall": head["rays_per_sec_wall"],
        "kernel_build_s": kern["build_s"],
        "kernel_timing": kern["timing"],
        "kernel_measurements": kern["measurements"],
        "rays_per_sec_eager": eager["rays_per_sec"],
        "eager_ms_per_step": eager["ms_per_step"],
        "eager_measurements": kern["eager"],
        "K": k,
        "plain": plain["rays_per_sec"],
        "plain_ms_per_step": plain["ms_per_step"],
        "plain_K": PLAIN_K,
        "plain_measurement": plain,
        "checks": checks,
        "launches_per_step": kern["launches_per_step"],
        "peak_memory_bytes": kern["peak_memory_bytes"],
        "march": march,
        "seconds": seconds,
        "config": {"height": h, "width": w, "num_octaves": octaves, "max_steps": MAX_STEPS,
                   "prime_ds": bench_config(h, w, octaves).prime_ds},
    }
    return {
        "metric": f"rays_per_sec_fwd_bwd_{w}x{h}",
        "value": head["rays_per_sec"],
        "unit": "rays/s/chip",
        "vs_baseline": head["rays_per_sec"] / plain["rays_per_sec"],
        "detail": detail,
        "backend": device.type,
        "parity": parity,
        "device": device_info(device),
    }


def mesh_sweep(n: int) -> list[int]:
    """1, 2, 4, ... up to n, and n itself (``bench.py:552-556``)."""
    sweep = [1]
    while sweep[-1] * 2 <= n:
        sweep.append(sweep[-1] * 2)
    if sweep[-1] != n:
        sweep.append(n)
    return sweep


def check_mesh_bands(cfg: RenderConfig, sweep: list[int]) -> None:
    """Every rank's band of every world size in ``sweep``: the height splits
    evenly and, on a primed config, each band is whole coarse rows
    (``ops/march.py:check_prime_band``), and with it each of the rank's
    stripes (``mesh.stripes``). Raises ``ValueError`` before any rank
    starts."""
    for m in sweep:
        for r in range(m):
            row0, h = band(cfg, r, m)
            try:
                check_prime_band(cfg, row0, h)
            except ValueError as e:
                raise ValueError(f"a mesh of {m} ranks at {cfg.width}x{cfg.height}: {e}; "
                                 f"prime_ds {cfg.prime_ds} needs bands of a multiple of "
                                 f"{cfg.prime_ds} rows") from e


def run_bench_mesh(n_devices: int, size=(512, 512), octaves: int = 6, iters: int = MESH_K,
                   device="cuda") -> dict:
    """The scaling harness (``bench.py:run_bench_mesh``, its ``_MESH_CODE``
    timing one jitted ``fori_loop`` of K sharded steps): for each world size
    m of ``mesh_sweep(n_devices)`` a job of m ranks of ``parallel/worker.py
    --time-k`` (``parallel/launch.py:launch_local_processes``), rank r on card
    r over NCCL, or on gloo with ``device="cpu"``. rps(m) is the slowest
    rank's fwd+bwd rays/s of the whole frame, each rank's the lower middle
    of its measurements of CUDA graphs of 1 and K steps (the all-reduces
    captured with the kernels; on gloo the eager loop), and eff(m) = rps(m)
    / (m · rps(1)); the eager loop's rps and eff beside them under their own
    keys. ``detail.checks`` holds each rank's ``graph_check``, so
    ``failures`` reports a rank whose graphs differ from its eager loop.
    Fewer cards than ``n_devices`` raise; so does, before any rank starts, a
    height that does not split into m bands for every m, or bands that are
    not whole coarse rows of the config's ``prime_ds`` (``check_mesh_bands``)."""
    from gpgpuraytrace_tpu_torch.parallel.launch import launch_local_processes

    dev = check_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"a mesh of {n_devices} needs {n_devices} cards, this machine has "
                           f"{torch.cuda.device_count()}: one rank runs on each card")
    h, w = size
    sweep = mesh_sweep(n_devices)
    check_mesh_bands(bench_config(h, w, octaves), sweep)
    k = max(iters, 4)
    ranks, rps, rps_eager = {}, {}, {}
    for m in sweep:
        outputs = launch_local_processes(
            WORKER, m, ["--device", dev.type, "--size", f"{w}x{h}", "--octaves", str(octaves),
                        "--max-steps", str(MAX_STEPS), "--time-k", str(k),
                        "--world-size", str(m)])
        timed = [json.loads(line[len("TIMED "):]) for out in outputs
                 for line in out.splitlines() if line.startswith("TIMED ")]
        if len(timed) != m:
            raise RuntimeError(f"{len(timed)} of {m} ranks printed a TIMED line:\n"
                               + "\n".join(o[-2000:] for o in outputs))
        ranks[m] = timed
        rps[m] = min(t["rays_per_sec"] for t in timed)
        rps_eager[m] = min(t["eager_rays_per_sec"] for t in timed)
    eff = {m: rps[m] / (m * rps[1]) for m in sweep}
    eff_eager = {m: rps_eager[m] / (m * rps_eager[1]) for m in sweep}
    return {
        "metric": f"scaling_efficiency_mesh{n_devices}_{w}x{h}",
        "value": eff[n_devices],
        "unit": "parallel_efficiency",
        "vs_baseline": eff[n_devices] / EFF_TARGET,
        "detail": {"rays_per_sec": {str(m): v for m, v in rps.items()},
                   "efficiency": {str(m): v for m, v in eff.items()},
                   "ms_per_step": {str(m): max(t["ms_per_step"] for t in ranks[m])
                                   for m in sweep},
                   "timing": {str(m): sorted({t["timing"] for t in ranks[m]}) for m in sweep},
                   "rays_per_sec_eager": {str(m): v for m, v in rps_eager.items()},
                   "efficiency_eager": {str(m): v for m, v in eff_eager.items()},
                   "eager_ms_per_step": {str(m): max(t["eager_ms_per_step"] for t in ranks[m])
                                         for m in sweep},
                   "checks": {f"graph_vs_eager_mesh{m}_rank{t['rank']}": t["graph_check"]
                              for m in sweep for t in ranks[m]},
                   "K": k, "ranks": {str(m): v for m, v in ranks.items()}},
        "backend": dev.type,
        "device": device_info(torch.device("cuda", 0) if dev.type == "cuda" else dev),
    }


def main(argv=None) -> int:
    """``python -m gpgpuraytrace_tpu_torch.bench``: the JSON line, then exit
    1 when the parity gate or a check failed (``failures``, each on stderr)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="the scaling harness over 1, 2, 4, ... N ranks, one card each")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--size", default="512", help="N or WxH")
    p.add_argument("--octaves", type=int, default=6)
    p.add_argument("--iters", type=int, default=None,
                   help=f"K of the slope (default {BENCH_K}; {MESH_K} with --mesh)")
    a = p.parse_args(argv)
    from gpgpuraytrace_tpu_torch.cli import _parse_size

    size = _parse_size(a.size)
    if a.mesh:
        result = run_bench_mesh(a.mesh, size, a.octaves, a.iters or MESH_K, a.device)
    else:
        result = run_bench(size, a.octaves, a.iters or BENCH_K, a.device)
    print(json.dumps(result), flush=True)
    bad = failures(result)
    for msg in bad:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
