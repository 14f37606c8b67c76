"""The port's forward trace kernel, one build against another, on one NVIDIA GPU.

    python scripts/torch_fwd_ab.py --arm parent=DIR --arm new=DIR [--rounds 3]
        [--out build/ab/fwd_ab.json]

Each arm is a copy of ``gpgpuraytrace_tpu_torch/kernels/csrc`` (``git archive``
of a parent commit unpacked beside the tree, say). Every arm is built with
the library's own nvcc flags (``kernels/build.py``), one nvcc per source, all at once, and loaded
with ctypes beside the others. Then, on one card:

1. ptxas's registers and spills of every kernel instantiation of each arm;
2. a SHA-256 digest of the bytes of every output of every forward
   instantiation (14: chunked, fixed and lod, each with and without the bf16
   march field and the step counter, and compaction's phase 1 with and
   without bf16, then phase 2 on its survivors) and of the backward, on both
   terrains at 512x512 with 6 octaves, with the 66x64 coarse prime pass and
   the ragged frames (a 37x100 band at row 5, one 512-pixel row):
   ``chip_smoke.py:output_digests``; arms whose digests differ are named;
3. a SASS census of the main path's instantiation (chunked, float32, no
   counter) by ``cuobjdump -sass``: its march loop's instructions per step
   by class, and from it and this run's per-lane step counts an issue bound
   of the march: warp instructions at one per sub-partition per cycle, 4 x
   132 per cycle at the card's maximum SM clock;
4. the coarse pass (66x64, unprimed) and the fine pass (512x512, primed)
   of both terrains: each arm 50 launches back to back between CUDA events,
   and a CUDA graph of 50 launches replayed between them (device time), in
   turns (arms in order, then reversed), ``--rounds`` times (skipped with
   ``--compact-only``);
5. compaction's two phases at 512x512, 6 octaves, budget 32, both terrains,
   float32 and bf16, every arm's phase 2 on the same phase-1 outputs (the
   first arm's): phase 1 as a CUDA graph of 50 launches; phase 2 as a graph
   of 50 calls that each restore phase 1's t into the in-place buffer and
   launch it, less a graph of the 50 restores alone; both back to back too;
   in turns as in 4. Then each phase's kernel time by torch.profiler (20
   calls; the mean over the launches it recorded, with their count), each
   launcher's host microseconds per call (``host_us``: the
   allocations and the ctypes call of the package's wrapper, without its
   checks), the survivors, and a SASS census of phase 1's float32
   instantiations and of phase 2's float32 kernel (instructions by class,
   shuffles, every loop), each function's SASS written beside ``--out``.

A design before the 4x8 warp tiles takes 11 pointers in ``trace_fwd_launch``,
the warp-tile design 12 (its tile scratch last); a phase 2 that takes a
scratch (persistent ray groups) 9 pointers in ``trace_compact_launch``, an
older one 8; a design with the frame axis takes the frame count after the
config in both (each arm here launches one frame); an arm's signatures are
read from its sources, the backward's as ``scripts/torch_bwd_ab.py:Arm``
reads it. The SASS census reads the one-frame instantiations. The digests of step 2 are also
held to ``chip_smoke.py:EXPECTED_DIGESTS``. Prints one JSON line per section
and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import functools
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    EXPECTED_DIGESTS, backward_branches, graph_ms, host_us, instructions, output_digests,
    ptxas_lines, sass_functions,
)
from scripts.torch_bwd_ab import Arm as BwdArm  # noqa: E402
from gpgpuraytrace_tpu_torch.kernels import build as kbuild  # noqa: E402
from gpgpuraytrace_tpu_torch.kernels import pack as kpack  # noqa: E402
from gpgpuraytrace_tpu_torch.kernels import trace as ktrace  # noqa: E402
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene  # noqa: E402
from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse  # noqa: E402

TERRAINS = {"heightfield": False, "volumetric": True}
REPS = 50


def emit(out: dict, key: str, value) -> None:
    out[key] = value
    print(json.dumps({key: value}), flush=True)


def build_all(dirs: dict[str, Path], root: Path) -> dict[str, tuple[Path, str]]:
    """Compile every arm's sources at once (one nvcc per source), then link
    each arm's library: {arm: (library, ptxas log)}."""
    nvcc = kbuild.find_nvcc()
    jobs = {}
    for name, src_dir in dirs.items():
        out = root / "lib" / name
        if out.exists():
            shutil.rmtree(out)
        out.mkdir(parents=True)
        for src in sorted(src_dir.glob("*.cu")):
            cmd = [nvcc, *kbuild.NVCC_FLAGS, "-c", str(src), "-o", str(out / f"{src.stem}.o")]
            jobs.setdefault(name, []).append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, procs in jobs.items():
        log = []
        for proc in procs:
            text, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc failed\n{text}")
            log.append(text)
        out = root / "lib" / name
        lib = out / kbuild.LIB_NAME
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                        str(lib), *map(str, sorted(out.glob("*.o")))], check=True)
        built[name] = (lib, "\n".join(log))
    return built


class Arm:
    """One built library and the launch signature of its source."""

    def __init__(self, name: str, lib_path: Path, src_dir: Path):
        self.name = name
        self.lib = ctypes.CDLL(str(lib_path))
        self.tiles = "tile_scratch" in (src_dir / "trace_fwd.cu").read_text()
        # Left at 0 by every launch; the arms' launches and graph replays all
        # run on one stream.
        self.scratch = None
        n_ptr = 12 if self.tiles else 11
        # The frame axis: the frame count after the config (1 here).
        self.frames = ("int frames" in (src_dir / "trace_fwd.cu").read_text()) * [1]
        frames_arg = [ctypes.c_int] if self.frames else []
        self.lib.trace_fwd_launch.argtypes = ([ctypes.c_void_p] * n_ptr
                                              + [ktrace.TraceConfig, *frames_arg,
                                                 ctypes.c_void_p])
        self.lib.trace_fwd_launch.restype = ctypes.c_int
        # Phase 2 on persistent ray groups takes a scratch for its slot counter.
        self.p2_scratch = "scratch" in (src_dir / "trace_compact.cu").read_text()
        self.lib.trace_compact_launch.argtypes = [ctypes.c_void_p] * (
            9 if self.p2_scratch else 8) + [ktrace.TraceConfig, *frames_arg, ctypes.c_void_p]
        self.lib.trace_compact_launch.restype = ctypes.c_int
        self.bwd_arm = BwdArm(name, lib_path, src_dir / "trace_bwd.cu")

    def fwd(self, packed, seed, cfg, h, prime=None, debug=False, compact=False):
        """trace_fwd_launch: (color, t, hit[, steps]) or phase 1's seven."""
        dev = packed.device
        w = cfg.width
        f = dict(dtype=torch.float32, device=dev)
        color, t, hit = torch.empty((3, h, w), **f), torch.empty((h, w), **f), \
            torch.empty((h, w), **f)
        steps = torch.empty((h, w), dtype=torch.int32, device=dev) if debug else None
        alive = prev = ids = n_alive = None
        if compact:
            alive, prev = torch.empty((h, w), **f), torch.empty((h, w), **f)
            ids = torch.empty(h * w, dtype=torch.int32, device=dev)
            n_alive = torch.empty(1, dtype=torch.int32, device=dev)
            kcfg = ktrace._kernel_config(cfg, h, budget=cfg.compact_budget, phase=1)
        else:
            kcfg = ktrace._kernel_config(cfg, h, primed=prime is not None)
        ptrs = [packed, seed, prime, color, t, hit, steps, alive, prev, ids, n_alive]
        if self.tiles:
            ptrs.append(self.kept_scratch(dev))
        err = self.lib.trace_fwd_launch(*(None if x is None else x.data_ptr() for x in ptrs),
                                        kcfg, *self.frames,
                                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: trace_fwd_launch returned CUDA error {err}")
        if compact:
            return color, t, hit, alive, prev, ids, n_alive
        return (color, t, hit) if steps is None else (color, t, hit, steps)

    def kept_scratch(self, dev):
        """The two int32 of the tile (and phase 2's slot) counters, zeroed
        once and left at 0 by every launch."""
        if self.scratch is None:
            self.scratch = torch.zeros(2, dtype=torch.int32, device=dev)
        return self.scratch

    def phase1(self, packed, seed, cfg, h):
        return self.fwd(packed, seed, cfg, h, compact=True)

    def phase2(self, packed, seed, cfg, h, n_alive, ids, prev, color, t, hit):
        kcfg = ktrace._kernel_config(cfg, h, budget=cfg.max_steps - cfg.compact_budget,
                                     phase=2)
        ptrs = [packed, seed, n_alive, ids, prev, color, t, hit]
        if self.p2_scratch:
            ptrs.append(self.kept_scratch(packed.device))
        err = self.lib.trace_compact_launch(
            *(x.data_ptr() for x in ptrs), kcfg, *self.frames,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: trace_compact_launch returned {err}")

    def bwd(self, packed, seed, cfg, h, t, hit, g):
        """trace_bwd_launch (contiguous g): pbar."""
        return self.bwd_arm.bwd(packed, seed, cfg, h, t, hit, g)


def coarse_inputs(scene, cfg):
    ccfg = coarse_prime_cfg(cfg)
    packed, _, seed = kpack.pack_frames(scene, scene.camera, ccfg.height, ccfg.width, -1.0)
    return packed.detach(), seed, ccfg, cfg.height // cfg.prime_ds + 2


CLASSES = {
    "fp32": ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "MUFU"),
    "fp64": ("DFMA", "DMUL", "DADD", "DSETP"),
    "int_mad": ("IMAD", "IMUL"),
    "int_logic": ("LOP3", "SHF", "IADD3", "ISETP", "LEA", "SEL", "IABS", "PRMT", "IMNMX",
                  "SHL", "SHR", "LOP"),
    "convert": ("F2I", "I2F", "FRND", "F2F", "I2FP", "F2IP"),
    "lds": ("LDS",),
    "shuffle": ("SHFL",),
    "memory": ("LDG", "STG", "LDC", "ULDC", "LD", "ST", "ATOM", "ATOMG", "RED"),
}


def klass(op: str) -> str:
    root = op.split(".")[0]
    return next((k for k, ops in CLASSES.items() if root in ops), "other")


def class_counts(insts, lo: int = 0, hi: int = 1 << 62, skip=()) -> dict:
    c = collections.Counter(klass(op) for addr, op, _ in insts
                            if lo <= addr <= hi and not any(a <= addr <= b for a, b in skip))
    c["all"] = sum(c.values())
    return dict(c)


def sass_census(lib_path: Path, dump: Path) -> dict:
    """The main path's instantiation in SASS: every loop (a backward branch)
    with its instructions by class, and the march loop's: the first loop
    whose body floors (FRND) in float, i.e. evaluates the noise. Writes the
    function's SASS to ``dump``."""
    funcs = sass_functions(lib_path)
    pick = [f for f in funcs if re.match(r"\S*trace_fwd_kernelILi0ELb0ELb0E(Li6E)?(Lb0E)?E", f)]
    pick.sort(key=lambda f: "Li6E" not in f.split("\n", 1)[0])  # the unrolled one first
    if not pick:
        raise SystemExit("no trace_fwd_kernel<chunked, 0, 0> in the SASS")
    body = pick[0]
    dump.write_text(body)
    insts = instructions(body)
    counts = functools.partial(class_counts, insts)

    loops = backward_branches(insts)

    def floors(lo, hi):
        return any(lo <= a <= hi and op.startswith(("FRND", "F2I")) for a, op, _ in insts)

    def double(lo, hi):
        return any(lo <= a <= hi and klass(op) == "fp64" for a, op, _ in insts)

    name = body.split("\n", 1)[0].strip()
    report = {"function": name[:160], "instructions": len(insts),
              "loops": [{"range": f"{lo:#x}-{hi:#x}", "classes": counts(lo, hi)}
                        for lo, hi in loops]}
    def fetches(lo, hi):
        return any(lo <= a <= hi and op.startswith(("ATOM", "SHFL")) for a, op, _ in insts)

    # The march: the first loop that floors in float, other than the parent
    # design's octave table (a double sincos per octave) and the warp-tile
    # design's loop over tiles (an atomic fetch and a shuffle).
    march = next(((lo, hi) for lo, hi in loops
                  if floors(lo, hi) and not double(lo, hi) and not fetches(lo, hi)), None)
    if march is None:
        return report
    # Inside the march loop: the octave loop first (unless the main path's
    # octaves are unrolled), then the volumetric warp's octave loop.
    inner = [(lo, hi) for lo, hi in loops
             if march[0] <= lo and hi < march[1] and floors(lo, hi)]
    unrolled = "Li6E" in name
    octave = None if unrolled else (inner[0] if inner else None)
    warp = inner[0 if unrolled else 1] if len(inner) > (0 if unrolled else 1) else None
    outside = counts(*march, skip=inner)
    report["march_outside_inner_loops"] = outside
    report["octave_loop"] = counts(*octave) if octave else None
    report["warp_octave_loop"] = counts(*warp) if warp else None

    def per_step(volumetric: bool) -> dict:
        c = collections.Counter(outside)
        if octave:
            c.update({k: 6 * v for k, v in counts(*octave).items()})
        if volumetric and warp:
            c.update({k: 2 * v for k, v in counts(*warp).items()})
        return dict(c)

    report["step"] = {t: per_step(v) for t, v in TERRAINS.items()}
    return report


def tile_max(steps: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Each rows x cols tile's longest lane (zero-padded edges)."""
    h, w = steps.shape
    gh, gw = -(-h // rows), -(-w // cols)
    pad = steps.new_zeros((gh * rows, gw * cols))
    pad[:h, :w] = steps
    return pad.reshape(gh, rows, gw, cols).amax(dim=(1, 3))


def issue_bound(arm: Arm, census: dict, dev) -> dict:
    """The march's issue bound per terrain: each warp tile executes its
    longest lane's steps, each step the march loop's warp instructions."""
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           check=True).stdout.split()[0]
    if "step" not in census:
        return {"error": "no march loop found"}
    tile = (4, 8) if arm.tiles else (1, 32)
    out = {"sm_clock_max_mhz": float(clock), "warp_tile": tile}
    with torch.no_grad():
        for terrain, vol in TERRAINS.items():
            scene = default_scene(6, volumetric=vol, device=dev)
            cfg = RenderConfig(num_octaves=6, volumetric=vol)
            cp, cs, ccfg, ch = coarse_inputs(scene, cfg)
            prime = prime_from_coarse(arm.fwd(cp, cs, ccfg, ch)[1], cfg)
            packed, _, seed = kpack.pack_frames(scene, scene.camera, 512, 512, 0.0)
            packed = packed.detach()
            steps = arm.fwd(packed, seed, cfg, 512, prime, debug=True)[3]
            warp_steps = tile_max(steps, *tile).sum().item()
            per_step = census["step"][terrain]["all"]
            ms = 1e3 * warp_steps * per_step / (4 * 132 * float(clock) * 1e6)
            out[terrain] = {"warp_instructions_per_step": per_step,
                            "lane_steps_mean": steps.float().mean().item(),
                            "per_warp_1x32": tile_max(steps, 1, 32).float().mean().item(),
                            "per_warp_4x8": tile_max(steps, 4, 8).float().mean().item(),
                            "issue_bound_ms": ms}
    return out


def events(fn) -> float:
    """ms per launch of ``fn`` (REPS launches, or one replay of a graph of
    them) between CUDA events, after a warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def time_arms(arms: dict[str, Arm], dev, rounds: int) -> dict:
    """Coarse and fine pass per arm and terrain, ms per launch: 50 launches
    back to back between CUDA events ("b2b": the host's launch time shows
    where it exceeds the kernel's), and one replay of a CUDA graph of 50
    launches ("graph": device time alone), arms in turns (in order, then
    reversed) for ``rounds`` rounds."""
    work = {}
    with torch.no_grad():
        for terrain, vol in TERRAINS.items():
            scene = default_scene(6, volumetric=vol, device=dev)
            cfg = RenderConfig(num_octaves=6, volumetric=vol)
            cp, cs, ccfg, ch = coarse_inputs(scene, cfg)
            packed, _, seed = kpack.pack_frames(scene, scene.camera, 512, 512, 0.0)
            packed = packed.detach()
            first = next(iter(arms.values()))
            prime = prime_from_coarse(first.fwd(cp, cs, ccfg, ch)[1], cfg)
            work[terrain, "coarse"] = (cp, cs, ccfg, ch, None)
            work[terrain, "fine"] = (packed, seed, cfg, 512, prime)
    graphs = {}
    for name, arm in arms.items():
        for key, (p, s, c, h, prime) in work.items():
            arm.fwd(p, s, c, h, prime)  # warm-up: the occupancy query runs once
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(REPS):
                    arm.fwd(p, s, c, h, prime)
            graphs[name, key] = g
    times = collections.defaultdict(list)
    order = list(arms)

    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]) + (order[::-1] if r % 2 == 0
                                                              else order):
            arm = arms[name]
            for key, (p, s, c, h, prime) in work.items():
                label = f"{name} {key[0]} {key[1]}"
                times[label + " b2b"].append(events(
                    lambda: [arm.fwd(p, s, c, h, prime) for _ in range(REPS)]))
                times[label + " graph"].append(events(graphs[name, key].replay))
    return {k: {"min": min(v), "median": statistics.median(v), "all": v}
            for k, v in times.items()}


def compact_work(arms: dict[str, Arm], dev) -> dict:
    """Compaction's inputs per terrain and precision: (packed, seed, cfg, the
    first arm's phase-1 outputs), budget 32, 512x512, 6 octaves."""
    first = next(iter(arms.values()))
    work = {}
    with torch.no_grad():
        for terrain, vol in TERRAINS.items():
            scene = default_scene(6, volumetric=vol, device=dev)
            packed, _, seed = kpack.pack_frames(scene, scene.camera, 512, 512, 0.0)
            packed = packed.detach()
            for bf16 in (False, True):
                cfg = RenderConfig(num_octaves=6, volumetric=vol, march_bf16=bf16,
                                   march_mode="compact")
                work[f"{terrain}/{'bf16' if bf16 else 'f32'}"] = (
                    packed, seed, cfg, first.phase1(packed, seed, cfg, 512))
    torch.cuda.synchronize()
    return work


def longest_ray(arms: dict[str, Arm], work: dict) -> dict:
    """Phase 2's latency alone: each arm's phase 2 on a list of one slot, the
    survivor that the counted unprimed march runs longest, as a CUDA graph of
    50 calls (each restoring phase 1's t), less the restores: ms, and us per
    step left to phase 2."""
    first = next(iter(arms.values()))
    out = {}
    for key, (packed, seed, cfg, p1) in work.items():
        ucfg = dataclasses.replace(cfg, march_mode="chunked", prime_ds=0)
        steps = first.fwd(packed, seed, ucfg, 512, debug=True)[3].view(-1)
        n = int(p1[6].item())
        listed = p1[5][:n].long()
        pix = listed[steps[listed].argmax()]
        ids = torch.zeros_like(p1[5])
        ids[0] = pix
        one = torch.ones(1, dtype=torch.int32, device=ids.device)
        left = int(steps[pix]) - cfg.compact_budget
        tbuf = p1[1].clone()
        outs = (p1[0].clone(), p1[2].clone())

        def restore(tbuf=tbuf, t1=p1[1]):
            tbuf.copy_(t1)

        row = {"pixel": int(pix), "steps_left": left}
        base = graph_ms(restore, REPS)
        for name, arm in arms.items():
            def call(arm=arm):
                restore()
                arm.phase2(packed, seed, cfg, 512, one, ids, p1[4], outs[0], tbuf, outs[1])
            ms = graph_ms(call, REPS) - base
            row[name] = {"ms": ms, "us_per_step": 1e3 * ms / max(left, 1)}
        out[key] = row
    return out


def compact_gaps(arms: dict[str, Arm], work: dict) -> dict:
    """Where each arm's phase 2 differs from the first arm's on the same
    phase-1 outputs: per input, the pixels whose colour, t or hit differ, how
    many are hits in either arm, the largest t gap, and up to 5 of them (pixel
    id, its place in phase 1's list, both arms' t and hit, phase 1's t)."""
    outs = {}
    for name, arm in arms.items():
        for key, (packed, seed, cfg, p1) in work.items():
            color, t, hit = (x.clone() for x in p1[:3])
            arm.phase2(packed, seed, cfg, 512, p1[6], p1[5], p1[4], color, t, hit)
            outs[name, key] = (color, t, hit)
    torch.cuda.synchronize()
    first = next(iter(arms))
    gaps = {}
    for name in arms:
        for key, (_, _, _, p1) in work.items():
            (c0, t0, h0), (c1, t1, h1) = outs[first, key], outs[name, key]
            diff = ((c0 != c1).any(0) | (t0 != t1) | (h0 != h1)).view(-1)
            if name == first or not diff.any():
                continue
            n = int(p1[6].item())
            place = torch.full_like(diff, -1, dtype=torch.long)
            place[p1[5][:n].long()] = torch.arange(n, device=diff.device)
            pix = diff.nonzero()[:, 0]
            either = (h0.view(-1)[pix] > 0.5) | (h1.view(-1)[pix] > 0.5)
            gaps[f"{name} {key}"] = {
                "pixels": int(pix.numel()), "of_listed": n, "hits_in_either": int(either.sum()),
                "max_t_gap": (t0.view(-1)[pix] - t1.view(-1)[pix]).abs().max().item(),
                "examples": [{"pixel": int(q), "list_place": int(place[q]),
                              "t": [t0.view(-1)[q].item(), t1.view(-1)[q].item()],
                              "hit": [h0.view(-1)[q].item(), h1.view(-1)[q].item()],
                              "phase1_t": p1[1].view(-1)[q].item()} for q in pix[:5]]}
    return gaps


def time_compact(arms: dict[str, Arm], work: dict, rounds: int) -> dict:
    """Per arm and input, ms per call: phase 1 and phase 2 as CUDA graphs of
    50 ("graph": device time; phase 2's graph restores phase 1's t before
    each launch, and the graph of the 50 restores alone is subtracted) and
    50 back to back ("b2b", phase 2 with its restores, less theirs), arms in
    turns; then each kernel's device us per launch (profiler over 20 calls:
    the mean over the launches it recorded, and their count) and
    each launcher's host us per call."""
    def phase2_call(arm, packed, seed, cfg, p1, tbuf, outs):
        arm.phase2(packed, seed, cfg, 512, p1[6], p1[5], p1[4], outs[0], tbuf, outs[1])

    calls = {}
    for name, arm in arms.items():
        for key, (packed, seed, cfg, p1) in work.items():
            tbuf = p1[1].clone()
            outs = (p1[0].clone(), p1[2].clone())

            def restore(tbuf=tbuf, t1=p1[1]):
                tbuf.copy_(t1)

            def p2(arm=arm, packed=packed, seed=seed, cfg=cfg, p1=p1, tbuf=tbuf, outs=outs,
                   restore=restore):
                restore()
                phase2_call(arm, packed, seed, cfg, p1, tbuf, outs)

            def p1_call(arm=arm, packed=packed, seed=seed, cfg=cfg):
                arm.phase1(packed, seed, cfg, 512)

            calls[name, key] = {"phase1": p1_call, "phase2+restore": p2, "restore": restore}
    graphs = {}
    for k, fns in calls.items():
        for part, fn in fns.items():
            fn()  # warm-up: the occupancy query runs once
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(REPS):
                    fn()
            graphs[k, part] = g

    times = collections.defaultdict(list)
    order = list(arms)
    for r in range(rounds):
        for name in (order + order[::-1]) if r % 2 == 0 else (order[::-1] + order):
            for key in work:
                got = {}
                for part, fn in calls[name, key].items():
                    got[part, "graph"] = events(graphs[(name, key), part].replay)
                    got[part, "b2b"] = events(lambda fn=fn: [fn() for _ in range(REPS)])
                for how in ("graph", "b2b"):
                    times[f"{name} {key} phase1 {how}"].append(got["phase1", how])
                    times[f"{name} {key} phase2 {how}"].append(
                        got["phase2+restore", how] - got["restore", how])
                    times[f"{name} {key} restore {how}"].append(got["restore", how])
    out = {k: {"min": min(v), "median": statistics.median(v), "max": max(v), "all": v}
           for k, v in times.items()}

    from torch.profiler import ProfilerActivity, profile

    for (name, key), fns in calls.items():
        packed, seed, cfg, p1 = work[key]
        for part in ("phase1", "phase2+restore"):
            fns[part]()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fns[part]()
                torch.cuda.synchronize()
            out[f"{name} {key} {part} kernels_us"] = {
                e.key[:60]: {"us": e.self_device_time_total / e.count, "count": e.count}
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        arm = arms[name]
        tbuf, outs = p1[1].clone(), (p1[0].clone(), p1[2].clone())
        out[f"{name} {key} host_us"] = {
            "phase1": host_us(fns["phase1"]),
            "phase2": host_us(lambda: phase2_call(arm, packed, seed, cfg, p1, tbuf, outs))}
    return out


def compact_census(lib_path: Path, dump_dir: Path, arm: str) -> dict:
    """Phase 1's float32 instantiations (rolled, and the unrolled twin where
    there is one) and phase 2's float32 kernel in SASS: instructions by
    class (shuffles apart) and every loop's; each written to
    ``dump_dir/sass_<kernel>_<arm>.txt``."""
    report = {}
    for label, pattern in (("phase1", r"\S*trace_fwd_kernelILi3ELb0ELb0E(Li\d+E)?(Lb0E)?E"),
                           ("phase2", r"\S*trace_phase2_kernelILb0E(Li\d+E)?(Lb0E)?E")):
        for body in (f for f in sass_functions(lib_path) if re.match(pattern, f)):
            name = body.split("\n", 1)[0].strip()
            tag = label + ("_unrolled" if "Li6E" in name else "")
            (dump_dir / f"sass_{tag}_{arm}.txt").write_text(body)
            insts = instructions(body)
            report[tag] = {"function": name[:160], "classes": class_counts(insts),
                           "loops": [{"range": f"{lo:#x}-{hi:#x}",
                                      "classes": class_counts(insts, lo, hi)}
                                     for lo, hi in backward_branches(insts)]}
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", action="append", required=True, help="name=csrc directory")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="build/ab/fwd_ab.json")
    ap.add_argument("--work", default="build/ab")
    ap.add_argument("--compact-only", action="store_true",
                    help="skip the SASS issue bound and the coarse and fine pass times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    out: dict = {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    emit(out, "card", smi)
    (REPO / args.out).parent.mkdir(parents=True, exist_ok=True)
    root = REPO / args.work
    dirs = {k: Path(v).resolve() for k, v in (a.split("=", 1) for a in args.arm)}
    built = build_all(dirs, root)
    emit(out, "ptxas", {name: [ln for ln in ptxas_lines(log) if not ln.startswith("---")]
                        for name, (_, log) in built.items()})
    arms = {name: Arm(name, lib, dirs[name]) for name, (lib, _) in built.items()}
    dig = {name: output_digests(arm, dev) for name, arm in arms.items()}
    ref_name = next(iter(arms))
    emit(out, "digests", dig[ref_name])
    emit(out, "digests_differ", {name: sorted(k for k in d if d[k] != dig[ref_name].get(k))
                                 for name, d in dig.items() if name != ref_name})
    emit(out, "digests_differ_from_recorded",
         {name: sorted(k for k, v in d.items() if v != EXPECTED_DIGESTS.get(k))
          for name, d in dig.items()})
    census = {}
    for name in dirs:
        census[name] = sass_census(built[name][0], (REPO / args.out).with_name(
            f"sass_{name}.txt"))
        if not args.compact_only:
            census[name]["issue_bound"] = issue_bound(arms[name], census[name], dev)
        census[name]["compact"] = compact_census(built[name][0], (REPO / args.out).parent,
                                                 name)
    emit(out, "sass", census)
    work = compact_work(arms, dev)
    emit(out, "survivors", {key: int(w[3][6].item()) for key, w in work.items()})
    emit(out, "compact_gaps", compact_gaps(arms, work))
    emit(out, "longest_ray", longest_ray(arms, work))
    emit(out, "compact_times", time_compact(arms, work, args.rounds))
    if not args.compact_only:
        emit(out, "times", time_arms(arms, dev, args.rounds))
    (REPO / args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
