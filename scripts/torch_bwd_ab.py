"""The port's backward trace kernel, one build against another, on one NVIDIA GPU.

    python scripts/torch_bwd_ab.py --arm parent=TREE --arm new=TREE
        [--rounds 3] [--out build/ab/bwd_ab.json]

Each arm is a checkout of the repository (``git archive`` of a commit
unpacked beside the tree, say). Each arm's
``gpgpuraytrace_tpu_torch/kernels/csrc/trace_bwd.cu`` is built with the
library's own nvcc flags (``kernels/build.py``), all arms at once, into a
library of its own, loaded with ctypes beside the others. The (t, hit) every
arm pulls back comes from this tree's forward kernel (its outputs held to
``chip_smoke.py:EXPECTED_DIGESTS`` too). Then, on one card:

1. ptxas's registers and spills of every backward kernel of each arm;
2. the SHA-256 digest of the backward's output on both terrains at 512x512
   with 6 octaves, float32 and bf16 march channel, on the primed fine
   frame's (t, hit) with a seeded normal cotangent: the four backward
   entries of ``chip_smoke.py:output_digests`` (held to
   ``chip_smoke.py:EXPECTED_DIGESTS``); arms whose digests differ are named,
   with each packed entry's gap to the first arm's;
3. a SASS census of each arm's float32 kernel (the pixel's adjoint,
   ``pixel_bwd``, is inlined in it) by ``cuobjdump -sass``: instructions by
   class, and the floors, two per 2D noise evaluation in the code (one
   octave loop when the reverse loop reuses its noise, as this design's
   does, two when it computes it again, as the parent's does) and three in
   the 3D warp's loop, and every loop's classes;
4. each arm's backward on the four inputs: one launch of the C entry point
   (both stages) as a CUDA graph of 50 replayed between CUDA events (device
   time; the kept scratch, so no zeroing runs between launches), and 50
   back to back between CUDA events; each stage's device time
   by torch.profiler over 20 launches; arms in turns (in order, then
   reversed), ``--rounds`` times;
5. each distinct tree's own wrapper (``kernels/trace.py:trace_frame_bwd``) in
   a fresh process in that tree: host microseconds per call (the least of 5
   runs of 200 calls enqueued after a synchronisation, host clock) and 50
   calls back to back between CUDA events; and the device kernels of one
   training step (``ops.fit.fit_step``, torch.profiler), those with "copy"
   in their name counted apart; trees in turns.

``scripts/torch_fwd_ab.py`` launches each of its arms' backward through
``Arm`` too (the backward digests of ``chip_smoke.py:output_digests``).

A launcher's signature is read from the arm's source: the struct
TraceBwdConfig field by field (a design after the parent's adds the
cotangent's two strides). Prints one JSON line per section and writes them
all to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
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

from chip_smoke import EXPECTED_DIGESTS, digest, ptxas_lines  # noqa: E402
from gpgpuraytrace_tpu_torch.kernels import build as kbuild  # noqa: E402
from gpgpuraytrace_tpu_torch.kernels import pack as kpack  # noqa: E402
from gpgpuraytrace_tpu_torch.kernels import trace as ktrace  # noqa: E402
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene  # noqa: E402
from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse  # noqa: E402
from gpgpuraytrace_tpu_torch.utils import packing as pk  # noqa: E402

CSRC = Path("gpgpuraytrace_tpu_torch/kernels/csrc")
TERRAINS = {"heightfield": False, "volumetric": True}
REPS = 50

CHILD = r"""
import json, time
import torch
from gpgpuraytrace_tpu_torch import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.kernels.trace import render_kernel_raw, trace_frame_bwd
try:  # a tree with the pack kernel packs CUDA scenes there
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_scene
except ImportError:
    from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

res = {}
for terrain, vol in (("heightfield", False), ("volumetric", True)):
    for bf16 in (False, True):
        scene = default_scene(6, volumetric=vol, device="cuda")
        cfg = RenderConfig(num_octaves=6, volumetric=vol, march_bf16=bf16)
        _, t, hit = render_kernel_raw(scene, cfg)
        packed, seed = pack_scene(scene, 512, 512, 0.0)
        g = torch.randn(3, 512, 512, generator=torch.Generator().manual_seed(0)).to("cuda")
        args = (packed.detach(), seed, cfg, 512, t, hit.float(), g)
        for _ in range(10):
            trace_frame_bwd(*args)
        best = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                trace_frame_bwd(*args)
            best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            trace_frame_bwd(*args)
        end.record()
        end.synchronize()
        res[f"{terrain}/{'bf16' if bf16 else 'f32'}"] = {
            "host_us": 1e6 * best / 200, "back_to_back_ms": start.elapsed_time(end) / 50}
    # One training step's device kernels (torch.profiler), after two warm-up steps.
    from torch.profiler import ProfilerActivity, profile
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod
    cfg = RenderConfig(num_octaves=6, volumetric=vol)
    with torch.no_grad():
        target = render(scene, cfg)
    start = fitmod.perturb_scene(scene, torch.Generator().manual_seed(0), rel=0.15)
    opt = fitmod.make_optimizer(fitmod.partition_scene(start), 5e-3)
    for _ in range(2):
        fitmod.fit_step(start, cfg, target, opt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fitmod.fit_step(start, cfg, target, opt)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    res[f"{terrain}/step"] = {"kernels": len(kernels),
                              "copies": sum("copy" in k.lower() for k in kernels)}
print(json.dumps(res))
"""


def emit(out: dict, key: str, value) -> None:
    out[key] = value
    print(json.dumps({key: value}), flush=True)


@dataclasses.dataclass
class ArmSpec:
    name: str
    tree: Path

    @property
    def source(self) -> Path:
        return self.tree / CSRC / "trace_bwd.cu"


def parse_arm(text: str) -> ArmSpec:
    name, tree = text.split("=", 1)
    return ArmSpec(name, Path(tree).resolve())


def build_all(arms: list[ArmSpec], root: Path) -> dict[str, tuple[Path, str]]:
    """Compile every arm's trace_bwd.cu at once, then link each into its own
    library: {arm: (library, ptxas log)}."""
    nvcc = kbuild.find_nvcc()
    procs = {}
    for arm in arms:
        out = root / "lib" / arm.name
        if out.exists():
            shutil.rmtree(out)
        out.mkdir(parents=True)
        cmd = [nvcc, *kbuild.NVCC_FLAGS, "-c", str(arm.source), "-o", str(out / "trace_bwd.o")]
        procs[arm.name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
    built = {}
    for arm in arms:
        text, _ = procs[arm.name].communicate()
        if procs[arm.name].returncode:
            raise SystemExit(f"{arm.name}: nvcc failed\n{text}")
        out = root / "lib" / arm.name
        lib = out / "libtrace_bwd.so"
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                        str(lib), str(out / "trace_bwd.o")], check=True)
        built[arm.name] = (lib, text)
    return built


class Arm:
    """One built backward library (``lib_path``, built from ``source``), its
    config struct read from the source and its scratch, zeroed once and kept
    (the counter of a design that has one is left at 0 by every launch)."""

    def __init__(self, name: str, lib_path: Path, source: Path):
        self.name = name
        self.lib = ctypes.CDLL(str(lib_path))
        body = re.search(r"struct TraceBwdConfig \{(.*?)\};", source.read_text(),
                         re.S).group(1)
        fields = re.findall(r"\bint (\w+);", body)
        self.cfg_type = type(f"TraceBwdConfig_{name}", (ctypes.Structure,),
                             {"_fields_": [(f, ctypes.c_int) for f in fields]})
        self.lib.trace_bwd_scratch_floats.argtypes = [self.cfg_type]
        self.lib.trace_bwd_scratch_floats.restype = ctypes.c_int
        self.lib.trace_bwd_launch.argtypes = [ctypes.c_void_p] * 7 + [
            self.cfg_type, ctypes.c_void_p]
        self.lib.trace_bwd_launch.restype = ctypes.c_int
        # One scratch per arm, zeroed once; every launch runs on one stream.
        self.scratch = None

    def kcfg(self, cfg, h):
        values = dict(height=cfg.height, width=cfg.width, local_h=h,
                      num_octaves=cfg.num_octaves, volumetric=int(cfg.volumetric),
                      warp_octaves=cfg.warp_octaves, bf16=int(cfg.march_bf16),
                      g_channel_stride=h * cfg.width, g_pixel_stride=1)
        return self.cfg_type(**{f: values[f] for f, _ in self.cfg_type._fields_})

    def bwd(self, packed, seed, cfg, h, t, hit, g, pbar=None):
        kcfg = self.kcfg(cfg, h)
        n = self.lib.trace_bwd_scratch_floats(kcfg)
        if self.scratch is None or self.scratch.numel() < n:
            self.scratch = torch.zeros(n, dtype=torch.float32, device=packed.device)
        if pbar is None:
            pbar = torch.empty((1, pk.AMPS + cfg.num_octaves), dtype=torch.float32,
                               device=packed.device)
        err = self.lib.trace_bwd_launch(
            *(x.data_ptr() for x in (packed, seed, t, hit, g, self.scratch, pbar)), kcfg,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: trace_bwd_launch returned CUDA error {err}")
        return pbar


def inputs(dev) -> dict:
    """The four backward inputs of output_digests: {tag: (packed, seed, cfg,
    h, t, hit, g)}, tag as its digest key without "bwd"."""
    work = {}
    with torch.no_grad():
        for terrain, vol in TERRAINS.items():
            scene = default_scene(6, volumetric=vol, device=dev)
            packed, seed = (x.detach() for x in kpack.pack_scene(scene, 512, 512, 0.0))
            for bf16 in (False, True):
                cfg = RenderConfig(num_octaves=6, volumetric=vol, march_bf16=bf16)
                ccfg = coarse_prime_cfg(cfg)
                cp, cs = (x.detach() for x in kpack.pack_scene(scene, ccfg.height, ccfg.width,
                                                             -1.0))
                coarse = ktrace.trace_frame(cp, cs, ccfg, cfg.height // cfg.prime_ds + 2)
                prime = prime_from_coarse(coarse[1], cfg)
                _, t, hit = ktrace.trace_frame(packed, seed, cfg, 512, prime)
                g = torch.randn(3, 512, 512, generator=torch.Generator().manual_seed(0)).to(dev)
                work[f"{terrain}/{'bf16/' if bf16 else ''}"] = (packed, seed, cfg, 512, t, hit,
                                                                g)
    return work


def sass_census(lib_path: Path, dump: Path) -> dict:
    """The float32 backward kernel in SASS: instructions by class, the
    floors (FRND, two per 2D noise evaluation plus three per 3D one) and
    every loop (a backward branch) with its classes. Writes the function's
    SASS to ``dump``."""
    cuobjdump = Path(kbuild.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", sass)
             if re.match(r"\S*trace_bwd_kernelILb0E", f)]
    if not funcs:
        return {"error": "no float32 trace_bwd_kernel in the SASS"}
    body = funcs[0]
    dump.write_text(body)
    insts = [(int(m.group(1), 16), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
    classes = {
        "fp32": ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "MUFU"),
        "fp64": ("DFMA", "DMUL", "DADD", "DSETP"),
        "int": ("IMAD", "IMUL", "LOP3", "SHF", "IADD3", "ISETP", "LEA", "SEL", "IABS", "PRMT",
                "IMNMX", "SHL", "SHR", "LOP"),
        "convert": ("F2I", "I2F", "FRND", "F2F", "I2FP", "F2IP"),
        "shared": ("LDS", "STS"),
        "shuffle": ("SHFL",),
        "global": ("LDG", "STG", "LDC", "ULDC", "LD", "ST", "ATOM", "ATOMG", "RED"),
    }

    def klass(op: str) -> str:
        root = op.split(".")[0]
        return next((k for k, ops in classes.items() if root in ops), "other")

    def counts(lo: int, hi: int) -> dict:
        c = collections.Counter(klass(op) for a, op in insts if lo <= a <= hi)
        c["all"] = sum(c.values())
        return dict(c)

    loops = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?BRA[^;]*?0x([0-9a-f]+)", body):
        addr, target = int(m.group(1), 16), int(m.group(3), 16)
        if target <= addr:
            loops.append((target, addr))
    return {"function": body.split("\n", 1)[0].strip()[:160],
            "classes": counts(0, 1 << 62),
            "floors": sum(op.startswith("FRND") for _, op in insts),
            "loops": [{"range": f"{lo:#x}-{hi:#x}", "classes": counts(lo, hi)}
                      for lo, hi in sorted(loops)]}


def profile_stages(arm: Arm, args, n: int = 20) -> dict:
    """Device microseconds per launch of each backward kernel, by name."""
    from torch.profiler import ProfilerActivity, profile

    arm.bwd(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            arm.bwd(*args)
        torch.cuda.synchronize()
    return {e.key[:48]: e.self_device_time_total / n for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "trace_bwd" in e.key}


def time_arms(arms: dict[str, Arm], work: dict, rounds: int) -> dict:
    """Per arm and input, ms per launch: a CUDA graph of 50 launches replayed
    between CUDA events ("graph": device time) and 50 launches back to back
    ("b2b"), arms in turns; and each stage's device us (profiler)."""
    graphs = {}
    for name, arm in arms.items():
        for key, args in work.items():
            pbar = arm.bwd(*args)  # warm-up; the scratch exists before capture
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(REPS):
                    arm.bwd(*args, pbar=pbar)
            graphs[name, key] = g
    times = collections.defaultdict(list)
    order = list(arms)

    def events(fn) -> float:
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    for r in range(rounds):
        for name in (order + order[::-1]) if r % 2 == 0 else (order[::-1] + order):
            arm = arms[name]
            for key, args in work.items():
                label = f"{name} {key}"
                times[label + " graph"].append(events(graphs[name, key].replay))
                times[label + " b2b"].append(events(
                    lambda: [arm.bwd(*args) for _ in range(REPS)]))
    out = {k: {"min": min(v), "median": statistics.median(v), "all": v}
           for k, v in times.items()}
    for name, arm in arms.items():
        for key, args in work.items():
            out[f"{name} {key} stages_us"] = profile_stages(arm, args)
    return out


def run_child(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: exited {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def wrapper_times(specs: list[ArmSpec], rounds: int) -> dict:
    """Each distinct tree's wrapper in a fresh process, trees in turns."""
    trees = {}
    for spec in specs:
        trees.setdefault(spec.tree, spec.name)
    for tree in trees:  # each tree builds its own kernels first
        run_child(tree)
    order = list(trees)
    turns = collections.defaultdict(list)
    for r in range(rounds):
        for tree in (order + order[::-1]) if r % 2 == 0 else (order[::-1] + order):
            for key, v in run_child(tree).items():
                turns[f"{trees[tree]} {key}"].append(v)
    return {k: {m: {"min": min(x[m] for x in v), "median": statistics.median(x[m] for x in v),
                    "max": max(x[m] for x in v)}
                for m in v[0]} for k, v in turns.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", action="append", required=True, help="name=checkout")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="build/ab/bwd_ab.json")
    ap.add_argument("--work", default="build/ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    out: dict = {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    emit(out, "card", smi)
    out_path = REPO / args.out
    out_path.parent.mkdir(parents=True, exist_ok=True)
    specs = [parse_arm(a) for a in args.arm]
    built = build_all(specs, REPO / args.work)
    emit(out, "ptxas", {name: [ln for ln in ptxas_lines(log) if not ln.startswith("---")]
                        for name, (_, log) in built.items()})
    arms = {s.name: Arm(s.name, built[s.name][0], s.source) for s in specs}
    work = inputs(dev)
    pbars = {name: {key: arm.bwd(*args) for key, args in work.items()}
             for name, arm in arms.items()}
    torch.cuda.synchronize()
    dig = {name: {key + "bwd": digest([p]) for key, p in d.items()} for name, d in pbars.items()}
    emit(out, "digests", dig)
    emit(out, "digests_differ_from_recorded",
         {name: sorted(k for k, v in d.items() if v != EXPECTED_DIGESTS[k])
          for name, d in dig.items()})
    ref = next(iter(arms))
    gaps = {}
    for name, d in pbars.items():
        for key, p in d.items():
            r = pbars[ref][key]
            if not torch.equal(p, r):
                gap = ((p - r).abs() / r.abs().clamp(min=1e-30))[0]
                gaps[f"{name} {key}"] = {"entries_differ": int((p != r).sum()),
                                         "max_rel_gap": gap.max().item(),
                                         "rel_gap": gap.tolist()}
    emit(out, "gaps_to_" + ref, gaps)
    emit(out, "sass", {s.name: sass_census(built[s.name][0], out_path.with_name(
        f"sass_bwd_{s.name}.txt")) for s in specs})
    emit(out, "times", time_arms(arms, work, args.rounds))
    emit(out, "wrapper", wrapper_times(specs, max(1, args.rounds - 1)))
    out_path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
