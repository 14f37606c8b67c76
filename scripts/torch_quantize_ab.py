"""The tonemap-and-quantize kernel's design arms, in turns, on one NVIDIA GPU.

    python scripts/torch_quantize_ab.py --parent DIR [--new DIR] [--rounds 3]
        [--out build/ab/quant_ab.json]

``--parent`` is a copy of ``gpgpuraytrace_tpu_torch/kernels/csrc`` from a
commit before the level table (``git archive`` of it unpacked beside the
tree), ``--new`` the one to measure (the package's own by default). Each arm
is a copy of one ``quantize.cu``, built alone into a library with the
package's nvcc flags (one nvcc per arm, all at once):

a. the parent's kernel as it is (a pixel per thread, three powf);
b. the parent with ``powf(c, gamma)`` replaced by ``c``: its values are
   wrong, it is for timing only (the chain's cost without the powf);
c. the new memory design (4 pixels a thread in 16-byte loads, the 1-D
   grid-stride walk) with the parent's chain inlined in place of the table;
d. the new kernel as it is;
e. the new kernel with a branch-free 8-step search over the 256 edges in
   place of the piece table and its compare.

The arms with a table make it with their own scan kernel
(``kernels/quantize.py:make_table``). Then, on the view of
``render_frames_raw``'s (B, 3, H, W) planes at 1920x1080 x 4, x 8 and
512x512 x 4 (6 octaves, the default scene and config): each arm's output
against ``tonemap_quantize_reference``'s (the values that differ; b's are
expected to); its device time as a CUDA graph of ``QUANT_REPS`` launches
(``chip_smoke.py:graph_ms``), arms in turns (in order, then reversed),
``--rounds`` times; ptxas's registers; and from ``cuobjdump -sass`` each
arm's kernel (``sass_<arm>.txt`` beside ``--out``): its static
instructions a pixel (``chip_smoke.py:sass_per_pixel``) with the issue
bound they give (``WARP_ISSUE_PER_S``) beside the byte bound; and, each
round, a device-to-device copy of the same planes (``copy_``, 24 bytes a
pixel moved), for the rate a plain stream reaches: every arm's and the
copy's bytes over their median time. Prints one JSON line per section
and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    HBM_BYTES_PER_S, QUANT_REPS, WARP_ISSUE_PER_S, graph_ms, ptxas_lines, quantize_sass,
)
from gpgpuraytrace_tpu_torch.kernels import build as kbuild  # noqa: E402
from gpgpuraytrace_tpu_torch.kernels import quantize as kq  # noqa: E402
from gpgpuraytrace_tpu_torch.kernels.trace import render_frames_raw  # noqa: E402
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene  # noqa: E402
from gpgpuraytrace_tpu_torch.ops.flythrough import flythrough_cameras  # noqa: E402

SHAPES = ((4, 1080, 1920), (8, 1080, 1920), (4, 512, 512))
PARENT_CHAIN = """
__device__ __forceinline__ unsigned char quantize_channel(float x, float gamma) {
  float c = clamp01(__fdiv_rn(x, __fadd_rn(1.f, x)));
  c = clamp01(powf(c, gamma));
  const float v = __fadd_rn(__fmul_rn(c, 255.f), 0.5f);
  return static_cast<unsigned char>(static_cast<long long>(v));
}
"""
LOOKUP = """  const int i = min(max(static_cast<int>(bits >> kPieceShift) - t.base, 0), t.last);
  const unsigned k0 = t.piece[i];
  const unsigned k = k0 + (bits >= t.edge[k0 + 1]);
"""
SEARCH = """  unsigned k = 0;
#pragma unroll
  for (unsigned step = 128; step; step >>= 1) {
    k += bits >= t.edge[k + step] ? step : 0;
  }
"""
FAST_CALL = "lv[p][c] = table_level(__float_as_uint(lane(v[u][c], p)), t, exact);"


def replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"arm source: expected one {old!r}")
    return src.replace(old, new)


def arm_sources(parent: Path, new: Path) -> dict[str, str]:
    old_src = (parent / "quantize.cu").read_text()
    new_src = (new / "quantize.cu").read_text()
    chain_at = "struct Table {"
    return {
        "a": old_src,
        "b": replace(old_src, "powf(c, gamma)", "c"),
        "c": replace(replace(new_src, chain_at, PARENT_CHAIN + "\n" + chain_at), FAST_CALL,
                     "lv[p][c] = quantize_channel(lane(v[u][c], p), gamma);"),
        "d": new_src,
        "e": replace(new_src, LOOKUP, SEARCH),
    }


def build_arms(sources: dict[str, str], root: Path) -> dict[str, tuple[Path, str]]:
    """One library per arm, every nvcc at once: {arm: (library, ptxas log)}."""
    nvcc = kbuild.find_nvcc()
    procs = {}
    for name, src in sources.items():
        out = root / name
        if out.exists():
            shutil.rmtree(out)
        out.mkdir(parents=True)
        (out / "quantize.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *kbuild.NVCC_FLAGS, "-shared", str(out / "quantize.cu"), "-o",
             str(out / "libquantize.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"arm {name}: nvcc failed\n{log}")
        built[name] = (root / name / "libquantize.so", log)
    return built


class Arm:
    """One arm's library; ``table`` is its own (None for the parent's)."""

    def __init__(self, name: str, lib_path: Path, dev):
        self.name = name
        self.lib = ctypes.CDLL(str(lib_path))
        self.table = None
        f = self.lib.tonemap_quantize_launch
        f.restype = ctypes.c_int
        if hasattr(self.lib, "tonemap_quantize_scan_launch"):
            f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_longlong] * 7
                          + [ctypes.c_void_p])
            scan = self.lib.tonemap_quantize_scan_launch
            scan.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_uint, ctypes.c_void_p]
            scan.restype = ctypes.c_int
            self.lib.trace_error_string = kq._library().trace_error_string
            self.table = kq.make_table(self.lib, dev)
        else:
            f.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 7 + [ctypes.c_void_p]

    def __call__(self, x: torch.Tensor, out: torch.Tensor) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        table = [] if self.table is None else [self.table.words.data_ptr(),
                                               self.table.words.numel()]
        err = self.lib.tonemap_quantize_launch(x.data_ptr(), out.data_ptr(), *table,
                                               *x.shape[:3], *x.stride(), stream)
        if err:
            raise RuntimeError(f"arm {self.name}: launch failed, CUDA error {err}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="csrc directory before the level table")
    ap.add_argument("--new", default=str(REPO / "gpgpuraytrace_tpu_torch/kernels/csrc"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="build/ab/quant_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    out: dict = {}

    def emit(key, value):
        out[key] = value
        print(json.dumps({key: value}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.strip().split(", ")
    emit("card", {"name": smi[0], "power_limit_w": smi[1], "sm_clock_max_mhz": smi[2]})
    out_path = REPO / args.out
    out_path.parent.mkdir(parents=True, exist_ok=True)
    sources = arm_sources(Path(args.parent), Path(args.new))
    built = build_arms(sources, out_path.parent / "quant")
    emit("ptxas", {name: [ln for ln in ptxas_lines(log) if "registers" in ln or "spill" in ln]
                   for name, (_, log) in built.items()})
    arms = {name: Arm(name, lib, dev) for name, (lib, _) in built.items()}
    emit("tables", {name: {"changes": a.table.changes, "windows": len(a.table.windows),
                           "exact_patterns": a.table.exact_patterns,
                           "scan_s": a.table.seconds}
                    for name, a in arms.items() if a.table is not None})
    sass = {}
    for name, (lib, _) in built.items():
        sass[name] = quantize_sass(lib, lib.with_name("quantize.cu"))
        out_path.with_name(f"sass_{name}.txt").write_text(sass[name].pop("sass"))

    scene = default_scene(6, device=dev)
    work = {}
    with torch.no_grad():
        for b, h, w in SHAPES:
            cfg = RenderConfig(num_octaves=6, height=h, width=w)
            t = torch.arange(b, dtype=torch.float32) / 30.0
            color = render_frames_raw(scene, flythrough_cameras(scene, t), cfg)[0]
            work[f"{b}x{w}x{h}"] = (color, kq.tonemap_quantize_reference(color))
    pixels = {key: color.shape[0] * color.shape[1] * color.shape[2]
              for key, (color, _) in work.items()}
    outs = {key: torch.empty(ref.shape, dtype=torch.uint8, device=dev)
            for key, (_, ref) in work.items()}
    differ = {}
    for name, arm in arms.items():
        for key, (color, ref) in work.items():
            got = outs[key]
            arm(color, got)
            torch.cuda.synchronize()
            differ[f"{name} {key}"] = int((got != ref).sum())
    emit("differ", differ)
    bounds = {key: {"bytes_ms": 1e3 * 15 * n / HBM_BYTES_PER_S,
                    **{f"issue_ms {name}": 1e3 * n * s["per_pixel"] / 32 / WARP_ISSUE_PER_S
                       for name, s in sass.items()}}
              for key, n in pixels.items()}
    emit("sass", sass)
    emit("bounds", bounds)
    times = collections.defaultdict(list)
    order = list(arms)
    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            for key, (color, _) in work.items():
                times[f"{name} {key}"].append(graph_ms(
                    lambda a=arms[name], c=color, o=outs[key]: a(c, o), QUANT_REPS))
        for key, (color, _) in work.items():
            planes = color.permute(0, 3, 1, 2)
            copy = torch.empty_like(planes)
            times[f"copy {key}"].append(graph_ms(lambda c=copy, p=planes: c.copy_(p),
                                                 QUANT_REPS))
    emit("times", {k: {"min": min(v), "median": statistics.median(v), "all": v}
                   for k, v in times.items()})
    emit("rates_tb_s", {k: (24 if k.startswith("copy") else 15) * pixels[k.split(" ", 1)[1]]
                        / v["median"] / 1e9 for k, v in out["times"].items()})
    out_path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
