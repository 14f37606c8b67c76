"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths at 512x512 with 6 octaves under the default
RenderConfig, through the hand-written CUDA trace kernels: serving
(``gpgpuraytrace_tpu_torch.render`` of a frame) and training (``ops.fit.fit``,
forward and backward, Adam steps), on the heightfield (phases 3-10) and on
the volumetric terrain with its 2-octave 3D warp (phases 11-14). In phases;
each prints one line and any failure exits non-zero:

1. host: CUDA present; card name and power limit; CUDA and nvcc versions;
2. build: the kernels from gpgpuraytrace_tpu_torch/kernels/csrc, one nvcc
   per source, in parallel, beside the test-only noise probe; no kernel
   spills (ptxas), and compaction's phase 2 at its recorded registers;
3. the forward kernel against its plain PyTorch version on the card, at the
   main path's shapes (coarse prime pass 66x64, then the 512x512 pass), and
   on frames that are not whole warp tiles (a 37x100 band at row 5, one
   512-pixel row), each bit for bit its whole frame's pixels; the fine
   pass's time, and the coarse pass's, back to back and as a CUDA graph;
4. the serving path: 3 frames at 3 camera yaws, 2 forward launches each;
5. the frozen golden image (tests/golden/config1_128.npy) through the kernel;
6. the command line renders a PNG, heightfield and volumetric;
7. serving frame times, kernel path vs plain path, with CUDA events;
8. the backward kernel against its plain version at 512x512, on the forward
   kernel's own (t, hit), bitwise repeatable (on a second stream and in CUDA
   graph replays too); its time as a CUDA graph and back to back, and the
   wrapper's host time per call;
9. the training path: 5 Adam steps of fit, 2 forward and 1 backward launch
   each, falling loss; kernel_bwd True vs False gradients; step times;
10. AD against finite differences through the kernel path at 512x512, on
    tests/test_grad.py's 2-octave scene (the 6-octave scene reported only);
11. volumetric: phase 3 on the volumetric terrain;
12. volumetric serving: 3 frames at 3 yaws, 2 forward launches each; frame
    times, kernel path vs plain path; the device's busy share;
13. volumetric: phase 8 on the volumetric terrain, warp entries non-zero;
    the default backward instantiation's registers and device time (both
    terrains) held to their record;
14. volumetric training: 5 Adam steps of fit with the warp amplitude
    trainable, 2 forward and 1 backward launch each, falling loss;
    kernel_bwd True vs False gradients; step times; AD vs FD of the warp
    amplitude on a 2-octave volumetric scene, reported only;
15. the executed-step counter (``debug_steps``), both terrains: it changes no
    output bit, JAX's per-tile bounds hold against the plain stats march from
    the same prime map; useful steps per ray, executed steps per lane, per
    warp and per TPU tile, the two divergence taxes, exhausted lanes;
16. ``march_mode="fixed"``: bit for bit equal to chunked, against its plain
    version with phase 3's gates, times at 128 and 64 steps and the marginal
    cost of a march step beside its bound;
17. ``march_mode="lod"``: against its plain version (phase 3's gates), the
    counted launch bit for bit equal to the uncounted one, against chunked
    (the JAX variant contract), its time beside chunked's;
18. ``march_bf16`` under each march mode: the 2D noise's bf16 arithmetic on
    the card against torch's, bit for bit (the test-only
    tests/csrc/noise2_probe.cu); the kernel against its plain version with
    the bf16 gates, and apart from the float32 instantiation on the same
    inputs; chunked+bf16 against the float32 frame with the JAX bf16
    contract; times beside float32's;
19. ``utils/profiling.py`` on both scenes: ``march_stats``, ``warn_if_rough``
    (and its warning on a rough scene), ``Timer`` and ``trace``;
20. ``march_mode="compact"`` (two-phase ray compaction, budget 32), both
    terrains: ``render`` launches phase 1 and phase 2 once each and nothing
    else; each phase kernel against its plain version (phase 3's gates,
    phase 2's on the survivors' pixels only; ``alive`` and the survivors'
    list exactly); the compact frame against the unprimed chunked kernel's
    with JAX's exactness contract, traced with host syncs raising; the
    survivors; the times of phase 1 and phase 2 (each as a CUDA graph of 50
    and back to back, phase 2's calls restoring phase 1's t, less the
    restores; each kernel by the profiler; each wrapper's host time per
    call) beside the unprimed and primed chunked passes; one training step
    under compact; the default instantiation's registers and fine-pass
    times, and phase 2's graph time, held to their record;
21. the flythrough: ``fly_frames`` at 512x512, 8 frames in batches of 4 under
    the default config and 4 under compact, one launch per pass per batch
    (the kernels' frame axis), each frame equal to ``render`` of its camera,
    tonemapped and quantized; a tweak file read between batches changes the
    next batch and reports an unknown name; the command line's ``fly`` and
    ``tweaks``; frames per second with and without writing;
22. the backward kernel's bf16 instantiation (its march channel through the
    bf16 field), both terrains: a training step under ``march_bf16`` launches
    it; against its plain version on the bf16 frame's (t, hit), with phase
    8's gates on the training loss's cotangent and the bf16 backward gates on
    a seeded normal one, bitwise repeatable (streams and graph replays too),
    and apart from the float32 instantiation on the same inputs; its times
    as phase 8's;
23. bit for bit: a SHA-256 digest of every output of every forward
    instantiation (coarse and fine pass, both terrains, compaction's two
    phases, the ragged frames) and of the backward, equal to the digests
    recorded before the forward kernel's warp tiles and the backward's warp
    groups (``EXPECTED_DIGESTS``);
24. march quality: tests/test_torch_quality.py's harness through the
    forward kernel against a dense plain oracle: both terrains within the
    reference's bounds, and the over-relaxed march outside them; and at the
    main path's 6 octaves (its unrolled instantiation) too, each config
    within the harness's margins of the plain path's own counts;
25. the fit loop, both terrains: ``fit`` of 24 steps in chunks of 8 (the
    first chunk eager, the rest replays of one CUDA graph of 8 whole steps)
    against 24 single steps, bit for bit, with the launch counts of the eager
    chunk and the capture (counted once, not per replay); killed at step 6
    of 12 and resumed from its checkpoint in chunks of 3, bit for bit the
    straight run; ms per step eager against graph replays of 8 and 16 steps
    (CUDA events) and the device's busy share of each (profiler); whether
    compaction's path captures (reported); the command line's ``fit --save
    --save-every --steps-per-call 8``, then ``--resume``, ``-o``;
26. the native frame writer (``utils/native_io.py``, built from
    native/tpurt_io.cc): 8 flythrough frames at 512x512 written through
    ``AsyncFrameWriter``, the native encoder alone and the Python encoder,
    every PNG decoded equal to its frame; fps of each and without writing;
    the command line's ``fly`` with native=True;
27. row bands, both terrains: a process group of world size 1 on NCCL, its
    sharded render bit for bit ``render`` and a sharded fit step's loss
    ``pixel_loss``'s; 4 bands of 128 rows, each through the kernels from its
    own row0, bit for bit the whole frame, their summed gradients the whole
    frame's within rtol 1e-4, atol 1e-7;
28. batches (the forward kernels' frame axis: the flythrough's temporal ray
    batching, one launch per pass per batch), both terrains: at 512x512,
    batches of 1, 2, 4 and 8 frames along the fly path, each frame's outputs
    (coarse and fine pass, float32 and bf16, compaction's two phases at
    budget 32) bit for bit (SHA-256) its one-frame launch; the batched
    kernels against their plain versions on 2 frames with phase 3's gates,
    their times and bounds; ``fly_frames``, 8 frames in batches of 4, one
    launch per pass per batch, and a batch traced with host syncs raising; a
    1920x1080 batch of 4 bit for bit its one-frame renders; device times as
    CUDA graphs (a batch of 4 against 4 one-frame traces, the coarse pass of
    4 frames against 1), the wrapper's host us per launch, one frame and a
    batch, and of each part of its launcher; fly fps without writing at
    batch 1, 4 and 8 at 512x512 and 1920x1080, and the device's busy share
    of a batch of 4;
29. the benchmark (``gpgpuraytrace_tpu_torch/bench.py``, the counterpart of
    the JAX package's ``bench.py``): ``run_bench`` at 512x512, 6 octaves, K =
    40: its same-run parity gate "ok", fwd+bwd rays/s by the slope of CUDA
    graphs of 1 and 40 steps (every float parameter trainable) with a
    training step's forward and backward launches per captured step (phase
    9's), the eager slope, the plain path's (vs_baseline above 1), both
    timed graphs replayed at a fixed salt bit for bit the eager loop, one
    kernel-path step against the plain path's, the march statistics with
    the counter's executed steps; ``run_bench_mesh(1)``, one rank of
    ``parallel/worker.py --time-k`` on NCCL, timed as CUDA graphs with
    ``graph_check`` ok; both JSON lines printed;
30. the flythrough batch as one CUDA graph: ``tonemap_quantize`` against its
    plain version at 512x512 x 4, 1920x1080 x 4 and x 8 on both terrains and
    modes (0 values may differ), its times beside its byte bound and the
    issue bound of its fast path's SASS instructions a pixel (read from the
    built library); all 2^32 float32 inputs through the kernel and the plain
    version on the card (0 may differ), with the level table's edges and
    windows; ``fly_frames`` of 10 frames in batches of 4 and 8 with a tweak
    before the last batch, every frame bit for bit ``render_frame_uint8``;
    the host copy pageable vs pinned; fps and busy share, graph vs eager;
31. BASELINE.json config 5 (a 3840x2160 frame, 6 octaves, ``max_steps``
    128, ``prime_ds`` 8): the 4K frame through ``render``, 2 forward
    launches, finite, a sky-blue top; phase 27 at 4K (on an NCCL group of
    one ``sharded_render`` bit for bit ``render``; 2 bands of 1080 rows from
    their own row0 bit for bit the whole frame, their summed gradients the
    whole frame's within phase 27's bounds); bands of 16 rows at row 1072
    (across the bands' edge) and 2144 (the bottom) through the kernels
    against the plain path with phase 3's gates, each bit for bit the whole
    frame's rows; the coarse and fine pass and the backward on the whole 4K
    frame against their plain versions (phase 3's and phase 8's gates),
    then as CUDA graphs beside their bounds for this frame; one rank's rows
    of the 4K fit over 4 ranks at prime_ds 4 as its 15 stripes of 36 rows
    (one batch of the one camera: its packed rows, a ROW0 per frame, bit for
    bit the plain packing's ops; its passes against their plain versions;
    its render bit for bit each stripe's; its backward, one launch pair, bit
    for bit the stripes' one-frame launches and against its plain version,
    its packed cotangent through the VJP kernel within 1e-6 of autograd
    through the plain packing; its times beside the one-frame launches;
    the rank's step through its stripes, ``band_loss_and_grad`` captured as
    one CUDA graph, its launches counted at the capture, its gradients
    against the plain backward at its (t, hit) with phase 8's gates, its loss
    and gradients against the plain path's own march);
    ``make_sharded_fit_step`` on
    the group of one, its eager
    warm-up and 3 replays of one CUDA graph bit for bit 4 eager steps of a
    copy, the launches counted at the capture; a ``dist.all_reduce``
    captured in a CUDA graph and replayed; and
    ``scripts/torch_contract_configs.py``'s config 5 (its JSON line
    printed): the frame's and the fwd+bwd step's ms by the slope of CUDA
    graphs of 1 and 6 salted steps beside the eager loop's, both
    ``graph_check`` ok, their launches per captured step;
32. the scene-packing kernels (``kernels/pack.py``): over 3000 seeded scenes
    and batches of 1 to 5 cameras, and at each benchmark cell's shape
    (512x512, a 1080p batch of 4, the 4K frame's four 540-row bands at
    prime_ds 4), ``pack_kernel``'s fine and coarse rows bit for bit the plain
    packing's ops (``utils/packing.py:_pack_scenes``) run on the card, and
    ``pack_vjp_kernel``'s gradients against autograd through those ops; both
    kernels and the plain ops as CUDA graphs beside their byte bounds; their
    launches on the fit loop (``fit`` in chunks), the fly batch
    (``fly_frames``) and phase 31's sharded step.

Phases 15-18, 20-22 and 25-32 each drive their paths through the entry point
a user calls (``render``, ``render_kernel_raw`` for the counter, ``fly_frames``,
``fit_step``, ``fit``, ``sharded_render``, ``make_sharded_fit_step``,
``bench.run_bench``, ``torch_contract_configs.config5``) with the launch counts set to 0 just before and read
just after. On the card ``fly_frames`` replays a CUDA graph for every batch
after the first; a launch counter counts the eager batch and the capture,
not the replays (``FlyBatch.launches`` and ``counted`` say what a batch
launched and how often it was counted).

A line before the last is a JSON record of the kernels, each with its least
time on the card (``bound_ms``, from operation counts of the source, or for
tonemap_quantize its SASS, and the published peaks); the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "config1_128.npy"
# Kernel vs plain version on the card. 99.9% of colour values within 2e-3
# (grazing rays are chaotic: one rounding can make a ray catch or skim a
# ridge) and 99% within 1e-4: FMA contraction and rsqrtf's 2-ulp error move
# the rounding of the bulk, so 1e-4 rather than the CPU suite's 1e-5.
COLOR_ATOL, COLOR_FRAC = 2e-3, 0.999
BULK_ATOL, BULK_FRAC = 1e-4, 0.99
HIT_AGREE = 0.995
T_ATOL, T_FRAC = 5e-2, 0.999
F32_GATES = {"color": COLOR_FRAC, "bulk": BULK_FRAC, "hit": HIT_AGREE, "t": T_FRAC,
             "mean": float("inf")}
# The bf16 march field's kernel vs its plain version: a bf16 field value
# moves in steps of a bf16 unit, so a last-bit difference in a sample point
# (FMA contraction) can move a march step, and a grazing ray's end with it,
# more often than in float32. Readings on an H100 80GB HBM3 at 700 W (the
# chunked 66x64 coarse and 512x512 fine pass, both terrains): colour
# 99.84-99.94% within 2e-3 and 99.61-99.84% within 1e-4, mean error 1.0e-5 to
# 3.4e-5, hit agreement >= 99.9977%, t 99.70-99.90%. The float32 march's
# output differs from the bf16 march's by a mean error of 1.2e-3 to 4.4e-3
# on the same inputs (plain versions, CPU, 128x128 and its coarse pass), so
# the mean-error gate (2e-4) sits between the two, and BF16_MIN_DIFF asks
# the bf16 kernel to differ from the float32 kernel by a mean error above
# 1e-4: a kernel that ignored its bf16 flag would fail both.
BF16_GATES = {"color": 0.995, "bulk": 0.99, "hit": 0.999, "t": 0.995, "mean": 2e-4}
BF16_MIN_DIFF = 1e-4
# Backward kernel vs its plain version: every packed entry within rtol 1e-3
# plus 1e-4 of the largest. The sums over 262,144 pixels run in another order,
# and rsqrtf, expf and FMA contraction round differently from torch.
BWD_RTOL, BWD_ATOL_REL = 1e-3, 1e-4
# The bf16 backward (its march channel through the bf16 field) vs its plain
# version. On the training loss's cotangent it keeps the backward gates
# (readings on an H100 80GB HBM3 at 700 W: 0.018 and 0.077 of them); on a
# seeded normal cotangent, whose pixel sums cancel, it reads 2.4 of them:
# an input off in its last bits (chiefly t's cotangent, summed in another
# order) moves a bf16 rounding, and so that pixel's contribution, by 2^-8,
# far more often than in float32. So that case is gated at
# rtol 5e-3 plus 5e-4 of the largest (read: 0.48-0.49), where the float32
# instantiation reads 15-21.
BF16_BWD_RTOL, BF16_BWD_ATOL_REL = 5e-3, 5e-4
# Range of the serving frame times recorded before the training path was
# added, on an H100 80GB HBM3 at 700 W (PERF.md, section 5, runs 1-5).
RECORDED_FRAME_MS = (1.0306, 1.4094)
# The packed entries of the volumetric warp's amplitude and frequency
# (utils/packing.py WARP_AMP, WARP_FREQ).
WARP_ENTRIES = slice(48, 50)
# The JAX variant contract between march modes (tests/test_pallas.py): 97% of
# colour values within 5e-2, 95% within 1e-3; and between the bf16 and the
# float32 march: mean image error under 5e-3, under 1% of hit verdicts flipped.
VARIANT_ATOL, VARIANT_FRAC = 5e-2, 0.97
VARIANT_BULK_ATOL, VARIANT_BULK_FRAC = 1e-3, 0.95
BF16_MEAN_ERR, BF16_FLIPS = 5e-3, 0.01
# Least time on the card (bound_ms): the larger of the bytes a kernel must
# move over HBM's rate and, per type, its operations over the peak rate of
# that type. Published peaks of the H100 SXM at its 700 W limit (NVIDIA's data
# sheet and Hopper white paper): HBM 3.35 TB/s; FP32 67 TFLOP/s (132 SMs x 128
# FP32 lanes x 2 for an FMA x 1.98 GHz); INT32 on 64 lanes per SM, 132 x 64 x
# 1.98 GHz; bf16 outside the tensor cores 133.8 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "int32": 132 * 64 * 1.98e9, "bf16": 133.8e12}
# Operations per pixel, counted operator by operator in the sources
# (kernels/csrc/field.cuh, trace_fwd.cu, trace_bwd.cu): each +, -, *, /, min,
# max, floor, compare, select and conversion is one operation of its
# operands' type; a multiply and an add count two, as the FP32 peak counts an
# FMA. "step": a march step's ray point, field sum, hit and escape tests and
# advance; "octave": one heightfield octave of the value-only field (the
# rotation, noise2_value's floors, four corner hashes and gradients, dots,
# fades and blend); "octave_bf16": the same with its blend in bf16;
# "warp_octave": one 3D warp octave (noise3_value, eight corners);
# "grad_octave" and "grad_warp_octave": the same in Field::value_grad (noise2
# with derivatives; fbm3_hess), which the polish calls newton_iters + 1 times
# per hit; "pixel": raygen, envelope and shade. The backward per hit pixel:
# one noise2_hess per octave with its rotation (166 FP32, 49 INT32) and its
# recompute and adjoint sums (94 FP32), and one fbm3_hess per warp octave with
# its adjoint sums; per pixel the raygen and shade adjoint and the column sums.
# (The design before the warp groups evaluated noise2_hess twice per octave;
# its count, 360 and 98, is BWD_OCTAVE_BEFORE, kept to set the old bound
# beside the new.)
OPS = {
    "step": {"fp32": 25, "int32": 2},
    "octave": {"fp32": 77, "int32": 49},
    "octave_bf16": {"fp32": 48, "int32": 49, "bf16": 40},
    "warp_step": {"fp32": 5},
    "warp_octave": {"fp32": 147, "int32": 125},
    "grad_octave": {"fp32": 117, "int32": 49},
    "grad_warp_octave": {"fp32": 480, "int32": 125},
    "pixel": {"fp32": 90},
    "bwd_octave": {"fp32": 260, "int32": 49},
    "bwd_warp_octave": {"fp32": 485, "int32": 125},
    "bwd_pixel": {"fp32": 260},
    # The bf16 march channel per hit and octave (trace_bwd.cu, field.cuh:
    # noise2_value_bf16_bwd): the rotation, the floors, the hash and the
    # conversions, 40 bf16 operations forward and 57 back, and the float
    # accumulations of the amplitude, frequency and position cotangents.
    "bwd_octave_bf16": {"fp32": 50, "int32": 49, "bf16": 97},
}
# tonemap_quantize's operations are read from the built library instead
# (quantize_sass): its fast path's SASS instructions a pixel, issued at one
# warp instruction a cycle on each of an SM's four sub-partitions, at the
# 1.98 GHz of the peaks above.
WARP_ISSUE_PER_S = 4 * 132 * 1.98e9
FLOAT_OPS = ("FADD", "FFMA", "FMUL", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FRND", "MUFU")
BWD_OCTAVE_BEFORE = {"fp32": 360, "int32": 98}
# Compaction's phase-1 budget on the main path (RenderConfig's default), and
# JAX's exactness contract between the compact and the unprimed chunked march
# (tests/test_pallas.py:169-190): no hit flip, every colour value within
# 1e-4, t within atol 5e-3 plus rtol 1e-4 where both hit.
COMPACT_BUDGET = 32
COMPACT_COLOR_ATOL, COMPACT_T_ATOL, COMPACT_T_RTOL = 1e-4, 5e-3, 1e-4
# The main path's instantiation (chunked, float32, no counter, its 6 octaves
# unrolled), with the register count and the fine pass's device time (a CUDA
# graph of 50 launches; heightfield, volumetric) that phase 20 holds it to:
# the same registers, and a fine pass at most DEFAULT_FINE_SLACK slower.
# Recorded with the 4x8 warp tiles and persistent warps (PERF.md, section 6): the
# unrolled octaves keep their coefficients in registers, so the count rose
# from 76, and 2 blocks per SM (no register cap below 128) timed fastest. The
# device time, not 50 launches back to back: the wrapper's host time per
# launch (about 0.1 ms) now comes close to the fine pass's.
DEFAULT_KERNEL = "trace_fwd_kernel<chunked, bf16=0, debug=0, octaves=6>"
DEFAULT_REGISTERS, DEFAULT_FINE_MS, DEFAULT_FINE_SLACK = 107, (0.1181, 0.2247), 0.03
# The backward's default instantiation (float32 march channel), with the
# register count and the wrapper's device time under capture (a CUDA graph
# of 50 calls of trace_frames_bwd: both stages and, per call, the zeroing of
# the fresh scratch's counter that a capture gets; heightfield, volumetric)
# that phase 13 holds it to: the same registers, no spill, and at most
# DEFAULT_BWD_SLACK slower.
# Recorded with the warp-per-group design on an H100 80GB HBM3 at 700 W
# (PERF.md, section 6).
DEFAULT_BWD_KERNEL = "trace_bwd_kernel<bf16=0>"
DEFAULT_BWD_REGISTERS, DEFAULT_BWD_MS, DEFAULT_BWD_SLACK = 126, (0.0349, 0.0427), 0.03
# Compaction's phase 2 (persistent ray groups of 2 lanes): its four
# instantiations' register counts, which phase 2 holds them to (no spill
# either), and its float32 device time that phase 20 holds it to, at most
# PHASE2_SLACK slower: a CUDA graph of 50 calls, each restoring phase 1's t
# into the in-place buffer, less a graph of the 50 restores (under capture
# each call's fresh scratch is zeroed too), its median over PHASE2_LISTINGS
# survivor lists from as many launches of phase 1; heightfield, volumetric.
# Recorded with the ray groups on an H100 80GB HBM3 at 700 W as the mean of
# two runs' medians (PERF.md, section 6).
PHASE2_REGISTERS = {"trace_phase2_kernel<bf16=0, octaves=0>": 113,
                    "trace_phase2_kernel<bf16=0, octaves=6>": 117,
                    "trace_phase2_kernel<bf16=1, octaves=0>": 108,
                    "trace_phase2_kernel<bf16=1, octaves=6>": 117}
PHASE2_MS, PHASE2_SLACK = (0.05151, 0.09827), 0.03
PHASE2_LISTINGS = 25
# The TPU kernel's lines each forward instantiation replaces
# (gpgpuraytrace_tpu/kernels/trace.py).
FWD_SOURCE = "gpgpuraytrace_tpu_torch/kernels/csrc/trace_fwd.cu"
REPLACES = {
    "chunked": "gpgpuraytrace_tpu/kernels/trace.py:510",
    "chunked+debug_steps": "gpgpuraytrace_tpu/kernels/trace.py:603",
    "fixed": "gpgpuraytrace_tpu/kernels/trace.py:431",
    "lod": "gpgpuraytrace_tpu/kernels/trace.py:556",
    "chunked+bf16": "gpgpuraytrace_tpu/ops/noise.py:181",
    "fixed+bf16": "gpgpuraytrace_tpu/ops/noise.py:181",
    "lod+bf16": "gpgpuraytrace_tpu/ops/noise.py:181",
    "compact:phase1": "gpgpuraytrace_tpu/kernels/trace.py:610",
    "compact:phase2": "gpgpuraytrace_tpu/kernels/trace.py:650",
    # A batch of frames, one launch (the kernels under the JAX package's vmap,
    # gpgpuraytrace_tpu/ops/flythrough.py:39-55).
    "chunked+frames": "gpgpuraytrace_tpu/kernels/trace.py:510",
    "compact+frames:phase1": "gpgpuraytrace_tpu/kernels/trace.py:610",
    "compact+frames:phase2": "gpgpuraytrace_tpu/kernels/trace.py:650",
    "bwd+bf16": "gpgpuraytrace_tpu/kernels/trace.py:796",
}
# The first 16 hex digits of the SHA-256 of every output's bytes
# (output_digests), read from the forward kernel's design before its 4x8 warp
# tiles and persistent warps (PERF.md, section 6: scripts/torch_fwd_ab.py
# on an H100 80GB HBM3 at 700 W). The redesign moved which warp traces a
# pixel, not a pixel's arithmetic, so every output is held to them bit for
# bit; so are the backward's four after its redesign (warp groups),
# which moved which thread computes a pixel and where a partial sum lives,
# not a pixel's arithmetic or the order of any sum.
EXPECTED_DIGESTS = {
    "heightfield/coarse 66x64": "b5d11c80c0b83bb3",
    "heightfield/chunked primed": "3763758695493f14",
    "heightfield/fixed": "753b1408933dbce8",
    "heightfield/lod": "4031ad09526fe768",
    "heightfield/chunked primed+debug_steps": "daa20374404fb2e0",
    "heightfield/coarse 66x64+debug_steps": "46dff1f72991dc76",
    "heightfield/fixed+debug_steps": "b2a9330be09a3b17",
    "heightfield/lod+debug_steps": "25c9b2536df3ad73",
    "heightfield/chunked unprimed": "753b1408933dbce8",
    "heightfield/compact phase 1": "3137d0f7b26d0e75",
    "heightfield/compact phase 2": "753b1408933dbce8",
    "heightfield/bwd": "9ae609c79a10488a",
    "heightfield/bf16/coarse 66x64": "e5b14111cb773d8a",
    "heightfield/bf16/chunked primed": "bebda83874ca3059",
    "heightfield/bf16/fixed": "5d8d8aa44e0f1f5a",
    "heightfield/bf16/lod": "cc8c4d74aaa7dc36",
    "heightfield/bf16/chunked primed+debug_steps": "5cb7220fba9d969f",
    "heightfield/bf16/coarse 66x64+debug_steps": "cd733bbc5c0c2e89",
    "heightfield/bf16/fixed+debug_steps": "96301db539ff29fb",
    "heightfield/bf16/lod+debug_steps": "91cbcb90934346a8",
    "heightfield/bf16/chunked unprimed": "5d8d8aa44e0f1f5a",
    "heightfield/bf16/compact phase 1": "77aa467364f9b70f",
    "heightfield/bf16/compact phase 2": "5d8d8aa44e0f1f5a",
    "heightfield/bf16/bwd": "da801a85fced9298",
    "heightfield/band 37x100 at row 5": "efe6ddbf81d2d613",
    "heightfield/row 1x512 at row 300": "fe80f733cf865663",
    "volumetric/coarse 66x64": "6caffd0acc2bb169",
    "volumetric/chunked primed": "28c58f9320428d84",
    "volumetric/fixed": "1b85338681d357b9",
    "volumetric/lod": "1a5698243ebaddc5",
    "volumetric/chunked primed+debug_steps": "65df4bbee4545d22",
    "volumetric/coarse 66x64+debug_steps": "3ab8c28e9e7df717",
    "volumetric/fixed+debug_steps": "4d1b456c1a732e81",
    "volumetric/lod+debug_steps": "fcd913abfc1ba19b",
    "volumetric/chunked unprimed": "1b85338681d357b9",
    "volumetric/compact phase 1": "9f2f44db4c377149",
    "volumetric/compact phase 2": "1b85338681d357b9",
    "volumetric/bwd": "c5627fe6125d91dc",
    "volumetric/bf16/coarse 66x64": "4f915d4c2fcc6102",
    "volumetric/bf16/chunked primed": "05bd1809572a942b",
    "volumetric/bf16/fixed": "aa0c37e627b9e343",
    "volumetric/bf16/lod": "13f0b0b9d6474659",
    "volumetric/bf16/chunked primed+debug_steps": "4ee18052b2bfa20b",
    "volumetric/bf16/coarse 66x64+debug_steps": "de5ff5751e6f3f6e",
    "volumetric/bf16/fixed+debug_steps": "22ca006114bae1eb",
    "volumetric/bf16/lod+debug_steps": "e444541b96e6fdf2",
    "volumetric/bf16/chunked unprimed": "aa0c37e627b9e343",
    "volumetric/bf16/compact phase 1": "469e8f99485dde40",
    "volumetric/bf16/compact phase 2": "aa0c37e627b9e343",
    "volumetric/bf16/bwd": "d89c6e21e3394a06",
    "volumetric/band 37x100 at row 5": "f372e28c79a0b3f8",
    "volumetric/row 1x512 at row 300": "346c4bc10cd187a5",
}
# Kill and resume in phase 25: a run stopped after RESUME_AT of RESUME_STEPS
# steps, resumed from its checkpoint. FIT_STEPS steps in chunks of FIT_K
# against single steps; step times of chunks of 1 (eager) and of
# STEP_CHUNKS steps (CUDA graph replays).
FIT_STEPS, FIT_K, RESUME_AT, RESUME_STEPS = 24, 8, 6, 12
STEP_CHUNKS = (1, 8, 16)
# Phase 27: the 512-row frame in BANDS bands of 128 rows; their summed
# gradients against the whole frame's at tests/test_sharding.py:80-84's
# tolerance, a group of one's loss against pixel_loss at BAND_LOSS_RTOL.
BANDS, BAND_GRAD_RTOL, BAND_GRAD_ATOL, BAND_LOSS_RTOL = 4, 1e-4, 1e-7, 1e-6
# Phase 28: batches of frames along the fly path through the forward
# kernels' frame axis, the 1080p size of BASELINE.json's config 4 (height,
# width), and the frames of each fly fps reading.
BATCHES = (1, 2, 4, 8)
HD = (1080, 1920)
FLY_FRAMES, FLY_ROUNDS = 24, 3
# Phase 30: the flythrough batch as one CUDA graph. fly_frames of
# FLY_GRAPH_FRAMES frames in batches of FLY_GRAPH_BATCHES (each with a short
# last batch); the tonemap-and-quantize kernel and its plain version as CUDA
# graphs of QUANT_REPS calls; COPY_REPS copies to the host of each size and
# kind; FLY_GRAPH_FPS_FRAMES frames per fps reading.
FLY_GRAPH_FRAMES, FLY_GRAPH_BATCHES = 10, (4, 8)
QUANT_REPS, COPY_REPS, FLY_GRAPH_FPS_FRAMES = 20, 10, 24
# Phase 30's exhaustive check: every float32 bit pattern through the kernel
# and its plain version, in chunks of one frame of EXHAUSTIVE_SIDE^2 pixels
# (3 x 2^26 values) as the fly path lays them out, (1, 3, H, W) planes viewed
# as (1, H, W, 3); the last chunk overlaps the one before.
EXHAUSTIVE_SIDE = 1 << 13
# Phase 31: BASELINE.json config 5, the 4K frame (height, width) at 6
# octaves, max_steps 128, prime_ds 8, in UHD_BANDS bands of 1080 rows; bands
# of UHD_PLAIN_ROWS rows at UHD_PLAIN_ROW0S (the middle, across the two bands'
# edge, and the bottom) through the kernels, from their own coarse pass and
# row0, against the plain path (the whole frame's passes are held against
# theirs too); SHARDED_FIT_CALLS calls of the sharded fit step (the eager
# warm-up, then replays of its graph).
UHD = (2160, 3840)
UHD_BANDS, UHD_PLAIN_ROWS, UHD_PLAIN_ROW0S = 2, 16, (1072, 2144)
SHARDED_FIT_CALLS = 4
# Phase 31's stripes: rank UHD_STRIPE_RANK of UHD_STRIPE_WORLD at the
# benchmark's 4K prime_ds (PACK_BAND_DS below), its rows as stripes
# (parallel/mesh.py:stripes), CUDA graphs of UHD_STRIPE_REPS calls for the
# times.
UHD_STRIPE_RANK, UHD_STRIPE_WORLD, UHD_STRIPE_REPS = 1, 4, 10
# The rank's step against the plain path's own march, leaf by leaf: |got -
# plain| / |plain| at most UHD_STRIPE_PLAIN_RTOL, four times the largest
# reading. The two marches stop up to 12% apart in t on grazing pixels at 4K,
# which moves the gradient by up to 1.17% (camera.fov_y) for the stripes and
# 1.25% for rank 1's contiguous band alike, over 11x phase 8's gates for
# either; the plain backward at the kernel's own (t, hit) is held to those.
UHD_STRIPE_PLAIN_RTOL = 0.05
# Phase 32: the scene-packing kernels. PACK_TRIALS scenes and batches of 1 to
# PACK_MAX_FRAMES cameras drawn from PACK_SEED, the rows of each against the
# plain ops on the card, the VJP of every PACK_VJP_EVERY-th; the VJP's
# relative error per leaf against autograd through the plain ops, for one
# camera and for a batch (measured against its frames' terms before a shared
# leaf sums them); CUDA graphs of PACK_REPS calls for the times; fly1080's
# batch of PACK_FLY_FRAMES frames and fit4k.x4's bands at prime_ds
# PACK_BAND_DS.
PACK_TRIALS, PACK_MAX_FRAMES, PACK_VJP_EVERY, PACK_SEED = 3000, 5, 7, 2147480011
PACK_VJP_RTOL = {"one": 1e-6, "batch": 1e-6}
PACK_REPS, PACK_FLY_FRAMES, PACK_BAND_DS = 100, 4, 4
# AD vs FD checks of tests/test_grad.py: (leaf, component, eps, rtol, t_cap).
FD_CHECKS = (
    ("noise.amplitudes", 0, 3e-3, 5e-2, 0.03),
    ("camera.yaw", None, 3e-3, 5e-2, 0.1),
    ("materials.fog_density", None, 1e-4, 1e-2, 0.1),
)


def phase(n: int, name: str, msg: str) -> None:
    print(f"[{n}] {name}: {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def frac_within(a: torch.Tensor, b: torch.Tensor, atol: float) -> float:
    return (a - b).abs().le(atol).float().mean().item()


def check_close(name, a, b, atol, frac):
    got = frac_within(a, b, atol)
    if got < frac:
        fail(f"{name}: {100 * got:.4f}% within {atol} (need {100 * frac}%)")
    return got


def compare_trace(tag, kern, ref, bf16: bool = False):
    """Hold a kernel result (color, t, hit) against the plain version's with
    phase 3's gates (F32_GATES), or for the bf16 march field with
    BF16_GATES: (max abs colour error, report)."""
    (ck, tk, hk), (cr, tr, hr) = kern, ref
    gates = BF16_GATES if bf16 else F32_GATES
    for x in (ck, tk):
        if not torch.isfinite(x).all():
            fail(f"{tag}: kernel output not finite")
    both = (hk > 0.5) & (hr > 0.5)
    err = (ck - cr).abs().max().item()
    mean_err = (ck - cr).abs().mean().item()
    c2 = check_close(f"{tag} color", ck, cr, COLOR_ATOL, gates["color"])
    c4 = check_close(f"{tag} color bulk", ck, cr, BULK_ATOL, gates["bulk"])
    agree = (hk == hr).float().mean().item()
    if agree <= gates["hit"]:
        fail(f"{tag}: hit masks agree on {100 * agree:.4f}% (need > {100 * gates['hit']}%)")
    tf = check_close(f"{tag} t", tk[both], tr[both], T_ATOL, gates["t"]) if both.any() else 1.0
    if mean_err >= gates["mean"]:
        fail(f"{tag}: mean abs colour error {mean_err:.3e} (need < {gates['mean']})")
    return err, (f"{tag}: color {100 * c2:.4f}% <= {COLOR_ATOL}, {100 * c4:.4f}% <= "
                 f"{BULK_ATOL}, mean abs err {mean_err:.3e}, max abs err {err:.3e}; hit "
                 f"agree {100 * agree:.4f}%; t {100 * tf:.4f}% <= {T_ATOL}")


def bf16_differs(tag, out16, out32) -> str:
    """A bf16 kernel's colour against the float32 instantiation's on the same
    inputs: the mean difference must exceed BF16_MIN_DIFF, or the bf16 field
    did not run."""
    diff = (out16[0] - out32[0]).abs().mean().item()
    if not diff > BF16_MIN_DIFF:
        fail(f"{tag}: the bf16 kernel's colour is within a mean {diff:.3e} of the float32 "
             f"kernel's on the same inputs (need > {BF16_MIN_DIFF})")
    return f"{tag} vs the float32 kernel: mean abs diff {diff:.3e}"


def bwd_error(got: torch.Tensor, ref: torch.Tensor, rtol: float = BWD_RTOL,
              atol_rel: float = BWD_ATOL_REL) -> tuple[float, float]:
    """(max abs error, worst error as a fraction of its tolerance)."""
    err = (got - ref).abs()
    tol = rtol * ref.abs() + atol_rel * ref.abs().max()
    return err.max().item(), (err / tol).max().item()


def reset_counts() -> None:
    """Set the forward, backward, tonemap-and-quantize and scene-packing
    kernels' launch counts to 0."""
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames, pack_vjp
    from gpgpuraytrace_tpu_torch.kernels.quantize import tonemap_quantize
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_bwd

    trace_frames.launches.clear()
    trace_frames_bwd.launches.clear()
    tonemap_quantize.launches = 0
    pack_frames.launches = 0
    pack_vjp.launches = 0


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register and spill lines, each with the kernel it reports on
    (the forward kernel as trace_fwd_kernel<mode, bf16, debug, octaves>,
    octaves 0 for the loop over a runtime count, and without octaves for a
    build before the unrolled twins; phase 2 as <bf16, octaves>, or <bf16>
    before its ray groups; the backward kernel as <bf16>, its second stage
    as <> or <frames>; an instantiation with the frame axis ends ",
    frames>")."""
    modes = ("chunked", "fixed", "lod", "compact")
    name, out = "", []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"\d(trace_\w+?)(?:ILi(\d)ELb(\d)ELb(\d)E(?:Li(\d+)E)?(?:Lb(\d)E)?"
                          r"|ILb(\d)E(?:Li(\d+)E)?(?:Lb(\d)E)?)?E", entry.group(1))
            name = m.group(1) if m else entry.group(1)
            if m and m.group(2):
                octaves = f", octaves={m.group(5)}" if m.group(5) else ""
                frames = ", frames" if m.group(6) == "1" else ""
                name += (f"<{modes[int(m.group(2))]}, bf16={m.group(3)}, debug={m.group(4)}"
                         f"{octaves}{frames}>")
            elif m and m.group(7) and name == "trace_bwd_sum":
                name += "<frames>" if m.group(7) == "1" else "<>"
            elif m and m.group(7):
                octaves = f", octaves={m.group(8)}" if m.group(8) else ""
                frames = ", frames" if m.group(9) == "1" else ""
                name += f"<bf16={m.group(7)}{octaves}{frames}>"
        elif line.startswith("---"):
            out.append(line.strip())
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.strip().removeprefix('ptxas info    : ')}")
    return out


def ptxas_registers(log: str, kernel: str) -> list[int]:
    """The register counts ptxas reports for ``kernel`` (named as
    ``ptxas_lines`` names it)."""
    return [int(m.group(1)) for ln in ptxas_lines(log)
            if ln.startswith(f"{kernel}:") and (m := re.search(r"Used (\d+) registers", ln))]


def sass_functions(lib_path: Path) -> list[str]:
    """The library's SASS (``cuobjdump -sass``), one text per function, its
    mangled name first."""
    from gpgpuraytrace_tpu_torch.kernels.build import find_nvcc

    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    return re.split(r"\n\s*Function : ", sass)


def instructions(body: str) -> list[tuple[int, str, str]]:
    """(address, opcode, operands) of every instruction of a function."""
    return [(int(m.group(1), 16), m.group(3), m.group(4)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]


def backward_branches(insts) -> list[tuple[int, int]]:
    """Every loop, as the (target, branch) addresses of a backward branch."""
    loops = []
    for addr, op, args in insts:
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) <= addr:
                loops.append((int(m.group(1), 16), addr))
    return sorted(loops)


def add_ops(total: dict, part: dict, times: float) -> dict:
    for k, n in part.items():
        total[k] = total.get(k, 0.0) + n * times
    return total


def bound(ops: dict, nbytes: float) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations")."""
    t_ops = max(n / PEAK_OPS_PER_S[k] for k, n in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def step_ops(cfg) -> dict:
    """Operations of one march step of one pixel."""
    ops = add_ops({}, OPS["step"], 1)
    add_ops(ops, OPS["octave_bf16" if cfg.march_bf16 else "octave"], cfg.num_octaves)
    if cfg.volumetric:
        add_ops(ops, OPS["warp_step"], 1)
        add_ops(ops, OPS["warp_octave"], cfg.warp_octaves)
    return ops


def fwd_bound(cfg, steps: float, hits: float, n_pix: int, debug: bool = False,
              nbytes: float | None = None):
    """Least time of a forward launch over ``n_pix`` pixels that march
    ``steps`` field evaluations in all and polish ``hits`` hits: (ms, bound_by).
    Bytes: the prime map read (when primed), colour, t and hit (and the
    counter) written once, unless ``nbytes`` says otherwise."""
    ops = add_ops({}, step_ops(cfg), steps)
    add_ops(ops, OPS["grad_octave"], hits * (cfg.newton_iters + 1) * cfg.num_octaves)
    if cfg.volumetric:
        add_ops(ops, OPS["grad_warp_octave"],
                hits * (cfg.newton_iters + 1) * cfg.warp_octaves)
    add_ops(ops, OPS["pixel"], n_pix)
    if nbytes is None:
        nbytes = n_pix * (4 * bool(cfg.prime_ds) + 20 + 4 * debug)
    return bound(ops, nbytes)


def bwd_bound(cfg, hits: float, n_pix: int, octave: dict = OPS["bwd_octave"]):
    """Least time of a backward launch: (ms, bound_by). Bytes: t, hit and the
    three cotangent planes read once. ``octave``: the operations per hit and
    octave."""
    ops = add_ops({}, octave, hits * cfg.num_octaves)
    if cfg.march_bf16:
        add_ops(ops, OPS["bwd_octave_bf16"], hits * cfg.num_octaves)
    if cfg.volumetric:
        add_ops(ops, OPS["bwd_warp_octave"], hits * cfg.warp_octaves)
    add_ops(ops, OPS["bwd_pixel"], n_pix)
    return bound(ops, n_pix * 20)


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-call device times (ms) of ``fn`` by CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms_back_to_back(fn, reps: int) -> float:
    """Device time (ms) per call of ``reps`` calls enqueued back to back
    between one pair of CUDA events, after a warm-up: for a kernel that
    outlasts its launch, the host's launch latency drops out."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, n: int = 200, runs: int = 5) -> float:
    """Host microseconds per call of ``fn``: the least of ``runs`` runs of
    ``n`` calls enqueued after a synchronisation, host clock (the device
    runs behind; its queue holds them all)."""
    fn()
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * best / n


def graph_ms(fn, reps: int) -> float:
    """Device time (ms) per call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed once between CUDA events after a warm-up replay. No
    host work runs between the launches, so a kernel shorter than its
    launch's host time reads its own time. A wrapper with a kept scratch
    (trace_frames, trace_frames_bwd) gets a fresh one per call under capture,
    so the time includes zeroing its counters, one small fill per call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_us(fn, name: str, calls: int = 20) -> tuple[float, int]:
    """Device microseconds per launch of the kernels whose name holds
    ``name``, by torch.profiler over ``calls`` calls of ``fn`` (after a
    warm-up), and the number of launches it recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in events)
    total = sum(e.self_device_time_total for e in events)
    return (total / count if count else float("nan")), count


def digest(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def output_digests(k, dev) -> dict[str, str]:
    """``digest`` of every output of every forward instantiation, and of the
    backward, on both terrains at 512x512 with 6 octaves under the default
    config (its bf16 twin too): the coarse prime pass (66x64), the primed
    chunked fine pass from it, fixed and lod (each with and without the step
    counter), the unprimed chunked pass, compaction's phase 1 (its survivors
    as a sorted set) and phase 2, the backward on the primed frame's (t, hit)
    with a seeded cotangent; and ragged frames: a 37x100 band at row 5 of a
    128x100 frame and one 512-pixel row at row 300, unprimed, counted. ``k``
    launches the kernels: ``k.fwd(packed, seed, cfg, h, prime=None,
    debug=False)`` and ``k.phase1``, ``k.phase2``, ``k.bwd`` with the
    arguments of trace_phase1s, trace_phase2s and trace_frames_bwd on one
    frame (``packed`` (1, n); a per-pixel tensor with or without the leading
    batch of one: a digest reads the bytes alone)."""
    from gpgpuraytrace_tpu_torch import RenderConfig, default_scene
    from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    def pack(scene, h, w, row0):
        packed, _, seed = pack_frames(scene, scene.camera, h, w, row0)
        return packed.detach(), seed

    out = {}
    with torch.no_grad():
        for terrain, vol in (("heightfield", False), ("volumetric", True)):
            scene = default_scene(6, volumetric=vol, device=dev)
            base = RenderConfig(num_octaves=6, volumetric=vol)
            packed, seed = pack(scene, 512, 512, 0.0)
            for bf16 in (False, True):
                cfg = dataclasses.replace(base, march_bf16=bf16)
                tag = f"{terrain}/{'bf16/' if bf16 else ''}"
                ccfg = coarse_prime_cfg(cfg)
                cp, cs = pack(scene, ccfg.height, ccfg.width, -1.0)
                ch = cfg.height // cfg.prime_ds + 2
                coarse = k.fwd(cp, cs, ccfg, ch)
                out[tag + "coarse 66x64"] = digest(coarse)
                prime = prime_from_coarse(coarse[1], cfg)
                for debug in (False, True):
                    d = "+debug_steps" if debug else ""
                    out[tag + "chunked primed" + d] = digest(
                        k.fwd(packed, seed, cfg, 512, prime, debug=debug))
                    if debug:
                        out[tag + "coarse 66x64" + d] = digest(k.fwd(cp, cs, ccfg, ch, debug=True))
                    for mode in ("fixed", "lod"):
                        mcfg = dataclasses.replace(cfg, march_mode=mode)
                        out[tag + mode + d] = digest(k.fwd(packed, seed, mcfg, 512, debug=debug))
                ucfg = dataclasses.replace(cfg, prime_ds=0)
                out[tag + "chunked unprimed"] = digest(k.fwd(packed, seed, ucfg, 512))
                ccmp = dataclasses.replace(cfg, march_mode="compact")
                color, t, hit, alive, prev, ids, n_alive = k.phase1(packed, seed, ccmp, 512)
                n = int(n_alive.item())
                out[tag + "compact phase 1"] = digest(
                    (color, t, hit, alive, prev, ids.reshape(-1)[:n].sort().values, n_alive))
                k.phase2(packed, seed, ccmp, 512, n_alive, ids, prev, color, t, hit)
                out[tag + "compact phase 2"] = digest((color, t, hit))
                _, t_f, hit_f = k.fwd(packed, seed, cfg, 512, prime)
                g = torch.randn(1, 3, 512, 512,
                                generator=torch.Generator().manual_seed(0)).to(dev)
                out[tag + "bwd"] = digest([k.bwd(packed, seed, cfg, 512, t_f, hit_f, g)])
            for label, h, w, row0 in (("band 37x100 at row 5", 37, 100, 5.0),
                                      ("row 1x512 at row 300", 1, 512, 300.0)):
                cfg = RenderConfig(height=128 if h == 37 else 512, width=w, num_octaves=6,
                                   volumetric=vol, prime_ds=0)
                p, s = pack(scene, cfg.height, w, row0)
                out[f"{terrain}/{label}"] = digest(k.fwd(p, s, cfg, h, debug=True))
    torch.cuda.synchronize()
    return out


class PackageKernels:
    """output_digests' launcher: the package's wrappers."""

    @staticmethod
    def fwd(packed, seed, cfg, h, prime=None, debug=False):
        from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames

        return trace_frames(packed, seed, cfg, h, prime, debug)

    @staticmethod
    def phase1(*args):
        from gpgpuraytrace_tpu_torch.kernels.trace import trace_phase1s

        return trace_phase1s(*args)

    @staticmethod
    def phase2(*args):
        from gpgpuraytrace_tpu_torch.kernels.trace import trace_phase2s

        return trace_phase2s(*args)

    @staticmethod
    def bwd(*args):
        from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames_bwd

        return trace_frames_bwd(*args)


def profile_frames(fn, frame_ms: float, frames: int = 5) -> str:
    """Device time by kernel over ``frames`` calls (torch.profiler), and the
    device's busy share of the frame time measured with CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies): the host ops that launched
    # them report the same device time again, and a user annotation such as
    # Optimizer.step's reports the span of its kernels, gaps included.
    per_kernel = sorted(
        ((e.self_device_time_total / frames, e.key) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and e.self_device_time_total > 0),
        reverse=True,
    )
    if not per_kernel:
        return "the profiler saw no device time"
    busy_us = sum(us for us, _ in per_kernel)
    top = "; ".join(f"{us:.1f} us {key[:60]}" for us, key in per_kernel[:6])
    return (f"device busy {busy_us:.1f} us of a {frame_ms * 1e3:.1f} us call "
            f"({100 * busy_us / (frame_ms * 1e3):.1f}%), {len(per_kernel)} kernels; "
            f"top: {top}")


def forward_vs_plain(scene, cfg, tag: str) -> tuple[float, str, float, float, dict]:
    """The forward kernel against its plain version at the main path's shapes
    (the coarse prime pass, then the fine pass from the kernel's prime map)
    with phase 3's gates (the bf16 gates, and apart from the float32 kernel,
    for ``cfg.march_bf16``), and the passes' times: (max abs colour error,
    report, fine-pass ms, plain ms, {"coarse", "coarse_graph", "fine_graph"}
    ms), the fine pass 50 launches back to back, the coarse pass that way and
    as a CUDA graph of 50 launches (its device time: the host's launch time
    exceeds it), the fine pass as a graph too."""
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_reference
    from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    ccfg = coarse_prime_cfg(cfg)
    ch = cfg.height // cfg.prime_ds + 2
    with torch.no_grad():
        packed_c, _, seed_c = pack_frames(scene, scene.camera, ccfg.height, ccfg.width, -1.0)
        coarse_k = trace_frames(packed_c, seed_c, ccfg, ch)
        coarse_r = trace_frames_reference(packed_c, seed_c, ccfg, ch)
        torch.cuda.synchronize()
        _, line_c = compare_trace(f"{tag}coarse {ch}x{ccfg.width}", coarse_k, coarse_r,
                                  cfg.march_bf16)
        prime = prime_from_coarse(coarse_k[1], cfg)
        packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width, 0.0)
        fine_k = trace_frames(packed, seed, cfg, cfg.height, prime)
        fine_r = trace_frames_reference(packed, seed, cfg, cfg.height, prime)
        torch.cuda.synchronize()
        err, line_f = compare_trace(f"{tag}fine {cfg.height}x{cfg.width}", fine_k, fine_r,
                                    cfg.march_bf16)
        if cfg.march_bf16:
            c32, f32 = (dataclasses.replace(c, march_bf16=False) for c in (ccfg, cfg))
            line_c += "; " + bf16_differs("coarse", coarse_k,
                                          trace_frames(packed_c, seed_c, c32, ch))
            line_f += "; " + bf16_differs("fine", fine_k,
                                          trace_frames(packed, seed, f32, cfg.height, prime))

        def coarse():
            return trace_frames(packed_c, seed_c, ccfg, ch)

        def fine():
            return trace_frames(packed, seed, cfg, cfg.height, prime)

        kern_ms = cuda_ms_back_to_back(fine, 50)
        plain_ms = cuda_ms_back_to_back(
            lambda: trace_frames_reference(packed, seed, cfg, cfg.height, prime), 3)
        times = {"coarse": cuda_ms_back_to_back(coarse, 50), "coarse_graph": graph_ms(coarse, 50),
                 "fine_graph": graph_ms(fine, 50)}
    return err, (f"{line_c} | {line_f} | fine pass {kern_ms:.4f} ms kernel (50 back to "
                 f"back; {times['fine_graph']:.4f} ms as a CUDA graph of 50), "
                 f"{plain_ms:.3f} ms plain (3); coarse pass {times['coarse']:.4f} ms (50 back "
                 f"to back), {times['coarse_graph']:.4f} ms as a CUDA graph of 50"
                 ), kern_ms, plain_ms, times


def ragged_vs_plain(scene, cfg, tag: str) -> str:
    """The forward kernel on frames that are not whole warp tiles: a 37x100
    band at row 5 of a 128x100 frame and one 512-pixel row at row 300,
    unprimed. Each equals the same pixels of the kernel's whole frame bit
    for bit (a pixel's arithmetic does not depend on the launch), and the
    two together hold phase 3's gates against the plain version."""
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_reference
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    kern, ref = [], []
    with torch.no_grad():
        for h, w, row0, height in ((37, 100, 5, 128), (1, 512, 300, 512)):
            c = dataclasses.replace(cfg, height=height, width=w, prime_ds=0)
            packed, _, seed = pack_frames(scene, scene.camera, height, w, float(row0))
            band = trace_frames(packed, seed, c, h)
            full_packed = pack_frames(scene, scene.camera, height, w, 0.0)[0]
            full = trace_frames(full_packed, seed, c, height)
            for a, b, what in zip(band, full, ("colour", "t", "hit")):
                if not torch.equal(a, b[..., row0:row0 + h, :]):
                    fail(f"{tag}{h}x{w} band at row {row0}: {what} differs from the whole "
                         f"frame's rows")
            kern.append(band)
            ref.append(trace_frames_reference(packed, seed, c, h))
    torch.cuda.synchronize()

    def flat(outs):
        return (torch.cat([o[0].reshape(3, -1) for o in outs], dim=1),
                *(torch.cat([o[i].reshape(-1) for o in outs]) for i in (1, 2)))

    _, line = compare_trace(f"{tag}ragged frames", flat(kern), flat(ref))
    return (f"37x100 band at row 5 and 1x512 row at row 300: each bit for bit the whole "
            f"frame's pixels; {line}")


def serve_frames(scene, cfg, yaws) -> tuple[int, str]:
    """The serving path: one frame per camera yaw under ``torch.no_grad()``,
    with the launch counts read around exactly these frames: (forward
    launches, mean colours)."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_bwd

    frames = []
    reset_counts()
    with torch.no_grad():  # serving builds no autograd graph
        for yaw in yaws:
            scene.camera.yaw.fill_(yaw)
            frames.append(render(scene, cfg))
    torch.cuda.synchronize()
    launches = trace_frames.launches.total()
    if launches != 2 * len(yaws) or trace_frames_bwd.launches.total():
        fail(f"serving path launched the forward kernel {launches} times and the "
             f"backward {trace_frames_bwd.launches.total()} times, expected "
             f"{2 * len(yaws)} (coarse + fine per frame) and 0")
    for yaw, img in zip(yaws, frames):
        if img.shape != (cfg.height, cfg.width, 3) or not torch.isfinite(img).all():
            fail(f"frame at yaw {yaw}: shape {tuple(img.shape)} or non-finite")
        if img.min().item() < 0.0:
            fail(f"frame at yaw {yaw}: negative colour")
        top = img[:8].mean(dim=(0, 1))
        if not top[2] > top[0]:
            fail(f"frame at yaw {yaw}: top rows not blue-dominant sky ({top.tolist()})")
    return launches, ", ".join(f"{img.mean().item():.4f}" for img in frames)


def frame_times(scene, cfg, reps: dict[str, int]) -> tuple[dict, dict, str]:
    """Serving frame times by CUDA events, kernel and plain path in turns
    (kernel, plain, kernel, plain; ``reps`` frames each): (median ms by
    path, frames by path, profile of a kernel-path frame)."""
    from gpgpuraytrace_tpu_torch import render

    plain_cfg = dataclasses.replace(cfg, use_kernel=False)
    serve = torch.no_grad()(render)
    times = {}
    for label, c in (("kernel", cfg), ("plain", plain_cfg)) * 2:
        times.setdefault(label, []).extend(cuda_ms(lambda: serve(scene, c), reps[label]))
    median = {k: statistics.median(v) for k, v in times.items()}
    prof = profile_frames(lambda: serve(scene, cfg), median["kernel"])
    return median, {k: len(v) for k, v in times.items()}, prof


def bwd_repeats(args, want: torch.Tensor) -> str:
    """The backward's scratch across streams and graphs: launches on a
    second stream and two replays of a CUDA graph give ``want`` bit for bit,
    and every kept scratch's counter is 0 afterwards."""
    from gpgpuraytrace_tpu_torch.kernels.trace import _BWD_SCRATCH, trace_frames_bwd

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs = [trace_frames_bwd(*args) for _ in range(2)]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = trace_frames_bwd(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        runs.append(captured.clone())
    if not all(torch.equal(r, want) for r in runs):
        fail("the backward on a second stream or replayed from a CUDA graph differs from "
             "its first launch")
    if any(int(x[:1].view(torch.int32)) for x in _BWD_SCRATCH.values()):
        fail("a backward scratch's counter was left non-zero")
    return "bitwise equal on a second stream and in 2 CUDA graph replays"


def backward_vs_plain(scene, cfg) -> dict:
    """The backward kernel against its plain version at 512x512, on the
    forward kernel's own (t, hit): finite, two launches bitwise equal (and
    on a second stream and in CUDA graph replays), every entry within
    BWD_RTOL plus BWD_ATOL_REL of the largest; its time back to back and as
    a CUDA graph, and the wrapper's host time per call."""
    from gpgpuraytrace_tpu_torch.kernels.trace import (
        render_kernel_raw, trace_frames_bwd, trace_frames_bwd_reference,
    )
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    _, t_fwd, hit_fwd = render_kernel_raw(scene, cfg)
    t_fwd, hit_fwd = t_fwd[None], hit_fwd.float()[None]
    packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width, 0.0)
    packed = packed.detach()
    g = torch.randn(1, 3, cfg.height, cfg.width,
                    generator=torch.Generator().manual_seed(0)).to(packed.device)
    args = (packed, seed, cfg, cfg.height, t_fwd, hit_fwd, g)
    pbar_k = trace_frames_bwd(*args)
    pbar_k2 = trace_frames_bwd(*args)
    pbar_r = trace_frames_bwd_reference(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(pbar_k).all():
        fail("backward kernel output not finite")
    if not torch.equal(pbar_k, pbar_k2):
        fail("two backward launches differ: the reduction is not deterministic")
    err, worst = bwd_error(pbar_k, pbar_r)
    if worst > 1.0:
        fail(f"backward kernel vs plain: worst entry at {worst:.3f} of its "
             f"tolerance (max abs err {err:.3e})")
    hits, n_pix = hit_fwd.sum().item(), cfg.height * cfg.width
    bound_ms, bound_by = bwd_bound(cfg, hits, n_pix)
    return {
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_before_ms": bwd_bound(cfg, hits, n_pix, BWD_OCTAVE_BEFORE)[0],
        "pbar": pbar_k, "ref": pbar_r, "err": err, "worst": worst,
        "hits": int(hit_fwd.sum().item()), "repeats": bwd_repeats(args, pbar_k),
        "ms": cuda_ms_back_to_back(lambda: trace_frames_bwd(*args), 50),
        "graph_ms": graph_ms(lambda: trace_frames_bwd(*args), 50),
        "host_us": host_us(lambda: trace_frames_bwd(*args)),
        "plain_ms": cuda_ms_back_to_back(lambda: trace_frames_bwd_reference(*args), 3),
    }


def bwd_report(b: dict) -> str:
    return (f"{b['pbar'].shape[1]} packed entries on the fine pass's (t, hit), "
            f"{b['hits']} hits: max abs err {b['err']:.3e}, worst entry at "
            f"{b['worst']:.4f} of rtol {BWD_RTOL} + {BWD_ATOL_REL} x max|pbar| "
            f"({b['ref'].abs().max().item():.4e}); two launches bitwise equal, "
            f"{b['repeats']}; {b['graph_ms']:.4f} ms the wrapper as a CUDA graph of 50 "
            f"(both stages and the fresh scratch's zeroing), "
            f"{b['ms']:.4f} ms 50 back to back, host {b['host_us']:.1f} us per call; "
            f"{b['plain_ms']:.3f} ms plain (3); bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}; {b['bound_before_ms']:.4f} ms by the earlier count)")


def train(start, target, cfg, trainable, steps: int, reps: dict[str, int]) -> dict:
    """The training path: ``steps`` Adam steps of fit from ``start`` with the
    launch counts read around exactly them (2 forward and 1 backward launch
    per step), a falling loss, kernel_bwd True vs False gradients on every
    trainable leaf, and step times by CUDA events (``reps`` steps per
    variant, two rounds in turns) with a profile of a kernel-path step."""
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_bwd
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod

    reset_counts()
    _, losses = fitmod.fit(copy.deepcopy(start), cfg, target, steps=steps,
                           learning_rate=5e-3, trainable=trainable, log_every=0)
    torch.cuda.synchronize()
    fwd, bwd = trace_frames.launches.total(), trace_frames_bwd.launches.total()
    if (fwd, bwd) != (2 * steps, steps):
        fail(f"training path launched the forward kernel {fwd} and the backward "
             f"{bwd} times in {steps} steps, expected {2 * steps} and {steps}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"fit losses not finite or not falling: {losses}")
    grads = []
    for kernel_bwd in (True, False):
        s = copy.deepcopy(start)
        fitmod.partition_scene(s, trainable)
        fitmod.pixel_loss(s, dataclasses.replace(cfg, kernel_bwd=kernel_bwd),
                          target).backward()
        grads.append({n: p.grad for n, p in s.named_parameters() if p.grad is not None})
    worst_leaf = 0.0
    for leaf, ref in grads[1].items():
        _, w = bwd_error(grads[0][leaf], ref)
        worst_leaf = max(worst_leaf, w)
        if w > 1.0:
            fail(f"{leaf}: kernel_bwd gradient at {w:.3f} of its tolerance vs the "
                 f"plain re-shade")
    step_cfgs = {"kernel": cfg, "kernel fwd + plain bwd":
                 dataclasses.replace(cfg, kernel_bwd=False),
                 "plain": dataclasses.replace(cfg, use_kernel=False)}
    step_times = {}
    for _ in range(2):
        for label, c in step_cfgs.items():
            s = copy.deepcopy(start)
            opt = fitmod.make_optimizer(fitmod.partition_scene(s, trainable), 5e-3)
            step_times.setdefault(label, []).extend(
                cuda_ms(lambda: fitmod.fit_step(s, c, target, opt), reps[label]))
    step_ms = {k: statistics.median(v) for k, v in step_times.items()}
    s = copy.deepcopy(start)
    opt = fitmod.make_optimizer(fitmod.partition_scene(s, trainable), 5e-3)
    prof = profile_frames(lambda: fitmod.fit_step(s, cfg, target, opt), step_ms["kernel"])
    return {"losses": losses, "fwd": fwd, "bwd": bwd, "leaves": sorted(grads[1]),
            "worst_leaf": worst_leaf, "step_ms": step_ms, "prof": prof}


def train_report(r: dict, steps: int) -> str:
    return (f"{steps} Adam steps: loss " + " ".join(f"{x:.4e}" for x in r["losses"])
            + f"; {r['fwd']} forward and {r['bwd']} backward launches; "
            f"{len(r['leaves'])} leaves kernel_bwd True vs False, worst at "
            f"{r['worst_leaf']:.4f} of tolerance; step time (median, CUDA events): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in r["step_ms"].items()))


def fine_inputs(scene, cfg):
    """(packed (1, n), seed, prime map (1, H, W) or None) of the main path's
    fine pass, a batch of one frame."""
    from gpgpuraytrace_tpu_torch.kernels.trace import _prime_maps
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    with torch.no_grad():
        prime = _prime_maps(scene, scene.camera, cfg)
        packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width, 0.0)
    return packed.detach(), seed, prime


def drive(fn, name: str, expect: int):
    """Run ``fn`` (a user's entry point) with the launch counts set to 0 just
    before and read just after: the launches of the forward instantiation
    ``name``, which must be ``expect``, and what ``fn`` returned."""
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_bwd

    reset_counts()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    got = trace_frames.launches[name]
    if got != expect or trace_frames_bwd.launches.total():
        fail(f"{name}: the path launched it {got} times, expected {expect} "
             f"({trace_frames.launches.total()} forward, "
             f"{trace_frames_bwd.launches.total()} backward launches in all)")
    return got, out


def counter_phase(scene, cfg, tag: str) -> dict:
    """Phase 15 on one terrain: the counter through render_kernel_raw, its
    outputs against the uncounted frame bit for bit, JAX's per-tile bounds
    against the plain stats march from the same prime map, and the taxes."""
    from gpgpuraytrace_tpu_torch.kernels.trace import (
        WARP_TILE, render_kernel_raw, tile_steps, trace_frames, trace_frames_reference,
        warp_steps,
    )
    from gpgpuraytrace_tpu_torch.ops.camera import generate_rays
    from gpgpuraytrace_tpu_torch.ops.march import march_with_stats
    from gpgpuraytrace_tpu_torch.utils.profiling import march_stats

    launches, counted = drive(lambda: render_kernel_raw(scene, cfg, debug_steps=True),
                              "chunked+debug_steps", 1)
    with torch.no_grad():
        plain = render_kernel_raw(scene, cfg)
    for a, b, what in zip(counted[:3], plain, ("colour", "t", "hit")):
        if not torch.equal(a, b):
            fail(f"{tag}counter: {what} differs from the uncounted frame")
    steps = counted[3]
    packed, seed, prime = fine_inputs(scene, cfg)
    with torch.no_grad():
        o, d = generate_rays(scene.camera, cfg.height, cfg.width)
        _, _, lanes = march_with_stats(cfg, o, d, scene.noise, prime[0])
        stats = march_stats(scene, cfg, t0_prime=prime[0])
        ref = [x[0] for x in trace_frames_reference(packed, seed, cfg, cfg.height, prime,
                                                    debug_steps=True)]
    tiles = tile_steps(steps, cfg)
    warps = warp_steps(steps)
    th, chunk = cfg.tile_h, cfg.march_chunk or 8
    tile_max = lanes.reshape(cfg.height // th, th, cfg.width // 128, 128).amax(dim=(1, 3))
    if not ((tiles % chunk == 0).all() and (tiles <= cfg.max_steps).all()):
        fail(f"{tag}counter: tile counts not whole chunks within max_steps")
    low = (tiles < tile_max).sum().item()
    high = (tiles > tile_max + 2 * chunk).sum().item()
    if low or high:
        fail(f"{tag}counter: {low} tiles below their lanes' longest useful march, "
             f"{high} more than two chunks above it (of {tiles.numel()})")
    err, _ = compare_trace(f"{tag}counter vs plain",
                           (counted[0].permute(2, 0, 1), counted[1], counted[2].float()),
                           ref[:3])
    same = (steps == ref[3]).float().mean().item()
    useful = lanes.float().mean().item()
    ms = cuda_ms_back_to_back(
        lambda: trace_frames(packed, seed, cfg, cfg.height, prime, debug_steps=True), 50)
    plain_ms = cuda_ms_back_to_back(
        lambda: trace_frames_reference(packed, seed, cfg, cfg.height, prime, debug_steps=True),
        1)
    hits = counted[2].sum().item()
    bound_ms, bound_by = fwd_bound(cfg, lanes.sum().item(), hits, lanes.numel(), debug=True)
    line = (f"{tag}{cfg.height}x{cfg.width}: launches {launches}; outputs bitwise equal with and without it; "
            f"useful steps per ray {useful:.4f} (march_stats {stats['steps_mean']:.4f}, "
            f"p99 {stats['steps_p99']:.1f}), executed per lane "
            f"{steps.float().mean().item():.4f}, per warp (the lane counts reduced over "
            f"the kernel's {WARP_TILE[0]}x{WARP_TILE[1]} tile map) "
            f"{warps.float().mean().item():.4f}, "
            f"per TPU tile {tiles.float().mean().item():.4f}; warp tax "
            f"{warps.float().mean().item() / useful:.4f}x, tile tax "
            f"{tiles.float().mean().item() / useful:.4f}x; exhausted lanes "
            f"{stats['exhausted_lanes']}; kernel lanes equal to the plain version's on "
            f"{100 * same:.4f}%; JAX tile bounds hold on all {tiles.numel()} tiles; fine "
            f"pass with the counter {ms:.4f} ms (50 back to back), plain {plain_ms:.3f} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"line": line, "launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "lanes": lanes, "hits": hits,
            "err": err}


def fixed_phase(scene, cfg, tag: str) -> dict:
    """Phase 16 on one terrain."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_reference

    fcfg = dataclasses.replace(cfg, march_mode="fixed")  # unprimed, as fixed frames are
    launches, _ = drive(lambda: render(scene, fcfg), "fixed", 1)
    packed, seed, _ = fine_inputs(scene, fcfg)
    h = cfg.height
    with torch.no_grad():
        kf = trace_frames(packed, seed, fcfg, h)
        kc = trace_frames(packed, seed, dataclasses.replace(cfg, prime_ds=0), h)
        ref = trace_frames_reference(packed, seed, fcfg, h)
    torch.cuda.synchronize()
    for a, b, what in zip(kf, kc, ("colour", "t", "hit")):
        if not torch.equal(a, b):
            fail(f"{tag}fixed: {what} differs from the chunked kernel's")
    err, line = compare_trace(f"{tag}fixed vs plain", kf, ref)
    cfg64 = dataclasses.replace(fcfg, max_steps=64)
    times = {128: [], 64: []}
    for _ in range(2):
        for steps, c in ((128, fcfg), (64, cfg64)):
            times[steps].append(cuda_ms_back_to_back(lambda: trace_frames(packed, seed, c, h),
                                                     20))
    t128, t64 = min(times[128]), min(times[64])
    per_step_us = 1e3 * (t128 - t64) / 64
    step_bound_us = 1e3 * bound(add_ops({}, step_ops(fcfg), h * cfg.width), 0.0)[0]
    plain_ms = cuda_ms_back_to_back(lambda: trace_frames_reference(packed, seed, fcfg, h), 1)
    n_pix = h * cfg.width
    bound_ms, bound_by = fwd_bound(fcfg, fcfg.max_steps * n_pix, kf[2].sum().item(), n_pix)
    return {"line": (f"{tag}launches {launches}; bit for bit equal to chunked (unprimed); "
                     f"{line}; fine pass 128 steps {t128:.4f} ms, 64 steps {t64:.4f} ms "
                     f"(best of 2 x 20 back to back), marginal {per_step_us:.4f} us per "
                     f"march step over the frame against a bound of {step_bound_us:.4f} us "
                     f"({per_step_us / step_bound_us:.2f}x); plain {plain_ms:.3f} ms; "
                     f"bound {bound_ms:.4f} ms ({bound_by})"),
            "launches": launches, "err": err, "ms": t128, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "per_step_us": per_step_us,
            "step_bound_us": step_bound_us}


def lod_phase(scene, cfg, tag: str) -> dict:
    """Phase 17 on one terrain."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.kernels.trace import (
        render_kernel_raw, trace_frames, trace_frames_reference,
    )

    lcfg = dataclasses.replace(cfg, march_mode="lod")  # unprimed, as lod frames are
    launches, _ = drive(lambda: render(scene, lcfg), "lod", 1)
    packed, seed, prime = fine_inputs(scene, cfg)
    h = cfg.height
    with torch.no_grad():
        kl = trace_frames(packed, seed, lcfg, h)
        *counted, lanes = trace_frames(packed, seed, lcfg, h, debug_steps=True)
        ref = trace_frames_reference(packed, seed, lcfg, h)
        lod_img = render_kernel_raw(scene, lcfg)[0]
        base_img = render_kernel_raw(scene, cfg)[0]
    for a, b, what in zip(counted, kl, ("colour", "t", "hit")):
        if not torch.equal(a, b):
            fail(f"{tag}lod: the counted launch's {what} differs from the uncounted one's")
    err, line = compare_trace(f"{tag}lod vs plain", kl, ref)
    v = check_close(f"{tag}lod vs chunked", lod_img, base_img, VARIANT_ATOL, VARIANT_FRAC)
    vb = check_close(f"{tag}lod vs chunked bulk", lod_img, base_img, VARIANT_BULK_ATOL,
                     VARIANT_BULK_FRAC)
    times = {"lod": [], "chunked": []}
    for _ in range(2):
        times["lod"].append(cuda_ms_back_to_back(lambda: trace_frames(packed, seed, lcfg, h),
                                                 50))
        times["chunked"].append(
            cuda_ms_back_to_back(lambda: trace_frames(packed, seed, cfg, h, prime), 50))
    ms, chunked_ms = min(times["lod"]), min(times["chunked"])
    plain_ms = cuda_ms_back_to_back(lambda: trace_frames_reference(packed, seed, lcfg, h), 1)
    # The fine phase's counted steps only: the coarse phase is not counted,
    # so this bound is low.
    bound_ms, bound_by = fwd_bound(lcfg, lanes.sum().item(), kl[2].sum().item(), h * cfg.width)
    return {"line": (f"{tag}launches {launches}; {line}; the counted launch bit for bit "
                     f"equal; vs chunked {100 * v:.4f}% <= "
                     f"{VARIANT_ATOL}, {100 * vb:.4f}% <= {VARIANT_BULK_ATOL}; fine-phase "
                     f"steps per lane {lanes.float().mean().item():.4f}; fine pass "
                     f"{ms:.4f} ms beside chunked (primed) {chunked_ms:.4f} ms (best of 2 x 50 "
                     f"back to back, in turns); plain {plain_ms:.3f} ms; bound {bound_ms:.4f} "
                     f"ms ({bound_by}, fine phase only)"),
            "launches": launches, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def noise_probe(lib, dev) -> str:
    """The march field's 2D noise by the kernel's device function (the
    test-only tests/csrc/noise2_probe.cu over kernels/csrc/field.cuh) against
    ops/noise.py on the card at 10^6 seeded points: bit for bit in bf16 (each
    operation rounds to bf16 on both sides), the largest difference in
    float32 (FMA contraction)."""
    from noise_probe import noise2_probe

    from gpgpuraytrace_tpu_torch.ops import noise

    gen = torch.Generator().manual_seed(5)
    x = ((torch.rand(1_000_000, generator=gen) - 0.5) * 120.0).to(dev)
    z = ((torch.rand(1_000_000, generator=gen) - 0.5) * 120.0).to(dev)
    seed = torch.tensor(7, dtype=torch.int32, device=dev)
    with torch.no_grad():
        b_kernel = noise2_probe(lib, x, z, 7, bf16=True)
        b_torch = noise.noise2_value_bf16(x, z, seed)
        f_kernel, f_torch = noise2_probe(lib, x, z, 7), noise.noise2_value(x, z, seed)
    if not torch.equal(b_kernel, b_torch):
        fail(f"bf16 noise: the kernel's device arithmetic differs from torch's on "
             f"{(b_kernel != b_torch).sum().item()} of 10^6 points")
    return (f"2D noise at 10^6 points, kernel vs torch on the card: bf16 bit for bit, "
            f"float32 max abs diff {(f_kernel - f_torch).abs().max().item():.3e}")


def once_ms(fn):
    """(``fn()``, its device time in ms by CUDA events, one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bf16_phase(scene, cfg, tag: str, lanes, hits, probe_lib) -> dict:
    """Phase 18 on one terrain, chunked: ``lanes`` and ``hits`` are the
    float32 march's useful steps per lane and hits (phase 15)."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.kernels.trace import render_kernel_raw, trace_frames

    bcfg = dataclasses.replace(cfg, march_bf16=True)
    launches, _ = drive(lambda: render(scene, bcfg), "chunked+bf16", 2)  # coarse + fine
    probe = noise_probe(probe_lib, scene.noise.amplitudes.device)
    err, line, ms, plain_ms, _ = forward_vs_plain(scene, bcfg, f"{tag}bf16 ")
    with torch.no_grad():
        c16, _, h16 = render_kernel_raw(scene, bcfg)
        c32, _, h32 = render_kernel_raw(scene, cfg)
    mean_err = (c16 - c32).abs().mean().item()
    flips = (h16 != h32).float().mean().item()
    if not (mean_err < BF16_MEAN_ERR and flips < BF16_FLIPS):
        fail(f"{tag}bf16 vs float32: mean image error {mean_err:.3e}, {100 * flips:.3f}% "
             f"hit flips (need < {BF16_MEAN_ERR}, < {100 * BF16_FLIPS}%)")
    packed, seed, prime = fine_inputs(scene, cfg)
    h = cfg.height
    times = {"bf16": [], "f32": []}
    for _ in range(2):
        for label, c in (("bf16", bcfg), ("f32", cfg)):
            times[label].append(
                cuda_ms_back_to_back(lambda: trace_frames(packed, seed, c, h, prime), 50))
    ms16, ms32 = min(times["bf16"]), min(times["f32"])
    bound_ms, bound_by = fwd_bound(bcfg, lanes.sum().item(), hits, h * cfg.width)
    return {"line": (f"{tag}launches {launches}; {probe}; {line}; vs float32 frame mean image "
                     f"error {mean_err:.4e}, hit flips {100 * flips:.4f}%; fine pass "
                     f"{ms16:.4f} ms beside float32 {ms32:.4f} ms (best of 2 x 50 back to "
                     f"back, in turns, the float32 prime map); bound {bound_ms:.4f} ms "
                     f"({bound_by})"),
            "launches": launches, "err": err, "ms": ms16, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def bf16_mode_phase(scene, cfg, tag: str, mode: str) -> dict:
    """Phase 18 on one terrain under ``mode`` ("fixed" or "lod"): the bf16
    instantiation driven once through ``render``, against its plain version
    with the bf16 gates and apart from its mode's float32 instantiation on
    the same inputs; its time and bound (lod: the counted fine phase only)."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_reference

    name = f"{mode}+bf16"
    mcfg = dataclasses.replace(cfg, march_mode=mode, march_bf16=True)  # unprimed
    launches, _ = drive(lambda: render(scene, mcfg), name, 1)
    packed, seed, _ = fine_inputs(scene, mcfg)
    h, n_pix = cfg.height, cfg.height * cfg.width
    with torch.no_grad():
        kern = trace_frames(packed, seed, mcfg, h)
        ref, plain_ms = once_ms(lambda: trace_frames_reference(packed, seed, mcfg, h))
        f32 = trace_frames(packed, seed, dataclasses.replace(mcfg, march_bf16=False), h)
        lanes = trace_frames(packed, seed, mcfg, h, debug_steps=True)[3]
    err, line = compare_trace(f"{tag}{name} vs plain", kern, ref, bf16=True)
    line += "; " + bf16_differs(name, kern, f32)
    ms = min(cuda_ms_back_to_back(lambda: trace_frames(packed, seed, mcfg, h), 20)
             for _ in range(2))
    steps = mcfg.max_steps * n_pix if mode == "fixed" else lanes.sum().item()
    bound_ms, bound_by = fwd_bound(mcfg, steps, kern[2].sum().item(), n_pix)
    return {"line": (f"{tag}launches {launches}; {line}; {ms:.4f} ms (best of 2 x 20 back "
                     f"to back), plain {plain_ms:.3f} ms (1); bound {bound_ms:.4f} ms "
                     f"({bound_by}{', fine phase only' if mode == 'lod' else ''})"),
            "launches": launches, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def profiling_phase(scene, cfg, tag: str) -> str:
    """Phase 19 on one terrain: march_stats, warn_if_rough (quiet here, and
    warning on a rough copy), Timer and trace."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.utils import profiling

    stats = profiling.march_stats(scene, cfg)
    if not (0.0 < stats["hit_rate"] < 1.0 and sum(stats["histogram"]) == cfg.height * cfg.width):
        fail(f"{tag}march_stats: {stats}")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        proxy = profiling.warn_if_rough(scene, cfg)
    rough = copy.deepcopy(scene)
    with torch.no_grad():
        n = rough.noise.amplitudes.numel()
        rough.noise.amplitudes.copy_(0.65 ** torch.arange(n, dtype=torch.float32))
        rough.noise.height_scale.fill_(8.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rough_proxy = profiling.warn_if_rough(rough, cfg)
    if not any("roughness proxy" in str(w.message) for w in caught):
        fail(f"{tag}warn_if_rough did not warn at proxy {rough_proxy:.3f}")
    serve = torch.no_grad()(render)
    frame_s = profiling.Timer(iters=5, warmup=1)(serve, scene, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as log_dir:
            serve(scene, cfg)
        size = os.path.getsize(os.path.join(log_dir, "trace.json"))
    hist = " ".join(str(x) for x in stats["histogram"])
    return (f"{tag}march_stats: hit rate {stats['hit_rate']:.6f}, useful steps mean "
            f"{stats['steps_mean']:.4f} p50 {stats['steps_p50']:.1f} p99 "
            f"{stats['steps_p99']:.1f} max {stats['steps_max']}, exhausted "
            f"{stats['exhausted_lanes']}, histogram [{hist}]; roughness proxy {proxy:.4f} "
            f"(quiet), rough copy {rough_proxy:.4f} (warned); Timer: a frame in "
            f"{1e3 * frame_s:.4f} ms (best of 5); trace(): {size} bytes of trace.json")


def quality_phase(dev) -> str:
    """Phase 24: tests/test_torch_quality.py's harness through the forward
    kernel against the plain dense oracle: the default config (primed: two
    launches) at the reference's configs within its holes and t bounds, the
    over-relaxed march out of them; and at every config, the main path's 6
    octaves (its unrolled instantiation) too, within the harness's margins of
    the plain path's own counts."""
    import test_torch_quality as harness

    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames

    parts = []
    for vol, octaves in ((False, None), (True, None), (False, harness.MAIN_OCTAVES)):
        p = harness.VOL if vol else harness.HF
        truth = harness.oracle(vol, device=dev, octaves=octaves)
        tag = (f"{'volumetric' if vol else 'heightfield'} {p['size']}^2, {truth.octaves} "
               f"octaves")
        reset_counts()
        holes, t_off = harness.quality(truth, kernel=True)
        torch.cuda.synchronize()
        launches = trace_frames.launches.total()
        plain = harness.quality(truth)
        margin = harness.t_off_margin(truth)
        if (launches != 2 or abs(holes - plain[0]) > harness.HOLES_MARGIN
                or abs(t_off - plain[1]) > margin):
            fail(f"march quality ({tag}): {launches} launches; kernel {holes} holes, {t_off} "
                 f"off, plain path {plain[0]} and {plain[1]} (margins "
                 f"{harness.HOLES_MARGIN} and {margin})")
        line = (f"{tag}: kernel {holes} holes, {t_off} off by more than {harness.T_ERR}, "
                f"plain path {plain[0]} and {plain[1]} (margins {harness.HOLES_MARGIN} and "
                f"{margin})")
        if octaves is None:
            if holes > p["holes_max"] or t_off > p["t_off_max"]:
                fail(f"march quality ({tag}): kernel {holes} holes (at most "
                     f"{p['holes_max']}), {t_off} off (at most {p['t_off_max']})")
            relax = 1.5 if vol else 1.6
            _, t_off_bad = harness.quality(truth, kernel=True, step_relax=relax)
            if not t_off_bad > p["t_off_max"]:
                fail(f"march quality: relax {relax} through the kernel scored {t_off_bad} <= "
                     f"{p['t_off_max']}: the harness cannot fail")
            line += (f", within the reference's bounds ({p['holes_max']}, {p['t_off_max']}); "
                     f"relax {relax} through the kernel {t_off_bad} off")
        parts.append(line)
    return "; ".join(parts)


def launch_counts() -> dict:
    """The launches since the last ``reset_counts()``, by instantiation."""
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_bwd

    return {**trace_frames.launches, **trace_frames_bwd.launches}


def expect_counts(what: str, expect: dict) -> None:
    got = {k: v for k, v in launch_counts().items() if v}
    if got != expect:
        fail(f"{what}: launches {got}, expected {expect}")


def compact_phase(scene, cfg, tag: str) -> dict:
    """Phase 20 on one terrain: compaction through ``render`` and a training
    step, each phase kernel against its plain version, the frame against the
    unprimed chunked kernel's, the survivors and the times."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.kernels.trace import (
        _prime_maps, phase_name, trace_frames, trace_phase1s, trace_phase1s_reference,
        trace_phase2s, trace_phase2s_reference, warp_steps,
    )
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod

    ccfg = dataclasses.replace(cfg, march_mode="compact", compact_budget=COMPACT_BUDGET)
    ucfg = dataclasses.replace(cfg, prime_ds=0)
    names = (phase_name(ccfg, 1), phase_name(ccfg, 2))
    h, n_pix = cfg.height, cfg.height * cfg.width
    reset_counts()
    with torch.no_grad():
        img = render(scene, ccfg)
    torch.cuda.synchronize()
    expect_counts(f"{tag}compact render", {names[0]: 1, names[1]: 1})
    launches = launch_counts()
    if img.shape != (h, cfg.width, 3) or not torch.isfinite(img).all():
        fail(f"{tag}compact frame: shape {tuple(img.shape)} or non-finite")
    packed, seed, _ = fine_inputs(scene, ccfg)
    with torch.no_grad():
        p1 = trace_phase1s(packed, seed, ccfg, h)
        r1, plain1_ms = once_ms(lambda: trace_phase1s_reference(packed, seed, ccfg, h))
        err1, line1 = compare_trace(f"{tag}phase 1 vs plain", p1[:3], r1[:3])
        alive_diff = (p1[3] != r1[3]).sum().item()
        if alive_diff:
            fail(f"{tag}phase 1: alive differs from the plain version's on {alive_diff} lanes")
        prev, ids, n_alive = p1[4:]
        n = int(n_alive.item())
        # The kernel lists the survivors in the order its warps finish, the
        # plain version in pixel order: the same set.
        if n != int(r1[6].item()) or not torch.equal(ids[0, :n].sort().values, r1[5][0, :n]):
            fail(f"{tag}phase 1: the survivors' list ({n}) differs from the plain "
                 f"version's ({int(r1[6].item())})")
        k2 = [x.clone() for x in p1[:3]]
        trace_phase2s(packed, seed, ccfg, h, n_alive, ids, prev, *k2)
        r2 = [x.clone() for x in p1[:3]]
        _, plain2_ms = once_ms(lambda: trace_phase2s_reference(
            packed, seed, ccfg, h, n_alive, ids, prev, *r2))
        # Phase 2 writes the survivors' pixels only; the others are phase
        # 1's on both sides, so phase 3's gates hold on the survivors alone.
        sel = ids[0, :n].long()

        def survivors(out):
            return out[0].view(3, -1)[:, sel], out[1].view(-1)[sel], out[2].view(-1)[sel]

        err2, line2 = compare_trace(f"{tag}phase 2 vs plain on the {n} survivors",
                                    survivors(k2), survivors(r2))
        # The frame, traced with every host sync raising, against the
        # unprimed chunked kernel's: JAX's exactness contract.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            frame = trace_frames(packed, seed, ccfg, h)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        chunked = trace_frames(packed, seed, ucfg, h)
        *_, (lanes,) = trace_frames(packed, seed, ucfg, h, debug_steps=True)
    torch.cuda.synchronize()
    flips = (frame[2] != chunked[2]).sum().item()
    color_err = (frame[0] - chunked[0]).abs().max().item()
    both = (frame[2] > 0.5) & (chunked[2] > 0.5)
    t_gap = (frame[1] - chunked[1]).abs() - COMPACT_T_RTOL * chunked[1].abs()
    t_worst = t_gap[both].max().item() if both.any() else 0.0
    if flips or color_err > COMPACT_COLOR_ATOL or t_worst > COMPACT_T_ATOL:
        fail(f"{tag}compact vs unprimed chunked: {flips} hit flips, max colour error "
             f"{color_err:.3e} (need 0, <= {COMPACT_COLOR_ATOL}), t {t_worst:.3e} beyond "
             f"rtol {COMPACT_T_RTOL} (need <= {COMPACT_T_ATOL})")
    bitwise = all(torch.equal(a, b) for a, b in zip(frame, chunked))
    counted = (lanes > COMPACT_BUDGET).sum().item()

    # Times of each phase: 50 calls as a CUDA graph (device time) and back
    # to back, phase 2's calls each restoring phase 1's t into the buffer it
    # writes in place, less 50 restores alone; each phase's kernel by the
    # profiler; each wrapper's host us per call. Then the whole traces in
    # turns, best of two.
    t_buf = p1[1].clone()

    def restore():
        t_buf.copy_(p1[1])

    def run1():
        trace_phase1s(packed, seed, ccfg, h)

    def run2():
        trace_phase2s(packed, seed, ccfg, h, n_alive, ids, prev, k2[0], t_buf, k2[2])

    def run2_restored():
        restore()
        run2()

    g1 = graph_ms(run1, 50)

    def graph2(ids_k):
        def run2_k():
            restore()
            trace_phase2s(packed, seed, ccfg, h, n_alive, ids_k, prev, k2[0], t_buf, k2[2])

        return graph_ms(run2_k, 50) - graph_ms(restore, 50)

    # Phase 2's time depends on the order of phase 1's list (the order in
    # which phase 1's warps finish, which differs between launches): the
    # groups take the survivors in that order. One list reads up to 20% off
    # another, so the reading is the median over PHASE2_LISTINGS lists, each
    # from its own launch of phase 1; and, for comparison, the same
    # survivors in pixel order.
    g2_all = [graph2(ids if k == 0 else trace_phase1s(packed, seed, ccfg, h)[5])
              for k in range(PHASE2_LISTINGS)]
    g2 = statistics.median(g2_all)
    by_pixel = ids.clone()
    by_pixel[0, :n] = ids[0, :n].sort().values
    g2_pixel = graph2(by_pixel)
    ms1 = cuda_ms_back_to_back(run1, 50)
    ms2 = cuda_ms_back_to_back(run2_restored, 50) - cuda_ms_back_to_back(restore, 50)
    host1, host2 = host_us(run1), host_us(run2)
    prime = _prime_maps(scene, scene.camera, cfg)
    traces = {
        "compact": lambda: trace_frames(packed, seed, ccfg, h),
        "unprimed chunked": lambda: trace_frames(packed, seed, ucfg, h),
        "primed chunked fine pass": lambda: trace_frames(packed, seed, cfg, h, prime),
        "primed chunked with its coarse pass": lambda: trace_frames(
            packed, seed, cfg, h, _prime_maps(scene, scene.camera, cfg)),
    }
    times = {k: [] for k in traces}
    for _ in range(2):
        for k, fn in traces.items():
            times[k].append(cuda_ms_back_to_back(fn, 50))
    best = {k: min(v) for k, v in times.items()}
    prof = profile_frames(traces["compact"], best["compact"])
    prof_u = profile_frames(traces["unprimed chunked"], best["unprimed chunked"])
    prof1 = kernel_us(run1, "trace_fwd_kernel")
    prof2 = kernel_us(run2_restored, "trace_phase2_kernel")

    # One training step under compact: phase 1, phase 2 and the backward
    # once each; its gradients against unprimed chunked's.
    target = render(scene, cfg).detach()
    start = fitmod.perturb_scene(scene, torch.Generator().manual_seed(0), rel=0.15)
    grads = []
    for c, expect in ((ccfg, {names[0]: 1, names[1]: 1, "bwd": 1}),
                      (ucfg, {"chunked": 1, "bwd": 1})):
        s = copy.deepcopy(start)
        opt = fitmod.make_optimizer(fitmod.partition_scene(s), 5e-3)
        reset_counts()
        loss = fitmod.fit_step(s, c, target, opt)
        torch.cuda.synchronize()
        expect_counts(f"{tag}training step ({c.march_mode})", expect)
        if c is ccfg:
            for k, v in launch_counts().items():
                launches[k] = launches.get(k, 0) + v
        if not torch.isfinite(loss):
            fail(f"{tag}training step under {c.march_mode}: loss {loss.item()}")
        grads.append({n_: p.grad for n_, p in s.named_parameters() if p.grad is not None})
    grads_equal = all(torch.equal(grads[0][k], grads[1][k]) for k in grads[1])
    if bitwise and not grads_equal:
        fail(f"{tag}compact training step: gradients differ from unprimed chunked's on "
             f"the same (t, hit)")
    worst_grad = max(bwd_error(grads[0][k], grads[1][k])[1] for k in grads[1])
    if worst_grad > 1.0:
        fail(f"{tag}compact training step: a gradient at {worst_grad:.3f} of its tolerance")

    hits1 = p1[2].sum().item()
    hits2 = frame[2].sum().item() - hits1
    # Bytes: phase 1 writes five planes, the survivors' ids and n_alive;
    # phase 2 reads n_alive and, per survivor, its id, t and prev, and writes
    # its colour, t and hit.
    b1 = fwd_bound(ccfg, lanes.clamp(max=COMPACT_BUDGET).sum().item(), hits1, n_pix,
                   nbytes=28 * n_pix + 4 * n + 4)
    b2 = fwd_bound(ccfg, (lanes - COMPACT_BUDGET).clamp(min=0).sum().item(), hits2, n,
                   nbytes=32 * n + 4)
    line = (f"{tag}budget {COMPACT_BUDGET}: render launched {names[0]} and {names[1]} once "
            f"each, nothing else; {line1}; alive equal on all {n_pix} lanes, the "
            f"survivors' list equal as a set; {line2}; "
            f"survivors n_alive {n} ({100 * n / n_pix:.4f}%; the counted unprimed march "
            f"leaves {counted} lanes active after {COMPACT_BUDGET} steps; it executes "
            f"{lanes.float().mean().item():.4f} steps per lane, "
            f"{warp_steps(lanes).float().mean().item():.4f} per warp, at most "
            f"{lanes.max().item()}, of which {(lanes - COMPACT_BUDGET).clamp(min=0).sum().item()} "
            f"are left to phase 2); vs the unprimed "
            f"chunked kernel: 0 hit flips, max colour error {color_err:.3e}, "
            f"{'bit for bit equal' if bitwise else 'not bit for bit equal'}; no host sync "
            f"in the compact trace; phase 1 (it lists the survivors itself, so no glue "
            f"runs between the phases): {g1:.5f} ms as a CUDA graph of 50, {ms1:.5f} back "
            f"to back, kernel {prof1[0]:.2f} us by the profiler ({prof1[1]} launches), "
            f"wrapper {host1:.1f} us host per call (bound {b1[0]:.4f} ms, {b1[1]}; plain "
            f"{plain1_ms:.3f} ms); phase 2 (each call restoring phase 1's t, less the "
            f"restores): {g2:.5f} ms as a CUDA graph of 50 (median over {len(g2_all)} lists, "
            f"{min(g2_all):.5f}-{max(g2_all):.5f}; {g2_pixel:.5f} on the list in pixel "
            f"order), {ms2:.5f} back to back, kernel "
            f"{prof2[0]:.2f} us by the profiler ({prof2[1]} launches), wrapper {host2:.1f} "
            f"us host per call (bound {b2[0]:.4f} ms, {b2[1]}; plain {plain2_ms:.3f} ms); "
            f"whole traces, best of 2 x 50 in turns: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in best.items())
            + f"; profile of the compact trace: {prof}; of the unprimed chunked pass: {prof_u}"
            + f"; training step: 1 + 1 launches and 1 backward, gradients "
            f"{'bitwise equal to' if grads_equal else 'within the backward gates of'} "
            f"unprimed chunked's (worst {worst_grad:.4f} of tolerance)")
    return {"line": line, "coarse_and_fine_ms": best["primed chunked with its coarse pass"],
            "phase1": {"launches": launches[names[0]], "err": err1, "ms": ms1,
                       "plain_ms": plain1_ms, "bound_ms": b1[0], "bound_by": b1[1],
                       "graph_ms": g1, "profiler_us": prof1[0], "host_us": host1},
            "phase2": {"launches": launches[names[1]], "err": err2, "ms": ms2,
                       "plain_ms": plain2_ms, "bound_ms": b2[0], "bound_by": b2[1],
                       "graph_ms": g2, "graph_all": g2_all, "graph_pixel_order_ms": g2_pixel,
                       "profiler_us": prof2[0],
                       "host_us": host2}}


def fly_phase(cfg, dev) -> tuple[str, dict]:
    """Phase 21: the flythrough through ``fly_frames``, its tweaks and its
    command line: (report, the frames' launches by instantiation)."""
    from gpgpuraytrace_tpu_torch import default_scene, render
    from gpgpuraytrace_tpu_torch.kernels.trace import phase_name, variant_name
    from gpgpuraytrace_tpu_torch.models.scene import Scene
    from gpgpuraytrace_tpu_torch.ops.flythrough import fly_frames, flythrough_camera
    from gpgpuraytrace_tpu_torch.ops.shade import tonemap
    from gpgpuraytrace_tpu_torch.utils.image import write_png
    from gpgpuraytrace_tpu_torch.utils.tweak import TweakWatcher, apply_tweaks

    scene = default_scene(6, device=dev)
    ccfg = dataclasses.replace(cfg, march_mode="compact", compact_budget=COMPACT_BUDGET)

    def by_render(s, c, i):
        """Frame i rendered apart from fly_frames: render, tonemap, quantize."""
        cam = flythrough_camera(s, torch.arange(i + 1, dtype=torch.float32)[i] / 30.0)
        with torch.no_grad():
            img = tonemap(render(Scene(s.noise, cam, s.materials), c))
        return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()

    counts = {}
    frames = {}
    for label, c, n, expect in (("default", cfg, 8, {variant_name(cfg, frames=4): 4}),
                                ("compact", ccfg, 4, {phase_name(ccfg, 1, 4): 1,
                                                      phase_name(ccfg, 2, 4): 1})):
        reset_counts()
        frames[label] = list(fly_frames(scene, c, n, batch=4))
        torch.cuda.synchronize()
        expect_counts(f"fly_frames {label}", expect)
        counts[label] = launch_counts()
        for i, f in frames[label]:
            if f.shape != (cfg.height, cfg.width, 3) or f.dtype != np.uint8:
                fail(f"fly frame {i}: {f.shape} {f.dtype}")
            if not np.array_equal(f, by_render(scene, c, i)):
                fail(f"fly frame {i} ({label}) differs from render of its camera")
    # A tweak file written while the first batch is out changes the next one.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "live.json")
        watcher = TweakWatcher(path)
        rejected, calls = [], []

        def on_batch(s):
            calls.append(len(calls))
            if len(calls) == 2:
                with open(path, "w") as fh:
                    json.dump({"noise.height_scale": 7.0, "noise.no_such_leaf": 1.0}, fh)
            tweaks = watcher.poll()
            if tweaks is None:
                return s
            s, rej = apply_tweaks(s, tweaks)
            rejected.extend(rej)
            return s

        tweaked = list(fly_frames(scene, cfg, 8, batch=4, on_batch=on_batch))
    same = [np.array_equal(a, b) for (_, a), (_, b) in zip(tweaked, frames["default"])]
    if same != [True] * 4 + [False] * 4 or rejected != ["noise.no_such_leaf"]:
        fail(f"fly tweaks: frames equal to the untweaked ones {same}, rejected {rejected}")
    if scene.noise.height_scale.item() != 6.0:
        fail("fly tweaks changed the caller's scene")
    # Frames per second, in-process: without writing, and writing PNGs.
    fps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label in ("without writing", "writing PNGs"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, f in fly_frames(scene, cfg, 8, batch=4):
                if label == "writing PNGs":
                    write_png(os.path.join(tmp, f"frame_{i:04d}.png"), f)
            fps[label] = 8 / (time.perf_counter() - t0)
    # The command line: a tweak template, then fly with it, then compact rgb.
    cli_lines = []
    with tempfile.TemporaryDirectory() as tmp:
        tweak = os.path.join(tmp, "t.json")
        runs = (["tweaks", "-o", tweak],
                ["fly", "--frames", "8", "--batch", "4", "--tweak", tweak, "-o",
                 os.path.join(tmp, "png")],
                ["fly", "--frames", "4", "--batch", "4", "--march-mode", "compact",
                 "--format", "rgb", "-o", os.path.join(tmp, "rgb")])
        for args in runs:
            proc = subprocess.run(
                [sys.executable, "-m", "gpgpuraytrace_tpu_torch.cli", *args, "--size", "512"],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"cli {args[0]} exited {proc.returncode}: {proc.stderr[-2000:]}")
            cli_lines.append(proc.stdout.strip().splitlines()[-1])
        pngs = sorted(os.listdir(os.path.join(tmp, "png")))
        rgbs = sorted(os.listdir(os.path.join(tmp, "rgb")))
        if len(pngs) != 8 or len(rgbs) != 4 or any(
                os.path.getsize(os.path.join(tmp, "rgb", f)) != 512 * 512 * 3 for f in rgbs):
            fail(f"cli fly wrote {pngs} and {rgbs}")
        with open(tweak) as fh:
            if json.load(fh)["noise.height_scale"] != 6.0:
                fail("cli tweaks: the template does not hold the scene's values")
    same_as_primed = sum(np.array_equal(a, b) for (_, a), (_, b)
                         in zip(frames["compact"], frames["default"]))
    return (f"fly_frames 512x512: 8 default frames in batches of 4 "
            f"({sum(counts['default'].values())} forward launches: one per pass per batch), "
            f"4 compact frames ({sum(counts['compact'].values())} launches), each "
            f"equal to render + tonemap + quantize of its camera bit for bit; compact frames "
            f"vs the default's primed frames: {same_as_primed} of 4 equal; "
            f"a tweak file read between batches changed batch 2 only and rejected "
            f"noise.no_such_leaf; in-process fps (host clock, 8 frames): "
            + ", ".join(f"{k} {v:.2f}" for k, v in fps.items())
            + "; cli: " + " | ".join(cli_lines)), {**counts["default"], **counts["compact"]}


def bf16_bwd_phase(scene, cfg, tag: str) -> dict:
    """Phase 22 on one terrain: the backward kernel's bf16 instantiation, on
    the bf16 frame's (t, hit), with the training loss's cotangent (the
    backward gates) and a seeded normal one (the bf16 backward gates)."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.kernels.trace import (
        render_kernel_raw, trace_frames_bwd, trace_frames_bwd_reference,
    )
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    bcfg = dataclasses.replace(cfg, march_bf16=True)
    f32 = dataclasses.replace(cfg, march_bf16=False)
    start = fitmod.perturb_scene(scene, torch.Generator().manual_seed(0), rel=0.15)
    with torch.no_grad():
        target = render(start, bcfg)
    s = copy.deepcopy(scene)
    opt = fitmod.make_optimizer(fitmod.partition_scene(s), 5e-3)
    reset_counts()
    fitmod.fit_step(s, bcfg, target, opt)
    torch.cuda.synchronize()
    expect_counts(f"{tag}training step under march_bf16", {"chunked+bf16": 2, "bwd+bf16": 1})
    launches = launch_counts()["bwd+bf16"]
    img, t, hit = render_kernel_raw(scene, bcfg)
    packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width, 0.0)
    t, hit = t[None], hit[None]
    cotangents = {
        "loss": ((2.0 / img.numel()) * (img - target)).permute(2, 0, 1)[None].contiguous(),
        "normal": torch.randn(1, 3, cfg.height, cfg.width,
                              generator=torch.Generator().manual_seed(0)).to(t.device),
    }
    gates = {"loss": (BWD_RTOL, BWD_ATOL_REL), "normal": (BF16_BWD_RTOL, BF16_BWD_ATOL_REL)}
    parts, errs = [], []
    for label, g in cotangents.items():
        args = (packed.detach(), seed, bcfg, cfg.height, t, hit.float(), g)
        k, k2 = trace_frames_bwd(*args), trace_frames_bwd(*args)
        ref, plain_ms = once_ms(lambda: trace_frames_bwd_reference(*args))
        k32 = trace_frames_bwd(packed.detach(), seed, f32, *args[3:])
        torch.cuda.synchronize()
        if not torch.isfinite(k).all() or not torch.equal(k, k2):
            fail(f"{tag}bf16 backward ({label}): not finite or not bitwise repeatable")
        err, worst = bwd_error(k, ref, *gates[label])
        if worst > 1.0:
            fail(f"{tag}bf16 backward vs plain ({label} cotangent): worst entry at "
                 f"{worst:.3f} of rtol {gates[label][0]} + {gates[label][1]} x max|pbar|")
        _, worst32 = bwd_error(k32, ref, *gates[label])
        if not worst32 > 1.0:
            fail(f"{tag}bf16 backward ({label}): the float32 instantiation is within the "
                 f"gates of the bf16 plain version too ({worst32:.3f}): the bf16 march "
                 f"channel did not run")
        _, worst_f32_gates = bwd_error(k, ref)
        errs.append(err)
        parts.append(f"{label} cotangent: max abs err {err:.3e}, worst entry at {worst:.4f} "
                     f"of rtol {gates[label][0]} + {gates[label][1]} x max|pbar| "
                     f"({worst_f32_gates:.4f} of phase 8's), the float32 instantiation at "
                     f"{worst32:.2f}; two launches bitwise equal; plain {plain_ms:.3f} ms")
    args = {label: (packed.detach(), seed, c, cfg.height, t, hit.float(), cotangents["loss"])
            for label, c in (("bf16", bcfg), ("f32", f32))}
    parts.append(bwd_repeats(args["bf16"], trace_frames_bwd(*args["bf16"])))
    times = {(label, how): [] for label in args for how in ("b2b", "graph")}
    for _ in range(2):
        for label, a in args.items():
            times[label, "b2b"].append(cuda_ms_back_to_back(lambda: trace_frames_bwd(*a), 50))
            times[label, "graph"].append(graph_ms(lambda: trace_frames_bwd(*a), 50))
    ms, ms32 = min(times["bf16", "b2b"]), min(times["f32", "b2b"])
    gms, gms32 = min(times["bf16", "graph"]), min(times["f32", "graph"])
    host = host_us(lambda: trace_frames_bwd(*args["bf16"]))
    hits, n_pix = hit.sum().item(), cfg.height * cfg.width
    bound_ms, bound_by = bwd_bound(bcfg, hits, n_pix)
    line = (f"{tag}a training step launched chunked+bf16 twice and bwd+bf16 once; on the "
            f"bf16 frame's (t, hit): " + "; ".join(parts)
            + f"; the wrapper {gms:.4f} ms as a CUDA graph of 50 (both stages and the fresh "
            f"scratch's zeroing; float32 {gms32:.4f} ms), {ms:.4f} ms 50 "
            f"back to back (float32 {ms32:.4f} ms; best of 2, in turns), host {host:.1f} us "
            f"per call; bound {bound_ms:.4f} ms ({bound_by}; "
            f"{bwd_bound(bcfg, hits, n_pix, BWD_OCTAVE_BEFORE)[0]:.4f} ms by the earlier count)")
    return {"line": line, "launches": launches, "err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "graph_ms": gms, "host_us": host}


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a filter-0 truecolor PNG (what both writers emit)."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail("not a PNG")
    off, idat, shape = 8, b"", None
    while off < len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        tag = data[off + 4:off + 8]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", data[off + 8:off + 16])
            shape = (h, w)
        elif tag == b"IDAT":
            idat += data[off + 8:off + 8 + n]
        off += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], shape[1] * 3 + 1)
    if (rows[:, 0] != 0).any():
        fail("PNG rows not filter 0")
    return rows[:, 1:].reshape(shape[0], shape[1], 3)


def params_of(scene) -> dict:
    return {n: p.detach().clone() for n, p in scene.named_parameters()}


def same_run(a, b) -> bool:
    """Two fits' (scene, losses) bit for bit."""
    return a[1] == b[1] and all(torch.equal(x, y) for x, y in
                                zip(params_of(a[0]).values(), params_of(b[0]).values()))


def fit_counts(what: str, steps: int, captured: int) -> dict:
    """The launches since reset_counts() of a fit that ran ``steps`` steps
    eagerly and captured ``captured`` (counted once, at capture): 2 forward
    (coarse + fine) and 1 backward each."""
    n = steps + captured
    expect_counts(what, {"chunked": 2 * n, "bwd": n})
    return launch_counts()


def fit_loop_phase(start, target, cfg, trainable, tag: str, card: str) -> dict:
    """Phase 25 on one terrain: ``fit`` in chunks of FIT_K (one CUDA graph)
    against single steps, kill and resume, step times eager against graph
    replays with the device's busy share; compaction's capture, reported."""
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod

    def run(steps, **kw):
        out = fitmod.fit(copy.deepcopy(start), cfg, target, steps=steps, learning_rate=5e-3,
                         trainable=trainable, log_every=0, **kw)
        torch.cuda.synchronize()
        return out

    reset_counts()
    single = run(FIT_STEPS)
    fit_counts(f"{tag}fit, {FIT_STEPS} single steps", FIT_STEPS, 0)
    reset_counts()
    chunked = run(FIT_STEPS, steps_per_call=FIT_K)
    # The first chunk runs eagerly; the second captures FIT_K steps once and
    # every full chunk after it replays them.
    counts = fit_counts(f"{tag}fit in chunks of {FIT_K}", FIT_K, FIT_K)
    # One Adam configuration for every chunk size and the same kernels
    # captured: bit for bit.
    if not same_run(single, chunked):
        fail(f"{tag}fit in chunks of {FIT_K} differs from single steps: losses "
             f"{chunked[1]} vs {single[1]}")
    if not (np.isfinite(single[1]).all() and single[1][-1] < single[1][0]):
        fail(f"{tag}fit losses not finite or not falling: {single[1]}")
    # What ``capturable`` moved: phase 9's (14's) 5 steps with torch's default
    # CUDA Adam beside make_optimizer's, reported.
    five = run(5)
    s = copy.deepcopy(start)
    opt = torch.optim.Adam(fitmod.partition_scene(s, trainable), lr=5e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    default = [fitmod.fit_step(s, cfg, target, opt).item() for _ in range(5)]
    adam_gap = (max(abs(a - b) / abs(b) for a, b in zip(five[1], default)),
                max((a - b).abs().max().item()
                    for a, b in zip(params_of(five[0]).values(), params_of(s).values())))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.npz")
        straight = run(RESUME_STEPS)
        run(RESUME_AT, save_path=path, save_every=RESUME_AT)  # "killed" after its save
        resumed = run(RESUME_STEPS, save_path=path, save_every=RESUME_AT, resume=True,
                      steps_per_call=3)
    if not same_run(straight, resumed):
        fail(f"{tag}kill at step {RESUME_AT} of {RESUME_STEPS} and resume (chunks of 3) "
             f"differs from the straight run: {resumed[1]} vs {straight[1]}")
    # Step times: a chunk of 1 eager, of 8 and 16 graph replays, in turns.
    runs = {}
    for k in STEP_CHUNKS:
        s = copy.deepcopy(start)
        opt = fitmod.make_optimizer(fitmod.partition_scene(s, trainable), 5e-3)
        runs[k] = fitmod.StepChunk(s, cfg, target, opt, k)
        runs[k]()  # eager (the warm-up); the next call captures and replays
    times = {k: [] for k in STEP_CHUNKS}
    for _ in range(2):
        for k, r in runs.items():
            times[k].extend(ms / k for ms in cuda_ms(r, max(2, 40 // k)))
    step_ms = {k: statistics.median(v) for k, v in times.items()}
    busy = {k: profile_frames(runs[k], step_ms[k] * k, frames=3) for k in STEP_CHUNKS}
    # Compaction's path syncs no host (phase 20), so it may capture too:
    # whether it captures is reported, not gated; once it has captured, its
    # chunks must be its single steps bit for bit.
    ccfg = dataclasses.replace(cfg, march_mode="compact")
    c1 = fitmod.fit(copy.deepcopy(start), ccfg, target, steps=2 * FIT_K,
                    learning_rate=5e-3, trainable=trainable, log_every=0)
    try:
        ck = fitmod.fit(copy.deepcopy(start), ccfg, target, steps=2 * FIT_K,
                        learning_rate=5e-3, trainable=trainable, log_every=0,
                        steps_per_call=FIT_K)
    except RuntimeError as e:
        compact = f"does not capture: {str(e).splitlines()[0][:200]}"
    else:
        if not same_run(c1, ck):
            fail(f"{tag}compact fit in chunks of {FIT_K} (captured) differs from single "
                 f"steps: losses {ck[1]} vs {c1[1]}")
        compact = f"captures; {2 * FIT_K} steps in chunks of {FIT_K} bit for bit single steps"
    torch.cuda.synchronize()
    line = (f"{tag}fit of {FIT_STEPS} steps in chunks of {FIT_K} (one CUDA graph; "
            f"launches counted {counts}: the eager chunk and the capture) bit for bit "
            f"single steps (losses {single[1][0]:.6e} -> {single[1][-1]:.6e}); killed at "
            f"step {RESUME_AT} of {RESUME_STEPS} and resumed in chunks of 3: bit for bit the "
            f"straight run; ms per step (median, CUDA events): "
            + ", ".join(f"{'eager' if k == 1 else f'graph of {k}'} {step_ms[k]:.4f}"
                        for k in STEP_CHUNKS)
            + f"; compaction {compact}; Adam capturable against torch's default CUDA "
            f"Adam over phase 9's 5 steps: losses within rel {adam_gap[0]:.3e}, parameters "
            f"within {adam_gap[1]:.3e} {card}")
    return {"line": line, "step_ms": step_ms, "busy": busy, "losses": single[1]}


def cli_fit_phase(losses: list[float]) -> str:
    """Phase 25's command line: ``fit --save --save-every --steps-per-call``
    for 16 steps, then ``--resume`` to 24, ``-o`` both; the 24 losses equal
    the in-process single-step run's (the same start: seed 0, rel 0.15) bit
    for bit."""
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, out = os.path.join(tmp, "fit.npz"), os.path.join(tmp, "out.npz")
        for steps, extra in ((16, []), (FIT_STEPS, ["--resume"])):
            args = ["fit", "--steps", str(steps), "--save", ckpt, "--save-every", "8",
                    "--steps-per-call", str(FIT_K), "-o", out, *extra]
            proc = subprocess.run([sys.executable, "-m", "gpgpuraytrace_tpu_torch.cli", *args],
                                  cwd=REPO, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"cli {' '.join(args)} exited {proc.returncode}: {proc.stderr[-2000:]}")
            lines.append(proc.stdout.strip().splitlines()[-2])
        if "fit: resumed from" not in proc.stdout:
            fail("cli fit --resume did not resume")
        got = np.load(out)
        if got["losses"].tolist() != losses or got["amplitudes"].shape != (6,):
            fail(f"cli fit's resumed losses {got['losses'].tolist()} differ from the "
                 f"in-process run's {losses}")
    return ("cli fit 16 steps in chunks of 8 with --save, then --resume to 24, -o: the "
            "in-process single steps' 24 losses bit for bit | " + " | ".join(lines))


def writer_phase(cfg, dev) -> str:
    """Phase 26: the flythrough through the native writer, every PNG decoded
    and equal to its frame; frames per second with the native async writer,
    the native encoder called synchronously, the Python encoder and without
    writing; the command line's ``fly`` says native=True."""
    from gpgpuraytrace_tpu_torch import default_scene
    from gpgpuraytrace_tpu_torch.kernels.trace import variant_name
    from gpgpuraytrace_tpu_torch.ops.flythrough import fly_frames
    from gpgpuraytrace_tpu_torch.utils import native_io
    from gpgpuraytrace_tpu_torch.utils.image import write_png

    scene = default_scene(cfg.num_octaves, device=dev)
    t0 = time.perf_counter()
    if not native_io.available():
        fail("the native writer did not build (g++ and zlib)")
    build_s = time.perf_counter() - t0
    reset_counts()
    frames = dict(fly_frames(scene, cfg, 8, batch=4))
    torch.cuda.synchronize()
    expect_counts("fly_frames for the writer", {variant_name(cfg, frames=4): 4})
    writers = {
        "without writing": None,
        "Python writer": lambda p, f: write_png(p, f),
        "native, synchronous": lambda p, f: native_io.write_png_native(p, f) or fail(p),
        "native AsyncFrameWriter (2 threads)": "async",
    }
    fps = {k: [] for k in writers}
    with tempfile.TemporaryDirectory() as tmp:
        for rnd in range(2):
            for n, (label, write) in enumerate(writers.items()):
                d = os.path.join(tmp, f"{rnd}-{n}")
                os.makedirs(d)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if write == "async":
                    with native_io.AsyncFrameWriter(num_threads=2, level=6) as w:
                        for i, f in fly_frames(scene, cfg, 8, batch=4):
                            w.push(os.path.join(d, f"frame_{i:04d}.png"), f)
                else:
                    for i, f in fly_frames(scene, cfg, 8, batch=4):
                        if write is not None:
                            write(os.path.join(d, f"frame_{i:04d}.png"), f)
                fps[label].append(8 / (time.perf_counter() - t0))
                if write is not None:
                    for i, f in frames.items():
                        with open(os.path.join(d, f"frame_{i:04d}.png"), "rb") as fh:
                            if not np.array_equal(decode_png(fh.read()), f):
                                fail(f"{label}: frame {i}'s PNG differs from the frame")
        proc = subprocess.run(
            [sys.executable, "-m", "gpgpuraytrace_tpu_torch.cli", "fly", "--size", "512",
             "--frames", "8", "--batch", "4", "-o", os.path.join(tmp, "cli")],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or "native=True" not in proc.stdout:
            fail(f"cli fly: exit {proc.returncode}, {proc.stdout[-500:]} {proc.stderr[-2000:]}")
        for i, f in frames.items():
            with open(os.path.join(tmp, "cli", f"frame_{i:04d}.png"), "rb") as fh:
                if not np.array_equal(decode_png(fh.read()), f):
                    fail(f"cli fly: frame {i}'s PNG differs from fly_frames' frame")
    return (f"native library built or loaded in {build_s:.2f} s; 8 frames 512x512 in "
            f"batches of 4, each writer's PNGs decoded equal to fly_frames' frames, the "
            f"cli's too; fps (host clock, 2 rounds in turns): "
            + "; ".join(f"{k} " + " / ".join(f"{x:.2f}" for x in v) for k, v in fps.items())
            + f" (phase 21's Python writer read 31.92 in PERF.md run 40) | "
            + proc.stdout.strip().splitlines()[-1])


def bands_phase(scene, cfg, tag: str, card: str, bands: int = BANDS) -> str:
    """Phase 27 on one terrain (and phase 31 at 4K): a process group of world
    size 1 on NCCL, its sharded render bit for bit ``render`` and a sharded
    fit step's loss ``pixel_loss``'s; then ``bands`` bands of height / bands
    rows, each traced through the kernels from its own row0, bit for bit the
    whole frame, and their summed gradients the whole frame's."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod
    from gpgpuraytrace_tpu_torch.parallel import mesh
    from gpgpuraytrace_tpu_torch.parallel.launch import free_port
    from gpgpuraytrace_tpu_torch.parallel.sharded import (
        make_sharded_fit_step, shard_target, sharded_render,
    )

    start = fitmod.perturb_scene(scene, torch.Generator().manual_seed(0), rel=0.15)
    with torch.no_grad():
        whole = render(scene, cfg)
        target = render(start, cfg)
    # "cuda" without an index: the rank binds its own card (mesh.rank_device).
    if not mesh.initialize_distributed("cuda", f"tcp://localhost:{free_port()}", 1, 0):
        fail("no process group was made")
    try:
        backend = torch.distributed.get_backend()
        if backend != "nccl" or torch.cuda.current_device() != 0:
            fail(f"{tag}the group of one runs {backend} on card "
                 f"{torch.cuda.current_device()}, not nccl on card 0")
        reset_counts()
        sharded = sharded_render(scene, cfg)
        torch.cuda.synchronize()
        expect_counts(f"{tag}sharded render", {"chunked": 2})
        if not torch.equal(sharded, whole):
            fail(f"{tag}the sharded render of a group of one differs from render")
        s = copy.deepcopy(scene)
        params = fitmod.partition_scene(s)
        with torch.no_grad():
            want = fitmod.pixel_loss(s, cfg, target).item()
        step = make_sharded_fit_step(s, cfg, params, fitmod.make_optimizer(params, 5e-3))
        reset_counts()
        got = step(shard_target(target, cfg)).item()
        torch.cuda.synchronize()
        expect_counts(f"{tag}sharded fit step", {"chunked": 2, "bwd": 1})
        if abs(got - want) > BAND_LOSS_RTOL * abs(want):
            fail(f"{tag}sharded fit step's loss {got!r} vs pixel_loss {want!r}")
    finally:
        torch.distributed.destroy_process_group()
    # The bands in one process, each with its own row0.
    params = fitmod.partition_scene(scene)
    loss = fitmod.pixel_loss(scene, cfg, target)
    whole_grads = torch.autograd.grad(loss, params)
    summed = [torch.zeros_like(p) for p in params]
    parts = []
    reset_counts()
    for r in range(bands):
        row0, h = mesh.band(cfg, r, bands)
        with torch.no_grad():
            parts.append(render(scene, cfg, row0, h))
        d = render(scene, cfg, row0, h) - target[int(row0):int(row0) + h]
        band_loss = torch.sum(d * d) * (1.0 / (cfg.height * cfg.width * 3))
        for acc, g in zip(summed, torch.autograd.grad(band_loss, params)):
            acc += g
    torch.cuda.synchronize()
    expect_counts(f"{tag}{bands} bands", {"chunked": 4 * bands, "bwd": bands})
    if not torch.equal(torch.cat(parts), whole):
        rows = (torch.cat(parts) != whole).any(dim=(1, 2)).nonzero().flatten().tolist()
        fail(f"{tag}the {bands} bands differ from the whole frame in rows {rows[:20]}")
    worst = 0.0
    for (n, _), a, b in zip([(n, p) for n, p in scene.named_parameters() if p.requires_grad],
                            summed, whole_grads):
        tol = BAND_GRAD_ATOL + BAND_GRAD_RTOL * b.abs()
        w = ((a - b).abs() / tol).max().item()
        worst = max(worst, w)
        if w > 1.0:
            fail(f"{tag}{n}: the bands' summed gradient at {w:.3f} of rtol {BAND_GRAD_RTOL} "
                 f"+ atol {BAND_GRAD_ATOL} against the whole frame's")
    return (f"{tag}group of world size 1 on {backend}: sharded render bit for bit render "
            f"(2 forward launches), a sharded fit step's loss {got:.9e} vs pixel_loss "
            f"{want:.9e} (rtol {BAND_LOSS_RTOL}); {bands} bands of {cfg.height // bands} rows "
            f"from their own row0 ({4 * bands} forward, {bands} backward launches): bit for "
            f"bit the whole frame, summed gradients at worst {worst:.4f} of rtol "
            f"{BAND_GRAD_RTOL} + atol {BAND_GRAD_ATOL} {card}")


def fly_batch(scene, n: int, start: int = 0):
    """The fly path's frames start .. start + n - 1 at 30 fps: (times, Cameras)."""
    from gpgpuraytrace_tpu_torch.ops.flythrough import flythrough_cameras

    times = torch.arange(start, start + n, dtype=torch.float32) / 30.0
    return times, flythrough_cameras(scene, times)


def one_frame_cameras(scene, times):
    """The scene seen from the fly path's camera at each time, one frame each."""
    from gpgpuraytrace_tpu_torch.models.scene import Scene
    from gpgpuraytrace_tpu_torch.ops.flythrough import flythrough_camera

    return [Scene(scene.noise, flythrough_camera(scene, t), scene.materials) for t in times]


def batch_digests(scene, cfg, tag: str) -> str:
    """Phase 28, part 1 on one terrain: at ``cfg``'s size, batches of
    BATCHES frames along the fly path through the frame axis, each frame's
    SHA-256 against its batch of one (the one-frame launch): the coarse and
    the fine pass (float32 and bf16), compaction's phase 1 (its survivors as
    a sorted set) and phase 2."""
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_phase1s, trace_phase2s
    from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    n_max = max(BATCHES)
    times, cams = fly_batch(scene, n_max)
    singles = one_frame_cameras(scene, times)
    ch = cfg.height // cfg.prime_ds + 2
    checked = 0
    with torch.no_grad():
        for bf16 in (False, True):
            c = dataclasses.replace(cfg, march_bf16=bf16)
            ccfg = coarse_prime_cfg(c)
            cmp = dataclasses.replace(c, march_mode="compact", compact_budget=COMPACT_BUDGET)
            ones = []
            for s in singles:  # every one-frame launch once; batches take the first B
                pc, _, seed = pack_frames(s, s.camera, ccfg.height, ccfg.width, -1.0)
                pc = pc.detach()
                pf = pack_frames(s, s.camera, c.height, c.width)[0].detach()
                coarse = trace_frames(pc, seed, ccfg, ch)
                prime = prime_from_coarse(coarse[1], c)
                fine = trace_frames(pf, seed, c, c.height, prime)
                p1 = trace_phase1s(pf, seed, cmp, c.height)
                n = int(p1[6].item())
                d1 = digest((*p1[:5], p1[5][0, :n].sort().values, p1[6]))
                trace_phase2s(pf, seed, cmp, c.height, p1[6], p1[5], p1[4], *p1[:3])
                ones.append({"coarse": digest(coarse), "prime": digest([prime]),
                             "fine": digest(fine), "phase1": d1, "phase2": digest(p1[:3])})
            for b in BATCHES:
                sub = dataclasses.replace(cams, position=cams.position[:b], yaw=cams.yaw[:b])
                pc = pack_frames(scene, sub, ccfg.height, ccfg.width, -1.0)[0].detach()
                pf, _, seed = pack_frames(scene, sub, c.height, c.width)
                pf = pf.detach()
                coarse = trace_frames(pc, seed, ccfg, ch)
                prime = prime_from_coarse(coarse[1], c)
                fine = trace_frames(pf, seed, c, c.height, prime)
                p1 = trace_phase1s(pf, seed, cmp, c.height)
                got1 = []
                for k in range(b):
                    n = int(p1[6][k].item())
                    got1.append(digest((*(x[k] for x in p1[:5]), p1[5][k][:n].sort().values,
                                        p1[6][k:k + 1])))
                trace_phase2s(pf, seed, cmp, c.height, p1[6], p1[5], p1[4], *p1[:3])
                for k in range(b):
                    got = {"coarse": digest(x[k] for x in coarse), "prime": digest([prime[k]]),
                           "fine": digest(x[k] for x in fine), "phase1": got1[k],
                           "phase2": digest(x[k] for x in p1[:3])}
                    moved = sorted(p for p in got if got[p] != ones[k][p])
                    if moved:
                        fail(f"{tag}batch of {b}{' bf16' if bf16 else ''}: frame {k}'s "
                             f"{moved} differ from its one-frame launch")
                    checked += len(got)
    torch.cuda.synchronize()
    return (f"{tag}{cfg.height}x{cfg.width}, batches of {'/'.join(map(str, BATCHES))} "
            f"frames along the fly path, float32 and bf16: {checked} outputs (coarse pass, "
            f"prime map, fine pass, compaction's phase 1 with its survivors as a set and "
            f"phase 2 at budget {COMPACT_BUDGET}) each bit for bit (SHA-256) its one-frame "
            f"launch")


def batch_vs_plain(scene, cfg, tag: str) -> dict:
    """Phase 28, part 2 on one terrain: on the fly path's first 2 frames,
    the batched kernels against their plain versions with phase 3's gates
    (the fine pass from the batch's prime map; phase 2 on the survivors'
    pixels), their device times as CUDA graphs and their bounds from this
    batch's counted steps and hits."""
    from gpgpuraytrace_tpu_torch.kernels.trace import (
        _prime_maps, trace_frames, trace_frames_reference, trace_phase1s,
        trace_phase1s_reference, trace_phase2s, trace_phase2s_reference,
    )
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    b = 2
    _, cams = fly_batch(scene, b)
    h, n_pix = cfg.height, b * cfg.height * cfg.width
    cmp = dataclasses.replace(cfg, march_mode="compact", compact_budget=COMPACT_BUDGET)
    ucfg = dataclasses.replace(cfg, prime_ds=0)
    with torch.no_grad():
        prime = _prime_maps(scene, cams, cfg)
        packed, _, seed = pack_frames(scene, cams, cfg.height, cfg.width)
        packed = packed.detach()
        kern = trace_frames(packed, seed, cfg, h, prime)
        ref, plain_ms = once_ms(lambda: trace_frames_reference(packed, seed, cfg, h, prime))
        err, line = compare_trace(f"{tag}batch of 2 fine vs plain", kern, ref)
        *_, steps = trace_frames(packed, seed, cfg, h, prime, debug_steps=True)
        ms = graph_ms(lambda: trace_frames(packed, seed, cfg, h, prime), 20)
        bnd = fwd_bound(cfg, steps.sum().item(), kern[2].sum().item(), n_pix)

        p1 = trace_phase1s(packed, seed, cmp, h)
        r1, plain1_ms = once_ms(lambda: trace_phase1s_reference(packed, seed, cmp, h))
        err1, line1 = compare_trace(f"{tag}batch of 2 phase 1 vs plain", p1[:3], r1[:3])
        if not torch.equal(p1[3], r1[3]) or not torch.equal(p1[6], r1[6]):
            fail(f"{tag}batch phase 1: alive or n_alive differs from the plain version's")
        for k in range(b):
            n = int(p1[6][k].item())
            if not torch.equal(p1[5][k][:n].sort().values, r1[5][k][:n]):
                fail(f"{tag}batch phase 1: frame {k}'s survivors' list differs as a set")
        k2 = [x.clone() for x in p1[:3]]
        trace_phase2s(packed, seed, cmp, h, p1[6], p1[5], p1[4], *k2)
        r2 = [x.clone() for x in p1[:3]]
        _, plain2_ms = once_ms(lambda: trace_phase2s_reference(
            packed, seed, cmp, h, p1[6], p1[5], p1[4], *r2))
        alive = p1[3] > 0.5

        def survivors(out):
            return out[0].transpose(0, 1)[:, alive], out[1][alive], out[2][alive]

        err2, line2 = compare_trace(f"{tag}batch of 2 phase 2 vs plain on the "
                                    f"{int(alive.sum())} survivors", survivors(k2),
                                    survivors(r2))
        ms1 = graph_ms(lambda: trace_phase1s(packed, seed, cmp, h), 20)
        tbuf = p1[1].clone()
        outs = [x.clone() for x in p1[:3]]

        def restore():
            outs[1].copy_(tbuf)

        def p2():
            restore()
            trace_phase2s(packed, seed, cmp, h, p1[6], p1[5], p1[4], *outs)

        ms2 = max(graph_ms(p2, 20) - graph_ms(restore, 20), 0.0)
        *_, lanes = trace_frames(packed, seed, ucfg, h, debug_steps=True)
    torch.cuda.synchronize()
    n = int(p1[6].sum().item())
    hits1 = p1[2].sum().item()
    hits2 = k2[2].sum().item() - hits1
    b1 = fwd_bound(cmp, lanes.clamp(max=COMPACT_BUDGET).sum().item(), hits1, n_pix,
                   nbytes=28 * n_pix + 4 * n + 4 * b)
    b2 = fwd_bound(cmp, (lanes - COMPACT_BUDGET).clamp(min=0).sum().item(), hits2, n,
                   nbytes=32 * n + 4 * b)
    report = (f"{line}; {ms:.5f} ms as a CUDA graph (bound {bnd[0]:.4f} ms, {bnd[1]}; plain "
              f"{plain_ms:.3f} ms) | {line1}; {ms1:.5f} ms (bound {b1[0]:.4f}; plain "
              f"{plain1_ms:.3f}) | {line2}; {ms2:.5f} ms less its restores (bound "
              f"{b2[0]:.4f}; plain {plain2_ms:.3f})")
    entry = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
    return {"line": report, "fine": entry,
            "phase1": {"err": err1, "ms": ms1, "plain_ms": plain1_ms, "bound_ms": b1[0],
                       "bound_by": b1[1]},
            "phase2": {"err": err2, "ms": ms2, "plain_ms": plain2_ms, "bound_ms": b2[0],
                       "bound_by": b2[1]}}


def batch_fly(scene, cfg, tag: str) -> tuple[str, dict]:
    """Phase 28, part 3 on one terrain: ``fly_frames``, 8 frames in batches
    of 4, under the default config and under compact, with the launch counts
    set to 0 just before and read just after: one launch per pass per batch
    (``FlyBatch.launches``; the counters rise by that for each batch that
    ran eagerly or was captured, ``FlyBatch.counted``), each frame bit for
    bit ``render_frame_uint8`` of its time; a batch traced with every host
    sync raising. Returns (report, launches by instantiation)."""
    from gpgpuraytrace_tpu_torch.kernels.trace import phase_name, variant_name
    from gpgpuraytrace_tpu_torch.ops.flythrough import (
        FlyBatch, fly_frames, render_batch_uint8, render_frame_uint8,
    )

    counts = collections.Counter()
    cmp = dataclasses.replace(cfg, march_mode="compact", compact_budget=COMPACT_BUDGET)
    for c, per_batch in ((cfg, {variant_name(cfg, frames=4): 2}),
                         (cmp, {phase_name(cmp, 1, 4): 1, phase_name(cmp, 2, 4): 1})):
        program = FlyBatch(scene, c, 4)
        reset_counts()
        frames = list(fly_frames(scene, c, 8, batch=4, program=program))
        torch.cuda.synchronize()
        got = {k: v for k, v in program.launches.items() if k != "tonemap_quantize"}
        if got != per_batch:
            fail(f"{tag}fly_frames {c.march_mode}: {program.launches} launches a batch, "
                 f"expected {per_batch} and one tonemap_quantize")
        expect_counts(f"{tag}fly_frames {c.march_mode}, 8 frames in batches of 4",
                      {k: v * program.counted for k, v in per_batch.items()})
        counts.update(launch_counts())
        times = torch.arange(8, dtype=torch.float32) / 30.0
        for i, f in frames:
            if not np.array_equal(f, render_frame_uint8(scene, c, times[i]).cpu().numpy()):
                fail(f"{tag}fly frame {i} ({c.march_mode}) differs from render_frame_uint8")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            render_batch_uint8(scene, c, times[4:])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (f"{tag}fly_frames 8 frames {cfg.height}x{cfg.width} in batches of 4: "
            f"{dict(counts)} launches (one per pass per batch, counted at the eager batch "
            f"and the graph's capture), every frame bit for bit "
            f"render_frame_uint8 of its time; a batch rendered with host syncs raising "
            f"(default and compact)"), dict(counts)


def batch_hd(scene, cfg, tag: str) -> str:
    """Phase 28, part 4 on one terrain: a 1920x1080 batch of 4 through
    ``render_frames_raw``, each frame bit for bit ``render_kernel_raw`` of
    its camera (coarse pass, prime map and fine pass); the device time of the
    batch's trace (coarse, prime maps, fine) as a CUDA graph against 4
    one-frame traces, at 1080p and at ``cfg``'s size; the coarse pass of 4
    frames against 1."""
    from gpgpuraytrace_tpu_torch.kernels.trace import (
        render_frames_raw, render_kernel_raw, trace_frames,
    )
    from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    hd = dataclasses.replace(cfg, height=HD[0], width=HD[1])
    times, cams = fly_batch(scene, 4)
    singles = one_frame_cameras(scene, times)
    with torch.no_grad():
        batch = render_frames_raw(scene, cams, hd)
        for k, s in enumerate(singles):
            for a, b, what in zip(batch, render_kernel_raw(s, hd), ("colour", "t", "hit")):
                if not torch.equal(a[k], b):
                    fail(f"{tag}1080p batch of 4: frame {k}'s {what} differs from its "
                         f"one-frame render")
    times_ms = {}
    for label, c in ((f"{cfg.height}x{cfg.width}", cfg), ("1920x1080", hd)):
        ccfg = coarse_prime_cfg(c)
        ch = c.height // c.prime_ds + 2
        with torch.no_grad():
            pc4 = pack_frames(scene, cams, ccfg.height, ccfg.width, -1.0)[0].detach()
            pf4, _, seed = pack_frames(scene, cams, c.height, c.width)
            pf4 = pf4.detach()
            pc1 = [pack_frames(s, s.camera, ccfg.height, ccfg.width, -1.0)[0].detach()
                   for s in singles]
            pf1 = [pack_frames(s, s.camera, c.height, c.width)[0].detach() for s in singles]

            def batched():
                coarse = trace_frames(pc4, seed, ccfg, ch)
                return trace_frames(pf4, seed, c, c.height, prime_from_coarse(coarse[1], c))

            def one_by_one():
                for p_c, p_f in zip(pc1, pf1):
                    coarse = trace_frames(p_c, seed, ccfg, ch)
                    trace_frames(p_f, seed, c, c.height, prime_from_coarse(coarse[1], c))

            reps = 10
            times_ms[label] = {
                "batch_of_4": graph_ms(batched, reps), "one_by_one_4": graph_ms(one_by_one, reps),
                "coarse_4": graph_ms(lambda: trace_frames(pc4, seed, ccfg, ch), 50),
                "coarse_1": graph_ms(lambda: trace_frames(pc1[0], seed, ccfg, ch), 50)}
    torch.cuda.synchronize()
    return (f"{tag}1920x1080 batch of 4: every frame's colour, t and hit bit for bit its "
            f"one-frame render; device time as CUDA graphs (ms): "
            + "; ".join(f"{k}: trace of a batch of 4 {v['batch_of_4']:.4f} against 4 one-frame "
                        f"traces {v['one_by_one_4']:.4f} ({v['one_by_one_4'] / v['batch_of_4']:.3f}x), "
                        f"coarse pass of 4 frames {v['coarse_4']:.5f} against 1 frame "
                        f"{v['coarse_1']:.5f} ({v['coarse_4'] / v['coarse_1']:.3f}x)"
                        for k, v in times_ms.items()))


def launcher_host_us(scene, cfg) -> str:
    """Phase 28, part 5a: host microseconds per call (``host_us``) of the
    fine pass's wrapper for one frame and for a batch of 4, and of the parts
    of its launcher ``_launch``: the library's handle, the config struct, the
    outputs' allocation, the device guard, the stream query, the capture
    query, the tile scratch, the input checks and the C call itself; and what
    setting the C functions' signatures costs, which every launch paid before
    the library's handle was cached."""
    from gpgpuraytrace_tpu_torch.kernels import trace as kt
    from gpgpuraytrace_tpu_torch.kernels.trace import (
        _check_inputs, _kernel_config, _library, _tile_scratch, trace_frames,
    )
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    dev = torch.device("cuda")
    _, cams = fly_batch(scene, 4)
    h, w = cfg.height, cfg.width
    with torch.no_grad():
        prime = kt._prime_maps(scene, cams, cfg)
        pf4, _, seed = pack_frames(scene, cams, h, w)
        pf4 = pf4.detach()
    pf1, prime1 = pf4[:1].contiguous(), prime[:1].contiguous()
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _tile_scratch(dev, stream)
    f32 = dict(dtype=torch.float32, device=dev)
    color, t, hit = torch.empty((3, h, w), **f32), torch.empty((h, w), **f32), \
        torch.empty((h, w), **f32)
    kcfg = _kernel_config(cfg, h, primed=True)

    def c_call():
        lib.trace_fwd_launch(pf1.data_ptr(), seed.data_ptr(), prime1.data_ptr(),
                             color.data_ptr(), t.data_ptr(), hit.data_ptr(), None, None, None,
                             None, None, scratch.data_ptr(), kcfg, 1, stream)

    def signatures():
        for fn in (lib.trace_fwd_launch, lib.trace_compact_launch, lib.trace_bwd_scratch_floats,
                   lib.trace_bwd_launch, lib.trace_error_string):
            fn.argtypes = list(fn.argtypes)
            fn.restype = fn.restype

    def device_guard():
        with torch.cuda.device(dev):
            pass

    parts = {
        "trace_frames (1 frame)": lambda: trace_frames(pf1, seed, cfg, h, prime1),
        "trace_frames (4 frames)": lambda: trace_frames(pf4, seed, cfg, h, prime),
        "input checks": lambda: _check_inputs(pf1, seed, cfg, h, prime1, False),
        "library handle (cached)": _library,
        "signatures set anew": signatures,
        "config struct made": lambda: _kernel_config(cfg, h, primed=True),
        "3 outputs allocated": lambda: (torch.empty((3, h, w), **f32), torch.empty((h, w), **f32),
                                        torch.empty((h, w), **f32)),
        "device guard": device_guard,
        "stream query": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "capture query": torch.cuda.is_current_stream_capturing,
        "tile scratch": lambda: _tile_scratch(dev, stream),
        "the C call (launch)": c_call,
    }
    us = {k: host_us(fn) for k, fn in parts.items()}
    return ("wrapper host us per call (least of 5 runs of 200): "
            + "; ".join(f"{k} {v:.2f}" for k, v in us.items()))


def fly_fps(scene, cfg, tag: str) -> str:
    """Phase 28, part 5b: ``fly_frames`` frames per second without writing
    (host clock, FLY_FRAMES frames after a warm-up) at batch 1, 4 and 8, at
    ``cfg``'s size and at 1920x1080, FLY_ROUNDS rounds in turns; and the
    device's busy share of a batch of 4 (``render_batch_uint8``, the
    profiler against its host-clock time)."""
    from gpgpuraytrace_tpu_torch.ops.flythrough import fly_frames, render_batch_uint8

    sizes = {f"{cfg.height}x{cfg.width}": cfg,
             "1920x1080": dataclasses.replace(cfg, height=HD[0], width=HD[1])}
    fps = collections.defaultdict(list)
    for label, c in sizes.items():
        for b in (1, 4, 8):
            for _ in fly_frames(scene, c, b, batch=b):  # warm-up
                pass
    for _ in range(FLY_ROUNDS):
        for label, c in sizes.items():
            for b in (1, 4, 8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in fly_frames(scene, c, FLY_FRAMES, batch=b):
                    pass
                fps[label, b].append(FLY_FRAMES / (time.perf_counter() - t0))
    busy = {}
    for label, c in sizes.items():
        times = torch.arange(4, dtype=torch.float32) / 30.0
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_batch_uint8(scene, c, times)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        busy[label] = profile_frames(lambda: render_batch_uint8(scene, c, times),
                                     statistics.median(walls))
    return (f"{tag}fly fps without writing (host clock, {FLY_FRAMES} frames, "
            f"{FLY_ROUNDS} rounds in turns): "
            + "; ".join(f"{k[0]} batch {k[1]} " + " / ".join(f"{x:.2f}" for x in v)
                        for k, v in fps.items())
            + " | a batch of 4: " + " | ".join(f"{k}: {v}" for k, v in busy.items()))


def bench_phase(fwd_per_step: float, bwd_per_step: float, card: str) -> tuple[str, dict]:
    """Phase 29: the port's benchmark, ``bench.run_bench`` at 512x512, 6
    octaves, K = 40 (parity gate, CUDA graphs of 1 and K steps, the eager
    slope, the plain path, the march statistics), and ``bench.run_bench_mesh(1)``
    (one rank of ``parallel/worker.py --time-k`` on NCCL), each JSON line
    printed. It fails unless parity is "ok", every slope is positive,
    vs_baseline is above 1, the K-step graph captured a training step's
    kernel launches per step (phase 9's), both timed graphs replayed at a
    fixed salt equal the eager loop bit for bit and one step of the kernel
    path holds against the plain path's (``detail.checks``); returns its
    line and this process's forward and backward launches (the captures
    count once)."""
    from gpgpuraytrace_tpu_torch import bench
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_bwd

    t0 = time.perf_counter()
    reset_counts()
    result = bench.run_bench((512, 512), 6, iters=40)
    torch.cuda.synchronize()
    counts = {"forward": trace_frames.launches.total(),
              "backward": trace_frames_bwd.launches.total()}
    print(json.dumps(result), flush=True)
    d = result["detail"]
    if result["parity"] != "ok":
        fail(f"bench: the parity gate says {result['parity']!r}")
    slopes = [m["ms_per_step"] for m in d["kernel_measurements"] + d["eager_measurements"]
              + [d["plain_measurement"]]]
    if not all(ms > 0 for ms in slopes):
        fail(f"bench: a slope is not positive: {slopes} ms per step")
    if not result["vs_baseline"] > 1.0:
        fail(f"bench: vs_baseline {result['vs_baseline']!r} is not above 1")
    graph, step = d["checks"]["graph_vs_eager"], d["checks"]["kernel_vs_plain"]
    if graph is None or not graph["ok"]:
        fail(f"bench: the timed graphs against the eager loop: {graph}")
    if not step["ok"]:
        fail(f"bench: one step of the kernel path against the plain path's: {step}")
    per_step = d["launches_per_step"]
    got = (sum(per_step["forward"].values()), sum(per_step["backward"].values()))
    if d["kernel_timing"] != "cuda_graph" or got != (fwd_per_step, bwd_per_step):
        fail(f"bench: the {d['K']}-step graph ({d['kernel_timing']}) captured {per_step} "
             f"launches per step, a training step launches {fwd_per_step:g} forward and "
             f"{bwd_per_step:g} backward (phase 9)")
    mesh = bench.run_bench_mesh(1)
    print(json.dumps(mesh), flush=True)
    rank = mesh["detail"]["ranks"]["1"][0]
    if rank["backend"] != "nccl" or not mesh["value"] > 0 or rank["timing"] != "cuda_graph":
        fail(f"bench --mesh 1: the rank ran {rank['backend']!r} ({rank['timing']!r}), eff(1) "
             f"{mesh['value']!r}")
    if bench.failures(mesh):
        fail(f"bench --mesh 1: {bench.failures(mesh)}")
    m = d["march"]
    spread = [x["rays_per_sec"] for x in d["kernel_measurements"]]
    line = (f"fwd+bwd {result['value']:.1f} rays/s ({d['kernel_ms_per_step']:.5f} ms a step, "
            f"CUDA graphs of 1 and {d['K']} steps, lower middle of "
            f"{', '.join(f'{x:.1f}' for x in spread)}), eager {d['rays_per_sec_eager']:.1f} "
            f"({d['eager_ms_per_step']:.4f} ms), plain {d['plain']:.2f} "
            f"({d['plain_ms_per_step']:.2f} ms, K {d['plain_K']}); vs_baseline "
            f"{result['vs_baseline']:.2f}; parity ok; graphs of 1 and {d['K']} steps equal "
            f"the eager loop bit for bit at salt {graph['salt']} ({graph[str(d['K'])]['graph']}); "
            f"a kernel step vs plain: accumulator {step['acc_kernel']!r} vs "
            f"{step['acc_plain']!r} (err {step['acc_err']:.3e}, bound {step['acc_bound']:.3e}), "
            f"worst leaf {step['worst_leaf']} at {step['worst_leaf_share']:.4f} of its bound; "
            f"{got[0]:g} forward and {got[1]:g} "
            f"backward launches per captured step ({per_step}); build {d['kernel_build_s']:.2f} "
            f"s; peak memory {d['peak_memory_bytes'] / 2**20:.1f} MiB; march: hit rate "
            f"{m['hit_rate']:.4f}, steps mean {m['steps_mean']:.4f}, p99 {m['steps_p99']:.1f}, "
            f"exhausted {m['exhausted_lanes']}, executed per ray {m['executed_steps_per_ray_kernel']} "
            f"(TPU tiles) / {m['executed_steps_per_ray_kernel_warp_tile']} (warp tiles); "
            f"mesh 1 on {rank['backend']}: {mesh['detail']['rays_per_sec']['1']:.1f} rays/s "
            f"(CUDA graphs; eager {mesh['detail']['rays_per_sec_eager']['1']:.1f}), graph_check "
            f"ok, eff(1) {mesh['value']}; seconds {d['seconds']}; phase 29 took "
            f"{time.perf_counter() - t0:.1f} s {card}")
    return line, counts


def quantize_sass(lib_path, source=None) -> dict:
    """``sass_per_pixel`` of the tonemap-and-quantize kernel in the built
    library's SASS (``cuobjdump -sass``), with the pixels an iteration takes
    read from its source (``source``, else the package's
    ``csrc/quantize.cu``), and the function's SASS text."""
    from gpgpuraytrace_tpu_torch.kernels.build import CSRC

    m = re.search(r"kGroups = (\d+)", Path(source or CSRC / "quantize.cu").read_text())
    bodies = [f for f in sass_functions(lib_path) if re.match(r"\S*tonemap_quantize_kernel", f)]
    if len(bodies) != 1:
        fail(f"the SASS holds {len(bodies)} tonemap_quantize_kernel functions, expected 1")
    return {**sass_per_pixel(bodies[0], int(m.group(1)) if m else 0), "sass": bodies[0]}


def sass_per_pixel(body: str, groups: int) -> dict:
    """Static SASS instructions a pixel of a tonemap-and-quantize kernel,
    its out-of-line subroutines (the targets of its calls) left out, and
    the rare blocks too: those a forward branch skips that hold a call and
    neither a store nor a float operation (the exact chain's call sites; the
    chain and the IEEE division's slow path run in subroutines). With
    ``groups`` 4-pixel groups an iteration (the redesigned kernel): the
    instructions of its grid-stride loop (the backward branch of the
    longest span) over 4 x ``groups`` pixels; without (a pixel per thread):
    the kernel's instructions."""
    insts = instructions(body)
    targets = [int(m.group(1), 16) for _, op, args in insts
               if op.startswith("CALL") and (m := re.search(r"0x([0-9a-f]+)", args))]
    insts = [i for i in insts if i[0] < min(targets, default=1 << 62)]
    loops = [(lo, hi) for lo, hi in backward_branches(insts) if lo < hi]
    looped = bool(groups and loops)
    lo, hi = (max(loops, key=lambda r: r[1] - r[0]) if looped
              else (insts[0][0], insts[-1][0]))
    span = [(a, op) for a, op, _ in insts if lo <= a <= hi]
    rare = set()
    for addr, op, args in insts:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        target = int(m.group(1), 16) if m else 0
        skipped = [o for a, o in span if addr < a < target]
        if (lo <= addr < target <= hi and any(o.startswith("CALL") for o in skipped)
                and not any(o.startswith("ST") or o.split(".")[0] in FLOAT_OPS
                            for o in skipped)):
            rare.update(a for a, _ in span if addr < a < target)
    return {"instructions": len(insts), "counted": len(span), "rare": len(rare),
            "calls": sum(o.startswith("CALL") for _, o in span),
            "per_pixel": (len(span) - len(rare)) / (4 * groups if looped else 1)}


def quantize_vs_plain(scene, cfg, tag: str, frames: int, sass_per_pixel: float) -> dict:
    """Phase 30, part 1: the tonemap-and-quantize kernel against its plain
    version (eight torch passes) on a batch of ``frames`` frames of the fly
    path at ``cfg``'s size, as ``render_frames_raw`` hands it over (the view
    of its (B, 3, H, W) planes): the count of differing values (0 allowed),
    and the device times of the kernel and of the plain version (CUDA graphs
    of QUANT_REPS calls) beside the kernel's two bounds: the bytes (12 read
    and 3 written a pixel) and the issue of ``sass_per_pixel`` SASS
    instructions a pixel."""
    from gpgpuraytrace_tpu_torch.kernels.quantize import (
        tonemap_quantize, tonemap_quantize_reference,
    )
    from gpgpuraytrace_tpu_torch.kernels.trace import render_frames_raw

    with torch.no_grad():
        color = render_frames_raw(scene, fly_batch(scene, frames)[1], cfg)[0]
        got = tonemap_quantize(color)
        ref = tonemap_quantize_reference(color)
    torch.cuda.synchronize()
    n_diff = int((got != ref).sum())
    if n_diff or got.shape != color.shape or not got.is_contiguous():
        fail(f"{tag}tonemap_quantize at {frames}x{cfg.height}x{cfg.width}: {n_diff} values "
             f"differ from the plain version (0 allowed)")
    pixels = color.shape[0] * color.shape[1] * color.shape[2]
    bytes_ms = 1e3 * 15 * pixels / HBM_BYTES_PER_S
    issue_ms = 1e3 * pixels * sass_per_pixel / 32 / WARP_ISSUE_PER_S
    return {"frames": frames, "size": f"{cfg.width}x{cfg.height}", "differ": n_diff,
            "max_abs_err": 0.0,
            "ms": graph_ms(lambda: tonemap_quantize(color), QUANT_REPS),
            "plain_ms": graph_ms(lambda: tonemap_quantize_reference(color), QUANT_REPS),
            "bound_ms": max(bytes_ms, issue_ms),
            "bound_by": "bytes" if bytes_ms >= issue_ms else "operations",
            "bytes_bound_ms": bytes_ms, "issue_bound_ms": issue_ms, "library_ms": None}


def quantize_exhaustive(dev) -> dict:
    """Phase 30, part 3: all 2^32 float32 bit patterns through
    ``tonemap_quantize`` and ``tonemap_quantize_reference`` on the card, in
    chunks of EXHAUSTIVE_SIDE^2 pixels; fails on any differing byte. With
    the level table's counts: its edges, the chain's changes, the windows
    where the chain steps back, the finite patterns sent to the exact chain
    and the scan's seconds."""
    from gpgpuraytrace_tpu_torch.kernels.quantize import (
        level_table, tonemap_quantize, tonemap_quantize_reference,
    )

    table = level_table(dev)
    n = 3 * EXHAUSTIVE_SIDE ** 2
    starts = list(range(-2 ** 31, 2 ** 31 - n, n)) + [2 ** 31 - n]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    differ = 0
    with torch.no_grad():
        for s in starts:
            bits = torch.arange(s, s + n, dtype=torch.int64, device=dev).to(torch.int32)
            color = bits.view(torch.float32).view(1, 3, EXHAUSTIVE_SIDE,
                                                  EXHAUSTIVE_SIDE).permute(0, 2, 3, 1)
            differ += int((tonemap_quantize(color) != tonemap_quantize_reference(color)).sum())
    seconds = time.perf_counter() - t0
    if differ:
        fail(f"tonemap_quantize: {differ} of the 2^32 float32 inputs differ from the plain "
             f"version on the card")
    return {"values": 2 ** 32, "chunks": len(starts), "differ": differ, "seconds": seconds,
            "edges": len(set(table.edges[1:])), "changes": table.changes,
            "windows": len(table.windows), "exact_patterns": table.exact_patterns,
            "scan_s": table.seconds}


def fly_graph_frames(scene, cfg, tag: str, batch: int) -> tuple[str, collections.Counter, int]:
    """Phase 30, part 2: ``fly_frames`` through ``FlyBatch``'s graph,
    FLY_GRAPH_FRAMES frames in batches of ``batch`` (the last one short), a
    tweak (a deep copy with other values, as utils/tweak.py hands over)
    before the last batch, with the launch counts set to 0 just before and
    read just after: every frame bit for bit ``render_frame_uint8`` of its
    time on the scene it was rendered from, the tweaked batch apart from the
    untweaked frames, every batch after the first a replay, the counters
    risen by the launches of a batch for each counted call. Returns (report,
    trace launches, tonemap_quantize launches)."""
    from gpgpuraytrace_tpu_torch.kernels.quantize import tonemap_quantize
    from gpgpuraytrace_tpu_torch.ops.flythrough import FlyBatch, fly_frames, render_frame_uint8
    from gpgpuraytrace_tpu_torch.utils.tweak import apply_tweaks

    n = FLY_GRAPH_FRAMES
    batches = -(-n // batch)
    used = []

    def on_batch(s):
        if len(used) == batches - 1:
            s = apply_tweaks(s, {"noise.height_scale": 7.0, "materials.fog_density": 0.03})[0]
        used.append(s)
        return s

    program = FlyBatch(scene, cfg, batch)
    reset_counts()
    frames = list(fly_frames(scene, cfg, n, batch=batch, on_batch=on_batch, program=program))
    torch.cuda.synchronize()
    trace = collections.Counter(launch_counts())
    quant = tonemap_quantize.launches
    what = f"{tag}fly graph {cfg.march_mode} {cfg.height}x{cfg.width}, {n} frames in {batch}s"
    per_batch = {k: v for k, v in program.launches.items() if k != "tonemap_quantize"}
    if (program.replays != batches - 1 or program.counted != 2
            or program.launches["tonemap_quantize"] != 1 or quant != program.counted
            or trace != collections.Counter({k: v * program.counted
                                             for k, v in per_batch.items()})):
        fail(f"{what}: {program.replays} replays, {program.counted} counted calls, "
             f"{dict(program.launches)} launches a batch, counters {dict(trace)} and "
             f"tonemap_quantize {quant}")
    times = torch.arange(n, dtype=torch.float32) / 30.0
    for i, f in frames:
        want = render_frame_uint8(used[i // batch], cfg, times[i]).cpu().numpy()
        if f.shape != want.shape or not np.array_equal(f, want):
            fail(f"{what}: frame {i} differs from render_frame_uint8 of its scene")
    last = (batches - 1) * batch
    if np.array_equal(frames[last][1], render_frame_uint8(scene, cfg, times[last]).cpu().numpy()):
        fail(f"{what}: the tweak before the last batch did not show in it")
    if scene.noise.height_scale.item() != 6.0:
        fail(f"{what}: the caller's scene changed")
    line = (f"{what}: {batches} batches, {program.replays} replays, launches a batch "
            f"{dict(program.launches)}, every frame bit for bit render_frame_uint8, the "
            f"tweak shown in batch {batches}")
    return line, trace, quant


def copy_times(dev) -> str:
    """Phase 30, part 3: a batch's device-to-host copy alone, pageable
    (``.cpu()``) against pinned (a pinned tensor from the caching host
    allocator, a non-blocking copy and an event, as ``FlyBatch.host_frames``
    copies), in turns, COPY_REPS each, host clock from a synchronised
    start."""
    out = []
    for frames, (h, w) in ((4, (512, 512)), (4, HD), (8, HD)):
        x = torch.randint(0, 256, (frames, h, w, 3), dtype=torch.uint8, device=dev)
        times = {"pageable": [], "pinned": []}

        def pageable():
            return x.cpu()

        def pinned():
            host = torch.empty(x.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            return host

        for fn in (pageable, pinned):  # warm-up: the pinned cache holds a block after
            if not torch.equal(fn(), x.cpu()):
                fail(f"copy of {frames}x{h}x{w}: the host copy differs")
        for _ in range(COPY_REPS):
            for label, fn in (("pageable", pageable), ("pinned", pinned)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times[label].append(1e3 * (time.perf_counter() - t0))
        mb = x.numel() / 1e6
        out.append(f"{frames}x{w}x{h} ({mb:.1f} MB): " + ", ".join(
            f"{k} {statistics.median(v):.4f} ms (min {min(v):.4f}; "
            f"{mb / statistics.median(v):.2f} GB/s)" for k, v in times.items()))
    return "copy to the host alone (median of " f"{COPY_REPS}): " + "; ".join(out)


def fly_graph_fps(scene, cfg) -> str:
    """Phase 30, part 4: fly frames per second without writing (host clock,
    FLY_GRAPH_FPS_FRAMES frames) at batch 1, 4 and 8, at ``cfg``'s size and
    at 1920x1080, the graph (``fly_frames`` with a ``FlyBatch`` kept from a
    warm-up, so every timed batch is a replay) against the eager batch (the
    loop before the graph: ``render_batch_uint8`` and a pageable ``.cpu()``
    copy per batch), FLY_ROUNDS rounds in turns; and each arm's device busy
    share: the profiler's device time (kernels and copies) over 5 batches
    against a batch's median host-clock time."""
    from torch.profiler import ProfilerActivity, profile

    from gpgpuraytrace_tpu_torch.ops.flythrough import FlyBatch, fly_frames, render_batch_uint8

    sizes = {f"{cfg.width}x{cfg.height}": cfg,
             "1920x1080": dataclasses.replace(cfg, height=HD[0], width=HD[1])}
    n = FLY_GRAPH_FPS_FRAMES
    programs, arms = {}, {}
    for label, c in sizes.items():
        for b in (1, 4, 8):
            program = programs[label, b] = FlyBatch(scene, c, b)
            for _ in fly_frames(scene, c, 2 * b, batch=b, program=program):  # warm-up, capture
                pass

            def graph(c=c, b=b, program=program):
                for _ in fly_frames(scene, c, n, batch=b, program=program):
                    pass

            def eager(c=c, b=b):
                for start in range(0, n, b):
                    times = torch.arange(start, start + b, dtype=torch.float32) / 30.0
                    render_batch_uint8(scene, c, times).cpu().numpy()

            arms[label, b] = {"graph": graph, "eager": eager}
            eager()
    fps = collections.defaultdict(list)
    for _ in range(FLY_ROUNDS):
        for key, fns in arms.items():
            for arm, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                fps[key, arm].append(n / (time.perf_counter() - t0))
    busy = {}
    for (label, b), program in programs.items():
        c = sizes[label]
        times = torch.arange(b, dtype=torch.float32) / 30.0
        one = {"graph": lambda: program.host_frames(scene, times, b),
               "eager": lambda: render_batch_uint8(scene, c, times).cpu().numpy()}
        for arm, fn in one.items():
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            device_us = sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == torch.autograd.DeviceType.CUDA) / 5
            busy[label, b, arm] = (device_us, 1e3 * statistics.median(walls))
    parts = []
    for (label, b) in programs:
        row = []
        for arm in ("graph", "eager"):
            us, wall_us = busy[label, b, arm]
            share = "the profiler saw no device time" if not us else f"{100 * us / wall_us:.1f}%"
            row.append(f"{arm} " + " / ".join(f"{x:.2f}" for x in fps[(label, b), arm])
                       + f" fps, busy {share} ({us:.1f} of {wall_us:.1f} us)")
        parts.append(f"{label} batch {b}: " + ", ".join(row))
    return (f"fly fps without writing (host clock, {n} frames, {FLY_ROUNDS} rounds in turns; "
            f"busy: profiler over 5 batches against a batch's median host time): "
            + "; ".join(parts))


def fly_graph_phase(dev, card: str) -> tuple[str, dict, collections.Counter]:
    """Phase 30: the flythrough batch as one CUDA graph, both terrains,
    default and compact. Returns (report, the tonemap_quantize entry of the
    kernels' record, the trace kernels' launches of its fly runs)."""
    from gpgpuraytrace_tpu_torch import RenderConfig, default_scene
    from gpgpuraytrace_tpu_torch.kernels.build import build_library

    t0 = time.perf_counter()
    lines = []
    quant = []
    trace_counts = collections.Counter()
    quant_launches = 0
    sass = quantize_sass(build_library()[0])
    for vol in (False, True):
        tag = "volumetric " if vol else ""
        scene = default_scene(6, volumetric=vol, device=dev)
        base = RenderConfig(num_octaves=6, volumetric=vol)
        for c in (base, dataclasses.replace(base, march_mode="compact",
                                            compact_budget=COMPACT_BUDGET)):
            for size in ((512, 512), HD):
                r = quantize_vs_plain(scene, dataclasses.replace(c, height=size[0],
                                                                 width=size[1]), tag, 4,
                                      sass["per_pixel"])
                r["config"] = f"{tag}{c.march_mode}"
                quant.append(r)
            for b in FLY_GRAPH_BATCHES:
                line, counts, q = fly_graph_frames(scene, c, tag, b)
                lines.append(line)
                trace_counts.update(counts)
                quant_launches += q
    hd8 = quantize_vs_plain(default_scene(6, device=dev), RenderConfig(
        num_octaves=6, height=HD[0], width=HD[1]), "", 8, sass["per_pixel"])
    hd8["config"] = "chunked"
    quant.append(hd8)
    qline = "; ".join(
        f"{r['config']} {r['frames']}x{r['size']}: {r['differ']} values differ, kernel "
        f"{r['ms']:.5f} ms against bound {r['bound_ms']:.5f} ({r['bound_by']}; bytes "
        f"{r['bytes_bound_ms']:.5f}, SASS issue {r['issue_bound_ms']:.5f}), plain "
        f"{r['plain_ms']:.5f} ms" for r in quant)
    every = quantize_exhaustive(dev)
    fps_line = fly_graph_fps(default_scene(6, device=dev), RenderConfig(num_octaves=6))
    line = (f"tonemap_quantize vs plain (CUDA graphs of {QUANT_REPS} calls; fast path "
            f"{sass['per_pixel']:g} SASS instructions a pixel, static: {sass['counted']} in its "
            f"loop less {sass['rare']} only the exact chain's inputs reach): {qline} | all "
            f"2^32 float32 inputs in {every['chunks']} chunks: {every['differ']} differ, "
            f"{every['seconds']:.2f} s; level table {every['edges']} edges from "
            f"{every['changes']} changes, {every['windows']} windows, "
            f"{every['exact_patterns']} finite patterns to the exact chain, scan "
            f"{every['scan_s']:.3f} s | " + " | ".join(lines) + f" | {copy_times(dev)} | "
            f"{fps_line} | phase 30 took {time.perf_counter() - t0:.1f} s {card}")
    head = next(r for r in quant if r["config"] == "chunked" and r["size"] == "1920x1080"
                and r["frames"] == 4)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bytes_bound_ms", "issue_bound_ms",
            "library_ms")
    entry = {"name": "tonemap_quantize", "route": "cuda",
             "source": "gpgpuraytrace_tpu_torch/kernels/csrc/quantize.cu",
             "replaces": "gpgpuraytrace_tpu/ops/flythrough.py:51",
             "variants": ["heightfield", "volumetric"], "frames": 4, "size": "1920x1080",
             "launches": quant_launches,
             "max_abs_err": max(r["max_abs_err"] for r in quant),
             "differing_values": sum(r["differ"] for r in quant),
             "sass_per_pixel": sass["per_pixel"], "exhaustive": every,
             **{k: head[k] for k in keys},
             "by_shape": [{k: r[k] for k in ("config", "frames", "size", "differ", *keys)}
                          for r in quant]}
    return line, entry, trace_counts


def uhd_band_vs_plain(scene, cfg, whole, row0: int, h: int) -> str:
    """A band of ``h`` rows from ``row0`` of the 4K frame through the kernels
    (its coarse pass of h / ds + 2 coarse rows, the prime map, the fine
    pass), bit for bit the whole frame's rows, and against the plain
    versions on the same inputs (the fine pass from the kernel's prime map)
    with phase 3's gates."""
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_reference
    from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    ds = cfg.prime_ds
    ccfg = coarse_prime_cfg(cfg)
    tag = f"4K band of {h} rows at row {row0}"
    with torch.no_grad():
        packed_c, _, seed_c = pack_frames(scene, scene.camera, ccfg.height, ccfg.width,
                                          row0 / ds - 1.0)
        coarse_k = trace_frames(packed_c, seed_c, ccfg, h // ds + 2)
        coarse_r = trace_frames_reference(packed_c, seed_c, ccfg, h // ds + 2)
        torch.cuda.synchronize()
        _, line_c = compare_trace(f"{tag}: coarse", coarse_k, coarse_r)
        prime = prime_from_coarse(coarse_k[1], cfg)
        packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width, float(row0))
        fine_k = trace_frames(packed, seed, cfg, h, prime)
        fine_r = trace_frames_reference(packed, seed, cfg, h, prime)
        torch.cuda.synchronize()
        _, line_f = compare_trace(f"{tag}: fine", fine_k, fine_r)
    if not torch.equal(fine_k[0][0].permute(1, 2, 0), whole[row0:row0 + h]):
        fail(f"{tag}: the kernel's band differs from the whole frame's rows")
    return f"{line_c} | {line_f}; bit for bit the whole frame's rows"


def uhd_kernels(scene, cfg) -> str:
    """The forward kernel's coarse and fine pass and the backward kernel on
    the whole 4K frame: each against its plain version on the same inputs
    (the forward passes with phase 3's gates, the fine pass from the
    kernel's prime map; the backward on the fine pass's (t, hit) and a
    seeded normal cotangent with phase 8's, finite and two launches
    bitwise equal), the plain versions' time once each and the plain
    backward's peak memory; then each kernel as a CUDA graph of 10
    launches, beside its bound counted for this frame: the march steps
    from the kernel's counter (its steps per lane: phase 15's "executed per
    lane", the work each lane's data needed, without the warp's
    divergence), the hits from the frame; the coarse pass from its own
    counter and hits."""
    from gpgpuraytrace_tpu_torch.kernels.trace import (
        render_kernel_raw, trace_frames, trace_frames_bwd, trace_frames_bwd_reference,
        trace_frames_reference,
    )
    from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames

    def once_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    n_pix = cfg.height * cfg.width
    ccfg = coarse_prime_cfg(cfg)
    ch = cfg.height // cfg.prime_ds + 2
    with torch.no_grad():
        *_, hit, steps = render_kernel_raw(scene, cfg, debug_steps=True)
        hits = hit.sum().item()
        packed_c, _, seed_c = pack_frames(scene, scene.camera, ccfg.height, ccfg.width, -1.0)
        _, _, c_hit, c_steps = trace_frames(packed_c, seed_c, ccfg, ch, debug_steps=True)
        coarse_k = trace_frames(packed_c, seed_c, ccfg, ch)
        coarse_r, plain_s = once_s(lambda: trace_frames_reference(packed_c, seed_c, ccfg, ch))
        _, line_c = compare_trace(f"4K coarse {ch}x{ccfg.width}", coarse_k, coarse_r)
        prime = prime_from_coarse(coarse_k[1], cfg)
        packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width, 0.0)
        fine_k = trace_frames(packed, seed, cfg, cfg.height, prime)
        fine_r, plain_fine_s = once_s(
            lambda: trace_frames_reference(packed, seed, cfg, cfg.height, prime))
        _, line_f = compare_trace(f"4K fine {cfg.height}x{cfg.width}", fine_k, fine_r)
        del fine_r
        _, t, hit_f = fine_k
        g = torch.randn(1, 3, cfg.height, cfg.width,
                        generator=torch.Generator().manual_seed(0)).to(packed.device)
        bwd_args = (packed, seed, cfg, cfg.height, t, hit_f, g)
        pbar_k = trace_frames_bwd(*bwd_args)
        pbar_k2 = trace_frames_bwd(*bwd_args)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pbar_r, plain_bwd_s = once_s(lambda: trace_frames_bwd_reference(*bwd_args))
    plain_bwd_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    if not torch.isfinite(pbar_k).all():
        fail("4K backward: kernel output not finite")
    if not torch.equal(pbar_k, pbar_k2):
        fail("4K backward: two launches differ")
    err, worst = bwd_error(pbar_k, pbar_r)
    if worst > 1.0:
        fail(f"4K backward vs plain: worst entry at {worst:.3f} of its tolerance (max abs "
             f"err {err:.3e})")
    del pbar_r
    torch.cuda.empty_cache()
    with torch.no_grad():
        ms = {"coarse": graph_ms(lambda: trace_frames(packed_c, seed_c, ccfg, ch), 10),
              "fine": graph_ms(lambda: trace_frames(packed, seed, cfg, cfg.height, prime), 10),
              "bwd": graph_ms(lambda: trace_frames_bwd(*bwd_args), 10)}
    c_pix = ch * ccfg.width
    bounds = {"coarse": fwd_bound(ccfg, c_steps.sum().item(), c_hit.sum().item(), c_pix),
              "fine": fwd_bound(cfg, steps.sum().item(), hits, n_pix),
              "bwd": bwd_bound(cfg, hits, n_pix)}
    return (f"{line_c} | {line_f} | 4K backward on the fine pass's (t, hit), "
            f"{int(hit_f.sum().item())} hits: max abs err {err:.3e}, worst entry at "
            f"{worst:.4f} of rtol {BWD_RTOL} + {BWD_ATOL_REL} x max|pbar|, two launches "
            f"bitwise equal | plain versions once: coarse {plain_s:.3f} s, fine "
            f"{plain_fine_s:.3f} s, backward {plain_bwd_s:.3f} s ({plain_bwd_mib:.1f} MiB "
            f"peak above its inputs) | 4K kernels as CUDA graphs of 10 (ms, bound, bound by; "
            f"march steps from the kernel's counter, "
            f"{steps.double().mean().item():.4f} per lane, {int(hits)} hits): "
            + ", ".join(f"{k} {ms[k]:.4f} ({bounds[k][0]:.4f}, {bounds[k][1]})"
                        for k in ("coarse", "fine", "bwd")))


def uhd_stripes(dev) -> str:
    """One rank's rows of the benchmark's 4K fit over UHD_STRIPE_WORLD ranks
    (prime_ds PACK_BAND_DS): its stripes (``mesh.stripes``) as one batch of
    the one camera. The packed rows, a ROW0 per frame, one launch, bit for bit
    the plain packing's ops on the card; the coarse and fine passes of the
    batch, one launch each, against their plain versions (phase 3's gates,
    the fine pass from the kernel's prime map); ``render`` of the stripes bit
    for bit each stripe's own render, concatenated; the backward of the
    batch (one launch pair, a seeded normal cotangent in the (B, h, W, 3)
    layout) bit for bit each stripe's one-frame launch and against its plain
    version (phase 8's gates), its packed cotangent through the VJP kernel
    against autograd through the plain packing's ops (PACK_VJP_RTOL); then
    the batch's passes and backward as CUDA graphs beside the stripes'
    one-frame launches."""
    from gpgpuraytrace_tpu_torch import RenderConfig, default_scene, render
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack
    from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
    from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
    from gpgpuraytrace_tpu_torch.parallel import mesh

    cfg = RenderConfig(height=UHD[0], width=UHD[1], max_steps=128, num_octaves=6,
                       prime_ds=PACK_BAND_DS)
    ccfg = coarse_prime_cfg(cfg)
    row0s, s = mesh.stripes(cfg, UHD_STRIPE_RANK, UHD_STRIPE_WORLD)
    k, hc = len(row0s), s // cfg.prime_ds + 2
    tag = f"4K rank {UHD_STRIPE_RANK} of {UHD_STRIPE_WORLD}: {k} stripes of {s} rows"
    scene = default_scene(6, device=dev)
    differ = pack_rows_differ(scene, scene.camera, cfg, row0s)
    if differ:
        fail(f"{tag}: the packed rows differ from the plain ops on the card in {differ} values")
    reset_counts()
    with torch.no_grad():
        packed, coarse, seed = ktrace._packs(scene, scene.camera, cfg, row0s)
        coarse_k = ktrace.trace_frames(coarse, seed, ccfg, hc)
        coarse_r = ktrace.trace_frames_reference(coarse, seed, ccfg, hc)
        _, line_c = compare_trace(f"{tag}: coarse", coarse_k, coarse_r)
        prime = prime_from_coarse(coarse_k[1], cfg)
        fine_k = ktrace.trace_frames(packed, seed, cfg, s, prime)
        fine_r = ktrace.trace_frames_reference(packed, seed, cfg, s, prime)
        _, line_f = compare_trace(f"{tag}: fine", fine_k, fine_r)
        del coarse_r, fine_r
        expect_counts(f"{tag}: the batch's passes", {"chunked+frames": 2})
        reset_counts()
        striped = render(scene, cfg, row0s, k * s)
        expect_counts(f"{tag}: render of the stripes", {"chunked+frames": 2})
        if kpack.pack_frames.launches != 1:
            fail(f"{tag}: render packed the stripes in {kpack.pack_frames.launches} launches")
        if not torch.equal(striped, torch.cat([render(scene, cfg, r, s) for r in row0s])):
            fail(f"{tag}: the striped render differs from each stripe's render")
        _, t, hit = fine_k
        g = torch.randn((k, s, cfg.width, 3),
                        generator=torch.Generator().manual_seed(0)).to(dev).permute(0, 3, 1, 2)
        reset_counts()
        pbar = ktrace.trace_frames_bwd(packed, seed, cfg, s, t, hit, g)
        expect_counts(f"{tag}: the batch's backward", {"bwd+frames": 1})
        ones = torch.cat([ktrace.trace_frames_bwd(packed[b:b + 1], seed, cfg, s, t[b:b + 1],
                                                  hit[b:b + 1], g[b:b + 1]) for b in range(k)])
        if not torch.equal(pbar, ones):
            fail(f"{tag}: the batch's backward differs from the stripes' one-frame launches")
    ref = ktrace.trace_frames_bwd_reference(packed, seed, cfg, s, t, hit, g)
    err, worst = bwd_error(pbar, ref)
    if not torch.isfinite(pbar).all() or worst > 1.0:
        fail(f"{tag}: backward vs plain: worst entry at {worst:.3f} of its tolerance (max abs "
             f"err {err:.3e})")
    del ref
    for p in scene.parameters():
        p.requires_grad_(True)
    rel, abs_err = pack_vjp_error(scene, scene.camera, cfg, row0s, pbar)
    if rel > PACK_VJP_RTOL["batch"]:
        fail(f"{tag}: the packed cotangent through pack_vjp_kernel at {rel:.3e} of autograd "
             f"through the plain ops (limit {PACK_VJP_RTOL['batch']})")
    with torch.no_grad():
        ms = {"coarse": graph_ms(lambda: ktrace.trace_frames(coarse, seed, ccfg, hc),
                                 UHD_STRIPE_REPS),
              "fine": graph_ms(lambda: ktrace.trace_frames(packed, seed, cfg, s, prime),
                               UHD_STRIPE_REPS),
              "bwd": graph_ms(lambda: ktrace.trace_frames_bwd(packed, seed, cfg, s, t, hit, g),
                              UHD_STRIPE_REPS)}
        one = {"coarse": graph_ms(lambda: [ktrace.trace_frames(coarse[b:b + 1], seed, ccfg, hc)
                                           for b in range(k)], UHD_STRIPE_REPS),
               "fine": graph_ms(lambda: [ktrace.trace_frames(packed[b:b + 1], seed, cfg, s,
                                                             prime[b:b + 1]) for b in range(k)],
                                UHD_STRIPE_REPS),
               "bwd": graph_ms(lambda: [ktrace.trace_frames_bwd(packed[b:b + 1], seed, cfg, s,
                                                                t[b:b + 1], hit[b:b + 1],
                                                                g[b:b + 1])
                                        for b in range(k)], UHD_STRIPE_REPS)}
    step_line = uhd_stripe_step(scene, cfg, row0s, s, tag)
    return (f"{line_c} | {line_f} | {tag}: one pack launch, rows bit for bit the plain ops; "
            f"render bit for bit each stripe's; backward one launch pair, bit for bit the "
            f"stripes' one-frame launches, max abs err {err:.3e} against its plain version, "
            f"worst entry at {worst:.4f} of its tolerance; its packed cotangent through "
            f"pack_vjp_kernel at {rel:.3e} of autograd through the plain ops (max abs "
            f"{abs_err:.3e}) | as CUDA graphs of {UHD_STRIPE_REPS} (ms, the batch against "
            f"{k} one-frame launches): "
            + ", ".join(f"{x} {ms[x]:.4f} / {one[x]:.4f}" for x in ("coarse", "fine", "bwd"))
            + f" | {step_line}")


def uhd_stripe_step(scene, cfg, row0s, s: int, tag: str) -> str:
    """The rank's training step through its stripes as ``fit4k.x4`` runs it:
    ``parallel/sharded.py:band_loss_and_grad`` of the rank's h rows (autograd
    through the kernel path's render of the stripes, its backward and the
    pack VJP), from phase 27's perturbed start toward the unperturbed
    scene's rows, as one CUDA graph (``CapturedProgram``: the eager warm-up,
    then the capture). The launches counted at the capture alone (one pack,
    the batch's coarse and fine passes, one backward launch pair, one VJP);
    the replay's loss and gradients bit for bit the warm-up's; each leaf's
    gradient within phase 8's gates of the plain backward at the kernel's own
    (t, hit) (``kernel_bwd=False``: autograd through
    ``render_from_checkpoint`` of each stripe); the loss within BWD_RTOL and
    each leaf within UHD_STRIPE_PLAIN_RTOL of the plain path (``render_torch``
    and its autograd, its own march) on the same stripes."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod
    from gpgpuraytrace_tpu_torch.parallel import sharded
    from gpgpuraytrace_tpu_torch.utils.graphs import CapturedProgram

    h = len(row0s) * s
    with torch.no_grad():
        target = render(scene, cfg, row0s, h)
    start = fitmod.perturb_scene(scene, torch.Generator().manual_seed(0), rel=0.15)
    params = fitmod.partition_scene(start)
    names = [n for n, p in start.named_parameters() if p.requires_grad]

    def step():
        loss, grads = sharded.band_loss_and_grad(start, params, cfg, target, row0s, h)
        return torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])

    program = CapturedProgram(step, target.device)
    eager = program().clone()
    torch.cuda.synchronize()
    reset_counts()
    program.capture()
    torch.cuda.synchronize()
    captured = {k: v for k, v in launch_counts().items() if v}
    pack = {"pack": kpack.pack_frames.launches, "pack_vjp": kpack.pack_vjp.launches}
    if captured != {"chunked+frames": 2, "bwd+frames": 1} or pack != {"pack": 1, "pack_vjp": 1}:
        fail(f"{tag}: the step through the stripes captured {captured} and {pack}, expected "
             f"{{'chunked+frames': 2, 'bwd+frames': 1}} and one pack and one VJP launch")
    replayed = program().clone()
    torch.cuda.synchronize()
    program.close()
    if not torch.equal(replayed, eager):
        fail(f"{tag}: the captured step's replay differs from its eager warm-up")
    want = {}
    for what, c in (("checkpoint", dataclasses.replace(cfg, kernel_bwd=False)),
                    ("plain", dataclasses.replace(cfg, use_kernel=False))):
        other = copy.deepcopy(start)
        want[what] = sharded.band_loss_and_grad(other, fitmod.partition_scene(other), c, target,
                                                row0s, h)
    want_loss = want["plain"][0]
    got_loss, rest = replayed[0], replayed[1:]
    if not abs(got_loss - want_loss).item() <= BWD_RTOL * abs(want_loss).item():
        fail(f"{tag}: the step's loss {got_loss.item()!r} vs the plain path's "
             f"{want_loss.item()!r} (rtol {BWD_RTOL})")
    worst, worst_plain, at = 0.0, 0.0, 0
    for n, ref, plain in zip(names, want["checkpoint"][1], want["plain"][1]):
        got = rest[at:at + ref.numel()].reshape(ref.shape)
        at += ref.numel()
        _, w = bwd_error(got, ref)
        r = ((got - plain).norm() / plain.norm()).item()
        worst, worst_plain = max(worst, w), max(worst_plain, r)
        if not torch.isfinite(got).all() or w > 1.0:
            fail(f"{tag}: {n}: the step's gradient at {w:.3f} of rtol {BWD_RTOL} + "
                 f"{BWD_ATOL_REL} x max against the plain backward at its (t, hit)")
        if not r <= UHD_STRIPE_PLAIN_RTOL:
            fail(f"{tag}: {n}: the step's gradient {r:.3e} (relative) from the plain path's "
                 f"(limit {UHD_STRIPE_PLAIN_RTOL})")
    return (f"{tag}: the step (band_loss_and_grad of {h} rows) as one CUDA graph, counted at "
            f"the capture {captured}, {pack}; its replay bit for bit the eager warm-up; "
            f"{len(names)} leaves' gradients at worst {worst:.4f} of rtol {BWD_RTOL} + "
            f"{BWD_ATOL_REL} x max against the plain backward at its (t, hit); against the plain "
            f"path: loss {got_loss.item():.9e} vs {want_loss.item():.9e}, gradients at worst "
            f"{worst_plain:.3e} relative (limit {UHD_STRIPE_PLAIN_RTOL})")


def sharded_graph_phase(scene, cfg, target) -> tuple[str, dict]:
    """On a process group of one (NCCL), from phase 27's perturbed start
    toward ``target``: ``make_sharded_fit_step`` called
    SHARDED_FIT_CALLS times (the eager warm-up, then replays of one captured
    step) against as many eager steps of a copy (``ShardedFitStep.eager``),
    losses and parameters bit for bit, the launches counted at the capture
    and none at a replay; and a ``dist.all_reduce`` (``mesh.all_reduce``)
    captured in a CUDA graph behind an add and replayed. Returns (report,
    the pack and VJP kernels' launches counted at the capture)."""
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod
    from gpgpuraytrace_tpu_torch.parallel import mesh
    from gpgpuraytrace_tpu_torch.parallel.launch import free_port
    from gpgpuraytrace_tpu_torch.parallel.sharded import make_sharded_fit_step, shard_target

    start = fitmod.perturb_scene(scene, torch.Generator().manual_seed(0), rel=0.15)
    if not mesh.initialize_distributed("cuda", f"tcp://localhost:{free_port()}", 1, 0):
        fail("no process group was made")
    try:
        steps, params = [], []
        for _ in range(2):
            s = copy.deepcopy(start)
            p = fitmod.partition_scene(s)
            params.append(p)
            steps.append(make_sharded_fit_step(s, cfg, p, fitmod.make_optimizer(p, 5e-3)))
        graphed, twin = steps
        local = shard_target(target, cfg)
        losses = [graphed(local).item()]
        reset_counts()
        mesh.all_reduce.launches.clear()
        losses.append(graphed(local).item())  # the capture and its first replay
        torch.cuda.synchronize()
        captured = {k: v for k, v in launch_counts().items() if v}
        captured_ar = mesh.all_reduce.launches.total()
        pack = {"pack": kpack.pack_frames.launches, "pack_vjp": kpack.pack_vjp.launches}
        if not graphed.program.captured or captured != {"chunked": 2, "bwd": 1}:
            fail(f"the sharded fit step captured {captured} (graph: "
                 f"{graphed.program.captured}), expected 2 forward and 1 backward launches")
        losses += [graphed(local).item() for _ in range(SHARDED_FIT_CALLS - 2)]
        torch.cuda.synchronize()
        if ({k: v for k, v in launch_counts().items() if v} != captured
                or pack != {"pack": kpack.pack_frames.launches,
                            "pack_vjp": kpack.pack_vjp.launches}):
            fail("a replay of the sharded fit step launched through the wrappers")
        eager = [twin.eager(local).item() for _ in range(SHARDED_FIT_CALLS)]
        if losses != eager or not all(torch.equal(a, b) for a, b in zip(*params)):
            fail(f"the sharded fit step's replays differ from its eager steps: losses "
                 f"{losses} vs {eager}")
        # One all-reduce captured behind an add and replayed twice: the
        # eager call first creates NCCL's communicator.
        x = torch.arange(8, dtype=torch.float32, device=target.device)
        mesh.all_reduce(x)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        mesh.all_reduce.launches.clear()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            x.add_(1.0)
            mesh.all_reduce(x)
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
        want = torch.arange(8, dtype=torch.float32, device=x.device) + 2.0
        if not torch.equal(x, want) or mesh.all_reduce.launches.total() != 1:
            fail(f"the captured all_reduce: {x.tolist()} after 2 replays, expected "
                 f"{want.tolist()}; {mesh.all_reduce.launches.total()} counted at capture")
        backend = torch.distributed.get_backend()
        # Release both graphs before the group goes: NCCL's communicator
        # waits for every graph that holds its collectives.
        graphed.close()
        del graph
    finally:
        torch.distributed.destroy_process_group()
    return (f"sharded fit step on a group of one ({backend}): {SHARDED_FIT_CALLS} calls (the "
            f"eager warm-up, then {SHARDED_FIT_CALLS - 1} replays of one CUDA graph) bit for "
            f"bit {SHARDED_FIT_CALLS} eager steps of a copy (losses {losses[0]:.9e} -> "
            f"{losses[-1]:.9e}, every parameter); counted at the capture {captured} and "
            f"{captured_ar} all-reduces (a group of one skips them) and {pack}, nothing at a "
            f"replay; a dist.all_reduce captured behind an add, 2 replays: "
            f"{x[:3].tolist()}..."), pack


def config5_phase(dev, card: str) -> tuple[str, dict]:
    """Phase 31: BASELINE.json config 5 on one card (see the module's
    docstring); returns its line and the config-5 path's forward and
    backward launches, and the pack kernels' at the sharded step's capture."""
    from gpgpuraytrace_tpu_torch import RenderConfig, default_scene, render
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_bwd

    sys.path.insert(0, str(REPO / "scripts"))
    import torch_contract_configs

    t0 = time.perf_counter()
    height, width = UHD
    cfg = RenderConfig(height=height, width=width, max_steps=128, num_octaves=6)
    if cfg.prime_ds != 8:
        fail(f"config 5 resolves prime_ds to {cfg.prime_ds}, expected 8")
    scene = default_scene(6, device=dev)
    serve_launches, mean = serve_frames(scene, cfg, (scene.camera.yaw.item(),))
    with torch.no_grad():
        whole = render(scene, cfg)
    lines = [f"the 4K frame ({width}x{height}, prime_ds {cfg.prime_ds}): {serve_launches} "
             f"forward launches, finite, sky-blue top, mean colour {mean}"]
    lines.append(bands_phase(scene, cfg, "4K ", card, bands=UHD_BANDS))
    for row0 in UHD_PLAIN_ROW0S:
        lines.append(uhd_band_vs_plain(scene, cfg, whole, row0, UHD_PLAIN_ROWS))
    lines.append(uhd_kernels(scene, cfg))
    lines.append(uhd_stripes(dev))
    sharded_line, pack = sharded_graph_phase(scene, cfg, whole)
    lines.append(sharded_line)
    reset_counts()
    result = torch_contract_configs.config5(height, width, 6, device=dev)
    torch.cuda.synchronize()
    counts = {"forward": trace_frames.launches.total(),
              "backward": trace_frames_bwd.launches.total()}
    print(json.dumps(result), flush=True)
    if not result["ok"]:
        fail(f"config 5: {json.dumps(result)}")
    want = {"frame": {"forward": {"chunked": 2.0}, "backward": {}, "all_reduce": {}},
            "fwd_bwd": {"forward": {"chunked": 2.0}, "backward": {"bwd": 1.0},
                        "all_reduce": {}}}
    got = {"frame": result["frame_launches"], "fwd_bwd": result["fwd_bwd_launches"]}
    timing = (result["frame_timing"], result["fwd_bwd_timing"])
    if got != want or timing != ("cuda_graph", "cuda_graph"):
        fail(f"config 5: launches per captured step {got} ({timing}), expected {want}")
    fc, sc = result["frame_graph_check"], result["fwd_bwd_graph_check"]
    lines.append(
        f"config 5 (scripts/torch_contract_configs.py, K {result['K']}): frame "
        f"{result['frame_ms']:.4f} ms as CUDA graphs ({result['mrays_per_sec']:.1f} Mrays/s), "
        f"eager {result['frame_ms_eager']:.4f} ms; fwd+bwd {result['fwd_bwd_ms_per_step']:.4f} "
        f"ms a step as CUDA graphs ({result['fwd_bwd_mrays_per_sec']:.1f} Mrays/s), eager "
        f"{result['fwd_bwd_ms_per_step_eager']:.4f} ms; graph_check ok (frame "
        f"{fc[str(result['K'])]['graph']}, step {sc[str(result['K'])]['graph']}); "
        f"launches per captured step {got}; sharded_render bit for bit render on "
        f"{result['group']['backend']}, mean pixel {result['mean_pixel']:.6f}; peak memory "
        f"frame {result['frame_peak_memory_bytes'] / 2**20:.1f} MiB, step "
        f"{result['fwd_bwd_peak_memory_bytes'] / 2**20:.1f} MiB")
    lines.append(f"phase 31 took {time.perf_counter() - t0:.1f} s {card}")
    return " | ".join(lines), {"forward": counts["forward"] + serve_launches,
                                "backward": counts["backward"], "pack": pack}


def pack_shapes() -> list[tuple[str, object, object, tuple[float, ...]]]:
    """Phase 32's shapes, one a benchmark cell: (name, RenderConfig, the
    cameras' maker from a scene, the rows' row0s)."""
    from gpgpuraytrace_tpu_torch import RenderConfig

    return [
        ("fit512", RenderConfig(num_octaves=6), lambda s: s.camera, (0.0,)),
        ("fly1080", RenderConfig(height=HD[0], width=HD[1], num_octaves=6),
         lambda s: fly_batch(s, PACK_FLY_FRAMES)[1], (0.0,)),
        ("4k.band", RenderConfig(height=UHD[0], width=UHD[1], num_octaves=6,
                                 prime_ds=PACK_BAND_DS),
         lambda s: s.camera, tuple(float(r) for r in range(0, UHD[0], UHD[0] // 4))),
    ]


def pack_plain(scene, cams, cfg, row0):
    """The plain packing's ops (``utils/packing.py:_pack_scenes``) run on the
    card: (the fine rows, the coarse prime pass's rows), each (B, n); ``row0``
    a number, or a tuple of a row0 per frame (a rank's stripes)."""
    from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg
    from gpgpuraytrace_tpu_torch.utils import packing as pk

    ccfg = coarse_prime_cfg(cfg)
    crow0 = (tuple(r / cfg.prime_ds - 1.0 for r in row0) if isinstance(row0, tuple)
             else row0 / cfg.prime_ds - 1.0)
    return tuple(pk._pack_scenes(scene, cams, h, w, r)[0].reshape(-1, pk.AMPS + cfg.num_octaves)
                 for h, w, r in ((cfg.height, cfg.width, row0), (ccfg.height, ccfg.width, crow0)))


def pack_rows_differ(scene, cams, cfg, row0) -> int:
    """The values in which ``pack_frames``' fine and coarse rows (one launch)
    differ from the plain ops' on the card."""
    from gpgpuraytrace_tpu_torch.kernels import trace as ktrace

    with torch.no_grad():
        got = ktrace._packs(scene, cams, cfg, row0)[:2]
        want = pack_plain(scene, cams, cfg, row0)
    return sum(int((a != b).sum()) + int(a.shape != b.shape) for a, b in zip(got, want))


def pack_vjp_error(scene, cams, cfg, row0, g) -> tuple[float, float]:
    """The VJP kernel's gradients against autograd through the plain ops on
    the card, for the cotangent ``g`` of the fine rows: (the largest over the
    float leaves of the error's norm over the norm of the sum of each frame's
    term's magnitude, the largest absolute error). For one frame the first is
    the plain relative error; a leaf the frames share sums their terms, which
    may cancel, so its error is measured against what they sum to before
    they cancel."""
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack
    from gpgpuraytrace_tpu_torch.kernels import trace as ktrace

    leaves = kpack._leaves(scene, cams)
    before = kpack.pack_vjp.launches
    got = torch.autograd.grad(ktrace._packs(scene, cams, cfg, row0)[0], leaves, g)
    if kpack.pack_vjp.launches != before + 1:
        fail(f"pack_vjp: {kpack.pack_vjp.launches - before} launches for one backward")
    plain = pack_plain(scene, cams, cfg, row0)[0]
    want = torch.autograd.grad(plain, leaves, g, retain_graph=True)
    scale = [torch.zeros_like(x) for x in leaves]
    for b in range(g.shape[0]):
        gb = torch.zeros_like(g)
        gb[b] = g[b]
        for s, d in zip(scale, torch.autograd.grad(plain, leaves, gb, retain_graph=True)):
            s.add_(d.abs())
    rel = max(float((a - w).norm()) / max(float(s.norm()), 1e-30)
              for a, w, s in zip(got, want, scale))
    return rel, max(float((a - w).abs().max()) for a, w in zip(got, want))


def pack_trial(scene, base, shapes, t: int, gen):
    """Trial ``t``: the card scene's float leaves drawn anew in place (each
    of ``base``'s values scaled by U(0.5, 1.5), the sun direction N(0, 1)),
    and cameras of 1 to PACK_MAX_FRAMES frames from ``gen``: position and
    yaw a value per frame (one shared in every other one-frame trial), pitch
    and fov_y per frame or shared in turn. Returns (cameras, RenderConfig,
    row0) of one of ``shapes``."""
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack
    from gpgpuraytrace_tpu_torch.ops.camera import Cameras

    with torch.no_grad():
        for name, x, x0 in zip(kpack.FLOAT_LEAVES, kpack._leaves(scene, scene.camera), base):
            new = (torch.randn(3, generator=gen) if name == "materials.sun_dir"
                   else x0 * (0.5 + torch.rand(x0.shape, generator=gen)))
            x.copy_(new)
    b = 1 + t % PACK_MAX_FRAMES
    framed = b > 1 or t % 4 == 1
    lead = (b,) if framed else ()
    u = torch.rand(4, b, generator=gen)
    pos = 20.0 * torch.randn(*lead, 3, generator=gen)
    yaw = (12.4 * u[0] - 6.2).reshape(lead)
    pitch = 2.4 * u[1] - 1.2
    fov = 0.2 + 1.4 * u[2]
    pitch = pitch.reshape(lead) if framed and t % 2 else pitch[0]
    fov = fov.reshape(lead) if framed and (t // 2) % 2 else fov[0]
    dev = scene.noise.amplitudes.device
    cams = Cameras(*(x.contiguous().to(dev) for x in (pos, yaw, pitch, fov)))
    _, cfg, _, row0s = shapes[t % len(shapes)]
    return cams, cfg, row0s[(t // len(shapes)) % len(row0s)]


def pack_phase(dev, card: str, sharded: dict) -> tuple[str, list[dict]]:
    """Phase 32: the scene-packing kernels (``kernels/pack.py``) against the
    plain packing's ops run on the card, at each cell's shape and over
    PACK_TRIALS seeded scenes and batches, their times beside the plain
    ops', and their launches on the main paths that run them; ``sharded``
    holds the launches phase 31's sharded fit step counted at its capture.
    Returns (report, the kernels' record entries)."""
    from gpgpuraytrace_tpu_torch import default_scene, render
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack
    from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod
    from gpgpuraytrace_tpu_torch.ops.camera import Cameras
    from gpgpuraytrace_tpu_torch.ops.flythrough import FlyBatch, fly_frames
    from gpgpuraytrace_tpu_torch.utils import packing as pk

    t0 = time.perf_counter()
    shapes = pack_shapes()

    # The seeded trials: the rows bit for bit, every PACK_VJP_EVERY-th VJP.
    scene = default_scene(6, device=dev)
    for p in scene.parameters():
        p.requires_grad_(True)
    base = [x.detach().cpu() for x in kpack._leaves(scene, scene.camera)]
    gen = torch.Generator().manual_seed(PACK_SEED)
    differ, worst = 0, {"one": 0.0, "batch": 0.0}
    worst_abs, vjp_trials = 0.0, 0
    for t in range(PACK_TRIALS):
        cams, cfg, row0 = pack_trial(scene, base, shapes, t, gen)
        n = pack_rows_differ(scene, cams, cfg, row0)
        if n:
            fail(f"pack_kernel, trial {t} ({cfg.height}x{cfg.width} at row {row0}, cameras "
                 f"{tuple(cams.yaw.shape)}): {n} values differ from the plain ops on the card")
        differ += n
        if t % PACK_VJP_EVERY == 0:
            cams = Cameras(*(x.requires_grad_(True) for x in
                             (cams.position, cams.yaw, cams.pitch, cams.fov_y)))
            frames = cams.yaw.shape[0] if cams.yaw.dim() else 1
            g = torch.randn(frames, pk.AMPS + cfg.num_octaves, generator=gen).to(dev)
            rel, err = pack_vjp_error(scene, cams, cfg, row0, g)
            kind = "one" if frames == 1 else "batch"
            worst[kind] = max(worst[kind], rel)
            worst_abs = max(worst_abs, err)
            vjp_trials += 1
    if any(worst[k] > PACK_VJP_RTOL[k] for k in worst):
        fail(f"pack_vjp_kernel against autograd through the plain ops over {vjp_trials} "
             f"trials: relative errors {worst}, limits {PACK_VJP_RTOL}")

    # Each cell's shape: rows bit for bit, the VJP, the times as CUDA graphs.
    by_shape = []
    for name, cfg, cameras, row0s in shapes:
        scene = default_scene(6, device=dev)
        for p in scene.parameters():
            p.requires_grad_(True)
        cams = cameras(scene)
        cams = Cameras(*(x.detach().clone().requires_grad_(True) for x in
                         (cams.position, cams.yaw, cams.pitch, cams.fov_y)))
        leaves = kpack._leaves(scene, cams)
        frames, octaves, strides = kpack._layout(leaves, scene.noise.seed)
        n_row = pk.AMPS + octaves
        g = torch.randn(frames, n_row, generator=torch.Generator().manual_seed(PACK_SEED)).to(dev)
        errs = [pack_vjp_error(scene, cams, cfg, r, g) for r in row0s]
        n_diff = sum(pack_rows_differ(scene, cams, cfg, r) for r in row0s)
        rel, err = max(e[0] for e in errs), max(e[1] for e in errs)
        if n_diff or rel > PACK_VJP_RTOL["one" if frames == 1 else "batch"]:
            fail(f"{name}: the pack kernel's rows differ from the plain ops on the card in "
                 f"{n_diff} values, its VJP's relative error {rel:.3e}")
        row0 = row0s[len(row0s) // 2]
        pcfg = kpack.PackConfig(frames=frames, num_octaves=octaves)
        needs = [True] * len(leaves)

        def no_grad(fn):
            def run():
                with torch.no_grad():
                    return fn()
            return run

        times = {
            "pack_ms": graph_ms(no_grad(lambda: ktrace._packs(scene, cams, cfg, row0)), PACK_REPS),
            "vjp_ms": graph_ms(lambda: kpack.pack_vjp(leaves, strides, pcfg, g, needs),
                               PACK_REPS),
            "pack_and_vjp_ms": graph_ms(lambda: torch.autograd.grad(
                ktrace._packs(scene, cams, cfg, row0)[0], leaves, g), PACK_REPS),
            "plain_ms": graph_ms(no_grad(lambda: pack_plain(scene, cams, cfg, row0)), PACK_REPS),
            "plain_fine_ms": graph_ms(no_grad(lambda: pack_plain(scene, cams, cfg, row0)[0]),
                                      PACK_REPS),
            "plain_fine_and_pullback_ms": graph_ms(lambda: torch.autograd.grad(
                pack_plain(scene, cams, cfg, row0)[0], leaves, g), PACK_REPS),
        }
        # Least time: the bytes each kernel must move, the leaves read once.
        leaf_bytes = 4 * sum(x.numel() for x in leaves)
        row_bytes = 4 * frames * n_row
        by_shape.append({"shape": name, "size": f"{cfg.width}x{cfg.height}", "frames": frames,
                         "row0s": list(row0s), "differ": n_diff, "vjp_rel_err": rel,
                         "vjp_max_abs_err": err,
                         "pack_bound_ms": 1e3 * (leaf_bytes + 2 * row_bytes) / HBM_BYTES_PER_S,
                         "vjp_bound_ms": 1e3 * (2 * leaf_bytes + row_bytes) / HBM_BYTES_PER_S,
                         **times})

    # The launches on the main paths, each counter set to 0 just before.
    def counts():
        return kpack.pack_frames.launches, kpack.pack_vjp.launches

    paths = {"sharded": sharded}
    _, cfg, _, _ = shapes[0]
    target_scene = default_scene(6, device=dev)
    with torch.no_grad():
        target = render(target_scene, cfg)
    start = fitmod.perturb_scene(target_scene, torch.Generator().manual_seed(0), rel=0.15)
    reset_counts()
    fitmod.fit(start, cfg, target, steps=3 * FIT_K, learning_rate=5e-3, log_every=0,
               steps_per_call=FIT_K)
    torch.cuda.synchronize()
    paths["training"] = dict(zip(("pack", "pack_vjp"), counts()))
    # The eager chunk and the capture count a step each; the replays none.
    if counts() != (2 * FIT_K, 2 * FIT_K):
        fail(f"fit of {3 * FIT_K} steps in chunks of {FIT_K}: pack and VJP launches "
             f"{counts()}, expected {2 * FIT_K} each")
    _, cfg, _, _ = shapes[1]
    scene = default_scene(6, device=dev)
    program = FlyBatch(scene, cfg, PACK_FLY_FRAMES)
    reset_counts()
    for _ in fly_frames(scene, cfg, 3 * PACK_FLY_FRAMES, batch=PACK_FLY_FRAMES,
                        program=program):
        pass
    torch.cuda.synchronize()
    paths["flythrough"] = dict(zip(("pack", "pack_vjp"), counts()))
    if counts() != (program.counted, 0) or program.counted != 2:
        fail(f"fly_frames of 3 batches: pack and VJP launches {counts()}, expected "
             f"({program.counted}, 0) and 2 counted batches")
    if sharded != {"pack": 1, "pack_vjp": 1}:
        fail(f"the sharded fit step's capture counted {sharded}, expected one of each")

    head = by_shape[0]
    entries = []
    for kernel, key, bound, plain, replaces in (
            ("pack", "pack_ms", "pack_bound_ms", "plain_ms", "(the XLA fusion)"),
            ("pack_vjp", "vjp_ms", "vjp_bound_ms", None, "(JAX's autodiff of it)")):
        launches = {p: c[kernel] for p, c in paths.items()}
        plain_ms = (head["plain_ms"] if plain else
                    head["plain_fine_and_pullback_ms"] - head["plain_fine_ms"])
        entries.append({
            "name": kernel, "route": "cuda",
            "source": "gpgpuraytrace_tpu_torch/kernels/csrc/pack.cu",
            "replaces": f"gpgpuraytrace_tpu/utils/packing.py:47 {replaces}",
            "variants": [s[0] for s in shapes], "frames": head["frames"], "size": head["size"],
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": 0.0 if kernel == "pack" else max(worst_abs, *(
                s["vjp_max_abs_err"] for s in by_shape)),
            "ms": head[key], "plain_ms": plain_ms, "bound_ms": head[bound], "bound_by": "bytes",
            "library_ms": None, "trials": PACK_TRIALS if kernel == "pack" else vjp_trials,
            "by_shape": [{k: s[k] for k in ("shape", "size", "frames", key, bound)}
                         for s in by_shape]})
    shape_lines = "; ".join(
        f"{s['shape']} ({s['size']}, {s['frames']} frame(s), rows {s['row0s']}): "
        f"{s['differ']} values differ, VJP rel {s['vjp_rel_err']:.3e}; pack {s['pack_ms']:.5f} ms (plain "
        f"{s['plain_ms']:.5f}), VJP {s['vjp_ms']:.5f} (plain pullback "
        f"{s['plain_fine_and_pullback_ms'] - s['plain_fine_ms']:.5f}), pack + VJP through "
        f"autograd {s['pack_and_vjp_ms']:.5f} (plain {s['plain_fine_and_pullback_ms']:.5f}); "
        f"bounds {s['pack_bound_ms']:.2e} / {s['vjp_bound_ms']:.2e} ms (bytes)"
        for s in by_shape)
    line = (f"{PACK_TRIALS} seeded scenes and batches of 1 to {PACK_MAX_FRAMES} cameras: fine "
            f"and coarse rows bit for bit the plain ops on the card ({differ} values differ); "
            f"VJP against autograd through them over {vjp_trials} of the trials: relative "
            f"error one camera {worst['one']:.3e}, a batch {worst['batch']:.3e} (limits "
            f"{PACK_VJP_RTOL}), max abs {worst_abs:.3e} | {shape_lines} | CUDA graphs of "
            f"{PACK_REPS} calls | launches on the main paths {paths} | phase 32 took "
            f"{time.perf_counter() - t0:.1f} s {card}")
    return line, entries


def main() -> None:
    # --- 1. host -----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gpgpuraytrace_tpu_torch import RenderConfig, default_scene, render
    from gpgpuraytrace_tpu_torch.kernels import build
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_bwd
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod
    from gpgpuraytrace_tpu_torch.ops.fd_check import fd_check_scalar, scene_with

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = f"({smi})"
    phase(1, "host", f"{name}; nvidia-smi '{smi}'; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; nvcc {build.find_nvcc()}")

    # --- 2. build ----------------------------------------------------------
    sys.path.insert(0, str(REPO / "tests"))
    import noise_probe

    probe_dir = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    probe_proc = noise_probe.start(probe_dir.name)
    try:
        lib_path, log = build.build_library()
        probe_lib = noise_probe.load(noise_probe.finish(probe_proc))
    finally:
        if probe_proc.poll() is None:
            probe_proc.kill()
            probe_proc.wait()
    build_s = time.perf_counter() - t0
    for line in ptxas_lines(log):
        print(f"    ptxas: {line}")
    kernels = [ln for ln in ptxas_lines(log) if "registers" in ln]
    spills = [ln for ln in ptxas_lines(log) if re.search(r"\b[1-9]\d* bytes spill", ln)]
    if spills:
        fail("ptxas reports spills: " + "; ".join(spills))
    p2_regs = {k: ptxas_registers(log, k) for k in PHASE2_REGISTERS}
    if p2_regs != {k: [v] for k, v in PHASE2_REGISTERS.items()}:
        fail(f"compaction's phase 2 compiled to {p2_regs} registers (ptxas), expected "
             f"{PHASE2_REGISTERS}")
    phase(2, "build", f"{lib_path.relative_to(REPO)} in {build_s:.2f} s; {len(kernels)} "
          f"kernels, no spills (ptxas); phase 2 at "
          f"{' / '.join(str(v[0]) for v in p2_regs.values())} registers (recorded: "
          f"{' / '.join(map(str, PHASE2_REGISTERS.values()))})")

    # --- 3. kernel vs plain version at the main path's shapes --------------
    cfg = RenderConfig(num_octaves=6)  # 512x512, the default march
    err, line, kern_ms, plain_ms, times = forward_vs_plain(default_scene(6, device=dev), cfg, "")
    line += "; " + ragged_vs_plain(default_scene(6, device=dev), cfg, "")
    phase(3, "kernel vs plain", f"{line} {card}")

    # --- 4. the main path ----------------------------------------------------
    yaws = (0.0, 0.7, -1.3)
    serve_launches, means = serve_frames(default_scene(6, device=dev), cfg, yaws)
    phase(4, "serving path", f"{len(yaws)} frames 512x512, {serve_launches} kernel "
          f"launches; mean colour {means}")

    # --- 5. golden image through the kernel ---------------------------------
    cfg1 = RenderConfig(height=128, width=128, max_steps=96, num_octaves=1,
                        step_floor_t=0.0, step_relax=0.7, newton_iters=4, prime_ds=0)
    golden = torch.from_numpy(np.load(GOLDEN)).to(dev)
    before = trace_frames.launches.total()
    with torch.no_grad():
        img1 = render(default_scene(1, device=dev), cfg1)
    if trace_frames.launches.total() != before + 1:
        fail("golden render did not go through the kernel")
    g2 = check_close("golden", img1, golden, COLOR_ATOL, COLOR_FRAC)
    g4 = check_close("golden bulk", img1, golden, BULK_ATOL, BULK_FRAC)
    phase(5, "golden", f"config1_128: {100 * g2:.4f}% <= {COLOR_ATOL}, "
          f"{100 * g4:.4f}% <= {BULK_ATOL}, max abs err "
          f"{(img1 - golden).abs().max().item():.3e}")

    # --- 6. command line -----------------------------------------------------
    cli_lines = []
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        for extra in ([], ["--volumetric"]):
            proc = subprocess.run(
                [sys.executable, "-m", "gpgpuraytrace_tpu_torch.cli", "render",
                 "--size", "512", "--octaves", "6", *extra, "-o", png],
                cwd=REPO, capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                fail(f"cli render {extra} exited {proc.returncode}: {proc.stderr[-2000:]}")
            with open(png, "rb") as fh:
                if fh.read(8) != b"\x89PNG\r\n\x1a\n":
                    fail(f"cli render {extra} wrote no valid PNG")
            os.remove(png)
            cli_lines.append(proc.stdout.strip())
    phase(6, "cli", " | ".join(cli_lines))

    # --- 7. serving frame times -------------------------------------------------
    frame, n_frames, prof = frame_times(
        default_scene(6, device=dev), cfg, {"kernel": 5, "plain": 5})
    frame_kernel = frame["kernel"]
    lo, hi = RECORDED_FRAME_MS
    moved = ("within" if lo <= frame_kernel <= hi else
             "below" if frame_kernel < lo else "above")
    phase(7, "serving times", f"512x512 6 octaves, median of {n_frames['kernel']} "
          f"frames: kernel path {frame_kernel:.4f} ms, plain path {frame['plain']:.3f} ms "
          f"{card}; {moved} the recorded {lo}-{hi} ms (PERF.md runs 1-5)")
    print(f"    where a kernel-path frame goes: {prof}")

    # --- 8. backward kernel vs plain version at 512x512 ---------------------------
    bwd = backward_vs_plain(default_scene(6, device=dev), cfg)
    phase(8, "backward kernel vs plain", f"{bwd_report(bwd)} {card}")

    # --- 9. the training path --------------------------------------------------------
    target_scene = default_scene(6, device=dev)
    with torch.no_grad():
        target = render(target_scene, cfg)
    start = fitmod.perturb_scene(target_scene, torch.Generator().manual_seed(0), rel=0.15)
    steps = 5
    tr = train(start, target, cfg, fitmod.default_trainable, steps,
               {"kernel": 10, "kernel fwd + plain bwd": 3, "plain": 2})
    phase(9, "training path", f"fit 512x512 6 octaves, {train_report(tr, steps)} {card}")
    print(f"    where a kernel-path training step goes: {tr['prof']}")

    # --- 10. AD vs finite differences through the kernel path ---------------------
    # Gated on tests/test_grad.py's scene (2 octaves) at 512x512, primed. The
    # 6-octave scene is measured and reported only: the JAX reference's own
    # fd_check shows the same gap there (ROADMAP.md section C).
    reset_counts()
    fd_lines = []
    for octaves, gated in ((2, True), (6, False)):
        fd_cfg = RenderConfig(num_octaves=octaves)
        scene = default_scene(octaves, device=dev)
        bright = copy.deepcopy(scene)
        with torch.no_grad():
            bright.noise.amplitudes.mul_(1.1)
            target = render(bright, fd_cfg)
        for leaf, index, eps, rtol, t_cap in FD_CHECKS:
            base = dict(scene.named_parameters())[leaf].detach()
            theta0 = base if index is None else base[index]
            ad, fd = fd_check_scalar(lambda th: scene_with(scene, leaf, th, index),
                                     theta0, fd_cfg, target, eps=eps, t_cap=t_cap)
            label = f"{octaves} oct {leaf}" + ("" if index is None else f"[{index}]")
            rel = abs(ad - fd) / max(abs(fd), 1e-5)
            if gated and not (np.isfinite(ad) and np.isfinite(fd) and rel <= rtol):
                fail(f"AD vs FD {label}: ad={ad} fd={fd} (rtol {rtol})")
            fd_lines.append(f"{label} ad {ad:.6e} fd {fd:.6e} rel {rel:.2e}"
                            + ("" if gated else " (not gated)"))
    if not (trace_frames.launches.total() and trace_frames_bwd.launches.total()):
        fail("the FD checks did not run through both kernels")
    phase(10, "AD vs FD", "; ".join(fd_lines)
          + f" ({trace_frames.launches.total()} forward, "
            f"{trace_frames_bwd.launches.total()} backward launches)")

    # --- 11. volumetric: forward kernel vs plain version ------------------------------
    vcfg = RenderConfig(num_octaves=6, volumetric=True)  # relax 0.9, prime 8, 128 steps
    vcfg_line = (f"512x512 6 octaves, warp_octaves {vcfg.warp_octaves}, relax "
                 f"{vcfg.step_relax}, prime_ds {vcfg.prime_ds}")
    verr, line, vkern_ms, vplain_ms, vtimes = forward_vs_plain(
        default_scene(6, volumetric=True, device=dev), vcfg, "volumetric ")
    line += "; " + ragged_vs_plain(default_scene(6, volumetric=True, device=dev), vcfg,
                                   "volumetric ")
    phase(11, "volumetric kernel vs plain", f"{vcfg_line}: {line} {card}")

    # --- 12. volumetric serving --------------------------------------------------------
    vserve_launches, means = serve_frames(default_scene(6, volumetric=True, device=dev),
                                          vcfg, yaws)
    vframe, n_frames, prof = frame_times(
        default_scene(6, volumetric=True, device=dev), vcfg, {"kernel": 5, "plain": 2})
    phase(12, "volumetric serving", f"{vcfg_line}: {len(yaws)} frames, {vserve_launches} "
          f"kernel launches, mean colour {means}; median frame time (CUDA events): "
          f"kernel path {vframe['kernel']:.4f} ms ({n_frames['kernel']} frames), plain "
          f"path {vframe['plain']:.3f} ms ({n_frames['plain']} frames) {card}")
    print(f"    where a volumetric kernel-path frame goes: {prof}")

    # --- 13. volumetric: backward kernel vs plain version -------------------------------
    vbwd = backward_vs_plain(default_scene(6, volumetric=True, device=dev), vcfg)
    warp_bars = vbwd["pbar"][0, WARP_ENTRIES]
    if not (warp_bars != 0).all():
        fail(f"volumetric backward: warp entries {warp_bars.tolist()} must be non-zero")
    phase(13, "volumetric backward kernel vs plain", f"{bwd_report(vbwd)}; warp amplitude "
          f"and frequency entries {warp_bars.tolist()} (plain "
          f"{vbwd['ref'][0, WARP_ENTRIES].tolist()}) {card}")
    bwd_regs = ptxas_registers(log, DEFAULT_BWD_KERNEL)
    if bwd_regs != [DEFAULT_BWD_REGISTERS]:
        fail(f"the default backward instantiation compiled to {bwd_regs} registers "
             f"(ptxas), expected [{DEFAULT_BWD_REGISTERS}]")
    bwd_graph = (bwd["graph_ms"], vbwd["graph_ms"])
    moved = [100 * (ms / before - 1) for ms, before in zip(bwd_graph, DEFAULT_BWD_MS)]
    if max(moved) > 100 * DEFAULT_BWD_SLACK:
        fail(f"the default backward took {bwd_graph[0]:.4f} / {bwd_graph[1]:.4f} ms, "
             f"{moved[0]:+.2f}% / {moved[1]:+.2f}% against {DEFAULT_BWD_MS[0]} / "
             f"{DEFAULT_BWD_MS[1]} ms (at most +{100 * DEFAULT_BWD_SLACK:.0f}%)")
    phase(13, "default backward", f"{DEFAULT_BWD_KERNEL}: {bwd_regs[0]} registers (recorded: "
          f"{DEFAULT_BWD_REGISTERS}), no spills (phase 2); the wrapper {bwd_graph[0]:.4f} / "
          f"{bwd_graph[1]:.4f} ms as a CUDA graph (both stages and the fresh scratch's "
          f"zeroing; phases 8, 13) against {DEFAULT_BWD_MS[0]} / "
          f"{DEFAULT_BWD_MS[1]} ms recorded ({moved[0]:+.2f}% / {moved[1]:+.2f}%, at most "
          f"+{100 * DEFAULT_BWD_SLACK:.0f}%) {card}")

    # --- 14. volumetric training ----------------------------------------------------------
    target_scene = default_scene(6, volumetric=True, device=dev)
    with torch.no_grad():
        target = render(target_scene, vcfg)
    start = fitmod.perturb_scene(target_scene, torch.Generator().manual_seed(0), rel=0.15)
    with torch.no_grad():
        start.noise.warp_amplitude.mul_(1.1)  # so the warp has a value to recover

    def vtrainable(name: str) -> bool:
        return fitmod.default_trainable(name) or name == "noise.warp_amplitude"

    vtr = train(start, target, vcfg, vtrainable, steps,
                {"kernel": 10, "kernel fwd + plain bwd": 3, "plain": 1})
    if "noise.warp_amplitude" not in vtr["leaves"]:
        fail("volumetric training: the warp amplitude got no gradient")
    phase(14, "volumetric training", f"fit {vcfg_line}, warp amplitude trainable, "
          f"{train_report(vtr, steps)} {card}")
    print(f"    where a volumetric kernel-path training step goes: {vtr['prof']}")
    # AD vs FD of the warp amplitude through the kernel path, reported only:
    # the warp's net pixel-loss gradient is small against FD noise
    # (tests/test_volumetric.py checks it per pixel, as the CPU suite does).
    fd_cfg = RenderConfig(num_octaves=2, volumetric=True)
    scene = default_scene(2, volumetric=True, device=dev)
    warped = copy.deepcopy(scene)
    with torch.no_grad():
        warped.noise.warp_amplitude.mul_(1.1)
        target = render(warped, fd_cfg)
    ad, fd = fd_check_scalar(
        lambda th: scene_with(scene, "noise.warp_amplitude", th),
        scene.noise.warp_amplitude.detach(), fd_cfg, target, eps=3e-3, t_cap=0.03)
    print(f"    AD vs FD, 2 oct volumetric noise.warp_amplitude at 512x512 (not gated): "
          f"ad {ad:.6e} fd {fd:.6e} rel {abs(ad - fd) / max(abs(fd), 1e-5):.2e}")

    # --- 15-19. the variants of the forward kernel and the observability path ----
    scenes = {"": (default_scene(6, device=dev), cfg),
              "volumetric ": (default_scene(6, volumetric=True, device=dev), vcfg)}
    results = {}
    for n, label, run in ((15, "counter", counter_phase), (16, "fixed", fixed_phase),
                          (17, "lod", lod_phase)):
        for tag, (scene, c) in scenes.items():
            results[label, tag] = run(scene, c, tag)
            phase(n, label, f"{results[label, tag]['line']} {card}")
    for tag, (scene, c) in scenes.items():
        counter = results["counter", tag]
        results["bf16", tag] = bf16_phase(scene, c, tag, counter["lanes"], counter["hits"],
                                          probe_lib)
        phase(18, "bf16", f"{results['bf16', tag]['line']} {card}")
        for mode in ("fixed", "lod"):
            results[f"{mode}+bf16", tag] = bf16_mode_phase(scene, c, tag, mode)
            phase(18, f"{mode}+bf16", f"{results[f'{mode}+bf16', tag]['line']} {card}")
    for tag, (scene, c) in scenes.items():
        phase(19, "profiling", profiling_phase(scene, c, tag))

    # --- 20-22. compaction, the flythrough, the bf16 backward --------------------
    regs = ptxas_registers(log, DEFAULT_KERNEL)
    if regs != [DEFAULT_REGISTERS]:
        fail(f"the default forward instantiation compiled to {regs} registers "
             f"(ptxas), expected [{DEFAULT_REGISTERS}]")
    fine = (times["fine_graph"], vtimes["fine_graph"])
    moved = [100 * (ms / before - 1) for ms, before in zip(fine, DEFAULT_FINE_MS)]
    if max(moved) > 100 * DEFAULT_FINE_SLACK:
        fail(f"the default fine pass took {fine[0]:.4f} / {fine[1]:.4f} ms, "
             f"{moved[0]:+.2f}% / {moved[1]:+.2f}% against {DEFAULT_FINE_MS[0]} / "
             f"{DEFAULT_FINE_MS[1]} ms (at most +{100 * DEFAULT_FINE_SLACK:.0f}%)")
    default_line = (f"the default instantiation ({DEFAULT_KERNEL}): "
                    f"{regs[0]} registers (recorded: {DEFAULT_REGISTERS}); fine pass "
                    f"{fine[0]:.4f} / {fine[1]:.4f} ms as a CUDA graph (phases 3, 11) against "
                    f"{DEFAULT_FINE_MS[0]} / {DEFAULT_FINE_MS[1]} ms recorded ({moved[0]:+.2f}% / "
                    f"{moved[1]:+.2f}%, at most +{100 * DEFAULT_FINE_SLACK:.0f}%)")
    phase(20, "compact", f"{default_line} {card}")
    for tag, (scene, c) in scenes.items():
        results["compact", tag] = compact_phase(scene, c, tag)
        phase(20, "compact", f"{results['compact', tag]['line']} {card}")
    p2_graph = tuple(results["compact", tag]["phase2"]["graph_ms"] for tag in scenes)
    p2_all = " / ".join(
        f"{min(r['graph_all']):.5f}-{max(r['graph_all']):.5f}, pixel order "
        f"{r['graph_pixel_order_ms']:.5f}"
        for r in (results["compact", tag]["phase2"] for tag in scenes))
    moved = [100 * (ms / before - 1) for ms, before in zip(p2_graph, PHASE2_MS)]
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    if max(moved) > 100 * PHASE2_SLACK:
        fail(f"compaction's phase 2 took {p2_graph[0]:.5f} / {p2_graph[1]:.5f} ms (medians "
             f"over {PHASE2_LISTINGS} lists: {p2_all}), {moved[0]:+.2f}% / {moved[1]:+.2f}% "
             f"against {PHASE2_MS[0]} / "
             f"{PHASE2_MS[1]} ms (at most +{100 * PHASE2_SLACK:.0f}%; SM clock, temperature, "
             f"power after: {clocks})")
    phase(20, "compact", f"phase 2 (ray groups, float32) {p2_graph[0]:.5f} / {p2_graph[1]:.5f} "
          f"ms as a CUDA graph (medians over {PHASE2_LISTINGS} lists: {p2_all}) against "
          f"{PHASE2_MS[0]} / {PHASE2_MS[1]} ms recorded ({moved[0]:+.2f}% / "
          f"{moved[1]:+.2f}%, at most +{100 * PHASE2_SLACK:.0f}%; SM clock, temperature, power after: {clocks}) {card}")
    fly_line, fly_counts = fly_phase(cfg, dev)
    fly_counts = collections.Counter(fly_counts)
    phase(21, "flythrough", f"{fly_line} {card}")
    for tag, (scene, c) in scenes.items():
        results["bwd+bf16", tag] = bf16_bwd_phase(scene, c, tag)
        phase(22, "bf16 backward", f"{results['bwd+bf16', tag]['line']} {card}")

    # --- 23. bit for bit: every output against its recorded digest ------------
    got = output_digests(PackageKernels, dev)
    moved = sorted(k for k in EXPECTED_DIGESTS if got.get(k) != EXPECTED_DIGESTS[k])
    if moved or set(got) != set(EXPECTED_DIGESTS):
        fail(f"outputs differ from their recorded digests: {moved}")
    phase(23, "digests", f"{len(got)} outputs (every forward instantiation on both terrains, "
          f"coarse and fine pass, compaction's two phases, the backward's two "
          f"instantiations, the ragged frames) equal bit for bit to their SHA-256 digests, "
          f"recorded before the forward's warp tiles and the backward's warp groups")

    # --- 24. march quality through the kernel --------------------------------------
    phase(24, "march quality", quality_phase(dev))

    # --- 25-27. the fit loop, the native writer, row bands -------------------------
    for tag, vol in (("", False), ("volumetric ", True)):
        c = vcfg if vol else cfg
        target_scene = default_scene(6, volumetric=vol, device=dev)
        with torch.no_grad():
            target = render(target_scene, c)
        start = fitmod.perturb_scene(target_scene, torch.Generator().manual_seed(0), rel=0.15)
        if vol:
            with torch.no_grad():
                start.noise.warp_amplitude.mul_(1.1)
        results["fit", tag] = fit_loop_phase(
            start, target, c, vtrainable if vol else fitmod.default_trainable, tag, card)
        phase(25, "fit loop", results["fit", tag]["line"])
        for k, prof in results["fit", tag]["busy"].items():
            print(f"    {tag}where a chunk of {k} step(s) goes: {prof}")
    phase(25, "fit loop", cli_fit_phase(results["fit", ""]["losses"]))
    phase(26, "native writer", f"{writer_phase(cfg, dev)} {card}")
    for tag, vol in (("", False), ("volumetric ", True)):
        phase(27, "row bands", bands_phase(default_scene(6, volumetric=vol, device=dev),
                                           vcfg if vol else cfg, tag, card))

    # --- 28. batches: the forward kernels' frame axis ------------------------------
    t28 = time.perf_counter()
    batch = {}
    for tag, (scene, c) in scenes.items():
        phase(28, "batch digests", batch_digests(scene, c, tag))
    for tag, (scene, c) in scenes.items():
        batch[tag] = batch_vs_plain(scene, c, tag)
        phase(28, "batch vs plain", f"{batch[tag]['line']} {card}")
    for tag, (scene, c) in scenes.items():
        line, counts = batch_fly(scene, c, tag)
        fly_counts.update(counts)
        phase(28, "batch fly", line)
    for tag, (scene, c) in scenes.items():
        phase(28, "batch 1080p", f"{batch_hd(scene, c, tag)} {card}")
    phase(28, "batch host", f"{launcher_host_us(default_scene(6, device=dev), cfg)} {card}")
    phase(28, "batch fly fps", f"{fly_fps(default_scene(6, device=dev), cfg, '')} {card}")
    phase(28, "batch", f"phase 28 took {time.perf_counter() - t28:.1f} s")

    # --- 29. the benchmark -------------------------------------------------------
    bench_line, bench_counts = bench_phase(tr["fwd"] / steps, tr["bwd"] / steps, card)
    phase(29, "bench", bench_line)

    # --- 30. the flythrough batch as one CUDA graph ----------------------------
    fly_graph_line, quant_entry, fly_graph_counts = fly_graph_phase(dev, card)
    fly_counts.update(fly_graph_counts)
    phase(30, "fly graph", fly_graph_line)

    # --- 31. BASELINE.json config 5: the 4K row-band frame and step ------------
    config5_line, config5_counts = config5_phase(dev, card)
    phase(31, "config 5", config5_line)

    # --- 32. the scene-packing kernels -------------------------------------------
    pack_line, pack_entries = pack_phase(dev, card, config5_counts["pack"])
    phase(32, "scene packing", pack_line)

    # Bounds of phases 3, 8, 11 and 13 from phase 15's useful steps and hits.
    n_pix = cfg.height * cfg.width
    fwd_b = {tag: fwd_bound(c, results["counter", tag]["lanes"].sum().item(),
                            results["counter", tag]["hits"], n_pix)
             for tag, (_, c) in scenes.items()}

    def variant_entry(label: str, name: str, source: str = FWD_SOURCE,
                      kernel: str = "trace_fwd", part: str | None = None) -> dict:
        h, v = results[label, ""], results[label, "volumetric "]
        if part is not None:
            h, v = h[part], v[part]
        # Compaction's phases: device time as a CUDA graph, the profiler's
        # kernel time and the wrapper's host time too.
        extra = ("graph_ms", "profiler_us", "host_us")
        return {
            "name": f"{kernel}[{name}]", "route": "cuda", "source": source,
            "replaces": REPLACES[name], "variants": ["heightfield", "volumetric"],
            "launches": h["launches"] + v["launches"], "max_abs_err": max(h["err"], v["err"]),
            "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": None,
            **{k: h[k] for k in extra if k in h},
            "volumetric": {"max_abs_err": v["err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
                           "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
                           **{k: v[k] for k in extra if k in v}},
        }

    def batch_entry(name: str, part: str, source: str = FWD_SOURCE,
                    kernel: str = "trace_fwd") -> dict:
        """A batched launch (phase 28, a batch of 2 frames at 512x512; its
        launches from the flythrough runs of phases 21, 28 and 30)."""
        h, v = batch[""][part], batch["volumetric "][part]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by")
        return {"name": f"{kernel}[{name}]", "route": "cuda", "source": source,
                "replaces": REPLACES[name], "variants": ["heightfield", "volumetric"],
                "frames": 2, "launches": fly_counts[name],
                "max_abs_err": max(h["err"], v["err"]), **{k: h[k] for k in keys},
                "library_ms": None,
                "volumetric": {"max_abs_err": v["err"], **{k: v[k] for k in keys}}}

    paths = {"fwd": {"serving": serve_launches, "training": tr["fwd"],
                     "volumetric serving": vserve_launches,
                     "volumetric training": vtr["fwd"],
                     "bench": bench_counts["forward"],
                     "config 5": config5_counts["forward"]},
             "bwd": {"serving": 0, "training": tr["bwd"], "volumetric serving": 0,
                     "volumetric training": vtr["bwd"],
                     "bench": bench_counts["backward"],
                     "config 5": config5_counts["backward"]}}
    record = {"kernels": [
        {
            "name": "trace_fwd",
            "route": "cuda",
            "source": "gpgpuraytrace_tpu_torch/kernels/csrc/trace_fwd.cu",
            "replaces": "gpgpuraytrace_tpu/kernels/trace.py:510",
            "variants": ["heightfield", "volumetric"],
            "launches": sum(paths["fwd"].values()),
            "launches_by_path": paths["fwd"],
            "max_abs_err": max(err, verr),
            "ms": kern_ms,
            "plain_ms": plain_ms,
            "bound_ms": fwd_b[""][0],
            "bound_by": fwd_b[""][1],
            "library_ms": None,
            # The fine pass's device time (a CUDA graph of 50 launches); the
            # coarse prime pass alone (66x64) the same way and back to back;
            # and the primed frame's trace, coarse pass, prime map and fine
            # pass (phase 20).
            "graph_ms": times["fine_graph"],
            "coarse_ms": times["coarse_graph"],
            "coarse_back_to_back_ms": times["coarse"],
            "coarse_and_fine_ms": results["compact", ""]["coarse_and_fine_ms"],
            "volumetric": {"max_abs_err": verr, "ms": vkern_ms, "plain_ms": vplain_ms,
                           "bound_ms": fwd_b["volumetric "][0],
                           "bound_by": fwd_b["volumetric "][1],
                           "graph_ms": vtimes["fine_graph"],
                           "coarse_ms": vtimes["coarse_graph"],
                           "coarse_back_to_back_ms": vtimes["coarse"],
                           "coarse_and_fine_ms":
                               results["compact", "volumetric "]["coarse_and_fine_ms"]},
        },
        {
            "name": "trace_bwd",
            "route": "cuda",
            "source": "gpgpuraytrace_tpu_torch/kernels/csrc/trace_bwd.cu",
            "replaces": "gpgpuraytrace_tpu/kernels/trace.py:716",
            "variants": ["heightfield", "volumetric"],
            "launches": sum(paths["bwd"].values()),
            "launches_by_path": paths["bwd"],
            "max_abs_err": max(bwd["err"], vbwd["err"]),
            "ms": bwd["ms"],
            "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd["bound_ms"],
            "bound_by": bwd["bound_by"],
            "library_ms": None,
            # The wrapper's device time under capture (a CUDA graph of 50
            # calls: both stages and the zeroing of the fresh scratch's
            # counter) and its host time per call.
            "graph_ms": bwd["graph_ms"],
            "host_us": bwd["host_us"],
            "volumetric": {"max_abs_err": vbwd["err"], "ms": vbwd["ms"],
                           "plain_ms": vbwd["plain_ms"], "bound_ms": vbwd["bound_ms"],
                           "bound_by": vbwd["bound_by"], "graph_ms": vbwd["graph_ms"],
                           "host_us": vbwd["host_us"]},
        },
        variant_entry("counter", "chunked+debug_steps"),
        variant_entry("fixed", "fixed"),
        variant_entry("lod", "lod"),
        variant_entry("bf16", "chunked+bf16"),
        variant_entry("fixed+bf16", "fixed+bf16"),
        variant_entry("lod+bf16", "lod+bf16"),
        variant_entry("compact", "compact:phase1", part="phase1"),
        variant_entry("compact", "compact:phase2", part="phase2",
                      source="gpgpuraytrace_tpu_torch/kernels/csrc/trace_compact.cu",
                      kernel="trace_compact"),
        variant_entry("bwd+bf16", "bwd+bf16", kernel="trace_bwd",
                      source="gpgpuraytrace_tpu_torch/kernels/csrc/trace_bwd.cu"),
        batch_entry("chunked+frames", "fine"),
        batch_entry("compact+frames:phase1", "phase1"),
        batch_entry("compact+frames:phase2", "phase2",
                    source="gpgpuraytrace_tpu_torch/kernels/csrc/trace_compact.cu",
                    kernel="trace_compact"),
        quant_entry,
        *pack_entries,
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
