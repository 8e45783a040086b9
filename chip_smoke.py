"""GPU smoke run of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --launch-probe [--src OTHER_CHECKOUT/src]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
per source, all nine started together): K1 ``fused_sweep.cu``, K2
``grid_decode.cu``, K3a/K3b ``stream_reduce.cu``, K4
``category_reduce.cu``, the functional simulator's K5 ``binning.cu``,
K6 ``stencil_conv.cu``, K7 ``frame_event.cu`` and K8 ``matmul.cu``, and
K9 ``flash_attention.cu``.  Holds each kernel against its plain-torch
twin on the card at the main paths' shapes (and ragged ones; K5-K9 also
in f16 and bf16; K1 on every cluster size of its plans, at the main-path
chunk and on a bank past four slots, every candidate position equal to
the twin's, and with the metric NaN at most or all points of a chunk,
NaN candidates bit-equal; K2 on its vec4 and scalar routes, int32 and int64 (past
2^31 and 2^32), across variants and past the end, on 1 and 16 axes;
K3a on every cluster size, on its vec4 and scalar routes, also with NaN
and +-inf; K3b on every cluster size, route and variant tile, on K2's
variant row, interleaved and single ids, past one tile, on an offset
view and with NaN and +-inf, a repeated launch bit-equal;
K5 and K6 on each of their routes, with offset views and
outputs either side of their tiles; K7 on vec4, vec8 and scalar, with
offset views; K8 on each of its three routes, the
wgmma route also
with positive operands at K = 16384, where its own f32 sums are held to
the rule, and offset views on the tile route; K9 also with mixed operand
dtypes and head dims past 128 on its SIMT route), then drives every
engine of ``explore()``, the functional simulator and the attention path
at full width, each with the launch counters zeroed just before it and
read just after:

* fused (the main path) — the ``mega_sweep`` space (all 5 Ed-Gaze + 3
  Rhythmic variants, 1.26e7 design points, ``chunk_size=2**18``,
  ``k=3``) through K1, checked against the twin lane, the int64 index
  path and the scalar ``estimate_energy`` oracle; ``progress`` calls and
  the host syncs of ``pipeline_depth=1`` counted exactly;
* staged — the same space through K2 -> banked evaluator -> K3a, equal
  to the fused result;
* campaign — the same space as a checkpointed campaign of 12 shards
  (``repro_torch.campaign``): serial through K1 (equal to fused, one
  stream preparation), ``workers=2`` with a worker killed and the
  campaign killed after 4 shards, then resumed (only the missing ranges
  dispatched; equal to the serial campaign bit for bit; one preparation
  a worker), and staged shards (equal to fused); the ``campaign_path``
  line;
* serve — ``repro_torch.serve.ExploreService`` at the reference's
  serving width (``serve_bench``, ``benchmarks/run.py:797-915``): 8
  tenants of 230,400 Ed-Gaze points (distinct ``vdd_scale`` values) run
  solo, then as two waves of 8 client threads through
  ``explore(service=)``: one coalesce group on ONE step build, each
  tenant's top-k values and indices bit-equal to its solo call, the
  second wave replayed from the cache with no dispatch and no launch;
  then one streaming tenant at mega_sweep's width (partials through the
  ``on_partial`` hook, the final bit-equal to the straight fused run)
  and a staged request (K2, K3a; equal to fused); the ``serve_path``
  line (``serve_speedup`` printed beside the reference's 1.2 floor, not
  gated);
* chunked (through ``auto``) — Ed-Gaze over the mega grids without
  ``active_fraction_scale`` (1.57e6 points) through K4, equal to fused;
* monolithic (through ``auto``) — the ``design_sweep`` grids of
  ``benchmarks/run.py`` (21,504 points) through K4, equal to fused, the
  winner against the scalar oracle;
* mesh — the batch split (``repro_torch.launch``) at full width:
  mega_sweep on ``make_batch_mesh()`` (every visible GPU) and on
  ``BatchMesh([cuda:0] * 4)`` (four shards on one card), fused (K1 once
  a shard: 192 launches on the 4-shard mesh) and staged (K2, K3a once a
  shard), the chunked lane through ``evaluate_batch_sharded`` (K4 once
  a shard), a 12-shard serial campaign and one serve wave of the 8
  tenants on the 4-shard mesh, each held to the one-device result of
  the same run (top-k bit-equal, counts exact, means rel 1e-5), with
  eval_s, wall s and the fused sweep's host syncs; the ``mesh_path``
  line;
* functional — 30 frames each, at the use cases' sensor sizes: Ed-Gaze
  (400 x 640: kT/C noise at 10 fF, ``edgaze_frontend`` through K5 and
  K7, then ``simple_dnn`` through K8 at the paper's S3 width,
  ``[1, 64000] @ [64000, 900] @ [900, 2]``), ``fig5_pipeline`` at the
  Rhythmic sensor's 720 x 1280 (K5, K6 twice) and
  ``rhythmic_pixel_frontend`` at 720 x 1280 (K6 twice); the first 2
  frames of each against the same pipeline run by the port on the CPU;
* attention — ``ops.flash_attention`` (K9) at the widths of two
  configured models, bf16: qwen2-7b's causal attention at 4096 tokens
  (28 heads over 4 kv heads, D = 128) and whisper-medium's encoder
  self-attention over its 1500 frames (16 heads, D = 64), each one
  launch of the tensor-core (wgmma) route, within one bf16 rounding of
  the twin, timed beside the twin and ``scaled_dot_product_attention``
  (whose distance from the twin is reported: it rounds P to bf16 once);
  then K9's SIMT route (f32) at the same widths;
* LM serving (P12a, ``repro_torch.models``; plain torch ops, no kernel of
  the port, every launch counter checked still 0) — qwen2-7b at its
  published width and depth (bf16, 7.07e9 parameters, 4 prompts of 1,024
  tokens, ``max_seq`` 1,056, 32 greedy tokens), the nine other
  architectures at full width with depth cut to 2 layers (B = 2, 512
  tokens, 8 greedy tokens; mixtral B = 1 and 4,608 tokens past its
  4,096 window; llava on embeddings, whisper on 1,500 audio frames; MoE
  at capacity factor 8.0): prefill and a decode step under the sync
  debug mode "error", the decode step against ``forward`` over one
  more position (``2e-2 max(scale, 1)``), prefill ms, tokens/s and
  decode ms a token, qwen2-7b's beside its bounds with a profiled decode
  of 4 tokens (busy share, kernels a token); then the ten reduced
  configs and qwen2-7b at full width with 2 layers, f32, on the card
  against the port on the CPU (1e-4 max|cpu|, greedy tokens equal); the
  ``lm_path`` line;
* LM training (P12b, ``repro_torch.train``; autograd over the same
  plain torch ops, no kernel of the port, every launch counter checked
  still 0) — olmo-1b at its published width and depth (bf16 parameters,
  f32 moments, remat ``full``, 8 sequences of 1,024 tokens of the
  structured stream, ``build_train_step(warmup_steps=2,
  total_steps=8)``): a warm-up step and 5 timed steps each under the
  sync debug mode "error", loss and grad_norm finite, the last loss below
  the first, step ms, tokens/s and peak memory beside the 6NT (and 8NT,
  with the recomputed forward) bound, the gradients and AdamW timed
  apart, a profiled step (busy share, kernels a step, device ms by kernel
  class); the loop drill at olmo-1b's width with 2 layers (``TrainLoop``
  for 6 steps with checkpoints every 2, keep 1, under
  ``build/train_ckpt_drill/``, removed after; the restored state bit-equal
  to the saved; a second loop resumed from step 6 to 8 within 1e-2 of an
  uninterrupted run; a synchronous and an async save timed); the nine
  other architectures at full width with 2 layers, one bf16 step each
  under the sync debug mode "error" (every leaf took a gradient, every
  leaf but those still all ones moved); the ten reduced configs and
  olmo-1b at full width with 2 layers, f32, one step on the card against
  the CPU (loss rel 1e-5, grad_norm rel 1e-4, moments 1e-4 max|leaf|,
  parameters within ``2 lr + 1e-6 |p|``, ``1e-3 lr`` where the gradient
  is not near zero); the ``train_path`` line;
* LM mesh (P12c-1 and P12c-2, ``repro_torch.distributed``; DTensor over
  the same plain ops, no kernel of the port, every launch counter
  checked still 0), in ranks spawned for the phase: a one-rank NCCL
  mesh (``make_host_mesh()``, 1 x 1) on GPU 0, olmo-1b at its published
  width and depth (bf16, 8 x 1,024 tokens) under ``tp`` and ``fsdp``:
  parameters and moments as ``param_shardings`` places them, one step
  under the sync debug mode "error" held to the same step without the
  mesh from the same parameters (bit-equal, or the loss within rel
  1e-6 and the sampled parameters within the card bound above), both
  steps timed in turns (CUDA-event ms and host ms to return), peak
  memory, a profiled mesh step; ``restore_resharded`` of a checkpoint
  of the parameters under both profiles, bit-equal;
  ``cross_pod_grad_reduce`` of the step's gradient tree on a 1 x 1 x 1
  ``pod`` mesh (each leaf within one LSB, the errors the residual); the
  prefill of 8 x 1,024 tokens on the mesh against the one without;
  ``python -m repro_torch.launch.train --devices 1`` (reduced olmo, 3
  steps) under both profiles, and ``--production-mesh`` raising the
  reference's ``RuntimeError``; with several GPUs visible, the step on
  ``(count / 2, 2)`` NCCL ranks, the loss within 2e-2 of one device's;
  the ``lm_mesh_path`` line;
* the dry run and the energy model (P12c-3, ``repro_torch.launch.
  dryrun``, ``repro_torch.energy``; no kernel of the port, the launch
  counters of its processes checked still 0), once the mesh phase has
  ended, in fresh processes started together, one for each cell and
  one for the estimates (their fake process groups of 512 ranks never
  meet the LM mesh's NCCL group; they trace on the host):
  olmo-1b's four cells, mixtral-8x7b's ``long_500k`` and zamba2-1.2b's
  ``train_4k`` on the 16 x 16 mesh with costs, olmo-1b's ``decode_32k``
  on 2 x 16 x 16, each ``ok`` or the reference's ``skipped``; then the
  estimator against the card on a 1 x 1 mesh: the training phase's
  olmo-1b step (its FLOPs within [0.85, 1.2] x 8NT, its predicted peak
  within [0.5, 2] x the measured ``max_memory_allocated``, its H100
  bound beside the measured step ms), qwen2-7b's decode at the serving
  phase's B = 4 (printed), and NVML's joules a step around the timed
  olmo-1b steps beside the energy model's (printed); the
  ``dryrun_path`` line;
* the examples (P15, ``repro_torch.examples``), once the dry run has
  ended, in this process: ``quickstart`` (K5 once, K6 twice; its lines
  equal the CPU's), ``explore_design_space`` with ``MEGA_SWEEP=1`` (the
  Sec. 6 studies and the hook axes on K4, the registry demo, the
  mega-sweep of 43,545,600 points at chunk 2^17, the campaigns and the
  two-tenant service on K1; its tables equal the CPU's, the mega-sweep's
  top-k and per-variant summaries bit-equal to the staged engine on the
  same space) and ``train_lm`` at its defaults (``LEARNED``, no
  port kernel); the ``examples_path`` line, its launches added to the
  ``kernels`` line;
* the static checks (P13): ``python -m repro_torch.analysis`` over the
  port's default scope exits 0 with 0 findings; the ``static_checks``
  line.

It times every kernel (K1 at ``kk`` 3 and 16 beside its bound and the
bound of the work its hoisting leaves, with a probe of K1's and K3a's
cluster sizes, the ``fused_probe`` line, K3b's beside them; K3b on three
id layouts, at 2^24 points, at its launch floor and beside a plain read
of its bytes, the ``block_stats_banked_timing`` line; K8 also at 4096^3
bf16, with a
probe of its tile widths, tensor-map encodes and enqueue times; K6 with a
probe of its tile heights; each library call's device time beside its
CUDA-event time; K2 on int64 too, beside torch's fill of the same
bytes; K2's and K7's launch floors, the device ms of a launch of one
thread, beside an empty kernel's, the ``launch_floor_device_ms`` line)
and the host time of the launch path every wrapper shares (the
``launch_probe`` line: each step, and each of K1-K9's wrappers at its
headline shape), prints its findings as JSON lines, and ends with the
``kernels`` line and the run's verdict::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Every check raises on failure, so the script exits nonzero and prints no
verdict; it also exits nonzero without a CUDA device or without the
repository's ``src/`` beside it.  ``--launch-probe`` is a tool apart,
never part of the smoke run: it prints only the launch-path probe's line
for what every checkout of the port offers (torch's steps, the operand
check, the K1-K9 wrappers' host us and event ms, and the device ms of
K1, K3a, K3b (2^18 points on three id layouts, 2^24 points and one block
of 512), K2 (int32, int64 and at a chunk of 4) and K7 (f32, bf16 and a
frame of one 16-byte vector)), on this checkout or on
the one whose ``src/`` is given with ``--src``, to hold two trees side by
side, and the ``sweep_probe`` line: that tree's fused and staged eval_s
on mega_sweep.  It imports nothing of ``jax`` or of the
JAX package ``repro``.  A ``torch.profiler`` pass over one sweep of each
engine (and one pass of the functional pipelines) reports device time
by kernel and the device's busy share, and writes chrome traces to
``build/traces/``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np



def source_dir() -> Path:
    """The port's sources: ``src/`` beside this script, or, for
    ``--launch-probe`` alone, the ``src/`` of another checkout named by
    ``--src DIR`` (to hold two trees side by side)."""
    if "--launch-probe" in sys.argv[1:] and "--src" in sys.argv[1:-1]:
        return Path(sys.argv[sys.argv.index("--src") + 1]).resolve()
    return Path(__file__).resolve().parent / "src"


sys.path.insert(0, str(source_dir()))

import torch  # noqa: E402

# Grids of the mega_sweep space (benchmarks/run.py): ~1.57e6 points per
# structural variant, ~1.26e7 across the 5 Ed-Gaze + 3 Rhythmic variants.
MEGA_GRIDS = {
    "cis_node": [130., 110., 90., 80., 65., 55., 45., 40., 32., 28., 22.,
                 16., 14.],
    "soc_node": [14., 22., 28.],
    "frame_rate": [15., 24., 30., 45., 60., 90., 120., 240.],
    "sys_rows": [4., 8., 16., 32., 48., 64., 96., 128.],
    "sys_cols": [4., 8., 16., 32., 64., 128.],
    "mem_tech": ["sram", "sram_hp", "stt"],
    "active_fraction_scale": [0.1, 0.25, 0.5, 0.75, 1.0],
    "pixel_pitch_um": [2., 2.5, 3., 3.5, 4., 5., 6.],
}
MEGA_POINTS = 8 * 13 * 3 * 8 * 8 * 6 * 3 * 5 * 7
CHUNK = 1 << 18
# K3b's large row: 2^24 points x 8 interleaved ids, 151 MB read
BIG_STATS = 1 << 24
# the int64 lane: 2.25e9 points in one variant (flat indices past 2**31)
WIDE_GRIDS = {"variant": ["3d_in"],
              "cis_node": list(np.linspace(28.0, 130.0, 1500)),
              "frame_rate": list(np.linspace(15.0, 120.0, 1500)),
              "active_fraction_scale": list(np.linspace(0.1, 1.0, 1000))}
WIDE_POINTS = 1500 * 1500 * 1000

# the chunked lane: Ed-Gaze over the mega grids without the gating axis,
# 5 x 314,496 = 1,572,480 points, which `auto` sends to `chunked`
CHUNKED_GRIDS = {k: v for k, v in MEGA_GRIDS.items()
                 if k != "active_fraction_scale"}
CHUNKED_POINTS = 5 * 13 * 3 * 8 * 8 * 6 * 3 * 7
# the monolithic lane: the design_sweep grids of benchmarks/run.py over
# Ed-Gaze + Rhythmic, 8 x 2,688 = 21,504 points
DESIGN_GRIDS = {"cis_node": [130., 110., 90., 65., 45., 32., 28.],
                "frame_rate": [15.0, 30.0, 60.0, 120.0],
                "sys_rows": [4.0, 8.0, 16.0, 32.0],
                "sys_cols": [8.0, 16.0, 32.0],
                "mem_tech": ["sram_hp", "stt"],
                "active_fraction_scale": [0.25, 1.0],
                "pixel_pitch_um": [3.0, 5.0]}
DESIGN_POINTS = 8 * 7 * 4 * 4 * 3 * 2 * 2 * 2
# the serve_bench grids (benchmarks/run.py:801-806): each of 8 tenants
# sweeps all 5 Ed-Gaze variants of these with its own vdd_scale pair,
# 46,080 points a variant, 230,400 a tenant
SERVE_GRIDS = {
    "cis_node": [180., 130., 90., 65., 45., 28.],
    "frame_rate": [float(v) for v in range(10, 250, 10)],
    "sys_rows": [float(v) for v in range(8, 136, 8)],
    "pixel_pitch_um": [1.0 + 0.5 * i for i in range(10)],
}
SERVE_CLIENTS = 8
SERVE_CHUNK = 1 << 12
SERVE_POINTS = 5 * 6 * 24 * 16 * 10 * 2
# the reference's SERVE_BENCH_MIN_SPEEDUP, a timing floor set on another
# platform: printed beside the measured rate, never gated on
SERVE_MIN_SPEEDUP = 1.2
KERNEL_SOURCES = ("fused_sweep", "grid_decode", "stream_reduce",
                  "category_reduce", "binning", "stencil_conv",
                  "frame_event", "matmul", "flash_attention")
# the functional path: 30 frames (one second at the use cases' 30 FPS);
# kT/C noise at 10 fF; Ed-Gaze's event threshold; its DNN's hidden width,
# DNN_MACS / (200 * 320) = 900 (core/usecases/edgaze.py)
FUNC_KERNELS = ("binning", "stencil_conv", "frame_event", "matmul")
FUNC_FRAMES = 30
FUNC_CAPACITANCE = 10e-15
EDGAZE_THRESHOLD = 0.05
RHYTHMIC_TILE = 16
RHYTHMIC_KEEP = 0.5
FUNC_COMPARED = 2          # frames held against the port run on the CPU
MATMUL_RULE = 1e-5         # |kernel - twin| <= 1e-5 * (|a| @ |b|)
# K9 against its twin, atol = rtol, compared in f32: another summation
# order and an online softmax (f32), plus one rounding of a half dtype
FA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}
# (B, H, Hkv, S, D): MHA, GQA with a ragged S, MQA, S = 1, and S = 127 at
# the largest head dim the kernel stages
FA_SHAPES = ((2, 4, 4, 256, 64), (2, 8, 2, 200, 32), (1, 8, 1, 128, 64),
             (1, 4, 2, 1, 16), (1, 4, 2, 127, 128))
# the attention path at the widths of two configured models, bf16 as the
# configs declare (src/repro/models/config.py:50), (B, H, Hkv, S, D,
# causal): qwen2-7b (src/repro/configs/qwen2_7b.py: 28 heads, 4 kv heads,
# d_head 128) at the train_4k sequence of 4096 (src/repro/launch/
# shapes.py:20); whisper-medium's encoder self-attention
# (src/repro/configs/whisper_medium.py: d_model 1024, 16 heads and kv
# heads, so D = 64, encoder_seq 1500), not causal
ATTENTION_MODELS = {
    "qwen2_7b": (1, 28, 4, 4096, 128, True),
    "whisper_medium_encoder": (1, 16, 16, 1500, 64, False),
}

# the launch probe's device ms (both trees' kernels carry these names)
PROBE_DEVICE = {"K1_fused_sweep_2^18": "fused_sweep_kernel",
                "K1_fused_sweep_2^18_kk16": "fused_sweep_kernel",
                "K2_grid_decode_2^18": "grid_decode_",
                "K2_grid_decode_2^18_int64": "grid_decode_",
                "K2_grid_decode_chunk4": "grid_decode_",
                "K3a_block_stats_2^18": "block_stats_kernel",
                "K3b_block_stats_banked_2^18": "block_stats_banked",
                "K3b_block_stats_banked_2^18_runs": "block_stats_banked",
                "K3b_block_stats_banked_2^18_single": "block_stats_banked",
                "K3b_block_stats_banked_2^24": "block_stats_banked",
                "K3b_block_stats_banked_floor_512": "block_stats_banked",
                "K7_frame_event_200x320": "frame_event",
                "K7_frame_event_200x320_bf16": "frame_event",
                "K7_frame_event_1x4": "frame_event",
                "K7_frame_event_1x8_bf16": "frame_event"}
# the synthetic rows' grid: 9,216 points, every axis moving
#: one value an axis: the grid K1's multi-pass cases widen
PASS_GRID = {"cis_node": [130.0], "soc_node": [22.0], "mem_tech": [1.0],
             "sys_rows": [16.0], "sys_cols": [32.0], "frame_rate": [60.0],
             "active_fraction_scale": [1.0], "pixel_pitch_um": [3.0],
             "vdd_scale": [1.0], "adc_bits": [10.0]}
SYNTHETIC_GRID = {"cis_node": [130.0, 90.0, 45.0, 22.0],
                  "soc_node": [14.0, 22.0],
                  "mem_tech": [-1.0, 0.0, 1.0, 2.0],
                  "sys_rows": [8.0, 64.0], "sys_cols": [16.0, 32.0],
                  "frame_rate": [30.0, 120.0, 500.0, 3000.0],
                  "active_fraction_scale": [0.25, 1.0],
                  "pixel_pitch_um": [3.0, 5.0],
                  "vdd_scale": [0.8, 1.0, 1.2],
                  "adc_bits": [-1.0, 6.0, 12.0]}

REL = 1e-6          # the reference's parity tolerance (values, top-k)
REL_SUM = 1e-5      # block sums: 4096 f32 terms summed in another order
REL_MEAN = 1e-5     # per-variant means: sums of such sums

# the LM serving path (P12a): qwen2-7b at its published width and depth,
# (batch, prompt, max_seq, greedy tokens); the nine others at full width
# cut to 2 layers, (batch, prompt, greedy tokens), mixtral past its
# 4096-token window so that the prefill's ring roll runs at full width
LM_MAIN = (4, 1024, 1056, 32)
LM_OTHERS = (2, 512, 8)
LM_LONG = {"mixtral_8x7b": (1, 4608)}
LM_CONT_RULE = 2e-2   # decode vs forward: 2e-2 * max(scale, 1), as the
#                       reference's tests/test_archs.py:85
LM_F32_REL = 1e-4     # card vs CPU in f32: 1e-4 * max|cpu|
# the LM training path (P12b): olmo-1b at its published width and depth,
# (batch, seq, timed steps); the loop drill at full width with 2 layers,
# (batch, seq, steps, resumed to); the nine others at full width with 2
# layers, (batch, seq); the card against the CPU in f32
TRAIN_MAIN = (8, 1024, 5)
TRAIN_DRILL = (4, 512, 6, 8)
TRAIN_OTHERS = (2, 512)
TRAIN_F32 = {"loss": 1e-5, "grad_norm": 1e-4, "moments": 1e-4}
# the LM mesh (P12c): the step on several GPUs against one, the loss
# within the reference's bound (tests/test_multidevice.py, bf16 here)
LM_MESH_REL = 2e-2

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit):
# FP32 outside the tensor cores, dense f16/bf16 on the tensor cores (f32
# accumulation; a product of two half values is exact in f32, so work
# whose products all have half operands is bounded at this rate), HBM3
# bandwidth, and the special-function units (16 per SM x 132 SMs at the
# 1.98 GHz boost clock).
# profiled device time by kernel name: the first class whose keys the
# name holds (cuBLAS's GEMMs, torch's elementwise and reduction kernels)
KERNEL_CLASSES = (("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
                  ("softmax", ("softmax",)),
                  ("reduce", ("reduce_kernel",)),
                  ("elementwise", ("elementwise_kernel",)),
                  ("copy_cat_index", ("copy", "Cat", "index", "scatter",
                                      "gather")))
PEAK_FP32 = 67e12
PEAK_HALF = 989e12
PEAK_BYTES = 3.35e12
PEAK_SFU = 132 * 16 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# kernel vs twin
# ---------------------------------------------------------------------------
def compare_blocks(name, ker, twin):
    """Kernel vs twin block outputs: cand_v at rel 1e-6, cand_l equal
    where finite (near-ties within the tolerance are reported), counts
    exact, sums at rel 1e-5.  Returns the error record."""
    kv, kl, ks, kc = (t.cpu().numpy() for t in ker)
    tv, tl, ts, tc = (t.cpu().numpy() for t in twin)
    kv, ks, tv, ts = (a.astype(np.float64) for a in (kv, ks, tv, ts))
    check(kv.shape == tv.shape and kl.shape == tl.shape, f"{name}: shapes")
    fin = np.isfinite(tv)
    check(np.array_equal(np.isfinite(kv), fin), f"{name}: +inf pattern")
    check(np.array_equal(kc, tc), f"{name}: counts differ")
    abs_err = np.abs(kv[fin] - tv[fin])
    rel_err = abs_err / np.maximum(np.abs(tv[fin]), 1e-300)
    max_rel = float(rel_err.max()) if rel_err.size else 0.0
    check(max_rel <= REL, f"{name}: cand_v rel err {max_rel}")
    # an all-masked block sums to 0 in both: no error
    sum_rel = float(np.max(np.abs(ks - ts)
                           / np.maximum(np.abs(ts), 1e-300)))
    check(sum_rel <= REL_SUM, f"{name}: sums rel err {sum_rel}")
    near_ties = 0
    for g, j in zip(*np.nonzero(fin & (kl != tl))):
        other = np.flatnonzero(tl[g] == kl[g, j])
        check(other.size > 0 and np.isclose(tv[g, other[0]], tv[g, j],
                                            rtol=REL, atol=0),
              f"{name}: cand_l differs at block {g} slot {j}")
        near_ties += 1
    rec = dict(case=name, blocks=int(kv.shape[0]), kk=int(kv.shape[1]),
               finite=int(fin.sum()), feasible=float(tc.sum()),
               max_abs_err=float(abs_err.max()) if abs_err.size else 0.0,
               max_rel_err=max_rel, sums_max_rel_err=sum_rel,
               near_ties=near_ties)
    emit({"kernel_vs_twin": rec})
    return rec


def run_case(prep, fs, compute, *, name, variant, start, low, limit, chunk,
             bp, kk, idx_dtype=torch.int32):
    kw = dict(compute=compute, metric="total_j",
              axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              block_points=bp, kk=kk, idx_dtype=idx_dtype)
    row = prep.bank.fused[variant]
    ker = fs.fused_sweep_block(prep.table2, row, start, low, limit, **kw)
    torch.cuda.synchronize()
    twin = fs.fused_sweep_block_torch(prep.table2, row, start, low, limit,
                                      **kw)
    return compare_blocks(name, ker, twin)


def forced_case(fs, name, p, args, kw):
    """K1 under a forced plan against its twin: the gates of
    :func:`compare_blocks`, and every candidate position equal, the +inf
    padding's too (the kernel's lexicographic merge gives the twin's
    stable sort exactly); the launch counted on its cluster size."""
    fs.reset_counts()
    ker = fs.run(*args, p, **kw)
    torch.cuda.synchronize()
    check(fs.COUNTS[f"cluster{p.cluster}_launches"]
          == fs.COUNTS["kernel_launches"] == 1,
          f"{name}: launches {fs.COUNTS}")
    twin = fs.fused_sweep_block_torch(*args, **kw)
    check(torch.equal(ker[1].cpu(), twin[1].cpu()),
          f"{name}: candidate positions differ from the twin's")
    rec = compare_blocks(name, ker, twin)
    rec["plan"] = p._asdict()
    return rec


def k1_staging(fs, dims, shape, n_var, n_variants, p):
    """K1's passes under plan ``p`` (``fs.staging`` at the bank's row
    width)."""
    from repro_torch.core.plan_bank import BankDims, bank_layout
    dims = BankDims(*(int(d) for d in dims))
    return fs.staging(bank_layout(dims)["__width__"][0], dims, shape, n_var,
                      n_variants, p)


def fused_plan_cases(fs, prep, compute):
    """K1 on every plan: each cluster size forced through ``fs.run`` at
    the main-path chunk (``kk`` 3 and 16) and on the wide synthetic row
    (every bank dim past 4: the 16-slot instantiation) over its 9,216
    points in blocks of 4096 (the last ragged); on the plan the wrapper
    picks, a grid whose timing each point computes itself; and blocks
    whose CTAs take their points in passes."""
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.grid import ChunkedGrid, axis_tables, fused_table2
    from repro_torch.core.plan_bank import bank_from_reference
    from repro_torch.core.shard_sweep import _prepare_stream
    from repro_torch.testing import synthetic_bank, synthetic_wide_bank
    n_var = prep.n_var
    kw = dict(compute=compute, metric="total_j",
              axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=n_var, total=prep.total,
              chunk=CHUNK, lmax=prep.lmax, block_points=4096)
    args = (prep.table2, prep.bank.fused[2], 2 * n_var + CHUNK, 0,
            3 * n_var)
    recs = []
    for cluster in fs.CLUSTER_CHOICES:
        for kk in (3, 16):
            recs.append(forced_case(
                fs, f"main_chunk_cluster{cluster}_kk{kk}",
                fs.make_plan(4096, kk, CHUNK, cluster), args,
                dict(kw, kk=kk)))
    dims, fused = synthetic_wide_bank(0)
    grid = ChunkedGrid(SYNTHETIC_GRID)
    table2 = torch.from_numpy(fused_table2(axis_tables([grid]))).cuda()
    row = bank_from_reference({"fused": fused}, dims, device="cuda").fused[0]
    n = len(grid)
    wkw = dict(compute=build_coeff_compute(dims), metric="total_j",
               axis_names=tuple(grid.names), shape=grid.shape, n_var=n,
               total=n, chunk=n, lmax=max(grid.shape), block_points=4096,
               kk=8)
    for cluster in fs.CLUSTER_CHOICES:
        recs.append(forced_case(
            fs, f"wide_synthetic_cluster{cluster}",
            fs.make_plan(4096, 8, n, cluster), (table2, row, 0, 0, n), wkw))
    # 96 x 96 (sys_rows, sys_cols) pairs pass the shared memory a block
    # has: each point times its own digital stages
    grid = list(np.linspace(4.0, 128.0, 96))
    pairs = _prepare_stream("edgaze", {
        "variant": ["2d_in"], "sys_rows": grid, "sys_cols": grid},
        device="cuda")
    pkw = dict(compute=build_coeff_compute(pairs.bank.dims),
               metric="total_j", axis_names=tuple(pairs.vgrids[0].names),
               shape=pairs.vgrids[0].shape, n_var=pairs.n_var,
               total=pairs.total, chunk=pairs.total, lmax=pairs.lmax,
               block_points=4096, kk=3)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    p = fs.plan(min(4096, pairs.total), 3, pairs.total, n_sm)
    check(not k1_staging(fs, pairs.bank.dims, pairs.vgrids[0].shape,
                         pairs.n_var, 1, p).tim,
          "per_point_timing: the timing table fits; the case tables it")
    recs.append(forced_case(
        fs, "per_point_timing", p,
        (pairs.table2, pairs.bank.fused[0], 0, 0, pairs.total), pkw))
    # passes: 20 variants of 1,000 cis_node values in blocks of 16,384 on
    # one CTA (passes of 8,000 points, restaging their variants' tables),
    # and one block of 2^18 points a chunk on the wrapper's plan (clusters
    # of 8, 32,768 points a CTA in 4 passes; the ragged second block's
    # last ranks all padding)
    cis = {"cis_node": list(np.linspace(14.0, 130.0, 1000))}
    dims, fused = synthetic_bank(0)
    row = bank_from_reference({"fused": fused}, dims, device="cuda").fused[0]
    for name, sizes, n_variants, bp, start, chunk, forced in (
            ("passes_restaged_cluster1", cis, 20, 16384, 0, 20_000, 1),
            ("passes_one_block_a_chunk",
             dict(cis, frame_rate=list(np.geomspace(15.0, 3000.0, 300))),
             1, 1 << 18, 1000, 299_000, None)):
        grid = ChunkedGrid(dict(PASS_GRID, **sizes))
        table2 = torch.from_numpy(fused_table2(axis_tables(
            [grid] * n_variants))).cuda()
        n = len(grid)
        mkw = dict(compute=build_coeff_compute(dims), metric="total_j",
                   axis_names=tuple(grid.names), shape=grid.shape, n_var=n,
                   total=n * n_variants, chunk=chunk, lmax=max(grid.shape),
                   block_points=bp, kk=16)
        p = fs.make_plan(bp, 16, chunk, forced) if forced \
            else fs.plan(bp, 16, chunk, n_sm)
        st = k1_staging(fs, dims, grid.shape, n, n_variants, p)
        check(-(-p.rank_points // st.span) > 1,
              f"{name}: {p} takes its points in one pass")
        rec = forced_case(fs, name, p,
                          (table2, row, start, 0, n * n_variants), mkw)
        rec["staging"] = st._asdict()
        recs.append(rec)
    return recs


def synthetic_case(fs):
    """The synthetic L=2 / D=3 bank row of the physics tests, from seed 0."""
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.grid import ChunkedGrid, axis_tables, fused_table2
    from repro_torch.core.plan_bank import bank_from_reference
    from repro_torch.testing import synthetic_bank
    dims, fused = synthetic_bank(0)
    grid = ChunkedGrid(SYNTHETIC_GRID)
    table2 = torch.from_numpy(fused_table2(axis_tables([grid]))).cuda()
    row = bank_from_reference({"fused": fused}, dims, device="cuda").fused[0]
    kw = dict(compute=build_coeff_compute(dims), metric="total_j",
              axis_names=tuple(grid.names), shape=grid.shape,
              n_var=len(grid), total=len(grid), chunk=len(grid),
              lmax=max(grid.shape), block_points=4096, kk=8)
    ker = fs.fused_sweep_block(table2, row, 0, 0, len(grid), **kw)
    torch.cuda.synchronize()
    twin = fs.fused_sweep_block_torch(table2, row, 0, 0, len(grid), **kw)
    return compare_blocks("synthetic_L2_D3", ker, twin)


def nan_case(fs, prep, compute, *, name, variant, nan_values, start, low,
             limit, chunk, bp, kk):
    """K1 vs its twin where the metric is NaN at some points (F5): the
    variant's ``active_fraction_scale`` values at ``nan_values`` (an axis
    that scales memory energy and no time, so the points stay feasible)
    set, in the axis table both read, to the NaN the card's arithmetic
    makes (0x7fffffff).  A NaN ranks above +inf (a masked point) and the
    pad pair above it, in the twin's total order and the kernel's keys:
    positions equal everywhere, NaN candidates bit-equal, finite ones at
    rel 1e-6, counts exact."""
    table2 = prep.table2.clone()
    axis = list(prep.vgrids[0].names).index("active_fraction_scale")
    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)
    for j in nan_values:
        table2[axis, variant * prep.lmax + j] = nan[0]
    kw = dict(compute=compute, metric="total_j",
              axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              block_points=bp, kk=kk)
    row = prep.bank.fused[variant]
    ker = fs.fused_sweep_block(table2, row, start, low, limit, **kw)
    torch.cuda.synchronize()
    twin = fs.fused_sweep_block_torch(table2, row, start, low, limit, **kw)
    kv, kl, ks, kc = (t.cpu().numpy() for t in ker)
    tv, tl, ts, tc = (t.cpu().numpy() for t in twin)
    tnan = np.isnan(tv)
    check(np.array_equal(np.isnan(kv), tnan), f"{name}: NaN pattern")
    check(bool(tnan.any()), f"{name}: no NaN candidate")
    check(np.array_equal(kv[tnan].view(np.uint32), tv[tnan].view(np.uint32)),
          f"{name}: NaN candidates' bits differ")
    check(np.array_equal(kl, tl), f"{name}: candidate positions differ")
    check(np.array_equal(kc, tc), f"{name}: counts differ")
    check(np.array_equal(np.isnan(ks), np.isnan(ts)), f"{name}: NaN sums")
    fin = np.isfinite(tv)
    check(np.array_equal(np.isfinite(kv), fin), f"{name}: +inf pattern")
    abs_err = np.abs(kv[fin].astype(np.float64) - tv[fin])
    rel_err = abs_err / np.maximum(np.abs(tv[fin]), 1e-300)
    max_rel = float(rel_err.max()) if rel_err.size else 0.0
    check(max_rel <= REL, f"{name}: cand_v rel err {max_rel}")
    rec = dict(case=name, blocks=int(kv.shape[0]), kk=int(kv.shape[1]),
               nan_candidates=int(tnan.sum()), finite=int(fin.sum()),
               nan_bits=sorted({hex(b) for b in tv[tnan].view(np.uint32)}),
               feasible=float(tc.sum()),
               max_abs_err=float(abs_err.max()) if abs_err.size else 0.0,
               max_rel_err=max_rel)
    emit({"kernel_vs_twin_nan": rec})
    return rec


# ---------------------------------------------------------------------------
# K2, K3a, K3b, K4 vs their twins
# ---------------------------------------------------------------------------
def decode_case(gd, prep, *, name, start, chunk, idx_dtype=torch.int32,
                route="vec4"):
    """K2 against its twin: axis values and variant ids bit-equal, one
    launch, on ``route``.  ``prep`` is a stream prep or a
    :func:`decode_grid`."""
    kw = dict(shape=tuple(prep.vgrids[0].shape), n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              idx_dtype=idx_dtype)
    gd.reset_counts()
    kv, kid = gd.grid_decode(prep.table2, start, **kw)
    torch.cuda.synchronize()
    check(gd.COUNTS["kernel_launches"] == gd.COUNTS[f"{route}_launches"] == 1,
          f"{name}: launches {gd.COUNTS}, want one on {route}")
    tv, tid = gd.grid_decode_torch(prep.table2, start, **kw)
    check(torch.equal(kv, tv) and torch.equal(kid, tid),
          f"{name}: grid_decode differs from its twin")
    rec = dict(case=name, points=chunk, start=int(start), route=route,
               idx=dtype_name(idx_dtype), axes=len(kw["shape"]),
               past_total=max(0, start + chunk - prep.total),
               variants_crossed=int(kid.max() - kid.min()),
               max_abs_err=float((kv - tv).abs().max()))
    emit({"kernel_vs_twin": rec})
    return rec


def decode_grid(shape, n_variants):
    """A synthetic decode input shaped like a stream prep: an axis table
    on the card whose every entry names its own (axis, column), so equal
    values mean equal indices."""
    lmax = max(shape)
    n_var = math.prod(shape)
    table2 = torch.arange(len(shape) * n_variants * lmax,
                          dtype=torch.float32, device="cuda").reshape(
                              len(shape), -1)
    return SimpleNamespace(table2=table2, n_var=n_var, lmax=lmax,
                           total=n_var * n_variants,
                           vgrids=[SimpleNamespace(shape=shape)])


def decode_cases(gd, prep, wide):
    """K2 on each route and edge: the main chunk (vec4), a chunk of
    4,099 (scalar), starts that are no multiple of 4, the tail past
    total, a chunk across a variant boundary, int64 past 2^31 and 2^32
    and at the end of the space, 1 and 16 axes."""
    n_var = prep.n_var
    past_2_32 = decode_grid((1500, 1500, 3, 1, 1, 1, 1, 1, 1000, 1), 3)
    one_axis = decode_grid((7,), 3)
    axes16 = decode_grid((2, 3, 2, 1, 2, 2, 3, 2, 2, 1, 2, 2, 2, 3, 2, 2),
                         2)
    i64 = torch.int64
    recs = [
        decode_case(gd, prep, name="decode_main_chunk",
                    start=2 * n_var + CHUNK, chunk=CHUNK),
        decode_case(gd, prep, name="decode_chunk_4099",
                    start=2 * n_var + 12345, chunk=4099, route="scalar"),
        decode_case(gd, prep, name="decode_start_1_mod_4",
                    start=2 * n_var + CHUNK + 1, chunk=CHUNK),
        decode_case(gd, prep, name="decode_start_3_mod_4_int64",
                    start=2 * n_var + 7, chunk=CHUNK, idx_dtype=i64),
        decode_case(gd, prep, name="decode_tail_past_total",
                    start=prep.total - 1000, chunk=4099, route="scalar"),
        decode_case(gd, prep, name="decode_tail_past_total_vec4",
                    start=prep.total - 1001, chunk=4096),
        decode_case(gd, prep, name="decode_across_variants",
                    start=3 * n_var - 777, chunk=CHUNK),
        decode_case(gd, wide, name="decode_int64_beyond_2^31",
                    start=WIDE_POINTS - 70_000, chunk=CHUNK, idx_dtype=i64),
        decode_case(gd, past_2_32, name="decode_int64_beyond_2^32",
                    start=2 ** 32 - 3001, chunk=CHUNK, idx_dtype=i64),
        decode_case(gd, past_2_32, name="decode_int64_beyond_2^32_scalar",
                    start=2 ** 32 - 3001, chunk=5001, idx_dtype=i64,
                    route="scalar"),
        decode_case(gd, past_2_32, name="decode_int64_end_of_space",
                    start=past_2_32.total - 3001, chunk=4096,
                    idx_dtype=i64),
        decode_case(gd, one_axis, name="decode_one_axis", start=4,
                    chunk=24),
        decode_case(gd, axes16, name="decode_16_axes", start=50_001,
                    chunk=40_000),
        decode_case(gd, axes16, name="decode_16_axes_int64_scalar",
                    start=axes16.total - 77, chunk=4099, idx_dtype=i64,
                    route="scalar"),
    ]
    check(all(r["past_total"] > 0 for r in recs if "tail" in r["case"]
              or "end" in r["case"]), "decode tail does not cross total")
    check(recs[6]["variants_crossed"] == 1, "decode does not cross variants")
    return recs


def stats_case(sr, *, name, values, mask, bp, variant=None, n_variants=0):
    """K3a/K3b against their twins: min, argmin and counts exact, sums
    at rel 1e-5."""
    if variant is None:
        ker = sr.block_stats(values, mask, bp)
        torch.cuda.synchronize()
        twin = sr.block_stats_torch(values, mask, bp)
    else:
        ker = sr.block_stats_banked(values, mask, variant, n_variants, bp)
        torch.cuda.synchronize()
        twin = sr.block_stats_banked_torch(values, mask, variant,
                                           n_variants, bp)
    return stats_compare(name, ker, twin, values)


def stats_compare(name, ker, twin, values, **extra):
    """Block stats against their twin's: min (NaN where the twin's is
    NaN), argmin and counts exact, sums at rel 1e-5 (non-finite ones
    equal); emits and returns the record."""
    km, ka, ks, kc = (t.cpu().numpy() for t in ker)
    tm, ta, ts, tc = (t.cpu().numpy() for t in twin)
    check(np.array_equal(km, tm, equal_nan=True) and np.array_equal(ka, ta),
          f"{name}: min/argmin differ from the twin")
    check(np.array_equal(kc, tc), f"{name}: counts differ")
    # a sum with NaN or +-inf terms is the same in any order: equal
    fin = np.isfinite(ts)
    check(np.array_equal(ks[~fin], ts[~fin], equal_nan=True)
          and np.isfinite(ks[fin]).all(), f"{name}: non-finite sums differ")
    ks, ts = ks[fin].astype(np.float64), ts[fin].astype(np.float64)
    sum_rel = float(np.max(np.abs(ks - ts)
                           / np.maximum(np.abs(ts), 1e-30), initial=0.0))
    check(sum_rel <= REL_SUM, f"{name}: sums rel err {sum_rel}")
    rec = dict(case=name, points=int(values.numel()), blocks=int(km.size),
               empty_blocks=int((tc == 0).sum()),
               nan_mins=int(np.isnan(tm).sum()),
               max_abs_err=float(np.max(np.abs(ks - ts), initial=0.0)),
               sums_max_rel_err=sum_rel, **extra)
    emit({"kernel_vs_twin": rec})
    return rec


def offset_copies(*ts):
    """Each tensor copied one element into a buffer of its own: the
    ``scalar`` routes' bases."""
    outs = []
    for t in ts:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:]
        buf.copy_(t)
        outs.append(buf)
    return outs


def stats_plan_cases(sr, vals, mask, tag=""):
    """K3a on every plan: each cluster size on the vec4 route (the
    aligned main-path vector) and the scalar route (the same values one
    element into their buffers), forced through ``sr.run``, each launch
    counted on its route."""
    off_v, off_m = offset_copies(vals, mask)
    recs = []
    for cluster in sr.CLUSTER_CHOICES:
        for route, (v, m) in (("vec4", (vals, mask)),
                              ("scalar", (off_v, off_m))):
            aligned = v.data_ptr() % 16 == 0 and m.data_ptr() % 4 == 0
            p = sr.make_plan(CHUNK, 4096, cluster, aligned)
            check(p.route == route, f"block stats plan {p}: not {route}")
            sr.reset_counts()
            ker = sr.run(v, m, p, 4096)
            torch.cuda.synchronize()
            check(sr.COUNTS[f"{route}_launches"]
                  == sr.COUNTS["kernel_launches"] == 1,
                  f"block stats {p}: launches {sr.COUNTS}")
            recs.append(stats_compare(
                f"stats{tag}_{route}_cluster{cluster}", ker,
                sr.block_stats_torch(v, m, 4096), v, plan=p._asdict()))
    return recs


def banked_plan_cases(sr, vals, mask, vid, tag=""):
    """K3b on every plan: cluster size x route (vec4 on the aligned
    vectors, scalar one element into their buffers) x variant tile (the
    plan's 8, or 3: three tiles), forced through ``sr.run_banked``, each
    launch counted on its route and launched twice: the two bit-equal,
    sums too."""
    off = offset_copies(vals, mask, vid)
    recs = []
    for cluster in sr.CLUSTER_CHOICES:
        for route, args in (("vec4", (vals, mask, vid)), ("scalar", off)):
            for tile in (None, 3):
                p = sr.make_banked_plan(CHUNK, 4096, 8, cluster,
                                        sr.aligned(*args), tile)
                check(p.route == route, f"banked plan {p}: not {route}")
                sr.reset_counts()
                ker = sr.run_banked(*args, 8, p, 4096)
                again = sr.run_banked(*args, 8, p, 4096)
                torch.cuda.synchronize()
                check(sr.COUNTS[f"banked_{route}_launches"]
                      == sr.COUNTS["banked_kernel_launches"] == 2,
                      f"banked {p}: launches {sr.COUNTS}")
                check(all(torch.equal(a.view(torch.int32),
                                      b.view(torch.int32))
                          for a, b in zip(ker, again)),
                      f"banked {p}: a repeated launch differs")
                recs.append(stats_compare(
                    f"stats_banked{tag}_{route}_cluster{cluster}_tile"
                    f"{p.tile}", ker,
                    sr.block_stats_banked_torch(*args, 8, 4096), args[0],
                    plan=p._asdict()))
    return recs


def k2_variant_row(gd, prep, start):
    """K2's variant-id row of the chunk of ``CHUNK`` points at ``start``
    of the mega_sweep space: runs of ``n_var`` points of one id."""
    return gd.grid_decode(prep.table2, start, shape=prep.vgrids[0].shape,
                          n_var=prep.n_var, total=prep.total, chunk=CHUNK,
                          lmax=prep.lmax)[1]


def banked_cases(sr, gd, prep, vals, mask, vid):
    """K3b (and K3a where it applies) against the twins beyond the
    interleaved ids: K2's variant row across two variants, one variant, V
    past one tile (17, 40, 100), an offset view (the scalar route), NaN
    and +-inf with ties of NaN and an all-masked block (F4, K3a on every
    plan too), and K3b's every plan on the interleaved and NaN inputs."""
    from repro_torch.testing import stats_case as edge_case
    runs = k2_variant_row(gd, prep, 2 * prep.n_var - CHUNK // 2)
    check(torch.unique(runs).tolist() == [1, 2], "K2's row: not two runs")
    recs = [stats_case(sr, name="stats_banked_runs", values=vals, mask=mask,
                       bp=4096, variant=runs, n_variants=8),
            stats_case(sr, name="stats_banked_single", values=vals,
                       mask=mask, bp=4096, variant=torch.full_like(vid, 3),
                       n_variants=8)]
    pos = torch.arange(CHUNK, device="cuda")
    for nv in (17, 40, 100):
        ids = (pos * 7 % (nv + 2) - 1).to(torch.int32)    # -1 .. nv
        recs.append(stats_case(sr, name=f"stats_banked_{nv}_variants",
                               values=vals, mask=mask, bp=4096,
                               variant=ids, n_variants=nv))
    off = offset_copies(vals, mask, vid)
    check(not sr.aligned(*off), "the offset views are aligned")
    recs.append(stats_case(sr, name="stats_banked_offset_scalar",
                           values=off[0], mask=off[1], bp=4096,
                           variant=off[2], n_variants=8))
    nan_in = [torch.from_numpy(a).cuda()
              for a in edge_case(CHUNK, 4096, 8, "interleaved", 11)]
    nan_k3a = [stats_case(sr, name="stats_nan_inf", values=nan_in[0],
                          mask=nan_in[1], bp=4096)]
    nan_k3a += stats_plan_cases(sr, *nan_in[:2], tag="_nan")
    recs.append(stats_case(sr, name="stats_banked_nan_inf",
                           values=nan_in[0], mask=nan_in[1], bp=4096,
                           variant=nan_in[2], n_variants=8))
    check(recs[-1]["nan_mins"] > 0 and nan_k3a[0]["nan_mins"] > 0,
          "the NaN case has no NaN min")
    recs += banked_plan_cases(sr, vals, mask, vid)
    recs += banked_plan_cases(sr, *nan_in, tag="_nan")
    return recs, nan_k3a


def reduce_case(cr, *, name, e, w):
    """K4 against its twin: bit-equal."""
    ker = cr.category_reduce(e, w)
    torch.cuda.synchronize()
    twin = cr.category_reduce_torch(e, w)
    check(torch.equal(ker, twin), f"{name}: category_reduce differs from "
          f"its twin by {float((ker - twin).abs().max())}")
    rec = dict(case=name, rows=int(e.shape[0]), units=int(e.shape[1]),
               cols=int(w.shape[1]), max_abs_err=0.0)
    emit({"kernel_vs_twin": rec})
    return rec


def stats_inputs(n, seed, *, ties=False, empty_block=None):
    # positive, energy-like values: block sums without cancellation
    rng = np.random.default_rng(seed)
    vals = (rng.choice(np.float32([0.5, 1.25, 2.0]), n) if ties
            else rng.uniform(0.5, 2.0, n).astype(np.float32))
    mask = rng.uniform(size=n) > 0.3
    if empty_block is not None:
        mask[empty_block[0]:empty_block[1]] = False
    return (torch.from_numpy(vals).cuda(), torch.from_numpy(mask).cuda())


def reduce_inputs(b, u, c, seed):
    rng = np.random.default_rng(seed)
    e = rng.uniform(1e-12, 1e-6, size=(b, u)).astype(np.float32)
    w = (rng.uniform(size=(u, c)) > 0.5).astype(np.float32)
    w[:, c - 2] = 1.0
    return torch.from_numpy(e).cuda(), torch.from_numpy(w).cuda()


# ---------------------------------------------------------------------------
# roofline bound of one launch
# ---------------------------------------------------------------------------
def ops_per_point(dims, knots):
    """FP32 operations and special-function calls per design point that
    the function itself needs (integer index arithmetic not counted).

    This counts the work of ``build_coeff_compute`` at the bank's dims,
    not the instructions of one implementation, so it stays put when the
    kernel changes.  An interpolation over n knots locates its one
    segment (two clamp compares and a binary search of ceil(log2(n - 1))
    compares), then does a sub, a div, a mul and an add; a unit's category
    fold is 2 (C + 2); exp and log are one SFU call each, pow two.
    ``knots`` are the (dyn, leak, hp, fom) table lengths.
    """
    _v, A, L, F, D, M = dims
    n_dyn, n_leak, n_hp, n_fom = knots
    interp = lambda n: 2 + math.ceil(math.log2(n - 1)) + 4  # noqa: E731
    red = 2 * 10
    units = A + D + M + 2
    fp = 2                                   # frame time, vdd^2
    if D:
        fp += 2 + 6 * D + 4 * D * (D - 1) // 2 + 4 * D + 1
    fp += 3                                  # t_a, feasibility
    fp += 2 * A + 6 * L + (A if L else 0)
    fp += F * (14 + interp(n_fom)) + (A if F else 0)
    fp += D * (7 + interp(n_dyn))
    fp += M * (30 + interp(n_dyn) + interp(n_leak) + interp(n_hp))
    fp += 2 + 3 + 7 * M + 2 + 3 + 4          # comm, area, metric, reduce
    fp += red * units
    sfu = D + 3 * M + F * 4                  # exp per node lookup; log+pow+exp
    return fp, sfu


def hoisted_ops_per_point(dims, knots, shape, variants, rank_points):
    """FP32 operations and special-function calls per design point that
    the redesigned K1 still does (:func:`ops_per_point`'s count less what
    its prologue tables: each digital row's and each memory row's node
    interpolations and ``exp``, the cell area's ``node * 1e-6`` and
    square, the ADC factor's sub, mul, two compares and ``exp``, the
    digital timing and the memory rows' reads), plus the prologue's own
    work spread over a CTA's ``rank_points`` points: for each of the
    ``variants`` a CTA reaches, 4 node entries a cis_node and soc_node
    value and F ADC entries an adc_bits value, each an interpolation and
    an ``exp``, and the timing of each (sys_rows, sys_cols) pair; and 80
    declared-node entries.  ``shape`` is the grid's axis sizes in
    registry order."""
    fp, sfu = ops_per_point(dims, knots)
    _v, _a, _l, f, d, m = dims
    n_dyn, n_leak, n_hp, _n_fom = knots
    interp = lambda n: 2 + math.ceil(math.log2(n - 1)) + 4  # noqa: E731
    timing = (2 + 6 * d + 4 * d * (d - 1) // 2 + 4 * d + 1 if d else 0) \
        + 3 * m
    fp -= d * interp(n_dyn) + m * (interp(n_dyn) + interp(n_leak)
                                   + interp(n_hp)) + 3 * m + 4 * f + timing
    sfu -= d + 3 * m + f
    entries = variants * (4 * (shape[0] + shape[1]) + f * shape[9]) + 80
    fp += (entries * (interp(max(n_dyn, n_leak, n_hp)) + 2)
           + variants * shape[3] * shape[4] * timing) / rank_points
    sfu += entries / rank_points
    return fp, sfu


def bound_ms(n_points, dims, knots, bytes_moved, per_point=None):
    fp, sfu = per_point or ops_per_point(dims, knots)
    t_ops = max(n_points * fp / PEAK_FP32, n_points * sfu / PEAK_SFU)
    t_bytes = bytes_moved / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes
            else "bytes", fp, sfu)


def time_ms(fn, reps=20, windows=1):
    """CUDA-event ms per call of ``fn`` over ``reps`` back-to-back calls;
    the median of ``windows`` such windows (a host-bound call's time moves
    with the host's other work, and one window can catch a stall)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return float(np.median(times))


def device_ms(fn, needle, reps=20, tries=5):
    """Device time per call of ``fn``'s kernels named ``*needle*``, from
    ``torch.profiler`` over ``reps`` back-to-back calls (the CUDA-event
    time of such a loop also holds the host's per-launch work): the sum,
    over the distinct kernel names, of each one's median span (each call
    launches each of its kernels once).  On the card the profiler has
    been seen to drop kernel records from a trace, which medians survive;
    a trace that holds fewer than ``reps // 2`` records of a name is
    taken again, up to ``tries`` times; then the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and needle in e.name:
                spans.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        if spans and min(map(len, spans.values())) >= reps // 2:
            return sum(float(np.median(v)) for v in spans.values()) * 1e-3
    raise AssertionError(f"device time of {needle}: {tries} profiler traces "
                         f"each held fewer than {reps // 2} of {reps} "
                         f"kernel records")


def library_device_ms(fn, reps=20, tries=5):
    """Device time per call of a library call ``fn``, all of its kernels
    whatever their names, from ``torch.profiler`` over ``reps``
    back-to-back calls: for each kernel name, its median span times the
    number of times a call launches it (its records over ``reps``,
    rounded, so a dropped record does not count).  A trace with no kernel
    is taken again, up to ``tries`` times; then the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        total = sum(float(np.median(v)) * round(len(v) / reps)
                    for v in spans.values())
        if total > 0:
            return total * 1e-3
    raise AssertionError(f"library device time: {tries} profiler traces "
                         f"held no kernel")


# ---------------------------------------------------------------------------
# scalar oracle (the jax-free estimate_energy walk, one design point)
# ---------------------------------------------------------------------------
def scalar_total(algorithm, variant, point):
    """total_j of one design point through the scalar estimate_energy,
    the model the batched physics is lowered from."""
    from repro_torch.core.digital import SystolicArray
    from repro_torch.core.energy import estimate_energy
    from repro_torch.core.grid import build_variant
    from repro_torch.core.plan import TECH_INDEX
    hw, stages, mapping, _ = build_variant(
        algorithm, variant, cis_node=int(point["cis_node"]),
        soc_node=int(point["soc_node"]))
    hw.frame_rate = float(point["frame_rate"])
    hw.pixel_pitch_um = float(point["pixel_pitch_um"])
    for binding in hw.digital.values():
        if isinstance(binding.unit, SystolicArray):
            binding.unit.rows = int(point["sys_rows"])
            binding.unit.cols = int(point["sys_cols"])
    tech = int(point["mem_tech"])
    names = {v: k for k, v in TECH_INDEX.items()}
    for mem in hw.memories.values():
        if tech >= 0:
            mem.technology = names[tech]
        mem.active_fraction *= float(point["active_fraction_scale"])
    return estimate_energy(hw, stages, mapping, strict=False).total()


# ---------------------------------------------------------------------------
def compare_results(name, a, b):
    """Kernel lane vs twin lane of one explore(): top-k rows and
    summaries (values rel 1e-6, means rel 1e-5, counts exact)."""
    check(a.n_points == b.n_points and a.n_feasible == b.n_feasible,
          f"{name}: counts {a.n_points}/{a.n_feasible} vs "
          f"{b.n_points}/{b.n_feasible}")
    check(len(a.topk) == len(b.topk), f"{name}: top-k length")
    worst = 0.0
    for ra, rb in zip(a.topk, b.topk):
        check((ra["variant"], ra["algorithm"], ra["index"])
              == (rb["variant"], rb["algorithm"], rb["index"]),
              f"{name}: top-k rows differ: {ra} vs {rb}")
        for key, va in ra.items():
            if isinstance(va, float):
                err = abs(va - rb[key]) / max(abs(rb[key]), 1e-300)
                worst = max(worst, err)
                check(err <= REL, f"{name}: {key} rel err {err}")
    for label, sa in a.summaries.items():
        sb = b.summaries[label]
        check((sa["n"], sa["n_feasible"], sa["argmin_index"])
              == (sb["n"], sb["n_feasible"], sb["argmin_index"]),
              f"{name}: {label} summary counts")
        for key, tol in (("metric_min", REL), ("metric_mean", REL_MEAN)):
            if math.isnan(sa[key]) and math.isnan(sb[key]):
                continue
            err = abs(sa[key] - sb[key]) / max(abs(sb[key]), 1e-300)
            check(err <= tol, f"{name}: {label}.{key} rel err {err}")
    return worst


def campaign_path(space, res, fs, kernel_mods, smi) -> dict:
    """P9 at full width: mega_sweep as a checkpointed campaign of 12
    shards (the default 4 chunks each, straddling variant boundaries),
    K1 in every shard.

    1. serial, held to the straight fused ``res`` by the engine rule;
    2. ``workers=2``, one worker SIGKILLed with a shard in flight
       (``KillWorker``, retried) and the campaign killed after 4
       completed shards (``kill_after``), then resumed with
       ``workers=2``: the resume dispatches only the missing ranges and
       equals step 1 bit for bit (top-k rows and summaries);
    3. staged (K2 -> banked evaluator -> K3a), held to the fused one.

    Each step runs with the counters zeroed just before it and read just
    after; workers report their own (one prep each)."""
    import shutil
    import tempfile
    from repro_torch.campaign import (CampaignOptions, FaultSchedule,
                                      KillCampaign, KillWorker,
                                      missing_ranges, plan_shards, resume)
    from repro_torch.core.shard_sweep import (stream_cache_clear,
                                              stream_cache_info)
    from repro_torch.explore import explore
    root = Path(__file__).resolve().parent / "build" / "campaigns"
    root.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=root))
    try:
        kw = dict(engine="fused", chunk_size=CHUNK, k=3)
        reset_all(kernel_mods)
        stream_cache_clear()
        t0 = time.perf_counter()
        serial = explore(space, checkpoint_dir=str(work / "serial"), **kw)
        serial_wall = time.perf_counter() - t0
        rep = serial.campaign
        serial_counts = stream_cache_info()
        plan = plan_shards(MEGA_POINTS, 4 * CHUNK)
        check(rep["n_planned"] == len(plan) == 12 and not rep["partial"]
              and rep["n_executed"] == 12, f"serial campaign: {rep}")
        check(serial_counts["preps"] == 1,
              f"serial campaign: {serial_counts['preps']} preparations")
        check(serial_counts["kernel_launches"] > 0
              and serial_counts["twin_calls"] == 0,
              f"serial campaign counters {serial_counts}")
        serial_worst = compare_results("campaign_vs_fused", serial, res)

        # 2. workers=2: a worker dies with shard 1 in flight, then the
        # campaign is killed after 4 completed shards, then resumed
        faults = FaultSchedule({(plan[1][0], 1): KillWorker("drill")},
                               kill_after=4)
        reset_all(kernel_mods)
        stream_cache_clear()
        t0 = time.perf_counter()
        try:
            explore(space, checkpoint_dir=str(work / "parallel"), workers=2,
                    campaign=CampaignOptions(faults=faults), **kw)
            raise AssertionError("the kill_after drill did not kill")
        except KillCampaign:
            pass
        killed_wall = time.perf_counter() - t0
        done = sorted((int(f.stem.split("_")[1]), int(f.stem.split("_")[2]))
                      for f in (work / "parallel" / "shards").glob("*.json"))
        check(len(done) == 4, f"killed campaign checkpointed {done}")
        t0 = time.perf_counter()
        par = resume(str(work / "parallel"), workers=2)
        resume_wall = time.perf_counter() - t0
        prep = par.campaign
        parent_counts = stream_cache_info()
        ran = sorted((e["lo"], e["hi"]) for e in prep["executed"]
                     if e["status"] == "ok")
        check(ran == missing_ranges(plan, done),
              f"resume dispatched {ran}, missing {missing_ranges(plan, done)}")
        check(prep["resumed"] and prep["n_loaded"] == 4
              and not prep["partial"], f"resumed campaign: {prep}")
        check(set(prep["worker_preps"]) == {1},
              f"worker preparations {prep['worker_preps']}")
        check(not any(prep["worker_modules"].values()),
              f"workers loaded {prep['worker_modules']}")
        check(parent_counts["preps"] == 0
              and parent_counts["kernel_launches"] == 0,
              f"the parallel parent ran shards itself: {parent_counts}")
        worker_launches = sum(c["kernel_launches"]
                              for c in prep["worker_counters"].values())
        check(worker_launches > 0, "resumed workers launched no K1")
        check(par.topk == serial.topk
              and json.dumps(par.summaries) == json.dumps(serial.summaries)
              and (par.n_points, par.n_feasible)
              == (serial.n_points, serial.n_feasible),
              "killed-and-resumed workers=2 campaign != serial campaign")

        # 3. staged shards
        reset_all(kernel_mods)
        stream_cache_clear()
        t0 = time.perf_counter()
        staged = explore(space, engine="staged", chunk_size=CHUNK, k=3,
                         checkpoint_dir=str(work / "staged"))
        staged_wall = time.perf_counter() - t0
        staged_counts = stream_cache_info()
        staged_launches = {m.__name__.rsplit(".", 1)[1]:
                           m.COUNTS["kernel_launches"] for m in kernel_mods
                           if m.__name__.rsplit(".", 1)[1]
                           in ("grid_decode", "stream_reduce")}
        check(staged_counts["preps"] == 1 and not staged.campaign["partial"]
              and all(staged_launches.values()),
              f"staged campaign: {staged_counts} {staged_launches}")
        staged_worst = compare_results("staged_campaign_vs_fused", staged,
                                       res)
        line = {
            "nvidia_smi": smi[0] if smi else None,
            "points": serial.n_points, "shards": rep["n_planned"],
            "serial": {
                "wall_s": serial_wall, "report_wall_s": rep["wall_s"],
                "dispatches": serial.dispatches,
                "k1_launches": serial_counts["kernel_launches"],
                "preps": serial_counts["preps"], "io_s": rep["io_s"],
                "io_overlap_frac": rep["io_overlap_frac"],
                "eval_s": serial.eval_s,
                "vs_fused_max_rel_err": serial_worst},
            "workers2_killed": {"wall_s": killed_wall,
                                "shards_checkpointed": len(done)},
            "workers2_resumed": {
                "wall_s": resume_wall, "report_wall_s": prep["wall_s"],
                "shards_run": len(ran),
                "dispatches": sum(c["dispatches"] for c in
                                  prep["worker_counters"].values()),
                "k1_launches": worker_launches,
                "worker_preps": prep["worker_preps"],
                "parent_preps": parent_counts["preps"],
                "worker_startup_s": prep["worker_startup_s"],
                "dispatch_wait_s": prep["dispatch_wait_s"],
                "bit_equal_to_serial": True},
            "staged": {"wall_s": staged_wall,
                       "dispatches": staged.dispatches,
                       "launches": staged_launches,
                       "preps": staged_counts["preps"],
                       "vs_fused_max_rel_err": staged_worst},
        }
        emit({"campaign_path": line})
        return line
    finally:
        shutil.rmtree(work, ignore_errors=True)


def serve_path(space, res, fs, gd, sr, kernel_mods, smi) -> dict:
    """P10 at full width: the reference's serve_bench gauntlet
    (``benchmarks/run.py:797-915``) on the card, then one streaming
    tenant at mega_sweep's width and one staged request.

    1. 8 tenants (``SERVE_GRIDS``, client ``i`` with ``vdd_scale`` =
       ``[0.80 + 0.002 i, 1.0]``; ``k=8``, fused, chunks of 4096): a warm
       solo call, the 8 solo calls, then ``ExploreService(
       coalesce_window_s=0.05)`` and two waves of 8 client threads
       through ``explore(service=)``: one step build in all, wave 1 one
       group of 8 (a share of 1/8 each), each tenant's top-k values and
       indices bit-equal to its solo call and its rows within rel 1e-6,
       wave 2 all cache hits with no dispatch and no K1 launch;
    2. mega_sweep (``space``) as one streaming tenant of a service with
       ``partial_interval_s=0``: ``seq`` counts up, ``done`` never falls,
       one final update last, a snapshot at every dispatch but the last,
       the final top-k and summaries bit-equal to the straight fused
       ``res``;
    3. a staged request of tenant 0 through the same service (the direct
       fallback: K2 and K3a), held to tenant 0's fused result by the
       engine rule.

    Each step runs with the counters zeroed just before it and read just
    after; a profiled pass of the 8 solo calls and a profiled wave (the
    cache emptied first) give the device's busy share and kernels."""
    import threading
    from repro_torch.core.shard_sweep import (stream_cache_clear,
                                              stream_cache_info)
    from repro_torch.explore import DesignSpace, explore
    from repro_torch.serve import ExploreService
    spaces = [DesignSpace(["edgaze"], dict(SERVE_GRIDS, vdd_scale=[
        0.80 + 0.002 * i, 1.0])) for i in range(SERVE_CLIENTS)]
    check(all(sp.n_points == SERVE_POINTS for sp in spaces),
          f"serve tenants have {[sp.n_points for sp in spaces]} points")
    kw = dict(k=8, engine="fused", chunk_size=SERVE_CHUNK)
    n_var = SERVE_POINTS // 5
    cpv = -(-n_var // SERVE_CHUNK)
    per_tenant = 5 * cpv                       # K1 launches a tenant
    segments = -(-per_tenant // 16)            # superchunks of 16 ordinals

    def k1():
        return fs.COUNTS["kernel_launches"]

    def rows_key(r):
        return [(row["total_j"], row["algorithm"], row["variant"],
                 row["index"]) for row in r.topk]

    def worst_rel(a, b):
        worst = 0.0
        for ra, rb in zip(a.topk, b.topk):
            for key, vb in rb.items():
                if isinstance(vb, float):
                    worst = max(worst, abs(ra[key] - vb)
                                / max(abs(vb), 1e-300))
        return worst

    # ----- 1. the 8-tenant gauntlet -----------------------------------------
    stream_cache_clear()
    reset_all(kernel_mods)
    explore(spaces[0], **kw)                       # warm
    warm_launches = k1()
    reset_all(kernel_mods)
    t0 = time.perf_counter()
    solos = [explore(sp, **kw) for sp in spaces]
    solo_s = time.perf_counter() - t0
    solo_launches = k1()
    check(warm_launches == per_tenant
          and solo_launches == SERVE_CLIENTS * per_tenant,
          f"serve solo: K1 launches {warm_launches} warm, {solo_launches} "
          f"for {SERVE_CLIENTS} tenants of {per_tenant}")
    solo_prof = profile_path("serve_solo",
                             lambda: [explore(sp, **kw) for sp in spaces])
    svc = ExploreService(coalesce_window_s=0.05, device="cuda")
    try:
        def wave():
            out = {}

            def client(i):
                out[i] = explore(spaces[i], service=svc, **kw)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(SERVE_CLIENTS)]
            t_wave = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            check(not any(t.is_alive() for t in threads)
                  and len(out) == SERVE_CLIENTS, "serve wave did not end")
            return out, time.perf_counter() - t_wave

        d0 = svc.metrics()["dispatches"]
        reset_all(kernel_mods)
        wave1, wave1_s = wave()
        w1_launches, d1 = k1(), svc.metrics()["dispatches"]
        w1_clusters = {c: fs.COUNTS[f"cluster{c}_launches"]
                       for c in fs.CLUSTER_CHOICES}
        reset_all(kernel_mods)
        wave2, wave2_s = wave()
        w2_launches, d2 = k1(), svc.metrics()["dispatches"]
        metrics = svc.metrics()
        builds = stream_cache_info()["step_builds"]
        check(builds == 1, f"serve: {builds} step builds across solo and "
              f"both waves")
        w1_worst = 0.0
        for i in range(SERVE_CLIENTS):
            a, b, solo = wave1[i], wave2[i], solos[i]
            check(a.serve["coalesce_group"] == SERVE_CLIENTS
                  and a.serve["dispatch_share"] == 1 / SERVE_CLIENTS
                  and not a.serve["cache_hit"] and a.backend == "cuda",
                  f"serve wave 1 tenant {i}: {a.serve}, {a.backend}")
            check(rows_key(a) == rows_key(solo) and a.n_points
                  == solo.n_points and a.n_feasible == solo.n_feasible,
                  f"serve wave 1 tenant {i}: top-k differs from solo")
            err = worst_rel(a, solo)
            check(err <= REL, f"serve wave 1 tenant {i}: rows rel err {err}")
            w1_worst = max(w1_worst, err)
            check(b.serve["cache_hit"] and b.serve["dispatches"] == 0
                  and b.topk == a.topk, f"serve wave 2 tenant {i}: "
                  f"{b.serve}")
        check(w1_launches == SERVE_CLIENTS * per_tenant
              and d1 - d0 == SERVE_CLIENTS * segments,
              f"serve wave 1: {w1_launches} K1 launches, {d1 - d0} "
              f"dispatches")
        check(w2_launches == 0 and d2 == d1,
              f"serve wave 2: {w2_launches} K1 launches, {d2 - d1} "
              f"dispatches")
        svc.cache.clear()
        prof = profile_path("serve_wave", lambda: wave()[0])
    finally:
        svc.close()

    # ----- 2. one streaming tenant at mega_sweep's width, 3. staged ---------
    svc = ExploreService(partial_interval_s=0, device="cuda")
    try:
        reset_all(kernel_mods)
        t0 = time.perf_counter()
        h = svc.submit(space, k=3, engine="fused", chunk_size=CHUNK,
                       stream=True)
        updates = list(h.partials())
        mega = h.result(timeout=600)
        mega_s = time.perf_counter() - t0
        mega_launches = k1()
        check([u.seq for u in updates] == list(range(len(updates)))
              and all(u0.done <= u1.done
                      for u0, u1 in zip(updates, updates[1:]))
              and [u.final for u in updates]
              == [False] * (len(updates) - 1) + [True]
              and updates[-1].done == updates[-1].span == MEGA_POINTS,
              f"serve stream: updates "
              f"{[(u.seq, u.done, u.final) for u in updates]}")
        check(len(updates) == mega.dispatches == res.dispatches
              and mega.serve["partial_updates"] == len(updates),
              f"serve stream: {len(updates)} updates, {mega.dispatches} "
              f"dispatches")
        check(all(math.isfinite(r["total_j"]) for u in updates
                  for r in u.topk), "serve stream: a partial is not finite")
        check(mega.topk == res.topk
              and json.dumps(mega.summaries) == json.dumps(res.summaries)
              and (mega.n_points, mega.n_feasible)
              == (res.n_points, res.n_feasible),
              "serve stream: final != the straight fused run")
        check(mega_launches == 8 * -(-(MEGA_POINTS // 8) // CHUNK),
              f"serve stream: {mega_launches} K1 launches")

        reset_all(kernel_mods)
        t0 = time.perf_counter()
        st = svc.explore(spaces[0], k=8, engine="staged",
                         chunk_size=SERVE_CHUNK)
        staged_s = time.perf_counter() - t0
        st_launches = {"fused_sweep": k1(),
                       "grid_decode": gd.COUNTS["kernel_launches"],
                       "block_stats": sr.COUNTS["kernel_launches"],
                       "twins": sum(m.COUNTS[key] for m in kernel_mods
                                    for key in m.COUNTS if "twin" in key)}
        check(st.engine == "staged" and not st.serve["cache_hit"]
              and st_launches == {"fused_sweep": 0,
                                  "grid_decode": per_tenant,
                                  "block_stats": per_tenant, "twins": 0},
              f"serve staged: {st.engine}, {st.serve}, {st_launches}")
        staged_worst = compare_results("serve_staged_vs_fused", st,
                                       solos[0])
    finally:
        svc.close()

    serve_rps = 2 * SERVE_CLIENTS / (wave1_s + wave2_s)
    solo_rps = SERVE_CLIENTS / solo_s
    waits = [r.serve["queue_wait_s"] for r in wave1.values()]
    line = {
        "nvidia_smi": smi[0] if smi else None,
        "clients": SERVE_CLIENTS, "points_per_tenant": SERVE_POINTS,
        "chunk": SERVE_CHUNK, "k": 8, "step_builds": builds,
        "solo": {"wall_s": solo_s, "k1_launches": solo_launches,
                 "warm_k1_launches": warm_launches,
                 "dispatches": sum(r.dispatches for r in solos),
                 "eval_s": sum(r.eval_s for r in solos)},
        "wave1": {"wall_s": wave1_s, "k1_launches": w1_launches,
                  "k1_launches_by_cluster": w1_clusters,
                  "dispatches": d1 - d0,
                  "coalesce_group": wave1[0].serve["coalesce_group"],
                  "segments_per_tenant": wave1[0].serve["segments"],
                  "queue_wait_s_max": max(waits),
                  "service_s_max": max(r.serve["service_s"]
                                       for r in wave1.values()),
                  "eval_s": sum(r.eval_s for r in wave1.values()),
                  "topk_bit_equal_to_solo": True,
                  "rows_vs_solo_max_rel_err": w1_worst},
        "wave2": {"wall_s": wave2_s, "k1_launches": w2_launches,
                  "dispatches": d2 - d1,
                  "cache_hits": sum(r.serve["cache_hit"]
                                    for r in wave2.values())},
        "requests_per_s": {"solo": solo_rps, "wave1": SERVE_CLIENTS
                           / wave1_s, "serve": serve_rps},
        "serve_speedup": serve_rps / solo_rps,
        "serve_speedup_reference_floor": SERVE_MIN_SPEEDUP,
        "serve_speedup_gated": False,
        "wave1_vs_solo_speedup": solo_s / wave1_s,
        "metrics": {key: val for key, val in metrics.items()
                    if key != "cache"},
        "profile_wave": prof, "profile_solo": solo_prof,
        "mega_stream": {"points": mega.n_points, "wall_s": mega_s,
                        "eval_s": mega.eval_s,
                        "k1_launches": mega_launches,
                        "dispatches": mega.dispatches,
                        "partial_updates": len(updates),
                        "done": [u.done for u in updates],
                        "bit_equal_to_fused": True},
        "staged": {"wall_s": staged_s, "eval_s": st.eval_s,
                   "dispatches": st.dispatches, "launches": st_launches,
                   "vs_fused_max_rel_err": staged_worst},
    }
    emit({"serve_path": line})
    return line


def mesh_path(space, res, st, ch_space, ch, kmods, kernel_mods, smi
              ) -> dict:
    """P8 at full width: the batch axis split across a mesh
    (``repro_torch.launch``), each run held to the one-device result of
    the same run (top-k bit-equal, counts exact, means rel 1e-5).

    1. mega_sweep on ``make_batch_mesh()`` (every visible GPU) and on
       ``BatchMesh([cuda:0] * 4)`` (four shards on one card): fused (K1
       once a shard of every live chunk: 4 x 48 = 192 on the 4-shard
       mesh; on a one-GPU host ``make_batch_mesh()`` is a one-entry mesh,
       which takes the main path's own step and launches) and staged
       (K2 and K3a once a shard).
    Then, on the split mesh (every visible GPU where there are several,
    else the four shards of one card):
    2. the host syncs of a fused sweep, equal to the one-device sweep's
       (finalize's copies only), and a profiled pass;
    3. the chunked lane (``auto``) through ``evaluate_batch_sharded``:
       K4 once a shard of every batch;
    4. mega_sweep as a 12-shard serial campaign;
    5. one serve wave of the 8 serve_bench tenants through an
       ``ExploreService``: one coalesce group, one step, each tenant
       bit-equal to its one-device solo call.

    Each step runs with the counters zeroed just before it and read just
    after."""
    import shutil
    import tempfile
    import threading
    from repro_torch.core.shard_sweep import (stream_cache_clear,
                                              stream_cache_info)
    from repro_torch.explore import DesignSpace, explore
    from repro_torch.launch import BatchMesh, make_batch_mesh
    from repro_torch.serve import ExploreService
    fs, gd, sr, cr = (kmods[n] for n in ("fused_sweep", "grid_decode",
                                         "stream_reduce", "category_reduce"))
    n_var = MEGA_POINTS // 8
    ordinals = 8 * -(-n_var // CHUNK)            # 48 live chunk ordinals
    kw = dict(chunk_size=CHUNK, k=3)

    def same(name, a, b, n_dev):
        """``a`` on the mesh against the one-device ``b``."""
        check(a.n_devices == n_dev, f"{name}: n_devices {a.n_devices}")
        check(a.topk == b.topk, f"{name}: top-k differs from one device")
        check((a.n_points, a.n_feasible) == (b.n_points, b.n_feasible),
              f"{name}: counts {a.n_points}/{a.n_feasible} vs "
              f"{b.n_points}/{b.n_feasible}")
        worst = 0.0
        for label, sa in a.summaries.items():
            sb = b.summaries[label]
            check((sa["n"], sa["n_feasible"], sa["argmin_index"],
                   sa["metric_min"]) == (sb["n"], sb["n_feasible"],
                                         sb["argmin_index"],
                                         sb["metric_min"]),
                  f"{name}: {label} summary differs")
            if sb["n_feasible"]:
                err = abs(sa["metric_mean"] - sb["metric_mean"]) / abs(
                    sb["metric_mean"])
                check(err <= REL_MEAN, f"{name}: {label} mean rel {err}")
                worst = max(worst, err)
        return worst

    def fused(mesh, name, n_dev):
        explore(space, engine="fused", **kw)    # the one-device step
        before = stream_cache_info()["step_builds"]
        explore(space, engine="fused", mesh=mesh, **kw)       # warm-up
        reset_all(kernel_mods)
        t0 = time.perf_counter()
        out = explore(space, engine="fused", mesh=mesh, **kw)
        wall = time.perf_counter() - t0
        launches = fs.COUNTS["kernel_launches"]
        twins = fs.COUNTS["twin_calls"]
        clusters = {c: fs.COUNTS[f"cluster{c}_launches"]
                    for c in fs.CLUSTER_CHOICES}
        check(launches == n_dev * ordinals and twins == 0,
              f"{name} fused: {launches} K1 launches, {twins} twin calls, "
              f"want {n_dev} x {ordinals}")
        check(out.dispatches == res.dispatches,
              f"{name} fused: {out.dispatches} dispatches")
        worst = same(f"{name} fused", out, res, n_dev)
        return dict(eval_s=out.eval_s, wall_s=wall,
                    points_per_s=out.points_per_sec, k1_launches=launches,
                    k1_launches_by_cluster=clusters,
                    step_builds=stream_cache_info()["step_builds"] - before,
                    dispatches=out.dispatches,
                    mean_vs_one_device_max_rel_err=worst)

    def staged(mesh, name, n_dev):
        explore(space, engine="staged", mesh=mesh, **kw)      # warm-up
        reset_all(kernel_mods)
        t0 = time.perf_counter()
        out = explore(space, engine="staged", mesh=mesh, **kw)
        wall = time.perf_counter() - t0
        counts = dict(grid_decode=gd.COUNTS["kernel_launches"],
                      block_stats=sr.COUNTS["kernel_launches"],
                      twins=sum(m.COUNTS[key] for m in kernel_mods
                                for key in m.COUNTS if "twin" in key))
        check(counts == dict(grid_decode=n_dev * st.dispatches,
                             block_stats=n_dev * st.dispatches, twins=0)
              and out.dispatches == st.dispatches,
              f"{name} staged: launches {counts}, {out.dispatches} "
              f"dispatches")
        worst = same(f"{name} staged", out, st, n_dev)
        return dict(eval_s=out.eval_s, wall_s=wall,
                    points_per_s=out.points_per_sec,
                    dispatches=out.dispatches,
                    mean_vs_one_device_max_rel_err=worst, **{
                        f"{k}_launches": v for k, v in counts.items()})

    visible = make_batch_mesh()
    four = BatchMesh([torch.device("cuda", 0)] * 4)
    split = visible if visible.size > 1 else four
    n = split.size
    name = ("cuda:0-" + str(n - 1) if split is visible
            else "4 x cuda:0")
    print(f"mesh_path: make_batch_mesh() spans {visible.size} visible "
          f"GPU(s); BatchMesh([cuda:0] * 4) four shards on one card; "
          f"campaign, serve and chunked on {name}", flush=True)
    line = {"nvidia_smi": smi, "visible_gpus": visible.size,
            "points": MEGA_POINTS, "chunk": CHUNK, "k": 3,
            "split_mesh": name}
    line["visible_fused"] = fused(visible, "make_batch_mesh()",
                                  visible.size)
    if visible.size == 1:
        check(line["visible_fused"]["step_builds"] == 0,
              "a one-entry mesh built a step of its own")
    line["visible_staged"] = staged(visible, "make_batch_mesh()",
                                    visible.size)
    line["mesh4_fused"] = fused(four, "4 x cuda:0", 4)
    line["mesh4_staged"] = staged(four, "4 x cuda:0", 4)

    # 2. host syncs: the one-device sweep's and the split's, in finalize
    # only; a profiled pass
    one_syncs = count_syncs(lambda: explore(space, engine="fused", **kw))
    split_syncs = count_syncs(lambda: explore(space, engine="fused",
                                              mesh=split, **kw))
    check(split_syncs == one_syncs and split_syncs < ordinals,
          f"{name} fused: {split_syncs} host syncs, one device "
          f"{one_syncs}")
    line["split_host_syncs"] = split_syncs
    line["one_device_host_syncs"] = one_syncs
    line["split_fused_profile"] = profile_path(
        "split_fused", lambda: explore(space, engine="fused", mesh=split,
                                       **kw))

    # 3. the chunked lane through evaluate_batch_sharded
    explore(ch_space, k=3, mesh=split)                         # warm-up
    reset_all(kernel_mods)
    t0 = time.perf_counter()
    ch_n = explore(ch_space, k=3, mesh=split)
    ch_wall = time.perf_counter() - t0
    k4 = (cr.COUNTS["kernel_launches"], cr.COUNTS["twin_calls"])
    n_batches = 5 * -(-(CHUNKED_POINTS // 5) // CHUNK)
    check(ch_n.engine == "chunked" and k4 == (n * n_batches, 0),
          f"{name} chunked: {ch_n.engine}, K4 launches/twin {k4}")
    line["split_chunked"] = dict(
        points=ch_n.n_points, eval_s=ch_n.eval_s, wall_s=ch_wall,
        k4_launches=k4[0], batches=n_batches,
        mean_vs_one_device_max_rel_err=same(f"{name} chunked", ch_n, ch,
                                            n))

    # 4. a 12-shard serial campaign
    root = Path(__file__).resolve().parent / "build" / "campaigns"
    root.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=root))
    try:
        reset_all(kernel_mods)
        stream_cache_clear()
        t0 = time.perf_counter()
        camp = explore(space, engine="fused", mesh=split,
                       checkpoint_dir=str(work / "mesh"), **kw)
        camp_wall = time.perf_counter() - t0
        rep, counts = camp.campaign, stream_cache_info()
        manifest = json.loads((work / "mesh" / "manifest.json").read_text())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(rep["n_planned"] == rep["n_executed"] == 12 and not rep["partial"]
          and counts["preps"] == 1 and counts["twin_calls"] == 0
          and manifest["torch"]["n_devices"] == n,
          f"{name} campaign: {rep['n_executed']} shards, {counts}")
    line["split_campaign"] = dict(
        shards=rep["n_planned"], wall_s=camp_wall, eval_s=camp.eval_s,
        dispatches=camp.dispatches, k1_launches=counts["kernel_launches"],
        preps=counts["preps"],
        mean_vs_one_device_max_rel_err=same(f"{name} campaign", camp, res,
                                            n))

    # 5. one serve wave of the 8 serve_bench tenants
    spaces = [DesignSpace(["edgaze"], dict(SERVE_GRIDS, vdd_scale=[
        0.80 + 0.002 * i, 1.0])) for i in range(SERVE_CLIENTS)]
    skw = dict(k=8, engine="fused", chunk_size=SERVE_CHUNK)
    solos = [explore(sp, **skw) for sp in spaces]
    per_tenant = 5 * -(-(SERVE_POINTS // 5) // SERVE_CHUNK)
    stream_cache_clear()
    with ExploreService(coalesce_window_s=0.05, mesh=split) as svc:
        explore(spaces[0], service=svc, **skw)                # warm
        svc.cache.clear()
        out = {}

        def client(i):
            out[i] = explore(spaces[i], service=svc, **skw)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        reset_all(kernel_mods)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wave_s = time.perf_counter() - t0
        launches = fs.COUNTS["kernel_launches"]
    check(len(out) == SERVE_CLIENTS and stream_cache_info()[
        "step_builds"] == 1, f"{name} serve: {len(out)} tenants, "
          f"{stream_cache_info()['step_builds']} step builds")
    check(launches == n * SERVE_CLIENTS * per_tenant,
          f"{name} serve: {launches} K1 launches")
    for i, r in out.items():
        check(r.serve["coalesce_group"] == SERVE_CLIENTS,
              f"{name} serve tenant {i}: {r.serve}")
        same(f"{name} serve tenant {i}", r, solos[i], n)
    line["split_serve_wave"] = dict(
        clients=SERVE_CLIENTS, wall_s=wave_s, k1_launches=launches,
        eval_s=sum(r.eval_s for r in out.values()),
        requests_per_s=SERVE_CLIENTS / wave_s, bit_equal_to_solo=True)
    line["launches"] = dict(
        fused_sweep=line["visible_fused"]["k1_launches"]
        + line["mesh4_fused"]["k1_launches"]
        + line["split_campaign"]["k1_launches"] + launches,
        grid_decode=line["visible_staged"]["grid_decode_launches"]
        + line["mesh4_staged"]["grid_decode_launches"],
        block_stats=line["visible_staged"]["block_stats_launches"]
        + line["mesh4_staged"]["block_stats_launches"],
        category_reduce=k4[0])
    emit({"mesh_path": line})
    return line


def profile_path(name, run) -> dict:
    """torch.profiler over one sweep ``run()``: device time by kernel
    name and the device's busy share of the sweep's wall time; writes
    the chrome trace to build/traces/trace_<name>.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = Path(__file__).resolve().parent / "build" / "traces"
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(out / f"trace_{name}.json"))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    by_name, busy, reach = {}, 0.0, None
    for start, end, kname in spans:
        by_name[kname] = by_name.get(kname, 0.0) + (end - start)
        if reach is None or start >= reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    by_class = {}
    for kname, us in by_name.items():
        cls = next((c for c, keys in KERNEL_CLASSES if any(
            k in kname for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us * 1e-6
    rec = {"wall_s": wall, "eval_s": getattr(res, "eval_s", None),
           "device_kernels": len(spans), "device_busy_s": busy * 1e-6,
           "device_busy_share_of_wall": busy * 1e-6 / wall,
           "device_s_by_kernel": {k[:80]: us * 1e-6 for k, us in top},
           "device_s_by_class": by_class}
    emit({f"profile_{name}": rec})
    return rec


def count_syncs(run) -> int:
    """Host syncs of one ``run()``, under the sync debug mode (which
    slows every op, so never in a timed run)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


# ---------------------------------------------------------------------------
# K5-K8 and the functional path
# ---------------------------------------------------------------------------
def exact_case(name, ker, twin):
    """A kernel against its twin on the same inputs: bit-equal."""
    k = ker()
    torch.cuda.synchronize()
    t = twin()
    diff = float((k.float() - t.float()).abs().max()) if k.numel() else 0.0
    check(k.shape == t.shape and k.dtype == t.dtype and torch.equal(k, t),
          f"{name}: differs from its twin by {diff}")
    rec = dict(case=name, shape=list(k.shape), dtype=str(k.dtype),
               max_abs_err=diff)
    emit({"kernel_vs_twin": rec})
    return rec


def gaussian(shape, seed, dtype=torch.float32):
    """Seeded normal values on the card, made in f32 and rounded to
    ``dtype`` (numpy has no bf16)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(dtype).cuda()


def frame(shape, seed, dtype=torch.float32, offset=False):
    """:func:`gaussian` values; ``offset``: as a contiguous view one
    element past a 16-byte boundary (no 16-byte copies)."""
    x = gaussian(shape, seed, dtype)
    if not offset:
        return x
    flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    view = flat[1:].view(shape)
    view.copy_(x)
    check(view.is_contiguous() and view.data_ptr() % 16 != 0,
          "offset view is aligned")
    return view


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def matmul_case(mm, *, name, m, k, n, seed, dtypes=(torch.float32,) * 2,
                positive=False, offset=False):
    """K8 against its twin: |kernel - twin| <= 1e-5 * (|a| @ |b|)
    elementwise (another summation order), plus one unit in the last place
    of an f16 or bf16 output (each side rounds its f32 sum once), equal
    from run to run, and one launch on the route that :func:`plan` picks.
    ``positive``: operands uniform in [0, 1), where a truncating
    accumulator's bias adds up along K; ``offset``: ``a`` is a contiguous
    view 2 or 4 bytes past a 16-byte boundary (no TMA base)."""
    from repro_torch.testing import ulp
    if positive:
        rng = np.random.default_rng(seed)
        a, b = (torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
                .to(dt).cuda() for shape, dt in (((m, k), dtypes[0]),
                                                 ((k, n), dtypes[1])))
    else:
        a = gaussian((m, k), seed, dtypes[0])
        b = gaussian((k, n), seed + 1, dtypes[1])
    if offset:
        flat = torch.empty(m * k + 1, dtype=a.dtype, device="cuda")
        a = flat[1:].view(m, k).copy_(a)
        check(a.is_contiguous() and a.data_ptr() % 16 != 0,
              f"{name}: the view is aligned")
    route = mm.plan(m, n, k, a.dtype, b.dtype,
                    a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
                    torch.cuda.get_device_properties(0).multi_processor_count
                    ).route
    mm.reset_counts()
    ker = mm.matmul(a, b)
    check(mm.COUNTS[f"{route}_launches"] == mm.COUNTS["kernel_launches"]
          == 1, f"{name}: launches {mm.COUNTS} (route {route})")
    again = mm.matmul(a, b)
    torch.cuda.synchronize()
    twin = mm.matmul_torch(a, b)
    check(ker.dtype == twin.dtype == dtypes[0], f"{name}: output dtype")
    bound = MATMUL_RULE * (a.double().abs() @ b.double().abs())
    if dtypes[0] != torch.float32:
        bound = bound + ulp(torch.maximum(ker.abs(), twin.abs()), dtypes[0])
    err = (ker.double() - twin.double()).abs()
    ratio = float((err / bound.clamp_min(1e-300)).max()) \
        if err.numel() else 0.0
    check(ratio <= 1.0, f"{name}: matmul off its twin by {ratio} x the rule")
    check(torch.equal(ker, again), f"{name}: matmul differs run to run")
    rec = dict(case=name, mkn=[m, k, n],
               dtypes=[dtype_name(d) for d in dtypes], route=route,
               max_abs_err=float(err.max()) if err.numel() else 0.0,
               max_err_over_rule=ratio)
    if positive and route == "wgmma":
        rec["f32_sums_over_rule"] = wgmma_f32_sums(mm, a, b, name)
    emit({"kernel_vs_twin": rec})
    return rec


def wgmma_f32_sums(mm, a, b, name):
    """The wgmma route's own f32 sums, before the output's rounding hides
    them: a two-way split plan writes them to an f32 scratch, added here
    in f64, held to 1e-5 * (|a| @ |b|) of the twin's f32 sums."""
    (m, k), n = a.shape, b.shape[1]
    depth = -(-k // 2 // 64) * 64
    part = torch.empty((2, m, n), dtype=torch.float32, device="cuda")
    mm.run(a, b, mm.Plan("wgmma", 64, 2, depth), part=part)
    torch.cuda.synchronize()
    got = part.double().sum(0)
    twin = mm.matmul_torch(a.float(), b.float()).double()
    ratio = float(((got - twin).abs()
                   / (MATMUL_RULE * (a.double().abs() @ b.double().abs()))
                   ).max())
    check(ratio <= 1.0, f"{name}: the wgmma route's f32 sums off the twin's "
          f"by {ratio} x the rule")
    return ratio


def functional_kernel_cases(fmods):
    """K5-K8 against their twins at the functional path's shapes and at
    ragged ones; returns the records by kernel."""
    bn, sc, fe, mm = (fmods[name] for name in FUNC_KERNELS)
    cases = {"binning": [], "stencil_conv": [], "frame_event": [],
             "matmul": []}
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # (shape, factor, dtype, offset view, the route the plan must pick):
    # the path's frames, odd crops, rows that are no whole 16-byte vector
    # (and output rows that are none), and a base 4 (f32) or 2 (f16/bf16)
    # bytes past one
    for shape, f, dt, off, want in (
            ((400, 640), 2, f32, False, "vec2"),
            ((720, 1280), 2, f32, False, "vec2"),
            ((17, 33), 3, f32, False, "scalar"),
            ((17, 33), 4, f32, False, "scalar"),
            ((17, 33), 2, f16, False, "scalar"),
            ((720, 1280), 2, f16, False, "vec2"),
            ((17, 33), 3, bf16, False, "scalar"),
            ((720, 1280), 2, bf16, False, "vec2"),
            ((63, 72), 2, f32, False, "vec2"),
            ((41, 1288), 2, f32, False, "vec2"),
            ((40, 1284), 2, f32, False, "vec2"),
            ((40, 1282), 2, f32, False, "scalar"),
            ((31, 1296), 2, bf16, False, "vec2"),
            ((31, 1300), 2, f16, False, "scalar"),
            ((9, 8), 2, f16, False, "vec2"),
            ((720, 1280), 2, f32, True, "scalar"),
            ((400, 640), 2, bf16, True, "scalar")):
        x = frame(shape, sum(shape) + f, dt, off)
        route = bn.plan(shape[1], f, dt, x.data_ptr() % 16 == 0)
        check(route == want, f"binning {shape} f{f} {dt}: route {route}")
        bn.reset_counts()
        cases["binning"].append(exact_case(
            f"binning_{shape[0]}x{shape[1]}_f{f}_{dtype_name(dt)}"
            f"{'_offset' if off else ''}",
            lambda: bn.binning(x, f), lambda: bn.binning_torch(x, f)))
        check(bn.COUNTS[f"{route}_launches"] == bn.COUNTS["kernel_launches"]
              == 1, f"binning {shape}: launches {bn.COUNTS}")
        cases["binning"][-1]["route"] = route
    # the kernel sums in f32: its twin is the f32 sum rounded once.
    # (shape, stencil, frame and tap dtypes, offset view, route): the path's
    # frames; output rows one either side of a multiple of the planned
    # tile's (16 or 32 rows at 8388 columns, 8 at small frames), and
    # columns two either side (64 f32, 128 bf16: a 16-byte row pitch leaves
    # ow = w - 2 even); each stencil size; rows that are no whole 16-byte
    # vector; offset views
    for shape, k, dt, taps_dt, off, want in (
            ((360, 640), (3, 3), f32, f32, False, "k3x3"),
            ((720, 1280), (3, 3), f32, f32, False, "k3x3"),
            ((65, 8388), (3, 3), f32, f32, False, "k3x3"),
            ((66, 8388), (3, 3), f32, f32, False, "k3x3"),
            ((67, 8388), (3, 3), f32, f32, False, "k3x3"),
            ((9, 64), (3, 3), f32, f32, False, "k3x3"),
            ((10, 68), (3, 3), f32, f32, False, "k3x3"),
            ((11, 128), (3, 3), bf16, bf16, False, "k3x3"),
            ((9, 136), (3, 3), bf16, f32, False, "k3x3"),
            ((100, 140), (3, 5), f32, f32, False, "generic"),
            ((77, 48), (5, 5), f32, f32, False, "generic"),
            ((77, 45), (5, 5), f32, f32, False, "scalar"),
            ((1000, 36), (2, 2), f32, f32, False, "generic"),
            ((1000, 33), (2, 2), f32, f32, False, "scalar"),
            ((33, 72), (1, 1), f32, f32, False, "generic"),
            ((720, 1280), (3, 3), f16, f32, False, "k3x3"),
            ((720, 1280), (3, 3), bf16, f32, False, "k3x3"),
            ((720, 1280), (3, 3), f16, f16, False, "k3x3"),
            ((720, 1280), (3, 3), bf16, bf16, False, "k3x3"),
            ((77, 45), (5, 5), bf16, bf16, False, "scalar"),
            ((77, 48), (5, 5), f16, f32, False, "generic"),
            ((360, 640), (3, 3), f32, f32, True, "scalar"),
            ((720, 1280), (3, 3), bf16, bf16, True, "scalar")):
        x = frame(shape, shape[0], dt, off)
        taps = gaussian(k, 10 * k[0] + k[1], taps_dt)
        p = sc.plan(*shape, *k, dt, x.data_ptr() % 16 == 0, n_sm)
        check(p.route == want, f"stencil {shape} {k} {dt}: route {p.route}")
        sc.reset_counts()
        cases["stencil_conv"].append(exact_case(
            f"stencil_{shape[0]}x{shape[1]}_k{k[0]}x{k[1]}_"
            f"{dtype_name(dt)}_taps_{dtype_name(taps_dt)}"
            f"{'_offset' if off else ''}",
            lambda: sc.stencil_conv(x, taps),
            lambda: sc.stencil_conv_torch(x, taps, acc_dtype=f32)))
        check(sc.COUNTS[f"{p.route}_launches"]
              == sc.COUNTS["kernel_launches"] == 1,
              f"stencil {shape}: launches {sc.COUNTS}")
        cases["stencil_conv"][-1].update(route=p.route, plan=p._asdict())
    # (shape, dtype, threshold, offset views, the route the plan must
    # pick): the path's frame in each dtype, ragged frames, frames of one
    # 16-byte vector (the launch floor's), offset views
    for shape, dt, t, off, want in (
            ((200, 320), f32, EDGAZE_THRESHOLD, False, "vec4"),
            ((200, 320), f16, EDGAZE_THRESHOLD, False, "vec8"),
            ((200, 320), bf16, EDGAZE_THRESHOLD, False, "vec8"),
            ((33, 47), f32, 0.5, False, "scalar"),
            ((33, 47), f16, 0.5, False, "scalar"),
            ((33, 47), bf16, 0.5, False, "scalar"),
            ((1, 3), f32, 0.5, False, "scalar"),
            ((1, 3), bf16, 0.5, False, "scalar"),
            ((1, 4), f32, 0.5, False, "vec4"),
            ((1, 8), bf16, 0.5, False, "vec8"),
            ((400, 640), f32, 0.5, False, "vec4"),
            ((200, 320), f32, EDGAZE_THRESHOLD, True, "scalar"),
            ((200, 320), bf16, EDGAZE_THRESHOLD, True, "scalar")):
        cur, prev = frame(shape, 1, dt, off), frame(shape, 2, dt, off)
        fe.reset_counts()
        cases["frame_event"].append(exact_case(
            f"frame_event_{shape[0]}x{shape[1]}_{dtype_name(dt)}"
            f"{'_offset' if off else ''}",
            lambda: fe.frame_event(cur, prev, t),
            lambda: fe.frame_event_torch(cur, prev, t)))
        check(fe.COUNTS[f"{want}_launches"] == fe.COUNTS["kernel_launches"]
              == 1, f"frame_event {shape} {dt}: launches {fe.COUNTS}, want "
              f"one on {want}")
        cases["frame_event"][-1]["route"] = want
    # the f32 rounding case: f32(0.7) - 0 >= 0.7 is an event; NaN is not;
    # on the scalar route (3 elements) and on each 16-byte one
    for dt, n, want in ((f32, 3, "scalar"), (f32, 8, "vec4"),
                        (f16, 8, "vec8"), (bf16, 16, "vec8")):
        cur = torch.zeros((1, n), device="cuda", dtype=dt)
        cur[0, :3] = torch.tensor([0.7, float("nan"), 0.69999])
        prev = torch.zeros_like(cur)
        fe.reset_counts()
        rec = exact_case(f"frame_event_threshold_and_nan_{dtype_name(dt)}_"
                         f"{want}", lambda: fe.frame_event(cur, prev, 0.7),
                         lambda: fe.frame_event_torch(cur, prev, 0.7))
        check(fe.COUNTS[f"{want}_launches"] == 1,
              f"frame_event threshold case: launches {fe.COUNTS}")
        if dt == f32:
            check(fe.frame_event(cur, prev, 0.7)[0, :3].tolist()
                  == [1.0, 0.0, 0.0], "frame_event: 0.7 rounding case")
        rec["route"] = want
        cases["frame_event"].append(rec)
    # (m, k, n), dtypes, the route the plan must pick, and the options:
    # ragged M and N, K % 64 != 0 and split K on the wgmma route; positive
    # operands at K = 16384; an offset view, which must take the tile route
    for (m, k, n), dts, want, opts in (
            ((1, 64000, 900), (f32, f32), "skinny", {}),
            ((1, 900, 2), (f32, f32), "skinny", {}),
            ((130, 150, 70), (f32, f32), "tile", {}),
            ((1, 64, 1), (f32, f32), "skinny", {}),
            ((1024, 1024, 1024), (f32, f32), "tile", {}),
            ((7, 5000, 333), (f32, f32), "skinny", {}),
            ((1, 64000, 900), (bf16, bf16), "skinny", {}),
            ((1, 64000, 900), (f16, f16), "skinny", {}),
            ((1024, 1024, 1024), (bf16, bf16), "wgmma", {}),
            ((1024, 1024, 1024), (f16, f16), "wgmma", {}),
            ((4096, 4096, 4096), (bf16, bf16), "wgmma", {}),
            ((130, 150, 70), (bf16, f32), "tile", {}),
            ((7, 5000, 333), (f32, f16), "skinny", {}),
            ((130, 72, 1000), (f16, f16), "wgmma", {}),
            ((130, 72, 1000), (bf16, bf16), "wgmma", {}),
            ((9, 1024, 4096), (f16, f16), "wgmma", {}),
            ((9, 1024, 4096), (bf16, bf16), "wgmma", {}),
            ((1000, 200, 4104), (f16, f16), "wgmma", {}),
            ((1000, 200, 4104), (bf16, bf16), "wgmma", {}),
            ((256, 16384, 256), (f16, f16), "wgmma", dict(positive=True)),
            ((256, 16384, 256), (bf16, bf16), "wgmma", dict(positive=True)),
            ((1024, 1024, 1024), (f32, f32), "tile", dict(positive=True)),
            ((130, 64, 72), (bf16, bf16), "tile", dict(offset=True)),
            ((1000, 200, 4104), (f16, f16), "tile", dict(offset=True))):
        tag = "" if dts == (f32, f32) else \
            f"_{dtype_name(dts[0])}@{dtype_name(dts[1])}"
        tag += "".join(f"_{key}" for key in opts)
        rec = matmul_case(mm, name=f"matmul_{m}x{k}x{n}{tag}", m=m, k=k,
                          n=n, seed=m + k + n, dtypes=dts, **opts)
        check(rec["route"] == want, f"{rec['case']}: route {rec['route']}, "
              f"not {want}")
        cases["matmul"].append(rec)
    return cases


def scene(n_frames, h, w, seed):
    """``n_frames`` [h, w] frames in [0, 0.9] of a still texture with a
    bright disk circling over it (the moving eye or object that makes
    events); numpy from a seed, moved to the card in one copy."""
    rng = np.random.default_rng(seed)
    texture = 0.3 * rng.uniform(size=(h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n_frames, h, w), np.float32)
    r2 = (0.12 * min(h, w)) ** 2
    for t in range(n_frames):
        phase = 2 * math.pi * t / n_frames
        cy = h / 2 + 0.25 * h * math.sin(phase)
        cx = w / 2 + 0.3 * w * math.cos(phase)
        frames[t] = texture + 0.6 * (((yy - cy) ** 2 + (xx - cx) ** 2)
                                     <= r2)
    return torch.from_numpy(frames).cuda()


def functional_counts(mods):
    return {name: dict(mod.COUNTS) for name, mod in mods.items()}


def timed_frames(run):
    """``run()`` under the host clock, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kept = run()
    torch.cuda.synchronize()
    return kept, time.perf_counter() - t0


def dnn_rule(x, w1, w2, hidden):
    """The matmul rule through both DNN layers, in f64 on the host:
    1e-5 * ((|x| @ |w1|) @ |w2| + |relu(h)| @ |w2|)."""
    x, w1, w2 = (np.abs(np.asarray(t, np.float64)) for t in (x, w1, w2))
    h = np.maximum(np.asarray(hidden, np.float64), 0)
    return MATMUL_RULE * ((x @ w1) @ w2 + h @ w2)


def functional_path(fmods, kernel_mods):
    """Ed-Gaze, Fig. 5 and Rhythmic, 30 frames each, with the launch
    counters zeroed just before each and read just after; the first 2
    frames of each against the port on the CPU.  Returns the record, a
    ``run_all`` for the profiler and the path's inputs (for timing)."""
    from repro_torch import functional as fn
    from repro_torch.core.usecases import edgaze, rhythmic
    hidden = int(edgaze.DNN_MACS / (edgaze.DH * edgaze.DW))
    rng = np.random.default_rng(13)
    n_in = edgaze.DH * edgaze.DW
    w1_np = (rng.standard_normal((n_in, hidden), dtype=np.float32)
             / np.float32(math.sqrt(n_in)))
    w2_np = rng.standard_normal((hidden, 2), dtype=np.float32)
    w1, w2 = fn.params_from_reference(w1_np, w2_np, "cuda")
    eg_frames = scene(FUNC_FRAMES, edgaze.H, edgaze.W, 21)
    rh_frames = scene(FUNC_FRAMES, rhythmic.H, rhythmic.W, 22)

    def run_edgaze(n=FUNC_FRAMES):
        gen = torch.Generator(device="cuda").manual_seed(5)
        prev = torch.zeros(edgaze.DH, edgaze.DW, device="cuda")
        kept = []
        for t in range(n):
            noisy = fn.with_thermal_noise(gen, eg_frames[t],
                                          FUNC_CAPACITANCE)
            events, prev = fn.edgaze_frontend(noisy, prev,
                                              threshold=EDGAZE_THRESHOLD)
            out = fn.simple_dnn(events, w1, w2)
            if t < FUNC_COMPARED:
                kept.append((noisy, events, prev, out))
        return kept

    def run_fig5(n=FUNC_FRAMES):
        kept = []
        for t in range(n):
            out = fn.fig5_pipeline(rh_frames[t])
            if t < FUNC_COMPARED:
                kept.append(out)
        return kept

    def run_rhythmic(n=FUNC_FRAMES):
        kept = []
        for t in range(n):
            out = fn.rhythmic_pixel_frontend(rh_frames[t], tile=RHYTHMIC_TILE,
                                             keep_fraction=RHYTHMIC_KEEP)
            if t < FUNC_COMPARED:
                kept.append(out)
        return kept

    expected = {"edgaze": {"binning": 1, "frame_event": 1, "matmul": 2},
                "fig5": {"binning": 1, "stencil_conv": 2},
                "rhythmic": {"stencil_conv": 2}}
    rec, kept = {}, {}
    for name, run in (("edgaze", run_edgaze), ("fig5", run_fig5),
                      ("rhythmic", run_rhythmic)):
        run(2)                                    # warm-up
        reset_all(kernel_mods)
        kept[name], wall = timed_frames(run)
        counts = functional_counts(fmods)
        twins = sum(m.COUNTS[k] for m in kernel_mods for k in m.COUNTS
                    if "twin" in k)
        launches = {k: c["kernel_launches"] for k, c in counts.items()}
        want = {k: FUNC_FRAMES * expected[name].get(k, 0) for k in fmods}
        check(launches == want and twins == 0,
              f"functional {name}: launches {launches} (want {want}), "
              f"{twins} twin calls")
        # the DNN's two products (M = 1) both run the skinny kernel; the
        # frames (fresh, aligned allocations) bin on vec2, take their
        # Sobel stencils on k3x3 and their events on vec4
        routes = {mod: {r[:-len("_launches")]: c for r, c in cs.items()
                        if r.endswith("_launches") and r != "kernel_launches"}
                  for mod, cs in counts.items()}
        check(routes["matmul"]["skinny"] == launches["matmul"]
              and routes["binning"]["vec2"] == launches["binning"]
              and routes["stencil_conv"]["k3x3"] == launches["stencil_conv"]
              and routes["frame_event"]["vec4"] == launches["frame_event"],
              f"functional {name}: routes {routes}")
        rec[name] = {"frames": FUNC_FRAMES, "wall_s": wall,
                     "frames_per_s": FUNC_FRAMES / wall,
                     "kernel_launches": launches, "twin_calls": twins,
                     "route_launches": routes,
                     "launches_per_frame": expected[name]}

    # the first frames against the same pipelines on the CPU
    w1_c, w2_c = fn.params_from_reference(w1_np, w2_np, "cpu")
    prev_c = torch.zeros(edgaze.DH, edgaze.DW)
    err = {"events": 0.0, "binned": 0.0, "dnn": 0.0}
    rule_ratio = 0.0
    for noisy, events, binned, out in kept["edgaze"]:
        ev_c, prev_c = fn.edgaze_frontend(noisy.cpu(), prev_c,
                                          threshold=EDGAZE_THRESHOLD)
        out_c = fn.simple_dnn(ev_c, w1_c, w2_c)
        check(torch.equal(events.cpu(), ev_c)
              and torch.equal(binned.cpu(), prev_c),
              "edgaze: events or binned frame differ from the CPU run")
        check(out.shape == (1, 2) and bool(torch.isfinite(out).all()),
              "edgaze: DNN output not finite [1, 2]")
        x = ev_c.reshape(1, -1).numpy()
        hidden_c = x.astype(np.float64) @ w1_np.astype(np.float64)
        bound = dnn_rule(x, w1_np, w2_np, hidden_c)
        d = np.abs(out.cpu().double().numpy() - out_c.double().numpy())
        rule_ratio = max(rule_ratio, float((d / bound).max()))
        err["dnn"] = max(err["dnn"], float(d.max()))
    check(rule_ratio <= 1.0, f"edgaze: DNN off the CPU run by {rule_ratio} "
          f"x the matmul rule")
    events_per_frame = float(kept["edgaze"][-1][1].sum())
    check(0 < events_per_frame < edgaze.DH * edgaze.DW,
          f"edgaze: {events_per_frame} events in a frame")
    for t, out in enumerate(kept["fig5"]):
        want = fn.fig5_pipeline(rh_frames[t].cpu())
        check(out.shape == (rhythmic.H // 2 - 2, rhythmic.W // 2 - 2)
              and torch.equal(out.cpu(), want),
              "fig5: edge map differs from the CPU run")
    for t, out in enumerate(kept["rhythmic"]):
        want = fn.rhythmic_pixel_frontend(rh_frames[t].cpu(),
                                          tile=RHYTHMIC_TILE,
                                          keep_fraction=RHYTHMIC_KEEP)
        check(out.shape == (rhythmic.H, rhythmic.W)
              and torch.equal(out.cpu(), want),
              "rhythmic: output differs from the CPU run")
    kept_share = float((kept["rhythmic"][0] != 0).float().mean())
    rec["edgaze"].update(frame=[edgaze.H, edgaze.W], dnn=[n_in, hidden, 2],
                         capacitance_f=FUNC_CAPACITANCE,
                         events_in_frame_2=events_per_frame,
                         vs_cpu_max_abs_err=err,
                         dnn_err_over_rule=rule_ratio)
    rec["fig5"].update(frame=[rhythmic.H, rhythmic.W], vs_cpu_max_abs_err=0.0)
    rec["rhythmic"].update(frame=[rhythmic.H, rhythmic.W],
                           tile=RHYTHMIC_TILE, kept_pixel_share=kept_share,
                           vs_cpu_max_abs_err=0.0)
    rec["compared_frames"] = FUNC_COMPARED
    emit({"functional_path": rec})

    def run_all():
        t0 = time.perf_counter()
        run_edgaze()
        run_fig5()
        run_rhythmic()
        torch.cuda.synchronize()
        return SimpleNamespace(eval_s=time.perf_counter() - t0)

    shapes = dict(eg_frames=eg_frames, rh_frames=rh_frames, w1=w1, w2=w2)
    return rec, run_all, shapes


def functional_timing(fmods, inputs):
    """ms, device ms, plain and library ms and the bound of K5-K8 at the
    functional path's shapes, in f32 and again in f16 and bf16; the first
    shape of each is its headline."""
    import torch.nn.functional as F
    bn, sc, fe, mm = (fmods[name] for name in FUNC_KERNELS)
    eg, rh = inputs["eg_frames"][0], inputs["rh_frames"][0]
    binned = bn.binning(rh, 2)
    sobel = torch.tensor([[1., 0., -1.], [2., 0., -2.], [1., 0., -1.]],
                         device="cuda")
    ev_a, ev_b = bn.binning(eg, 2), bn.binning(inputs["eg_frames"][1], 2)
    events = fe.frame_event(ev_a, ev_b, EDGAZE_THRESHOLD).reshape(1, -1)
    hidden = torch.relu(mm.matmul(events, inputs["w1"]))
    big_a, big_b = gaussian((1024, 1024), 1), gaussian((1024, 1024), 2)
    huge_a = gaussian((4096, 4096), 3, torch.bfloat16)
    huge_b = gaussian((4096, 4096), 4, torch.bfloat16)
    halves = (torch.float16, torch.bfloat16)

    def label(shape, x):
        return shape if x.dtype == torch.float32 else \
            f"{shape} {dtype_name(x.dtype)}"

    def binning_row(x, f):
        h, w = x.shape
        n_out = (h // f) * (w // f)
        return (label(f"{h}x{w} f{f}", x), lambda: bn.binning(x, f),
                lambda: bn.binning_torch(x, f),
                lambda: F.avg_pool2d(x[None, None], f),
                x.element_size() * n_out * (f * f + 1), n_out * (f * f + 1))

    def stencil_row(x, k):
        (h, w), (kh, kw) = x.shape, k.shape
        n_out = (h - kh + 1) * (w - kw + 1)
        k_lib = k.to(x.dtype)
        return (label(f"{h}x{w} k{kh}x{kw}", x), lambda: sc.stencil_conv(x, k),
                lambda: sc.stencil_conv_torch(x, k, acc_dtype=torch.float32),
                lambda: F.conv2d(x[None, None], k_lib[None, None]),
                x.element_size() * (h * w + n_out) + 4 * kh * kw,
                2 * kh * kw * n_out)

    def event_row(a, b):
        return (label(f"{a.shape[0]}x{a.shape[1]}", a),
                lambda: fe.frame_event(a, b, EDGAZE_THRESHOLD),
                lambda: fe.frame_event_torch(a, b, EDGAZE_THRESHOLD),
                None, 3 * a.element_size() * a.numel(), 3 * a.numel())

    def matmul_row(a, b, plain_reps=5):
        (m, k), n = a.shape, b.shape[1]
        ops = 2 * m * n * k
        halves_only = a.dtype == b.dtype and a.dtype in halves
        return (label(f"{m}x{k}x{n}", a), lambda: mm.matmul(a, b),
                lambda: mm.matmul_torch(a, b), lambda: torch.matmul(a, b),
                a.element_size() * (m * k + m * n) + b.element_size() * k * n,
                (0, ops) if halves_only else (ops, 0), plain_reps)

    rows = {
        "binning": ("binning",
                    [binning_row(rh, 2), binning_row(eg, 2)]
                    + [binning_row(rh.to(dt), 2) for dt in halves]),
        "stencil_conv": ("stencil_",
                         [stencil_row(rh, sobel),
                          stencil_row(binned, sobel)]
                         + [stencil_row(rh.to(dt), sobel)
                            for dt in halves]),
        "frame_event": ("frame_event", [event_row(ev_a, ev_b)]
                        + [event_row(ev_a.to(dt), ev_b.to(dt))
                           for dt in halves]),
        "matmul": ("matmul_", [matmul_row(events, inputs["w1"]),
                               matmul_row(hidden, inputs["w2"]),
                               matmul_row(big_a, big_b)]
                   + [matmul_row(x.to(dt), w.to(dt)) for dt in halves
                      for x, w in ((events, inputs["w1"]),
                                   (big_a, big_b))]
                   + [matmul_row(huge_a, huge_b, plain_reps=1)]),
    }
    out = {}
    for name, (needle, shape_rows) in rows.items():
        out[name] = [timing_row(label_, ker, plain, lib, nbytes, nops,
                                needle, plain_reps=rest[0] if rest else 5)
                     for label_, ker, plain, lib, nbytes, nops, *rest
                     in shape_rows]
    out["matmul_probe"] = matmul_probe(mm, events, inputs["w1"], hidden,
                                       inputs["w2"], big_a, big_b)
    out["stencil_conv_probe"] = stencil_probe(sc, sobel, {
        "720x1280": rh, "360x640": binned,
        "720x1280 bf16": rh.to(torch.bfloat16)})
    return out


def stencil_probe(sc, taps, frames):
    """What K6's tile choice costs, measured here: device ms of each
    ``rows`` (output rows a thread) of the frame's route at each frame,
    every plan's output bit-equal to the twin; and the plan the wrapper
    picks."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rec = {}
    for label_, x in frames.items():
        (h, w), (kh, kw) = x.shape, taps.shape
        chosen = sc.plan(h, w, kh, kw, x.dtype, x.data_ptr() % 16 == 0,
                         n_sm)
        twin = sc.stencil_conv_torch(x, taps, acc_dtype=torch.float32)
        by_rows = {}
        for rows in sc.ROW_CHOICES:
            p = chosen._replace(rows=rows, tile_h=chosen.tile_h
                                // chosen.rows * rows)
            check(torch.equal(sc.run(x, taps, p), twin),
                  f"stencil probe {label_} rows {rows}: differs from twin")
            blocks = -(-(h - kh + 1) // p.tile_h) * -(-(w - kw + 1)
                                                      // p.tile_w)
            by_rows[rows] = {"blocks": blocks, "device_ms": device_ms(
                lambda: sc.run(x, taps, p), "stencil_")}
        rec[label_] = {"chosen": chosen._asdict(), "by_rows": by_rows}
    emit({"stencil_probe": rec})
    return rec


def fused_probe(fs, sr, prep, compute, vals, mask, vid):
    """What K1's, K3a's and K3b's cluster sizes cost, measured here:
    device ms of each cluster size at the main-path chunk (K1 at ``kk`` 3
    and 16, K3a on its vec4 route, K3b on its vec4 route over 8
    interleaved ids), the plans the wrappers pick, and K3a's and K3b's
    scalar routes on the same values one element into their buffers."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_var = prep.n_var
    kw = dict(compute=compute, metric="total_j",
              axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=n_var, total=prep.total,
              chunk=CHUNK, lmax=prep.lmax, block_points=4096)
    args = (prep.table2, prep.bank.fused[2], 2 * n_var + CHUNK, 0,
            3 * n_var)
    rec = {}
    for kk in (3, 16):
        by_cluster = {}
        for c in fs.CLUSTER_CHOICES:
            p = fs.make_plan(4096, kk, CHUNK, c)
            by_cluster[c] = {"ctas": p.ctas, "device_ms": device_ms(
                lambda: fs.run(*args, p, **kw, kk=kk), "fused_sweep_kernel")}
        rec[f"fused_sweep_kk{kk}"] = {
            "chosen": fs.plan(4096, kk, CHUNK, n_sm)._asdict(),
            "by_cluster": by_cluster}
    by_cluster = {}
    for c in sr.CLUSTER_CHOICES:
        p = sr.make_plan(CHUNK, 4096, c, True)
        by_cluster[c] = {"ctas": p.ctas, "device_ms": device_ms(
            lambda: sr.run(vals, mask, p, 4096), "block_stats_kernel")}
    off_v, off_m, off_i = offset_copies(vals, mask, vid)
    scalar = sr.plan(CHUNK, 4096, False, n_sm)
    rec["block_stats"] = {
        "chosen": sr.plan(CHUNK, 4096, True, n_sm)._asdict(),
        "by_cluster": by_cluster,
        "scalar_route": {"plan": scalar._asdict(), "device_ms": device_ms(
            lambda: sr.run(off_v, off_m, scalar, 4096),
            "block_stats_kernel")}}
    by_cluster = {}
    for c in sr.CLUSTER_CHOICES:
        p = sr.make_banked_plan(CHUNK, 4096, 8, c, True)
        by_cluster[c] = {"ctas": p.ctas, "device_ms": device_ms(
            lambda: sr.run_banked(vals, mask, vid, 8, p, 4096),
            "block_stats_banked")}
    scalar = sr.plan_banked(CHUNK, 4096, 8, False, n_sm)
    rec["block_stats_banked"] = {
        "chosen": sr.plan_banked(CHUNK, 4096, 8, True, n_sm)._asdict(),
        "by_cluster": by_cluster,
        "scalar_route": {"plan": scalar._asdict(), "device_ms": device_ms(
            lambda: sr.run_banked(off_v, off_m, off_i, 8, scalar, 4096),
            "block_stats_banked")}}
    emit({"fused_probe": rec})
    return rec


def banked_timing(sr, gd, prep, vals, mask, vid, n_sm):
    """K3b's device ms at 2^18 x 8 on three id layouts (interleaved, K2's
    variant row, one id), its row at 2^24 x 8 (interleaved; also runs of
    2^21) beside its bound, its launch floor (one block of 512 points,
    V = 8) and a byte yardstick: the device ms of torch's ``amax`` over a
    buffer of the same 9 bytes a point (a plain read of K3b's bytes,
    another function)."""
    layouts = {"interleaved": vid,
               "runs": k2_variant_row(gd, prep, 2 * prep.n_var - CHUNK // 2),
               "single": torch.full_like(vid, 3)}
    by_layout = {k: device_ms(
        lambda: sr.block_stats_banked(vals, mask, ids, 8, 4096),
        "block_stats_banked") for k, ids in layouts.items()}
    big_v, big_m = stats_inputs(BIG_STATS, 21)
    pos = torch.arange(BIG_STATS, device="cuda")
    big_i = (pos % 8).to(torch.int32)
    big_runs = (pos // (BIG_STATS // 8)).to(torch.int32)
    row = timing_row(
        f"{BIG_STATS} points x 8 variants",
        lambda: sr.block_stats_banked(big_v, big_m, big_i, 8, 4096),
        lambda: sr.block_stats_banked_torch(big_v, big_m, big_i, 8, 4096),
        None, BIG_STATS * 9 + BIG_STATS // 4096 * 8 * 16, BIG_STATS * 3,
        "block_stats_banked")
    row.update(runs_device_ms=device_ms(
        lambda: sr.block_stats_banked(big_v, big_m, big_runs, 8, 4096),
        "block_stats_banked"),
        plan=sr.plan_banked(BIG_STATS, 4096, 8, True, n_sm)._asdict())
    fl_v, fl_m = stats_inputs(512, 22)
    floor = device_ms(
        lambda: sr.block_stats_banked(fl_v, fl_m, vid[:512], 8, 512),
        "block_stats_banked")

    def yardstick(n):
        raw = torch.zeros(n * 9 // 4, dtype=torch.int32, device="cuda")
        return library_device_ms(lambda: torch.amax(raw))
    rec = {"by_layout_device_ms": by_layout, "big": row,
           "floor_device_ms": floor,
           "read_yardstick_device_ms": {"2^18": yardstick(CHUNK),
                                        "2^24": yardstick(BIG_STATS)}}
    emit({"block_stats_banked_timing": rec})
    return rec


def host_us(fn, reps=50):
    """Host microseconds a call of ``fn`` takes to enqueue its work (no
    synchronise inside the window; the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def headline_calls(kmods, prep, compute):
    """The wrapper of each of K1-K9 at its headline shape (``PERF.md``'s
    kernel table), on inputs made here from seeds: label -> call.  K3b
    also on K2's variant row (two runs), one id, 2^24 points and one
    block of 512 (its launch floor)."""
    fs, gd, sr, cr, bn, sc, fe, mm, fa = (kmods[n] for n in KERNEL_SOURCES)
    n_var = prep.n_var
    start = 2 * n_var + CHUNK
    dkw = dict(shape=prep.vgrids[0].shape, n_var=n_var, total=prep.total,
               chunk=CHUNK, lmax=prep.lmax)
    kw = dict(dkw, compute=compute, metric="total_j",
              axis_names=tuple(prep.vgrids[0].names), block_points=4096,
              kk=3)
    row = prep.bank.fused[2]
    vals, mask = stats_inputs(CHUNK, 1)
    vid = (torch.arange(CHUNK, device="cuda") % 8).to(torch.int32)
    runs = gd.grid_decode(prep.table2, 2 * n_var - CHUNK // 2, **dkw)[1]
    single = torch.full_like(vid, 3)
    big_v, big_m = stats_inputs(BIG_STATS, 21)
    big_i = (torch.arange(BIG_STATS, device="cuda") % 8).to(torch.int32)
    fl_v, fl_m = stats_inputs(512, 22)
    e, w = reduce_inputs(CHUNK, 11, 10, 3)
    rh, binned = gaussian((720, 1280), 1), gaussian((360, 640), 2)
    sobel = torch.tensor([[1., 0., -1.], [2., 0., -2.], [1., 0., -1.]],
                         device="cuda")
    ev_a, ev_b = gaussian((200, 320), 3), gaussian((200, 320), 4)
    ev_ha, ev_hb = ev_a.bfloat16(), ev_b.bfloat16()
    ev4 = gaussian((1, 4), 7), gaussian((1, 4), 8)
    ev8 = (gaussian((1, 8), 7, torch.bfloat16),
           gaussian((1, 8), 8, torch.bfloat16))
    events = (gaussian((1, 64000), 5) > 0).float()
    w1 = gaussian((64000, 900), 6)
    b, h, hkv, s, d, causal = ATTENTION_MODELS["qwen2_7b"]
    q, k, v = attention_inputs(b, h, hkv, s, d, 7, torch.bfloat16)
    return {
        "K1_fused_sweep_2^18": lambda: fs.fused_sweep_block(
            prep.table2, row, start, 0, 3 * n_var, **kw),
        "K1_fused_sweep_2^18_kk16": lambda: fs.fused_sweep_block(
            prep.table2, row, start, 0, 3 * n_var, **dict(kw, kk=16)),
        "K2_grid_decode_2^18": lambda: gd.grid_decode(prep.table2, start,
                                                      **dkw),
        "K2_grid_decode_2^18_int64": lambda: gd.grid_decode(
            prep.table2, start, **dict(dkw, idx_dtype=torch.int64)),
        "K2_grid_decode_chunk4": lambda: gd.grid_decode(
            prep.table2, start, **dict(dkw, chunk=4)),
        "K3a_block_stats_2^18": lambda: sr.block_stats(vals, mask, 4096),
        "K3b_block_stats_banked_2^18": lambda: sr.block_stats_banked(
            vals, mask, vid, 8, 4096),
        "K3b_block_stats_banked_2^18_runs": lambda: sr.block_stats_banked(
            vals, mask, runs, 8, 4096),
        "K3b_block_stats_banked_2^18_single": lambda: sr.block_stats_banked(
            vals, mask, single, 8, 4096),
        "K3b_block_stats_banked_2^24": lambda: sr.block_stats_banked(
            big_v, big_m, big_i, 8, 4096),
        "K3b_block_stats_banked_floor_512": lambda: sr.block_stats_banked(
            fl_v, fl_m, vid[:512], 8, 512),
        "K4_category_reduce_2^18": lambda: cr.category_reduce(e, w),
        "K5_binning_720x1280": lambda: bn.binning(rh, 2),
        "K6_stencil_conv_720x1280": lambda: sc.stencil_conv(rh, sobel),
        "K6_stencil_conv_360x640": lambda: sc.stencil_conv(binned, sobel),
        "K7_frame_event_200x320": lambda: fe.frame_event(ev_a, ev_b,
                                                         EDGAZE_THRESHOLD),
        "K7_frame_event_200x320_bf16": lambda: fe.frame_event(
            ev_ha, ev_hb, EDGAZE_THRESHOLD),
        "K7_frame_event_1x4": lambda: fe.frame_event(ev4[0], ev4[1], 0.5),
        "K7_frame_event_1x8_bf16": lambda: fe.frame_event(ev8[0], ev8[1],
                                                          0.5),
        "K8_matmul_1x64000x900": lambda: mm.matmul(events, w1),
        "K9_flash_attention_qwen2_7b_bf16": lambda: fa.flash_attention(
            q, k, v, causal),
    }


def launch_steps(dev):
    """The launch path's steps that every checkout of the port offers:
    torch's own calls and ``check_operands``: label -> call."""
    from repro_torch.kernels import cuda_build
    x = torch.empty((360, 640), device=dev)

    def device_context():
        with torch.cuda.device(dev):
            pass

    return {
        "torch_empty_360x640": lambda: torch.empty((360, 640), device=dev),
        "torch_empty_dtype_device": lambda: torch.empty(
            (360, 640), dtype=torch.float32, device=dev),
        "tensor_new_empty": lambda: x.new_empty((360, 640)),
        "tensor_device_attr": lambda: x.device,
        "tensor_data_ptr": x.data_ptr,
        "check_operands_one_tensor": lambda: cuda_build.check_operands(
            "probe", dev, (torch.float32,), x=x),
        "torch_cuda_device_enter_exit": device_context,
        "current_stream_cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "torch_cuda_current_device": torch.cuda.current_device,
        "raw_get_device": torch._C._cuda_getDevice,
    }


def c_entry_steps(kmods, dev):
    """This checkout's C entries, called through ctypes as the wrappers
    call them: ``repro_binning_noop`` (returns 0, launches nothing), and
    K5's and K6's entries launching with the arguments their wrappers pass
    at 720 x 1280 and 360 x 640 (label -> call); and, timed in C, the
    launch of an empty kernel (``repro_binning_launch_us``: label -> a
    call that returns its host us)."""
    lib_bn = kmods["binning"].load_kernel_library()
    lib_sc = kmods["stencil_conv"].load_kernel_library()
    rh, out = torch.empty((720, 1280), device=dev), torch.empty(
        (360, 640), device=dev)
    taps = torch.ones((3, 3), device=dev)
    sc_out = torch.empty((358, 638), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sc = kmods["stencil_conv"]
    p = sc.plan(360, 640, 3, 3, torch.float32, True,
                torch.cuda.get_device_properties(dev).multi_processor_count)
    bin_args = [rh.data_ptr(), out.data_ptr(), 0, 1280, 360, 640, 2, 0.25,
                1, stream]                      # f32, the vec2 route
    sc_args = [out.data_ptr(), taps.data_ptr(), sc_out.data_ptr(), 0, 360,
               640, 3, 3, sc.ROUTES[p.route], p.rows, p.tile_w // 16,
               stream]                  # f32, k3x3 (which reads no nv)

    def launch_alone():
        torch.cuda.synchronize()
        us = lib_bn.repro_binning_launch_us(200, stream)
        torch.cuda.synchronize()
        return us

    return ({"ctypes_noop_call": lib_bn.repro_binning_noop,
             "binning_c_entry_launch": lambda: lib_bn.repro_binning(
                 *bin_args),
             "stencil_c_entry_launch": lambda: lib_sc.repro_stencil_conv(
                 *sc_args)},
            {"cuda_launch_alone": launch_alone})


def launch_probe(kmods, calls, entry_steps=None, timed_in_c=None,
                 trials=7):
    """Host microseconds a call takes to enqueue, for each step of the
    launch path the wrappers share (:func:`launch_steps`, and
    ``entry_steps``) and for each wrapper of ``calls``: the median and the
    least of ``trials`` runs of :func:`host_us` (2000 calls a step, 200 a
    wrapper; each trial visits every item in turn, so that a slow spell of
    the host lands on all of them); each of ``timed_in_c``'s calls returns
    its own host us.  Also each wrapper's CUDA-event ms, as
    :func:`timing_row` takes them (20 calls, the median of 5 windows)."""
    dev = torch.device("cuda", torch.cuda.current_device())

    def spread(fns, reps):
        runs = {k: [] for k in fns}
        for _ in range(trials):
            for k, fn in fns.items():
                runs[k].append(fn() if reps is None else host_us(fn, reps))
        return {k: {"median": float(np.median(v)), "min": float(min(v))}
                for k, v in runs.items()}

    rec = {"steps_us": spread({**launch_steps(dev),
                               **(entry_steps or {})}, 2000),
           "wrappers_us": spread(calls, 200),
           "wrappers_event_ms": {k: time_ms(fn, 20, windows=5)
                                 for k, fn in calls.items()},
           "wrappers_device_ms": {k: device_ms(calls[k], needle)
                                  for k, needle in PROBE_DEVICE.items()},
           "source": str(source_dir())}
    rec["steps_us"].update(spread(timed_in_c or {}, None))
    emit({"launch_probe": rec})
    return rec


def probe_main() -> int:
    """``--launch-probe [--src DIR]``: a tool to hold two checkouts side by
    side (run it once with each tree's ``src/``), never part of the smoke
    run.  Builds the kernels of the checkout in use and prints the
    :func:`launch_probe` line of what every checkout offers: torch's steps,
    ``check_operands`` and the K1-K9 wrappers at their headline shapes."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the probe "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.shard_sweep import _prepare_stream
    from repro_torch.kernels import cuda_build
    kmods = {name: importlib.import_module(f"repro_torch.kernels.{name}")
             for name in KERNEL_SOURCES}
    cuda_build.build_libraries(KERNEL_SOURCES)
    for mod in kmods.values():
        mod.load_kernel_library()
    prep = _prepare_stream(["edgaze", "rhythmic"], MEGA_GRIDS, device="cuda")
    launch_probe(kmods, headline_calls(
        kmods, prep, build_coeff_compute(prep.bank.dims)))
    emit({"sweep_probe": sweep_probe()})
    return 0


def sweep_probe(reps: int = 5) -> dict:
    """The fused and staged engines' eval_s on mega_sweep (after one
    warm-up each; ``reps`` fused runs, 3 staged), sorted: the host path
    of the checkout in use, for ``--launch-probe``'s side-by-side runs."""
    from repro_torch.explore import DesignSpace, explore
    space = DesignSpace(["edgaze", "rhythmic"], MEGA_GRIDS)
    out = {"src": str(source_dir())}
    for engine, n in (("fused", reps), ("staged", 3)):
        explore(space, engine=engine, chunk_size=CHUNK, k=3)
        out[f"{engine}_eval_s"] = sorted(
            explore(space, engine=engine, chunk_size=CHUNK, k=3).eval_s
            for _ in range(n))
    return out


def matmul_probe(mm, events, w1, hidden, w2, big_a, big_b):
    """What K8's design choices cost, measured here: the tile width (and a
    two-way K split) at 1024^3 on the wgmma and tile routes (device ms of
    each plan), the host time of encoding the wgmma route's two tensor
    maps, and the host time a wrapper call takes to enqueue, for the
    GEMV in f16 and bf16, the (1, 900, 2) layer and 1024^3 bf16."""
    lib = mm.load_kernel_library()
    big_h = big_a.to(torch.bfloat16), big_b.to(torch.bfloat16)
    plans = {}
    for route, (a, b) in (("wgmma", big_h), ("tile", (big_a, big_b))):
        unit = 64 if route == "wgmma" else 16
        for tile_n, splits in ((128, 1), (64, 1), (128, 2)):
            p = mm.Plan(route, tile_n, splits, -(-1024 // splits // unit)
                        * unit)
            plans[f"{route}_n{tile_n}_s{splits}"] = device_ms(
                lambda: mm.run(a, b, p), "matmul_")
    encode = lib.repro_matmul_encode_us(big_h[0].data_ptr(),
                                        big_h[1].data_ptr(), 2, 1024, 1024,
                                        1024, 2000)
    enqueue = {}
    for label_, a, b in (("gemv_f16", events.half(), w1.half()),
                         ("gemv_bf16", events.bfloat16(), w1.bfloat16()),
                         ("gemv_f32", events, w1),
                         ("1x900x2", hidden, w2),
                         ("1024^3_bf16", *big_h)):
        enqueue[label_] = host_us(lambda: mm.matmul(a, b))
    rec = {"device_ms_by_plan_1024^3": plans,
           "chosen_plan_1024^3": {r: mm.plan(1024, 1024, 1024, dt, dt, True,
                                             torch.cuda.get_device_properties(
                                                 0).multi_processor_count
                                             )._asdict()
                                  for r, dt in (("wgmma", torch.bfloat16),
                                                ("tile", torch.float32))},
           "tensor_map_encode_us": encode, "enqueue_us": enqueue}
    emit({"matmul_probe": rec})
    return rec


def split_ops(nops):
    """``(fp32, half)`` operations: a bare count is all FP32."""
    return nops if isinstance(nops, tuple) else (nops, 0)


def timing_row(shape, ker, plain, lib, nbytes, nops, needle, reps=20,
               plain_reps=5):
    """One kernel's times at one shape: CUDA-event ms of back-to-back
    wrapper calls (the median of 5 windows), profiler device ms, the plain twin's and the library
    call's ms, the library call's device ms (all its kernels), and the
    bound from the bytes it must move and the
    operations it must do.  ``nops`` is an FP32 count or ``(fp32, half)``:
    the half operations (products of two f16/bf16 values) at the tensor
    cores' rate, added to the FP32 ones' time at the CUDA cores' rate."""
    fp32_ops, half_ops = split_ops(nops)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = fp32_ops / PEAK_FP32 + half_ops / PEAK_HALF
    return dict(shape=shape, ms=time_ms(ker, reps, windows=5),
                device_ms=device_ms(ker, needle, reps),
                plain_ms=time_ms(plain, reps=plain_reps),
                library_ms=time_ms(lib, reps, windows=5)
                if lib is not None else None,
                library_device_ms=library_device_ms(lib, reps)
                if lib is not None else None,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, operations=fp32_ops + half_ops,
                half_operations=half_ops)


# ---------------------------------------------------------------------------
# K9 and the attention path
# ---------------------------------------------------------------------------
def attention_inputs(b, h, hkv, s, d, seed, dtype):
    return (gaussian((b, h, s, d), seed, dtype),
            gaussian((b, hkv, s, d), seed + 1, dtype),
            gaussian((b, hkv, s, d), seed + 2, dtype))


def attention_scores(b, h, s, causal):
    """Unmasked scores: one exp each, and ``D`` products in each of
    ``Q K^T`` and ``P V``."""
    return (s * (s + 1) // 2 if causal else s * s) * b * h


def attention_ops(b, h, s, d, causal, dtype, route):
    """``(fp32, half)`` operations of the route's arithmetic per unmasked
    score.  wgmma: ``2 D`` for q . k and ``4 D`` for the split p . v
    (``P_hi V + P_lo V``), all products of two f16/bf16 values (exact in
    f32), so half operations.  SIMT: ``2 D`` for q . k, half operations
    with f16/bf16 operands, and ``2 D`` FP32 for p . v (p in f32); all
    ``4 D`` FP32 in f32."""
    per_d = d * attention_scores(b, h, s, causal)
    if route == "wgmma":
        return 0, 6 * per_d
    if dtype == torch.float32:
        return 4 * per_d, 0
    return 2 * per_d, 2 * per_d


def half_rule(k, t):
    """Max over the elements of ``|k - t|`` over one unit in the last place
    of the half dtype at ``max(|k|, |t|)`` (each side rounds its f32 result
    once) plus the f32 tolerance ``1e-5 (1 + |t|)`` (another summation
    order); at most 1 when the two agree to one rounding."""
    from repro_torch.testing import ulp
    kf, tf = k.double(), t.double()
    rule = ulp(torch.maximum(kf.abs(), tf.abs()), k.dtype) \
        + FA_TOL[torch.float32] * (1.0 + tf.abs())
    return float(((kf - tf).abs() / rule).max())


def close_case(name, ker, twin, tol, **extra):
    """A kernel against its twin on the same inputs, compared in f32 at
    ``atol = rtol = tol``, and bit-equal from run to run; ``extra`` goes
    into the record."""
    k = ker()
    again = ker()
    torch.cuda.synchronize()
    t = twin()
    check(k.shape == t.shape and k.dtype == t.dtype,
          f"{name}: {tuple(k.shape)} {k.dtype} against the twin's "
          f"{tuple(t.shape)} {t.dtype}")
    err = (k.float() - t.float()).abs()
    over = float((err - tol * (1.0 + t.float().abs())).max())
    check(over <= 0.0, f"{name}: off its twin by {float(err.max())} "
          f"(tolerance {tol})")
    ratio = half_rule(k, t) if k.dtype != torch.float32 else None
    check(ratio is None or ratio <= 1.0,
          f"{name}: off its twin by {ratio} x one rounding")
    check(torch.equal(k, again), f"{name}: differs from run to run")
    rec = dict(case=name, shape=list(k.shape), dtype=dtype_name(k.dtype),
               max_abs_err=float(err.max()), tol=tol,
               max_err_over_one_rounding=ratio, **extra)
    emit({"kernel_vs_twin": rec})
    return rec


def attention_cases(fa):
    """K9 against its twin at each dtype, shape and mask, and in f32 at the
    attention path's shapes, each on the route the wrapper picks (f16/bf16
    on wgmma, f32 on SIMT), checked by the route's launch counter."""
    cases = [(dt, shape, causal) for dt in FA_TOL for shape in FA_SHAPES
             for causal in (True, False)]
    cases += [(torch.float32, shape[:5], shape[5])
              for shape in ATTENTION_MODELS.values()]
    # mixed operand dtypes and head dims past 128: the SIMT route
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    cases += [((bf16, f32, f16), (1, 4, 2, 200, 64), True),
              ((f32, bf16, bf16), (1, 4, 2, 200, 128), False),
              ((f16, f16, f32), (2, 8, 2, 127, 40), True),
              (f32, (1, 4, 2, 200, 160), True),
              (bf16, (1, 4, 2, 200, 256), False),
              (f16, (1, 4, 4, 130, 160), True)]
    recs = []
    for dt, (b, h, hkv, s, d), causal in cases:
        dts = dt if isinstance(dt, tuple) else (dt,) * 3
        q = gaussian((b, h, s, d), s + d, dts[0])
        k = gaussian((b, hkv, s, d), s + d + 1, dts[1])
        v = gaussian((b, hkv, s, d), s + d + 2, dts[2])
        dt = dts[0]
        route = fa.route(q, k, v)
        simt = dt == torch.float32 or len(set(dts)) > 1 or d > 128
        check(route == ("simt" if simt else "wgmma"),
              f"flash {dts} D = {d}: route {route}")
        fa.reset_counts()
        recs.append(close_case(
            f"flash_{b}x{h}x{hkv}x{s}x{d}_"
            f"{'causal' if causal else 'full'}_"
            f"{'_'.join(dict.fromkeys(dtype_name(x) for x in dts))}",
            lambda: fa.flash_attention(q, k, v, causal),
            lambda: fa.flash_attention_torch(q, k, v, causal), FA_TOL[dt],
            route=route))
        check(fa.COUNTS[f"{route}_launches"] == fa.COUNTS["kernel_launches"]
              == 2, f"flash {dt} {route}: launches {fa.COUNTS}")
        del q, k, v
    return recs


def attention_path(fa, kernel_mods):
    """The attention of qwen2_7b and whisper_medium's encoder at full
    width, bf16, through ``ops.flash_attention``, with the launch
    counters zeroed just before each and read just after: one launch, on
    the wgmma route; each output is finite, of the query's shape and
    dtype, and within one bf16 rounding of the twin.  Then the kernel's,
    twin's and SDPA's times, SDPA's distance from the twin (it rounds P to
    bf16 once) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    rec = {}
    for seed, (name, (b, h, hkv, s, d, causal)) in enumerate(
            ATTENTION_MODELS.items()):
        q, k, v = attention_inputs(b, h, hkv, s, d, 100 * seed + 7,
                                   torch.bfloat16)
        ops.flash_attention(q, k, v, causal=causal)     # warm-up
        reset_all(kernel_mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.COUNTS["kernel_launches"]
        wgmma = fa.COUNTS["wgmma_launches"]
        twins = sum(m.COUNTS[c] for m in kernel_mods for c in m.COUNTS
                    if "twin" in c)
        check(launches == 1 and wgmma == 1 and twins == 0,
              f"attention {name}: {launches} kernel launches ({wgmma} "
              f"wgmma), {twins} twin calls")
        check(out.shape == q.shape and out.dtype == q.dtype
              and bool(torch.isfinite(out).all()),
              f"attention {name}: output not finite {tuple(q.shape)} bf16")
        twin = fa.flash_attention_torch(q, k, v, causal)
        err = (out.float() - twin.float()).abs()
        ratio = half_rule(out, twin)
        check(ratio <= 1.0, f"attention {name}: off its twin by "
              f"{float(err.max())}, {ratio} x one bf16 rounding")

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
        lib_out = sdpa()
        lib_diff = float((lib_out.float() - out.float()).abs().max())
        lib_ratio = half_rule(lib_out, twin)
        del twin, lib_out
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        times = timing_row(
            f"{b}x{h}x{hkv}x{s}x{d} {'causal' if causal else 'full'} bf16",
            lambda: fa.flash_attention(q, k, v, causal),
            lambda: fa.flash_attention_torch(q, k, v, causal), sdpa, nbytes,
            attention_ops(b, h, s, d, causal, q.dtype, "wgmma"),
            "flash_attention_wgmma_kernel",
            reps=10, plain_reps=3)
        exps = attention_scores(b, h, s, causal)
        rec[name] = dict(b_h_hkv_s_d=[b, h, hkv, s, d], causal=causal,
                         dtype="bfloat16", route="wgmma", wall_s=wall,
                         kernel_launches=launches, wgmma_launches=wgmma,
                         twin_calls=twins,
                         vs_twin_max_abs_err=float(err.max()),
                         vs_twin_over_one_rounding=ratio,
                         library_vs_kernel_max_abs_diff=lib_diff,
                         library_over_one_rounding=lib_ratio,
                         exps=exps, exp_ms=exps / PEAK_SFU * 1e3, **times)
    emit({"attention_path": rec})
    return rec


def attention_f32_timing(fa):
    """K9's SIMT route at the attention path's widths: f32 operands (the
    kernel's, twin's and SDPA's (f32, TF32 off) times and the bound), and
    mixed operands, a bf16 q over f32 k and v (the mixed-dtype kernel; no
    single library call takes mixed dtypes)."""
    import torch.nn.functional as F
    rec = {}
    for seed, (name, (b, h, hkv, s, d, causal)) in enumerate(
            ATTENTION_MODELS.items()):
        q, k, v = attention_inputs(b, h, hkv, s, d, 100 * seed + 7,
                                   torch.float32)
        check(fa.route(q, k, v) == "simt", f"f32 {name}: not on SIMT")
        mode = 'causal' if causal else 'full'
        rec[name] = timing_row(
            f"{b}x{h}x{hkv}x{s}x{d} {mode} f32",
            lambda: fa.flash_attention(q, k, v, causal),
            lambda: fa.flash_attention_torch(q, k, v, causal),
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True),
            q.element_size() * (2 * q.numel() + 2 * k.numel()),
            attention_ops(b, h, s, d, causal, q.dtype, "simt"),
            "flash_attention_kernel", reps=5, plain_reps=2)
        qm = q.to(torch.bfloat16)
        check(fa.route(qm, k, v) == "simt", f"mixed {name}: not on SIMT")
        rec[f"{name}_mixed"] = timing_row(
            f"{b}x{h}x{hkv}x{s}x{d} {mode} bf16 q, f32 k v",
            lambda: fa.flash_attention(qm, k, v, causal),
            lambda: fa.flash_attention_torch(qm, k, v, causal), None,
            qm.element_size() * 2 * qm.numel() + k.element_size() * 2
            * k.numel(),
            attention_ops(b, h, s, d, causal, torch.float32, "simt"),
            "flash_attention_kernel_any", reps=5, plain_reps=2)
    emit({"attention_f32": rec})
    return rec


# ---------------------------------------------------------------------------
# the LM serving path (P12a): plain torch ops, no kernel of the port
# ---------------------------------------------------------------------------
def lm_inputs(cfg, b, s, seed, device):
    """``s`` prompt positions and the next one, from a numpy seed: tokens
    (embeddings for vlm), plus the stub audio frames for encdec."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal((b, s + 1, cfg.d_model),
                                            dtype=np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s + 1))
    if cfg.family == "encdec":
        out["audio_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def lm_prompt(full, s):
    """(the batch of the first ``s`` positions, position ``s``'s input)"""
    key = "embeds" if "embeds" in full else "tokens"
    return dict(full, **{key: full[key][:, :s]}), full[key][:, s:s + 1]


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


def lm_serve(M, cfg, params, full, s, new, max_seq) -> dict:
    """One architecture on the card, under ``torch.inference_mode()``:
    prefill and one decode step with the sync debug mode at "error" (a
    host sync raises), their logits finite, the decode step held to
    ``forward`` over ``s + 1`` positions at the last one (the continuity
    rule of ``tests/test_archs.py:58-85``), then prefill and ``new``
    greedy decode steps timed with CUDA events."""
    b = next(iter(full.values())).shape[0]
    batch, nxt = lm_prompt(full, s)
    # warm-up outside the guarded run: cuBLAS handles and workspaces
    _, cache = M.prefill(params, batch, M.init_cache(cfg, b, max_seq), cfg)
    M.decode_step(params, nxt, cache, cfg)
    cache = M.init_cache(cfg, b, max_seq)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = M.prefill(params, batch, cache, cfg)
        dlog, cache = M.decode_step(params, nxt, cache, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(logits).all() and torch.isfinite(dlog).all()),
          f"{cfg.arch_id}: prefill or decode logits not finite")
    check(tuple(cache["pos"].shape) == () and int(cache["pos"]) == s + 1,
          f"{cfg.arch_id}: cache pos {cache['pos']}")
    del cache
    ref = M.forward(params, full, cfg)[:, s].float()
    scale = float(ref.abs().max())
    err = float((dlog[:, 0].float() - ref).abs().max())
    check(math.isfinite(scale) and err < LM_CONT_RULE * max(scale, 1.0),
          f"{cfg.arch_id}: decode vs forward err {err} (scale {scale})")
    del ref, logits, dlog
    torch.cuda.synchronize()

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cache = M.init_cache(cfg, b, max_seq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    logits, cache = M.prefill(params, batch, cache, cfg)
    ev[1].record()
    toks = [greedy(logits)]
    for _ in range(new):
        logits, cache = M.decode_step(params, toks[-1], cache, cfg)
        toks.append(greedy(logits))
    ev[2].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = torch.cat(toks, dim=1)
    check(bool(torch.isfinite(logits).all()) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"{cfg.arch_id}: greedy decode")
    prefill_ms = ev[0].elapsed_time(ev[1])
    return {"batch": b, "prompt": s, "max_seq": max_seq,
            "decode_tokens": new, "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": b * s / (prefill_ms * 1e-3),
            "decode_ms_per_token": ev[1].elapsed_time(ev[2]) / new,
            "wall_s": wall, "continuity_err": err, "continuity_scale": scale,
            "continuity_bound": LM_CONT_RULE * max(scale, 1.0),
            "host_syncs": 0, "cache_bytes": tree_bytes(cache),
            "sample": toks[0, :8].tolist()}


def lm_cut(arch):
    """A published config at full width with its depth cut to 2 layers
    (whisper's encoder too; zamba2 keeps shared_attn_every 6, so one
    shared block runs); MoE at capacity factor 8.0, as
    ``tests/test_archs.py:63``.  Returns (config, the cuts named)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    upd, cuts = {"n_layers": 2}, [f"n_layers {cfg.n_layers} -> 2"]
    if cfg.n_encoder_layers:
        upd["n_encoder_layers"] = 2
        cuts.append(f"n_encoder_layers {cfg.n_encoder_layers} -> 2")
    if cfg.shared_attn_every:
        cuts.append(f"shared_attn_every {cfg.shared_attn_every} kept: one "
                    f"shared block")
    if cfg.family == "moe":
        upd["moe_capacity_factor"] = 8.0
        cuts.append(f"moe_capacity_factor {cfg.moe_capacity_factor} -> 8.0")
    return dataclasses.replace(cfg, **upd), cuts


def lm_card_vs_cpu(M, cfg, params, full, s, steps) -> dict:
    """The same weights and inputs (f32) through prefill and ``steps``
    greedy decode steps on the CPU and on the card: every step's logits
    and the final caches within ``LM_F32_REL * max|cpu|``, the greedy
    tokens equal."""
    b = next(iter(full.values())).shape[0]
    runs = {}
    for dev in ("cpu", "cuda"):
        p, f = tree_to(params, dev), tree_to(full, dev)
        batch, _ = lm_prompt(f, s)
        logits, cache = M.prefill(p, batch,
                                  M.init_cache(cfg, b, s + steps, device=dev),
                                  cfg)
        outs, toks = [logits], []
        for _ in range(steps):
            toks.append(greedy(logits))
            logits, cache = M.decode_step(p, toks[-1], cache, cfg)
            outs.append(logits)
        runs[dev] = (outs, torch.cat(toks, dim=1), cache)
        del p, f
    (c_out, c_tok, c_cache), (g_out, g_tok, g_cache) = (runs["cpu"],
                                                        runs["cuda"])
    check(torch.equal(c_tok, g_tok.cpu()), f"{cfg.arch_id}: greedy tokens "
          f"{g_tok.tolist()} on the card, {c_tok.tolist()} on the CPU")
    worst = 0.0
    pairs = list(zip(c_out, g_out)) + [(c_cache[k], g_cache[k])
                                       for k in c_cache]
    for c, g in pairs:
        c, g = c.double(), g.cpu().double()
        rel = float((g - c).abs().max() / max(float(c.abs().max()), 1e-30))
        check(rel <= LM_F32_REL, f"{cfg.arch_id}: card vs CPU rel {rel}")
        worst = max(worst, rel)
    return {"max_rel_err": worst, "tokens": c_tok[0].tolist()}


def lm_path(smi, kernel_mods=()) -> dict:
    """The LM stack's serving path (P12a) on the card: qwen2-7b at its
    published width and depth (bf16, 4 prompts of 1024 tokens, 32 greedy
    tokens; a profiled decode of 4 tokens for the device's busy share
    and kernels a token, beside the bounds), the nine other
    architectures at full width cut to 2 layers, and the card held to
    the CPU path in f32 (the ten reduced configs; qwen2-7b at full width
    with 2 layers).  No kernel of ``repro_torch.kernels`` is on the path:
    their launch counters stay at 0."""
    from repro_torch.configs import ARCH_IDS, get_config, reduced
    from repro_torch.models import model as M
    t_start = time.perf_counter()
    reset_all(kernel_mods)
    out = {"power_limit": smi}
    with torch.inference_mode():
        cfg = get_config("qwen2_7b")
        b, s, max_seq, new = LM_MAIN
        t0 = time.perf_counter()
        params = M.init_params(cfg, 0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(int(np.prod(shape))
                       for shape, _ in M.param_shapes(cfg).values())
        n_embed = cfg.vocab * cfg.d_model
        check(tree_bytes(params) == 2 * n_params, "qwen2-7b: not bf16")
        full = lm_inputs(cfg, b, s, 0, "cuda")
        rec = lm_serve(M, cfg, params, full, s, new, max_seq)
        # bounds: decode reads every weight and the K/V cache once a
        # token; prefill does 2 flops a weight of the layers a token,
        # causal attention's 4 hd flops a (query, key) pair, and the last
        # position's logits
        L, H, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
        ops = (2 * (n_params - n_embed) * b * s
               + 4 * hd * H * L * b * s * (s + 1) // 2 + 2 * n_embed * b)
        weight_bytes = tree_bytes(params)
        decode_bytes = weight_bytes + rec["cache_bytes"]
        by_ops, by_bytes = ops / PEAK_HALF, weight_bytes / PEAK_BYTES
        rec.update(
            params=n_params, params_gb=weight_bytes / 1e9, init_s=init_s,
            prefill_ops=ops, prefill_bound_ms=max(by_ops, by_bytes) * 1e3,
            prefill_bound_by="operations" if by_ops >= by_bytes
            else "bytes",
            decode_bytes=decode_bytes,
            decode_bound_ms=decode_bytes / PEAK_BYTES * 1e3,
            decode_bound_by="bytes")
        # the device's busy share and kernels a token: a profiled decode
        # of 4 tokens after a fresh prefill
        batch, _ = lm_prompt(full, s)
        logits, cache = M.prefill(params, batch,
                                  M.init_cache(cfg, b, max_seq), cfg)
        state = {"toks": greedy(logits), "cache": cache}

        def decode4():
            for _ in range(4):
                lg, state["cache"] = M.decode_step(params, state["toks"],
                                                   state["cache"], cfg)
                state["toks"] = greedy(lg)
        prof = profile_path("lm_decode_qwen2_7b", decode4)
        rec.update(
            profiled_decode_ms_per_token=prof["wall_s"] / 4 * 1e3,
            kernels_per_token=prof["device_kernels"] / 4,
            device_busy_ms_per_token=prof["device_busy_s"] / 4 * 1e3,
            busy_share=prof["device_busy_s"] / 4 * 1e3
            / rec["decode_ms_per_token"],
            busy_share_profiled=prof["device_busy_share_of_wall"])
        out["qwen2_7b"] = rec
        del params, full, state, cache, logits
        torch.cuda.empty_cache()

        others = {}
        for arch in ARCH_IDS:
            if arch == "qwen2_7b":
                continue
            cfg, cuts = lm_cut(arch)
            b, s = LM_LONG.get(arch, LM_OTHERS[:2])
            new = LM_OTHERS[2]
            params = M.init_params(cfg, 0)
            full = lm_inputs(cfg, b, s, 1, "cuda")
            rec = lm_serve(M, cfg, params, full, s, new, s + new)
            rec["cuts"] = cuts
            rec["params"] = sum(int(np.prod(shape)) for shape, _ in
                                M.param_shapes(cfg).values())
            if cfg.sliding_window:
                rec["window"] = cfg.sliding_window
            others[arch] = rec
            del params, full
            torch.cuda.empty_cache()
        out["full_width_2_layers"] = others

        # the card against the CPU path, f32 (TF32 off)
        versus = {}
        for arch in ARCH_IDS:
            cfg = reduced(get_config(arch))
            params = M.init_params(cfg, 0, device="cpu")
            full = lm_inputs(cfg, 2, 48, 2, "cpu")
            versus[arch] = lm_card_vs_cpu(M, cfg, params, full, 48, 3)
        cfg = dataclasses.replace(get_config("qwen2_7b"), n_layers=2,
                                  dtype="float32")
        params = tree_to(M.init_params(cfg, 0), "cpu")
        torch.cuda.empty_cache()
        full = lm_inputs(cfg, 1, 128, 3, "cpu")
        versus["qwen2_7b_full_width_2_layers"] = lm_card_vs_cpu(
            M, cfg, params, full, 128, 4)
        out["card_vs_cpu_f32"] = versus
        del params
        torch.cuda.empty_cache()
    launched = {m.__name__.rsplit(".", 1)[-1]: m.COUNTS["kernel_launches"]
                for m in kernel_mods if m.COUNTS["kernel_launches"]}
    check(not launched, f"LM path launched port kernels {launched}")
    out["seconds"] = time.perf_counter() - t_start
    emit({"lm_path": out})
    return out


# ---------------------------------------------------------------------------
# LM training on one device (P12b): plain torch ops and autograd, no kernel
# of the port
# ---------------------------------------------------------------------------
def train_batch(cfg, b, s, step, device):
    """One training batch on the device: the structured token stream of
    ``repro_torch.data`` at ``step`` (vlm: embeddings from a numpy seed
    and the stream as labels; encdec: its stub audio frames too)."""
    from repro_torch.data import SyntheticTextDataset, batch_for_shape
    if cfg.family in ("vlm", "encdec"):
        out = batch_for_shape(cfg, b, s, step)
    else:
        ds = SyntheticTextDataset(cfg.vocab, s, b, seed=0, mode="structured")
        out = {"tokens": ds.batch_at(step)}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def n_params(M, cfg) -> int:
    return sum(int(np.prod(shape)) for shape, _ in
               M.param_shapes(cfg).values())


def leaf_list(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


def tree_map(fn, tree):
    from repro_torch.tree import tree_map as tmap
    return tmap(fn, tree)


def sorted_paths(tree):
    from repro_torch.tree import paths
    return list(paths(tree))


def guarded(fn):
    """``fn()`` with the sync debug mode at "error": a host sync raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def nvml_energy_mj():
    """GPU 0's cumulative energy counter in mJ (NVML's
    ``nvmlDeviceGetTotalEnergyConsumption`` through the driver's
    ``libnvidia-ml.so.1``), or None where NVML cannot read it."""
    import ctypes
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    lib.nvmlInit_v2.restype = ctypes.c_int
    lib.nvmlInit_v2.argtypes = []
    lib.nvmlShutdown.restype = ctypes.c_int
    lib.nvmlShutdown.argtypes = []
    lib.nvmlDeviceGetHandleByIndex_v2.restype = ctypes.c_int
    lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
        ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
    lib.nvmlDeviceGetTotalEnergyConsumption.restype = ctypes.c_int
    lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
    if lib.nvmlInit_v2() != 0:
        return None
    try:
        handle, mj = ctypes.c_void_p(), ctypes.c_ulonglong()
        if lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(handle)) or \
                lib.nvmlDeviceGetTotalEnergyConsumption(handle,
                                                        ctypes.byref(mj)):
            return None
        return mj.value
    finally:
        lib.nvmlShutdown()


def train_main(M, smi) -> dict:
    """olmo-1b at its published width and depth, bf16 parameters, f32
    moments, ``remat`` full: one warm-up step and 5 timed steps (CUDA
    events, each under the sync debug mode "error"), then a profiled
    step; loss and grad_norm finite, the last step's loss below the
    first's; step ms, tokens/s and peak memory beside the 6NT bound."""
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    cfg = get_config("olmo_1b")
    b, s, timed = TRAIN_MAIN
    n = n_params(M, cfg)
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = tree_bytes(params) * 2 + tree_bytes(opt)
    step_fn = build_train_step(cfg, warmup_steps=2, total_steps=8)
    batches = [train_batch(cfg, b, s, i, "cuda") for i in range(timed + 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    params, opt, m = step_fn(params, opt, batches[0], 0)      # warm-up
    metrics.append(m)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    torch.cuda.synchronize()
    mj0 = nvml_energy_mj()
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(1, timed + 1):
        params, opt, m = guarded(
            lambda: step_fn(params, opt, batches[i], i))
        ev[i].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mj1 = nvml_energy_mj()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [ev[i - 1].elapsed_time(ev[i]) for i in range(1, timed + 1)]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    check(all(map(math.isfinite, losses + norms)),
          f"olmo-1b: loss {losses} grad_norm {norms}")
    check(losses[-1] < losses[0], f"olmo-1b: loss did not fall {losses}")
    state = {"p": params, "o": opt}

    def one_step():
        state["p"], state["o"], _ = step_fn(state["p"], state["o"],
                                            batches[timed + 1], timed + 1)
    prof = profile_path("train_step_olmo_1b", one_step)
    # the step's two halves, each timed alone: the gradients, then AdamW
    from repro_torch.optim import adamw_update
    from repro_torch.train.steps import value_and_grad
    ev2 = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev2[0].record()
    _, grads = value_and_grad(state["p"], batches[timed + 1], cfg)
    ev2[1].record()
    adamw_update(grads, state["o"], state["p"], metrics[-1]["lr"])
    ev2[2].record()
    torch.cuda.synchronize()
    del grads
    tokens = b * s
    ops6 = 6 * n * tokens
    med = float(np.median(step_ms))
    rec = {
        "arch": "olmo_1b", "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "params": n, "dtype": cfg.dtype,
        "remat_policy": cfg.remat_policy, "batch": b, "seq": s,
        "tokens_per_step": tokens, "init_s": init_s,
        "state_gb": state_bytes / 1e9, "losses": losses,
        "grad_norms": norms, "lrs": [float(m["lr"]) for m in metrics],
        "step_ms": step_ms, "step_ms_median": med,
        "tokens_per_s": tokens / (med * 1e-3), "wall_s_timed": wall,
        "peak_memory_gb": peak / 1e9, "peak_memory_bytes": peak,
        "host_syncs": 0,
        "nvml_j_per_step": (None if mj0 is None or mj1 is None
                            else (mj1 - mj0) / 1e3 / timed),
        "nvml_w_timed": (None if mj0 is None or mj1 is None
                         else (mj1 - mj0) / 1e3 / wall),
        "flops_6nt": ops6, "bound_ms": ops6 / PEAK_HALF * 1e3,
        "bound_by": "operations",
        "flops_8nt_remat": 8 * n * tokens,
        "bound_ms_remat": 8 * n * tokens / PEAK_HALF * 1e3,
        "grads_ms": ev2[0].elapsed_time(ev2[1]),
        "adamw_ms": ev2[1].elapsed_time(ev2[2]),
        "profiled_step_ms": prof["wall_s"] * 1e3,
        "device_ms_by_class": {k: v * 1e3 for k, v in
                               prof["device_s_by_class"].items()},
        "kernels_per_step": prof["device_kernels"],
        "device_busy_ms": prof["device_busy_s"] * 1e3,
        "busy_share": prof["device_busy_s"] * 1e3 / med,
        "busy_share_profiled": prof["device_busy_share_of_wall"],
        "power_limit": smi}
    del params, opt, state, batches, metrics
    torch.cuda.empty_cache()
    return rec


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def train_loop_drill(M) -> dict:
    """The loop, its checkpoints and resume, at olmo-1b's full width with
    its depth cut to 2 layers: ``TrainLoop`` for 6 steps
    (``checkpoint_every=2``, ``keep=1``), the restored state bit-equal to
    the loop's, a second loop that resumes from step 6 to step 8, its loss
    within 1e-2 rel of an uninterrupted 8-step run; a synchronous save
    and an async one timed beside a step."""
    import shutil
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainLoop, build_train_step
    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=2)
    b, s, steps, resume_to = TRAIN_DRILL
    root = Path(__file__).resolve().parent / "build" / "train_ckpt_drill"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    n = n_params(M, cfg)
    ckpt_bytes = n * 2 + n * 8
    free = shutil.disk_usage(root).free
    print(json.dumps({"train_drill_disk": {"free_gb": free / 1e9,
                                           "checkpoint_gb": ckpt_bytes / 1e9}}),
          flush=True)
    # keep=1: a published checkpoint, the one being written, and the
    # async save's and the timing probe's
    check(free > 4 * ckpt_bytes, f"{free} bytes free, a checkpoint takes "
          f"{ckpt_bytes}: the drill would not fit")
    ds = SyntheticTextDataset(cfg.vocab, s, b, seed=0, mode="structured")
    step_fn = build_train_step(cfg, warmup_steps=2, total_steps=resume_to)

    def make_batch(step):
        return {"tokens": torch.from_numpy(ds.batch_at(step)).to("cuda")}

    def fresh():
        params = M.init_params(cfg, 0)
        return params, adamw_init(params)

    try:
        mgr = CheckpointManager(str(root / "run"), keep=1)
        p, o = fresh()
        t0 = time.perf_counter()
        out1 = TrainLoop(step_fn, ds, mgr, checkpoint_every=2).run(
            p, o, num_steps=steps, make_batch=make_batch, log_every=1)
        loop_s = time.perf_counter() - t0
        check(out1["step"] == steps and mgr.list_steps() == [steps],
              f"drill: step {out1['step']}, checkpoints {mgr.list_steps()}")
        sk_p, sk_o = fresh()
        rp, ro, manifest = mgr.restore(sk_p, sk_o)
        check(manifest["step"] == steps, f"drill: manifest {manifest}")
        for name, a, r in (("params", out1["params"], rp),
                           ("opt_state", out1["opt_state"], ro)):
            for x, y in zip(leaf_list(a), leaf_list(r)):
                check(x.dtype == y.dtype and x.device == y.device
                      and torch.equal(x, y), f"drill: restored {name} "
                      f"differ from the saved")
        del rp, ro, out1
        t0 = time.perf_counter()
        out2 = TrainLoop(step_fn, ds, mgr, checkpoint_every=2).run(
            sk_p, sk_o, num_steps=resume_to, make_batch=make_batch,
            log_every=1)
        resume_s = time.perf_counter() - t0
        check(out2["step"] == resume_to and [h["step"] for h in
                                             out2["history"]]
              == list(range(steps + 1, resume_to + 1)),
              f"drill: resumed run {out2['step']} {out2['history']}")
        del out2["params"], out2["opt_state"]
        torch.cuda.empty_cache()
        p, o = fresh()
        straight = CheckpointManager(str(root / "straight"), keep=1)
        out3 = TrainLoop(step_fn, ds, straight,
                         checkpoint_every=resume_to + 1).run(
            p, o, num_steps=resume_to, make_batch=make_batch, log_every=1)
        resumed, uninterrupted = (out2["history"][-1]["loss"],
                                  out3["history"][-1]["loss"])
        rel = abs(resumed - uninterrupted) / abs(uninterrupted)
        check(math.isfinite(resumed) and rel <= 1e-2,
              f"drill: resumed loss {resumed}, uninterrupted "
              f"{uninterrupted}")
        # a synchronous save, then an async one with a step behind it
        params, opt = out3["params"], out3["opt_state"]
        probe = CheckpointManager(str(root / "probe"), keep=1)
        t0 = time.perf_counter()
        probe.save(100, params, opt)
        save_s = time.perf_counter() - t0
        written = dir_bytes(root / "probe" / "step_00000100")
        t0 = time.perf_counter()
        probe.async_save(101, params, opt)
        snapshot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, opt, _ = step_fn(params, opt, make_batch(resume_to),
                                 resume_to)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        probe.wait()
        wait_s = time.perf_counter() - t0
        rec = {
            "arch": "olmo_1b", "n_layers": 2, "d_model": cfg.d_model,
            "params": n, "batch": b, "seq": s, "steps": steps,
            "resumed_to": resume_to, "checkpoint_every": 2, "keep": 1,
            "checkpoint_bytes": written, "free_bytes": free,
            "loop_s": loop_s, "resume_s": resume_s,
            "restored_bit_equal": True,
            "history": [h["loss"] for h in out3["history"]],
            "resumed_loss": resumed, "uninterrupted_loss": uninterrupted,
            "resumed_rel": rel, "save_ms": save_s * 1e3,
            "save_gb_per_s": written / save_s / 1e9,
            "async_snapshot_ms": snapshot_s * 1e3,
            "step_behind_async_ms": step_s * 1e3,
            "wait_after_step_ms": wait_s * 1e3,
            # the share of the async write's wall time (from the call's
            # return to the end of its wait) that a training step filled
            "async_overlap": step_s / (step_s + wait_s)}
        del params, opt, out3
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def sample_leaves(tree, k=65536):
    """A strided sample of each leaf (at most ``k`` elements), cloned."""
    out = []
    for t in leaf_list(tree):
        flat = t.reshape(-1)
        out.append(flat[::max(flat.numel() // k, 1)].clone())
    return out


def train_other(M, arch) -> dict:
    """One architecture at full width cut to 2 layers (``lm_cut``), bf16:
    a warm-up step, then one step under the sync debug mode "error";
    loss and grad_norm finite, every leaf's first moment nonzero (every
    leaf took a gradient), every leaf moved but those still all ones
    (norm scales, mamba's ``d_skip``: in bf16 a step of lr = 3e-4 is
    under half their ulp, 2^-8, as in the reference)."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    cfg, cuts = lm_cut(arch)
    b, s = TRAIN_OTHERS
    params = M.init_params(cfg, 0)
    opt = adamw_init(params)
    step_fn = build_train_step(cfg, warmup_steps=2, total_steps=8)
    batches = [train_batch(cfg, b, s, i, "cuda") for i in range(2)]
    params, opt, _ = step_fn(params, opt, batches[0], 0)     # warm-up
    before = sample_leaves(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    # step 2: the end of the warm-up, the peak rate
    params, opt, m = guarded(lambda: step_fn(params, opt, batches[1], 2))
    ev[1].record()
    torch.cuda.synchronize()
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    check(math.isfinite(loss) and math.isfinite(gnorm),
          f"{arch}: loss {loss} grad_norm {gnorm}")
    leaves = leaf_list(params)
    moved = [not torch.equal(x, y) for x, y in
             zip(before, sample_leaves(params))]
    with_grad = [bool((v != 0).any()) for v in leaf_list(opt["m"])]
    check(all(with_grad), f"{arch}: a leaf took no gradient")
    names = [k for k, _ in sorted_paths(params)]
    still = [k for k, mv in zip(names, moved) if not mv]
    check(all(bool((x == 1).all()) for x, mv in zip(before, moved)
              if not mv), f"{arch}: leaves did not move: {still}")
    rec = {"cuts": cuts, "params": n_params(M, cfg), "batch": b, "seq": s,
           "loss": loss, "grad_norm": gnorm,
           "step_ms": ev[0].elapsed_time(ev[1]),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "leaves": len(leaves), "leaves_moved": sum(moved),
           "ones_below_an_ulp": still,
           "leaves_with_grad": sum(with_grad), "host_syncs": 0}
    del params, opt, batches, before
    torch.cuda.empty_cache()
    return rec


def train_card_vs_cpu(M, cfg, b, s) -> dict:
    """One f32 train step on carried weights and one batch, on the CPU
    and on the card: loss within rel 1e-5, grad_norm within rel 1e-4, the
    moments within 1e-4 max|leaf|, the parameters within ``1e-3 lr +
    1e-6 |p|`` where the CPU's first moment is above 1e-3 of its leaf's
    largest, ``2 lr + 1e-6 |p|`` elsewhere (Adam's first step is
    ``lr sign(g)``: a near-zero gradient may flip)."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    params = M.init_params(cfg, 0, device="cpu")
    batch = train_batch(cfg, b, s, 0, "cpu")
    step_fn = build_train_step(cfg, warmup_steps=2, total_steps=8)
    runs = {}
    for dev in ("cpu", "cuda"):
        # a copy on each device: the step writes its params in place
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        runs[dev] = step_fn(p, adamw_init(p), tree_to(batch, dev), 1)
    (cp, co, cm), (gp, go, gm) = runs["cpu"], runs["cuda"]
    loss_rel = abs(float(gm["loss"]) - float(cm["loss"])) / abs(
        float(cm["loss"]))
    norm_rel = abs(float(gm["grad_norm"]) - float(cm["grad_norm"])) / abs(
        float(cm["grad_norm"]))
    check(loss_rel <= TRAIN_F32["loss"], f"{cfg.arch_id}: loss rel "
          f"{loss_rel}")
    check(norm_rel <= TRAIN_F32["grad_norm"], f"{cfg.arch_id}: grad_norm "
          f"rel {norm_rel}")
    lr = float(cm["lr"])
    worst = {"m": 0.0, "v": 0.0, "params": 0.0}
    for key in ("m", "v"):
        for c, g in zip(leaf_list(co[key]), leaf_list(go[key])):
            c, g = c.double(), g.cpu().double()
            err = float((g - c).abs().max()) / max(float(c.abs().max()),
                                                   1e-30)
            check(err <= TRAIN_F32["moments"], f"{cfg.arch_id}: {key} "
                  f"err {err}")
            worst[key] = max(worst[key], err)
    for c, g, m in zip(leaf_list(cp), leaf_list(gp), leaf_list(co["m"])):
        c, g, m = c.double(), g.cpu().double(), m.double()
        strong = m.abs() > 1e-3 * m.abs().max()
        bound = torch.where(strong, 1e-3 * lr, 2 * lr) + 1e-6 * c.abs()
        err = (g - c).abs()
        check(bool((err <= bound).all()), f"{cfg.arch_id}: parameters "
              f"off by {float((err - bound).max())} past the bound")
        worst["params"] = max(worst["params"], float((err / bound).max()))
    return {"loss_rel": loss_rel, "grad_norm_rel": norm_rel,
            "moments_rel": max(worst["m"], worst["v"]),
            "params_err_over_bound": worst["params"], "lr": lr}


def train_path(smi, kernel_mods=()) -> dict:
    """The LM stack's training path (P12b) on the card: olmo-1b at its
    published width and depth (``train_main``), the loop drill
    (``train_loop_drill``), the nine other architectures at full width
    with 2 layers (``train_other``), the card against the CPU in f32
    (the ten reduced configs; olmo-1b at full width with 2 layers).  No
    kernel of ``repro_torch.kernels`` is on the path: their launch
    counters stay at 0."""
    from repro_torch.configs import ARCH_IDS, get_config, reduced
    from repro_torch.models import model as M
    t_start = time.perf_counter()
    reset_all(kernel_mods)
    out = {"power_limit": smi}
    out["olmo_1b"] = train_main(M, smi)
    emit({"train_main": out["olmo_1b"]})
    out["loop_drill"] = train_loop_drill(M)
    emit({"train_loop_drill": out["loop_drill"]})
    others = {}
    for arch in ARCH_IDS:
        if arch != "olmo_1b":
            others[arch] = train_other(M, arch)
            emit({f"train_step_{arch}": others[arch]})
    out["full_width_2_layers"] = others
    versus = {}
    for arch in ARCH_IDS:
        versus[arch] = train_card_vs_cpu(M, reduced(get_config(arch)),
                                         2, 48)
    versus["olmo_1b_full_width_2_layers"] = train_card_vs_cpu(
        M, dataclasses.replace(get_config("olmo_1b"), n_layers=2,
                               dtype="float32"), 1, 128)
    out["card_vs_cpu_f32"] = versus
    torch.cuda.empty_cache()
    launched = {m.__name__.rsplit(".", 1)[-1]: m.COUNTS["kernel_launches"]
                for m in kernel_mods if m.COUNTS["kernel_launches"]}
    check(not launched, f"training path launched port kernels {launched}")
    out["kernel_launches"] = 0
    out["seconds"] = time.perf_counter() - t_start
    emit({"train_path": out})
    return out


# ---------------------------------------------------------------------------
# The LM mesh (P12c-1, P12c-2): DTensor over NCCL, in spawned ranks
# ---------------------------------------------------------------------------
def local_tree(tree):
    """Each DTensor leaf's local tensor (on a one-rank mesh, all of it)."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                    tree)


def clone_tree(tree):
    return tree_map(lambda t: t.clone(), tree)


def timed_call(fn) -> tuple:
    """(result, host ms to return, device ms by CUDA events)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    t0 = time.perf_counter()
    out = fn()
    host = (time.perf_counter() - t0) * 1e3
    ev[1].record()
    torch.cuda.synchronize()
    return out, host, ev[0].elapsed_time(ev[1])


def lm_mesh_step(M, cfg, mesh, profile, batches) -> dict:
    """One olmo-1b train step on the mesh against the same step without
    it, from the same parameters on the card: the mesh step under the
    sync debug mode "error", then both timed in turns (plain, mesh, mesh,
    plain; host ms to return and CUDA-event ms), peak memory of the
    mesh's first step, a profiled mesh step."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import param_shardings, use_mesh
    from repro_torch.distributed.sharding import (NamedSharding, batch_spec,
                                                  distribute, distribute_tree)
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    b = batches[0]["tokens"].shape[0]
    params = M.init_params(cfg, 0)
    psh = param_shardings(params, mesh, profile=profile)
    mparams = distribute_tree(clone_tree(params), psh)
    placed = all(isinstance(t, DTensor) and tuple(t.placements)
                 == tuple(sh.placements) for (_, t), (_, sh) in
                 zip(sorted_paths(mparams), sorted_paths(psh)))
    check(placed, f"mesh {profile}: parameters not placed as "
          f"param_shardings says")
    opt, mopt = adamw_init(params), adamw_init(mparams)
    check(all(isinstance(t, DTensor) for t in leaf_list(mopt["m"])),
          f"mesh {profile}: moments are not DTensors")
    tok_sh = NamedSharding(mesh, batch_spec(mesh, b, profile=profile))
    mbatches = [{"tokens": distribute(x["tokens"], tok_sh,
                                      src_data_rank=None)}
                for x in batches]
    step_fn = build_train_step(cfg, warmup_steps=2, total_steps=8)
    state = {"plain": [params, opt], "mesh": [mparams, mopt]}

    def run(which, i):
        p, o = state[which]
        if which == "plain":
            p, o, m = step_fn(p, o, batches[i], i)
        else:
            with use_mesh(mesh, profile=profile):
                p, o, m = step_fn(p, o, mbatches[i], i)
        state[which] = [p, o]
        return m

    pm = run("plain", 1)
    plain_p, plain_m = sample_leaves(params), sample_leaves(opt["m"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mm = guarded(lambda: run("mesh", 1))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(all(not isinstance(v, DTensor) and v.shape == ()
              for v in mm.values()), f"mesh {profile}: metrics {mm}")
    mesh_p = sample_leaves(local_tree(mparams))
    loss, mloss = float(pm["loss"]), float(mm["loss"])
    gnorm, mgnorm = float(pm["grad_norm"]), float(mm["grad_norm"])
    check(all(map(math.isfinite, (loss, mloss, gnorm, mgnorm))),
          f"mesh {profile}: loss {loss} {mloss} grad_norm {gnorm} {mgnorm}")
    equal = [torch.equal(a, c) for a, c in zip(plain_p, mesh_p)]
    lr = float(pm["lr"])
    worst = 0.0
    for a, c, m in zip(plain_p, mesh_p, plain_m):
        a, c, m = a.double(), c.double(), m.double()
        strong = m.abs() > 1e-3 * m.abs().max()
        bound = torch.where(strong, 1e-3 * lr, 2 * lr) + 1e-6 * a.abs()
        worst = max(worst, float(((c - a).abs() / bound).max()))
    loss_rel = abs(mloss - loss) / abs(loss)
    bit_equal = loss == mloss and gnorm == mgnorm and all(equal)
    check(bit_equal or (loss_rel <= REL and worst <= 1.0),
          f"mesh {profile}: loss rel {loss_rel}, parameters at {worst} of "
          f"their bound")
    times = {"plain": [], "mesh": []}
    host = {"plain": [], "mesh": []}
    for k, which in enumerate(("plain", "mesh", "mesh", "plain")):
        _, h, ms = timed_call(lambda: run(which, 2 + k % 2))
        times[which].append(ms)
        host[which].append(h)
    prof = profile_path(f"lm_mesh_step_{profile}",
                        lambda: run("mesh", 3))
    med = float(np.median(times["mesh"]))
    rec = {"profile": profile, "mesh": dict(mesh.shape),
           "loss": loss, "mesh_loss": mloss, "loss_rel": loss_rel,
           "grad_norm": gnorm, "mesh_grad_norm": mgnorm,
           "bit_equal": bit_equal,
           "leaves_bit_equal": f"{sum(equal)}/{len(equal)}",
           "params_err_over_bound": worst, "host_syncs": 0,
           "plain_step_ms": times["plain"], "mesh_step_ms": times["mesh"],
           "plain_host_ms": host["plain"], "mesh_host_ms": host["mesh"],
           "mesh_over_plain": med / float(np.median(times["plain"])),
           "peak_memory_gb_both_states": peak / 1e9,
           "profiled_mesh_step_ms": prof["wall_s"] * 1e3,
           "kernels_per_step": prof["device_kernels"],
           "device_busy_ms": prof["device_busy_s"] * 1e3,
           "busy_share": prof["device_busy_s"] * 1e3 / med,
           "busy_share_profiled": prof["device_busy_share_of_wall"]}
    del state, params, opt, mparams, mopt, mbatches
    torch.cuda.empty_cache()
    return rec


def lm_mesh_restore(M, cfg, mesh, root: Path) -> dict:
    """A checkpoint of olmo-1b's parameters, restored onto the mesh by
    ``restore_resharded`` under both profiles: bit-equal, placed as
    ``param_shardings`` says."""
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import CheckpointManager, restore_resharded
    from repro_torch.distributed import param_shardings
    params = M.init_params(cfg, 1)
    mgr = CheckpointManager(str(root / "ckpt"), keep=1)
    t0 = time.perf_counter()
    mgr.save(1, params)
    save_s = time.perf_counter() - t0
    rec = {"save_s": save_s, "checkpoint_gb": dir_bytes(root / "ckpt")
           / 1e9}
    skeleton = M.abstract_params(cfg)
    for profile in ("tp", "fsdp"):
        sh = param_shardings(skeleton, mesh, profile=profile)
        t0 = time.perf_counter()
        got = restore_resharded(mgr, skeleton, sh, step=1)
        torch.cuda.synchronize()
        rec[f"{profile}_restore_s"] = time.perf_counter() - t0
        for (k, a), (_, g), (_, s) in zip(sorted_paths(params),
                                          sorted_paths(got),
                                          sorted_paths(sh)):
            check(isinstance(g, DTensor) and g.dtype == a.dtype
                  and tuple(g.placements) == tuple(s.placements)
                  and g.to_local().device == a.device
                  and torch.equal(g.to_local(), a),
                  f"restore_resharded {profile}: {k} differs")
        del got
    rec["bit_equal"] = True
    del params
    torch.cuda.empty_cache()
    return rec


def lm_mesh_cross_pod(M, cfg, batch) -> dict:
    """``cross_pod_grad_reduce`` of olmo-1b's real gradient tree on a
    ``pod`` x ``data`` x ``model`` mesh of 1 x 1 x 1: each leaf within one
    LSB (``max|g| / 127``) of its gradient, the errors equal to the
    residual ``g - dequantize(quantize(g))``."""
    from repro_torch.distributed import cross_pod_grad_reduce, quantize_int8
    from repro_torch.launch import make_mesh
    from repro_torch.train.steps import value_and_grad
    pod = make_mesh((1, 1, 1), ("pod", "data", "model"))
    params = M.init_params(cfg, 0)
    _, grads = value_and_grad(params, batch, cfg)
    errors = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                      grads)
    (red, err), _, ms = timed_call(
        lambda: cross_pod_grad_reduce(grads, pod, errors))
    worst = 0.0
    for (k, g), (_, r), (_, e) in zip(sorted_paths(grads), sorted_paths(red),
                                      sorted_paths(err)):
        lsb = float(g.float().abs().max()) / 127
        dev = float((r.float() - g.float()).abs().max())
        q, scale = quantize_int8(g)
        check(r.dtype == g.dtype and dev <= lsb, f"cross_pod {k}: "
              f"{dev} past one LSB {lsb}")
        check(torch.equal(e, g.float() - q.float() * scale),
              f"cross_pod {k}: errors are not the residual")
        worst = max(worst, dev / lsb if lsb else 0.0)
    rec = {"mesh": dict(pod.shape), "leaves": len(leaf_list(grads)),
           "grad_dtype": str(leaf_list(grads)[0].dtype),
           "worst_over_lsb": worst, "errors_equal_residual": True,
           "reduce_ms": ms, "bytes_payload": sum(
               g.numel() for g in leaf_list(grads))}
    del params, grads, errors, red, err
    torch.cuda.empty_cache()
    return rec


def lm_mesh_prefill(M, cfg, mesh, tokens) -> dict:
    """olmo-1b's prefill of B prompts on the mesh (``cache_shardings``,
    ``input_shardings``) against the same prefill without it."""
    from repro_torch.distributed import (cache_shardings, input_shardings,
                                         param_shardings, use_mesh)
    from repro_torch.distributed.sharding import distribute, distribute_tree
    from repro_torch.train import build_prefill
    b, s = tokens.shape
    params = M.init_params(cfg, 0)
    prefill = build_prefill(cfg)
    (logits, cache), _, plain_ms = timed_call(lambda: prefill(
        params, {"tokens": tokens}, M.init_cache(cfg, b, s)))
    mparams = distribute_tree(clone_tree(params),
                              param_shardings(params, mesh))
    mcache = M.init_cache(cfg, b, s)
    mcache = distribute_tree(mcache, cache_shardings(mesh, mcache, b))
    mtok = distribute(tokens, input_shardings(mesh, b)["tokens"],
                      src_data_rank=None)

    def on_mesh():
        with use_mesh(mesh):
            return prefill(mparams, {"tokens": mtok}, mcache)
    on_mesh()                                        # warm-up
    (mlogits, mcache2), host, mesh_ms = timed_call(lambda: guarded(on_mesh))
    # one rank: the mesh runs the plain prefill's ops on whole tensors,
    # so logits and every cache leaf must be bit-equal
    mlogits = local_tree({"x": mlogits})["x"]
    dev = float((mlogits.float() - logits.float()).abs().max())
    check(tuple(mlogits.shape) == (b, 1, cfg.vocab)
          and torch.equal(mlogits, logits),
          f"mesh prefill: logits {dev} from the plain prefill's")
    leaves = 0
    for (k, a), (_, c) in zip(sorted_paths(cache),
                              sorted_paths(local_tree(mcache2))):
        check(c.dtype == a.dtype and torch.equal(a, c),
              f"mesh prefill: cache {k} differs from the plain prefill's")
        leaves += 1
    rec = {"batch": b, "prompt": s, "logits_bit_equal": True,
           "logits_max_abs_dev": dev, "cache_bit_equal": True,
           "cache_leaves": leaves,
           "plain_ms": plain_ms, "mesh_ms": mesh_ms, "mesh_host_ms": host,
           "host_syncs": 0}
    del params, mparams, cache, mcache, mcache2, logits, mlogits
    torch.cuda.empty_cache()
    return rec


def lm_mesh_rank(rank, root, smi) -> None:
    """The one-rank NCCL mesh on GPU 0 (``make_host_mesh()``: 1 x 1):
    olmo-1b at its published width and depth; writes
    ``root/one_rank.json``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(root)
    mesh = make_host_mesh()
    check(mesh.shape == {"data": 1, "model": 1}
          and mesh.device_mesh is not None
          and mesh.device_mesh.device_type == "cuda",
          f"host mesh {mesh}")
    cfg = get_config("olmo_1b")
    b, s, _ = TRAIN_MAIN
    batches = [train_batch(cfg, b, s, i, "cuda") for i in range(4)]
    rec = {"arch": "olmo_1b", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "params": n_params(M, cfg), "dtype": cfg.dtype, "batch": b,
           "seq": s, "backend": "nccl", "ranks": 1, "power_limit": smi}
    # the rank's own counters: the path runs in this process
    mods = kernel_modules()
    reset_all(mods)
    for profile in ("tp", "fsdp"):
        rec[profile] = lm_mesh_step(M, cfg, mesh, profile, batches)
    rec["restore_resharded"] = lm_mesh_restore(M, cfg, mesh, root)
    rec["cross_pod"] = lm_mesh_cross_pod(M, cfg, batches[0])
    rec["prefill"] = lm_mesh_prefill(M, cfg, mesh, batches[0]["tokens"])
    rec["kernel_launches"] = launch_counts(mods)
    (root / "one_rank.json").write_text(json.dumps(rec))


def lm_mesh_rank_many(rank, root, n, one_loss) -> None:
    """olmo-1b's step on ``n`` NCCL ranks, one GPU each, a
    ``(n / 2, 2)`` mesh, under ``tp`` and ``fsdp``: the loss within
    ``LM_MESH_REL`` of the one-device step's; rank 0 writes
    ``root/several.json``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import param_shardings, use_mesh
    from repro_torch.distributed.sharding import (NamedSharding, batch_spec,
                                                  distribute, distribute_tree)
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(model=2)
    cfg = get_config("olmo_1b")
    b, s, _ = TRAIN_MAIN
    batch = train_batch(cfg, b, s, 1, "cuda")
    rec = {"ranks": n, "mesh": dict(mesh.shape)}
    mods = kernel_modules()
    reset_all(mods)
    for profile in ("tp", "fsdp"):
        params = M.init_params(cfg, 0)
        params = distribute_tree(params, param_shardings(params, mesh,
                                                         profile=profile))
        opt = adamw_init(params)
        tokens = distribute(batch["tokens"], NamedSharding(
            mesh, batch_spec(mesh, b, profile=profile)), src_data_rank=None)
        step_fn = build_train_step(cfg, warmup_steps=2, total_steps=8)

        def run():
            with use_mesh(mesh, profile=profile):
                return step_fn(params, opt, {"tokens": tokens}, 1)[2]
        m = guarded(run)
        m2, _, ms = timed_call(run)
        loss = float(m["loss"])
        rel = abs(loss - one_loss) / abs(one_loss)
        check(math.isfinite(loss) and rel <= LM_MESH_REL,
              f"{n} ranks {profile}: loss {loss} against {one_loss}")
        rec[profile] = {"loss": loss, "one_device_loss": one_loss,
                        "loss_rel": rel, "step_ms": ms,
                        "peak_memory_gb": torch.cuda.max_memory_allocated()
                        / 1e9}
        del params, opt, tokens
        torch.cuda.empty_cache()
    rec["kernel_launches"] = launch_counts(mods)
    (Path(root) / f"several{rank}.json").write_text(json.dumps(rec))


def lm_mesh_launch(root: Path) -> dict:
    """``python -m repro_torch.launch.train --devices 1`` (one NCCL rank,
    reduced olmo, 3 steps) under ``tp`` and ``fsdp``: exit 0, the host
    mesh printed, a finite loss; ``--production-mesh`` exits with the
    reference's ``RuntimeError``."""
    env = dict(__import__("os").environ, PYTHONPATH=str(source_dir()))
    rec = {}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--reduced"]
    for profile in ("tp", "fsdp"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            base + ["--devices", "1", "--steps", "3", "--profile", profile,
                    "--ckpt-dir", str(root / f"launch_{profile}")],
            env=env, capture_output=True, text=True, timeout=600)
        out = proc.stdout
        check(proc.returncode == 0, f"launch.train --devices 1 {profile}: "
              f"exit {proc.returncode}\n{out[-2000:]}\n{proc.stderr[-4000:]}")
        check(f"mesh: {{'data': 1, 'model': 1}}  profile: {profile}" in out
              and "finished at step 3" in out, f"launch.train: {out}")
        last = [ln for ln in out.splitlines() if ln.startswith("step ")][-1]
        loss = float(last.split("loss")[1].split()[0])
        check(math.isfinite(loss), f"launch.train: loss {loss}")
        rec[profile] = {"exit": 0, "loss": loss,
                        "wall_s": time.perf_counter() - t0}
    proc = subprocess.run(base + ["--production-mesh", "--ckpt-dir",
                                  str(root / "launch_prod")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode != 0 and "RuntimeError: mesh (16, 16) needs 256 "
          "devices" in proc.stderr, f"--production-mesh: exit "
          f"{proc.returncode}\n{proc.stderr[-2000:]}")
    rec["production_mesh"] = proc.stderr.strip().splitlines()[-1][:200]
    return rec


def lm_mesh_path(smi, kernel_mods=()) -> dict:
    """The LM mesh (P12c-1) and the int8 cross-pod reduction (P12c-2) on
    the card, in ranks spawned for the phase (their process group ends
    with it): a one-rank NCCL mesh on GPU 0 (``lm_mesh_rank``), the
    training entry point's mesh flags (``lm_mesh_launch``), and, where
    several GPUs are visible, the step on ``(count / 2, 2)`` ranks
    (``lm_mesh_rank_many``).  No kernel of the port is on the path: each
    rank resets its launch counters before its run and reads them after
    it, and every count must be 0."""
    import shutil
    from repro_torch.launch import spawn
    t_start = time.perf_counter()
    reset_all(kernel_mods)
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent / "build" / "lm_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        spawn(lm_mesh_rank, 1, (str(root), smi), device="cuda",
              store_dir=str(root))
        rec = json.loads((root / "one_rank.json").read_text())
        emit({"lm_mesh_one_rank": rec})
        launched = {"rank 0": rec["kernel_launches"]}
        rec["launch_train"] = lm_mesh_launch(root)
        count = torch.cuda.device_count()
        if count >= 2:
            n = count // 2 * 2
            spawn(lm_mesh_rank_many, n, (str(root), n,
                                         rec["tp"]["loss"]),
                  device="cuda", store_dir=str(root / "many"))
            many = [json.loads((root / f"several{r}.json").read_text())
                    for r in range(n)]
            rec["several_gpus"] = many[0]
            launched.update({f"{n} ranks, rank {r}": m["kernel_launches"]
                             for r, m in enumerate(many)})
        else:
            rec["several_gpus"] = ("one GPU visible: the LM mesh ran one "
                                   "rank; the split across ranks is held "
                                   "on the CPU over gloo")
            print("lm_mesh_path: one GPU visible, the mesh ran one rank",
                  flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the ranks' own counters, read in each rank after its run; the
    # launch.train subprocesses' are not read (their own processes)
    launched["parent"] = launch_counts(kernel_mods)
    check(not any(n for c in launched.values() for n in c.values()),
          f"LM mesh path launched port kernels {launched}")
    rec["kernel_launches"] = launched
    rec["seconds"] = time.perf_counter() - t_start
    emit({"lm_mesh_path": rec})
    return rec

# ---------------------------------------------------------------------------
# The dry run and the energy model (P12c-3): a fake process group of 512
# ranks in a process of its own, no kernel of the port
# ---------------------------------------------------------------------------
# (arch, shape, multi-pod): olmo-1b's four cells, an MoE and the hybrid
# with costs on 16 x 16, olmo-1b's decode on 2 x 16 x 16
DRYRUN_CELLS = (("olmo_1b", "train_4k", False),
                ("olmo_1b", "prefill_32k", False),
                ("olmo_1b", "decode_32k", False),
                ("olmo_1b", "long_500k", False),
                ("mixtral_8x7b", "long_500k", False),
                ("zamba2_1p2b", "train_4k", False),
                ("olmo_1b", "decode_32k", True))
DRYRUN_FLOPS_8NT = (0.85, 1.2)    # the traced olmo-1b step over 8NT
DRYRUN_PEAK = (0.5, 2.0)          # predicted peak over the measured one
DRYRUN_DECODE_HAND_BOUND_MS = 4.29   # PERF.md: qwen2-7b decode, B = 4


def dryrun_estimate(D, cfg, shape, mesh) -> dict:
    """One cell's step traced on a 1 x 1 mesh: the reference's keys, the
    H100 roofline terms and bound, and the energy model's joules."""
    from repro_torch.energy import (H100, model_flops, roofline_terms,
                                    tpu_energy_report)
    rec = D._compile(cfg, shape, mesh, True)
    terms = roofline_terms(rec["flops_dev"], rec["bytes_dev"],
                           rec["coll_bytes_dev"], 1,
                           model_flops(cfg, shape.kind, shape.global_batch,
                                       shape.seq_len), hw=H100)
    rec.update(roofline=terms.as_dict(), bound_ms=terms.bound_time * 1e3,
               energy=tpu_energy_report(rec["flops_dev"], rec["bytes_dev"],
                                        rec["coll_bytes_dev"], 1, hw=H100))
    return rec


def dryrun_child(out: str, part: int) -> None:
    """One of phase 13's processes: ``DRYRUN_CELLS[part]`` through
    ``run_cell`` (fake tensors on ``cuda``), or, at ``part ==
    len(DRYRUN_CELLS)``, the estimates on a 1 x 1 mesh of the training
    phase's olmo-1b step and the serving phase's qwen2-7b decode; its own
    kernel launch counters, zeroed first; all written to ``out`` as
    JSON."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import SHAPES, ShapeSpec
    mods = kernel_modules()
    reset_all(mods)
    t0 = time.perf_counter()
    rec = {"cells": {}}
    if part < len(DRYRUN_CELLS):
        arch, shape, multi = DRYRUN_CELLS[part]
        cell = D.run_cell(arch, SHAPES[shape], multi_pod=multi)
        cell["seconds"] = time.perf_counter() - t0
        rec["cells"][f"{arch}|{shape}|{'multi' if multi else 'single'}"] = \
            cell
    else:
        D.fake_group()
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        b, s, _ = TRAIN_MAIN
        rec["olmo_1b_train"] = dryrun_estimate(
            D, get_config("olmo_1b"),
            ShapeSpec("train_path", "train", s, b), mesh)
        b, _, max_seq, _ = LM_MAIN
        rec["qwen2_7b_decode"] = dryrun_estimate(
            D, get_config("qwen2_7b"),
            ShapeSpec("lm_path", "decode", max_seq, b), mesh)
        rec["estimates_s"] = time.perf_counter() - t0
    rec["kernel_launches"] = launch_counts(mods)
    rec["seconds"] = time.perf_counter() - t0
    Path(out).write_text(json.dumps(rec))


def dryrun_start():
    """Start phase 13's processes (``dryrun_child``), one for each
    production cell and one for the estimates, together: they trace on
    the host once every phase on the card has ended."""
    root = Path(__file__).resolve().parent
    env = dict(__import__("os").environ, PYTHONPATH=str(source_dir()),
               OMP_NUM_THREADS="1")
    started = []
    for part in range(len(DRYRUN_CELLS) + 1):
        out = root / "build" / f"dryrun_smoke_{part}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        if out.exists():
            out.unlink()
        started.append((subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as c; "
             f"c.dryrun_child({str(out)!r}, {part})"], cwd=str(root),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), out))
    return started, time.perf_counter()


def dryrun_path(smi, started, train, lm) -> dict:
    """The dry run and the energy model (P12c-3): the production cells
    ``ok`` or ``skipped``; the traced olmo-1b step against the training
    phase's measured one (FLOPs within ``DRYRUN_FLOPS_8NT`` x 8NT, the
    predicted peak within ``DRYRUN_PEAK`` x ``max_memory_allocated``;
    its H100 bound beside the step ms, NVML's joules a step beside the
    model's, printed), qwen2-7b's decode beside the serving phase's ms a
    token (printed); the process's kernel launch counters all 0."""
    procs, t_start = started
    rec = {"cells": {}, "kernel_launches": {}, "seconds": {}}
    try:
        for part, (proc, out) in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=900)
            check(proc.returncode == 0 and out.exists(),
                  f"dry run process {part}: exit {proc.returncode}\n"
                  f"{stdout[-2000:]}\n{stderr[-4000:]}")
            one = json.loads(out.read_text())
            rec["cells"].update(one.pop("cells"))
            counts = rec["kernel_launches"]
            for k, v in one.pop("kernel_launches").items():
                counts[k] = counts.get(k, 0) + v
            rec["seconds"][part] = one.pop("seconds")
            rec.update(one)
    finally:
        for proc, _ in procs:
            proc.kill()
            proc.communicate()
    for key, cell in rec["cells"].items():
        check(cell["status"] in ("ok", "skipped"),
              f"dry run {key}: {cell.get('error')}\n"
              f"{cell.get('traceback', '')}")
        if cell["status"] == "skipped":
            print(f"dryrun {key}: skipped ({cell['reason'][:40]})",
                  flush=True)
            continue
        r = cell.get("roofline", {})
        print(f"dryrun {key}: dominant={r.get('dominant', 'n/a')} "
              f"roofline_fraction={r.get('roofline_fraction', 'n/a')} "
              f"scan_peak_gb_dev={cell['scan_peak_gb_dev']:.3f} "
              f"fits_hbm={cell['fits_hbm']} ({cell['seconds']:.1f} s)",
              flush=True)
    olmo, qwen = rec["olmo_1b_train"], rec["qwen2_7b_decode"]
    n, tokens = train["params"], train["tokens_per_step"]
    ratio = olmo["flops_dev"] / (8 * n * tokens)
    peak = olmo["peak_gb_dev"] * 1e9 / train["peak_memory_bytes"]
    print(f"dryrun olmo_1b step: flops_dev={olmo['flops_dev']:.4e} "
          f"({ratio:.4f} x 8NT) bound={olmo['bound_ms']:.2f} ms "
          f"({olmo['roofline']['dominant']}) vs measured "
          f"{train['step_ms_median']:.2f} ms; peak "
          f"{olmo['peak_gb_dev']:.3f} GB predicted vs "
          f"{train['peak_memory_gb']:.3f} GB measured ({peak:.3f} x)",
          flush=True)
    print(f"dryrun energy: NVML {train['nvml_j_per_step']} J a step vs "
          f"model {olmo['energy']['e_total_j']:.3f} J "
          f"({olmo['energy']['dominant']}-dominated)", flush=True)
    q = lm["qwen2_7b"]
    print(f"dryrun qwen2_7b decode (B = {LM_MAIN[0]}): bound "
          f"{qwen['bound_ms']:.3f} ms ({qwen['roofline']['dominant']}), "
          f"hand bound {DRYRUN_DECODE_HAND_BOUND_MS} ms, measured "
          f"{q['decode_ms_per_token']:.2f} ms a token; peak "
          f"{qwen['peak_gb_dev']:.3f} GB", flush=True)
    check(DRYRUN_FLOPS_8NT[0] <= ratio <= DRYRUN_FLOPS_8NT[1],
          f"dry run olmo-1b FLOPs {ratio} x 8NT")
    check(DRYRUN_PEAK[0] <= peak <= DRYRUN_PEAK[1],
          f"dry run olmo-1b peak {peak} x the measured one")
    check(not any(rec["kernel_launches"].values()),
          f"dry run launched port kernels {rec['kernel_launches']}")
    rec.update(
        power_limit=smi, flops_over_8nt=ratio, peak_over_measured=peak,
        measured_step_ms=train["step_ms_median"],
        measured_peak_gb=train["peak_memory_gb"],
        nvml_j_per_step=train["nvml_j_per_step"],
        nvml_w_timed=train["nvml_w_timed"],
        model_j_per_step=olmo["energy"]["e_total_j"],
        measured_decode_ms_per_token=q["decode_ms_per_token"],
        hand_decode_bound_ms=DRYRUN_DECODE_HAND_BOUND_MS,
        wall_s=time.perf_counter() - t_start)
    emit({"dryrun_path": rec})
    return rec


# ---------------------------------------------------------------------------
# The examples (P15) and the static checks (P13)
# ---------------------------------------------------------------------------
MEGA_EXAMPLE_POINTS = 8 * 18 * 3 * 8 * 6 * 5 * 3 * 5 * 7 * 4   # MEGA_SWEEP=1
#: a printed number of the examples: 27,648 / 0.423 / 3.034e-05
EXAMPLE_NUM = r"-?\d[\d,]*(?:\.\d+)?(?:e[+-]?\d+)?"


def same_printed(got: str, want: str) -> bool:
    """Two printed lines equal to their printed digits, within one unit
    of each number's last digit."""
    import re
    num = re.compile(EXAMPLE_NUM)
    if num.sub("#", got) != num.sub("#", want):
        return False
    for g, w in zip(num.findall(got), num.findall(want)):
        mant, _, exp = w.replace(",", "").partition("e")
        unit = 10.0 ** (-(len(mant.split(".")[1]) if "." in mant else 0)
                        + int(exp or 0))
        if abs(float(g.replace(",", "")) - float(w.replace(",", ""))) \
                > 1.0000001 * unit:
            return False
    return True


def captured(fn, log: Path):
    """``fn()`` with its standard output written to ``log``; returns
    ``(result, text)``."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text(buf.getvalue())
    return result, buf.getvalue()


def examples_path(smi, kernel_mods) -> dict:
    """Phase 14: the three examples (``repro_torch.examples``) in this
    process on the card, each with the launch counters zeroed just before
    it and read just after, their output under ``build/examples/``.

    * ``quickstart``: K5 ``binning`` once and K6 ``stencil_conv`` twice;
      its lines equal the same script's on the CPU (within one unit of
      the last printed digit);
    * ``explore_design_space`` with ``MEGA_SWEEP=1``: the Sec. 6 studies
      and the hook-axis ``explore()`` on K4, the registry demo, the
      mega-sweep of 43,545,600 points over 8 variants at chunk 2^17 and
      the campaigns and the two-tenant service on K1 (its own verdicts
      assert inside); the lines of its first three sections equal those
      sections on the CPU; the mega-sweep's top-k rows, flat indices and
      per-variant summaries (counts, argmins, minima, means) bit-equal to
      ``engine="staged"`` on the same space (K2, K3a);
    * ``train_lm`` at its defaults (200 steps of reduced qwen3-4b, 8 x 64
      tokens): ``LEARNED``, no port kernel (every counter 0), ms a step.
    """
    import os
    from repro_torch.examples import explore_design_space as eds
    from repro_torch.examples import quickstart, train_lm
    from repro_torch.explore import explore
    root = Path(__file__).resolve().parent / "build" / "examples"
    t_start = time.perf_counter()
    rec = {"power_limit": smi}

    # ----- quickstart: K5, K6 ----------------------------------------------
    reset_all(kernel_mods)
    t0 = time.perf_counter()
    rc, card = captured(lambda: quickstart.main(["--device", "cuda"]),
                        root / "quickstart_cuda.log")
    qs_counts = launch_counts(kernel_mods)
    qs_s = time.perf_counter() - t0
    _, cpu = captured(lambda: quickstart.main(["--device", "cpu"]),
                      root / "quickstart_cpu.log")
    check(rc == 0 and qs_counts["binning"] >= 1
          and qs_counts["stencil_conv"] >= 2,
          f"quickstart: rc {rc}, launches {qs_counts}")
    lines = list(zip(card.splitlines(), cpu.splitlines()))
    check(len(card.splitlines()) == len(cpu.splitlines()) and all(
        same_printed(a, b) for a, b in lines),
        f"quickstart on the card differs from the CPU:\n{card}\n{cpu}")
    rec["quickstart"] = {"seconds": qs_s, "launches": {
        k: v for k, v in qs_counts.items() if v},
        "functional_line": card.splitlines()[-1]}

    # ----- explore_design_space, MEGA_SWEEP=1: K1, K4 ------------------------
    prev = os.environ.get("MEGA_SWEEP")
    os.environ["MEGA_SWEEP"] = "1"
    try:
        reset_all(kernel_mods)
        t0 = time.perf_counter()
        out, text = captured(lambda: eds.run(["--device", "cuda"]),
                             root / "explore_design_space_cuda.log")
        ex_s = time.perf_counter() - t0
        ex_counts = launch_counts(kernel_mods)
    finally:
        if prev is None:
            os.environ.pop("MEGA_SWEEP")
        else:
            os.environ["MEGA_SWEEP"] = prev
    mega = out["mega"]
    par = out["campaigns"][2].campaign
    worker_k1 = sum(c["kernel_launches"]
                    for c in par["worker_counters"].values())
    check(ex_counts["fused_sweep"] > 0 and ex_counts["category_reduce"] > 0,
          f"explore_design_space: launches {ex_counts}")
    check(mega.n_points == MEGA_EXAMPLE_POINTS and mega.n_variants == 8
          and mega.chunk_size == 1 << 17 and mega.backend == "cuda",
          f"mega-sweep: {mega.n_points} points, {mega.n_variants} "
          f"variants, chunk {mega.chunk_size}, backend {mega.backend}")
    # the first three sections against the same functions on the CPU
    def head_sections():
        eds.sec6_tables("cpu")
        eds.hook_axes("cpu")
        eds.registry_demo("cpu")
    _, cpu_text = captured(head_sections,
                           root / "explore_design_space_cpu_head.log")
    card_head = text.split("\n=== Streaming mega-sweep")[0].splitlines()
    cpu_head = cpu_text.rstrip("\n").splitlines()
    skip = ("=== explore(): ", "=== Registry demo")
    pairs = [(a, b) for a, b in zip(card_head, cpu_head)
             if not a.startswith(skip)]
    check(len(card_head) == len(cpu_head)
          and all(same_printed(a, b) for a, b in pairs),
          "explore_design_space's tables on the card differ from the CPU")
    # the mega-sweep against the staged engine on the same space
    t0 = time.perf_counter()
    staged = explore(eds.mega_space(True), engine="staged",
                     chunk_size=eds.mega_chunk(True), k=mega.k)
    staged_s = time.perf_counter() - t0
    check(mega.topk == staged.topk, "mega-sweep: top-k differs from staged")
    check((mega.n_points, mega.n_feasible)
          == (staged.n_points, staged.n_feasible),
          f"mega-sweep counts {mega.n_feasible} vs staged "
          f"{staged.n_feasible}")
    for label, sa in mega.summaries.items():
        sb = staged.summaries[label]
        ma, mb = sa["metric_mean"], sb["metric_mean"]
        rest = [{k: v for k, v in x.items() if k != "metric_mean"}
                for x in (sa, sb)]
        check((ma == mb or math.isnan(ma) and math.isnan(mb))
              and rest[0] == rest[1],
              f"mega-sweep: {label} summary differs from staged: {sa} "
              f"vs {sb}")
    rec["explore_design_space"] = {
        "seconds": ex_s, "launches": {k: v for k, v in ex_counts.items()
                                      if v},
        "campaign_worker_k1_launches": worker_k1,
        "mega": {"points": mega.n_points, "variants": mega.n_variants,
                 "chunk": mega.chunk_size, "eval_s": mega.eval_s,
                 "wall_s": mega.wall_s, "compile_s": mega.compile_s,
                 "points_per_s": mega.points_per_sec,
                 "dispatches": mega.dispatches,
                 "superchunk": mega.superchunk,
                 "n_feasible": mega.n_feasible,
                 "best_total_j": mega.topk[0]["total_j"]},
        "staged": {"eval_s": staged.eval_s, "wall_s": staged_s,
                   "dispatches": staged.dispatches,
                   "topk_and_summaries_bit_equal": True},
        "verdicts": [ln for ln in text.splitlines()
                     if "identical" in ln or "group=" in ln
                     or "cache_hit=" in ln]}

    # ----- train_lm at its defaults: no port kernel -------------------------
    ckpt = root / "train_lm_ckpt"
    reset_all(kernel_mods)
    t0 = time.perf_counter()
    tr, tr_text = captured(lambda: train_lm.run(
        ["--device", "cuda", "--ckpt-dir", str(ckpt)]),
        root / "train_lm_cuda.log")
    tr_s = time.perf_counter() - t0
    __import__("shutil").rmtree(ckpt, ignore_errors=True)
    tr_counts = launch_counts(kernel_mods)
    hist = tr["history"]
    check("(LEARNED)" in tr_text.splitlines()[-1],
          f"train_lm did not learn: {tr_text.splitlines()[-1]}")
    check(not any(tr_counts.values()),
          f"train_lm launched port kernels {tr_counts}")
    rec["train_lm"] = {
        "seconds": tr_s, "steps": tr["step"],
        "first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
        "ms_per_step_median": 1e3 * float(np.median(
            [h["step_time_s"] for h in hist])),
        "verdict": tr_text.splitlines()[-1].split(";")[0]}

    launches = {}
    for part in (qs_counts, ex_counts):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    launches["fused_sweep"] += worker_k1
    rec["kernel_launches"] = {k: v for k, v in launches.items() if v}
    rec["wall_s"] = time.perf_counter() - t_start
    print(f"examples_path: {rec['wall_s']:.1f} s on {smi}", flush=True)
    emit({"examples_path": rec})
    return rec


def static_checks(smi) -> dict:
    """Phase 15: ``python -m repro_torch.analysis`` over its default scope
    (the port's core, kernels, explore and serve) under this machine's
    Python: exit 0 with 0 findings against the empty baseline."""
    import os
    from repro_torch.analysis import RULE_MAP, rule_names
    root = Path(__file__).resolve().parent
    report = root / "build" / "analysis_report.json"
    report.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--report",
         str(report)], cwd=str(root), capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(source_dir())))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"static checks: exit {proc.returncode}\n"
          f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    counts = json.loads(report.read_text())["counts"]
    check(counts["total"] == 0 and "0 finding(s)" in proc.stdout,
          f"static checks: {proc.stdout[-4000:]}")
    rec = {"rules": len(rule_names()), "reference_rules": len(RULE_MAP),
           "not_applicable": sorted(k for k, (p, _r) in RULE_MAP.items()
                                    if p is None),
           "findings": counts["total"], "exit_code": proc.returncode,
           "summary": next(ln for ln in proc.stdout.splitlines()
                           if "finding(s)" in ln),
           "wall_s": wall, "power_limit": smi}
    print(f"static_checks: {rec['rules']} rules, {rec['findings']} "
          f"findings, {wall:.1f} s on {smi}", flush=True)
    emit({"static_checks": rec})
    return rec


def ptxas_by_entry(log: str) -> dict:
    """nvcc's ``-Xptxas -v`` report as ``{kernel: "registers, stack and
    spills"}``, the kernel names demangled by ``c++filt`` where it runs."""
    entries, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
            entries[cur] = []
        elif cur is not None and ("registers" in ln or "spill" in ln):
            entries[cur].append(ln.split(":", 1)[-1].strip())
    try:
        names = subprocess.run(["c++filt"], input="\n".join(entries),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) != len(entries):
        names = list(entries)
    return {name.replace("(anonymous namespace)::", "").split("(")[0]:
            "; ".join(v) for name, v in zip(names, entries.values())}


def reset_all(mods) -> None:
    for mod in mods:
        mod.reset_counts()


def kernel_modules() -> tuple:
    """The port's kernel wrappers, each with its launch ``COUNTS``: K1,
    K2, K3, K4, the functional path's (``FUNC_KERNELS``), K9."""
    names = ("fused_sweep", "grid_decode", "stream_reduce",
             "category_reduce", *FUNC_KERNELS, "flash_attention")
    return tuple(importlib.import_module(f"repro_torch.kernels.{n}")
                 for n in names)


def launch_counts(mods) -> dict:
    """``{kernel module: launches}`` since the last ``reset_all``."""
    return {m.__name__.rsplit(".", 1)[-1]: m.COUNTS["kernel_launches"]
            for m in mods}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.batch import build_coeff_compute, interp_tables
    from repro_torch.core.shard_sweep import _prepare_stream
    from repro_torch.core.sweep import scalar_point
    from repro_torch.explore import DesignSpace, explore
    from repro_torch.kernels import cuda_build
    kernel_mods = kernel_modules()
    fs, gd, sr, cr = kernel_mods[:4]
    fmods = dict(zip(FUNC_KERNELS, kernel_mods[4:-1]))
    fa = kernel_mods[-1]

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    emit({"device": kind, "nvidia_smi": smi[0] if smi else None,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    # ----- 1. build: one nvcc per source, all started together -------------
    t0 = time.perf_counter()
    cuda_build.build_libraries(KERNEL_SOURCES)
    for mod in kernel_mods:
        mod.load_kernel_library()
    emit({"build": {
        "seconds": time.perf_counter() - t0,
        "ptxas": {name: ptxas_by_entry(cuda_build.build_info(name)["log"])
                  for name in KERNEL_SOURCES}}})

    # ----- 2. each kernel vs its twin on the card ---------------------------
    prep = _prepare_stream(["edgaze", "rhythmic"], MEGA_GRIDS, device="cuda")
    check(prep.total == MEGA_POINTS, f"mega space has {prep.total} points")
    compute = build_coeff_compute(prep.bank.dims)
    n_var = prep.n_var
    recs = []
    for kk in (3, 16):                        # the main-path chunk
        recs.append(run_case(prep, fs, compute, name=f"main_chunk_kk{kk}",
                             variant=2, start=2 * n_var + CHUNK, low=0,
                             limit=3 * n_var, chunk=CHUNK, bp=4096, kk=kk))
    cpv = -(-n_var // CHUNK)                  # the variant's masked tail
    recs.append(run_case(prep, fs, compute, name="masked_tail_chunk",
                         variant=6, start=6 * n_var + (cpv - 1) * CHUNK,
                         low=0, limit=7 * n_var, chunk=CHUNK, bp=4096, kk=3))
    recs.append(run_case(prep, fs, compute, name="ragged_chunk",
                         variant=0, start=12345, low=0, limit=n_var,
                         chunk=100_003, bp=4096, kk=5))
    recs.append(run_case(prep, fs, compute, name="low_limit_inside",
                         variant=4, start=4 * n_var + 5000,
                         low=4 * n_var + 5000 + 777,
                         limit=4 * n_var + 5000 + 9000, chunk=16384,
                         bp=4096, kk=16))
    recs.append(run_case(prep, fs, compute, name="kk_above_bp",
                         variant=1, start=n_var, low=0, limit=2 * n_var,
                         chunk=64, bp=8, kk=16))
    recs.append(synthetic_case(fs))
    wide = _prepare_stream("edgaze", WIDE_GRIDS, device="cuda")
    wide_compute = build_coeff_compute(wide.bank.dims)
    recs.append(run_case(wide, fs, wide_compute, name="int64_beyond_2^31",
                         variant=0, start=WIDE_POINTS - 70_000, low=0,
                         limit=WIDE_POINTS, chunk=CHUNK, bp=4096, kk=4,
                         idx_dtype=torch.int64))
    recs += fused_plan_cases(fs, prep, compute)
    # F5: NaN metrics. Four of five active_fraction_scale values NaN with
    # blocks of 16 (a few finite points a block, masked ones at either
    # end); then every value NaN at the main-path chunk
    recs.append(nan_case(fs, prep, compute, name="nan_most_points",
                         variant=3, nan_values=(1, 2, 3, 4),
                         start=3 * n_var + 999, low=3 * n_var + 1005,
                         limit=3 * n_var + 999 + 4000, chunk=4096, bp=16,
                         kk=8))
    recs.append(nan_case(fs, prep, compute, name="nan_all_points",
                         variant=5, nan_values=range(5),
                         start=5 * n_var + CHUNK, low=0, limit=6 * n_var,
                         chunk=CHUNK, bp=4096, kk=3))

    k2 = decode_cases(gd, prep, wide)
    vals, mask = stats_inputs(CHUNK, 1, empty_block=(5 * 4096, 6 * 4096))
    k3a = [stats_case(sr, name="stats_main_chunk", values=vals, mask=mask,
                      bp=4096)]
    rvals, rmask = stats_inputs(CHUNK - 1234, 2, ties=True)
    k3a.append(stats_case(sr, name="stats_ragged_ties", values=rvals,
                          mask=rmask, bp=4096))
    check(k3a[0]["empty_blocks"] >= 1, "no all-masked block in the case")
    k3a += stats_plan_cases(sr, vals, mask)
    vid = (torch.arange(CHUNK, device="cuda") % 8).to(torch.int32)
    vid[-5000:] = -1                          # padding rows
    k3b = [stats_case(sr, name="stats_banked_8_variants", values=vals,
                      mask=mask, bp=4096, variant=vid, n_variants=8)]
    k3b_more, k3a_nan = banked_cases(sr, gd, prep, vals, mask, vid)
    k3b += k3b_more
    k3a += k3a_nan
    e_main, w_main = reduce_inputs(CHUNK, 11, 10, 3)
    k4 = [reduce_case(cr, name="reduce_main_chunk", e=e_main, w=w_main)]
    # ragged B around a block's 256 rows, odd and even U, U past the 32
    # units staged at a time, each column capacity (8, 10, 16, 32)
    for b, u, c in ((100_003, 11, 10), (1, 11, 10), (255, 11, 10),
                    (257, 32, 32), (CHUNK + 3, 11, 10), (1000, 6, 8),
                    (4099, 33, 17), (513, 12, 16), (700, 64, 32)):
        e_c, w_c = reduce_inputs(b, u, c, b + u + c)
        k4.append(reduce_case(cr, name=f"reduce_{b}x{u}x{c}", e=e_c, w=w_c))
    e_off = torch.empty(1000 * 11 + 1, device="cuda")[1:].view(1000, 11)
    e_off.copy_(reduce_inputs(1000, 11, 10, 5)[0])
    k4.append(reduce_case(cr, name="reduce_unaligned_rows", e=e_off,
                          w=w_main))
    fcases = functional_kernel_cases(fmods)
    k9 = attention_cases(fa)
    # launch-path probe: host us per step and per wrapper call
    kmods = dict(zip(KERNEL_SOURCES, kernel_mods))
    launch_probe(kmods, headline_calls(kmods, prep, compute),
                 *c_entry_steps(kmods, torch.device("cuda", 0)))

    # ----- 3. the main path at full width: fused ----------------------------
    space = DesignSpace(["edgaze", "rhythmic"], MEGA_GRIDS)
    explore(space, engine="fused", chunk_size=CHUNK, k=3)   # warm-up
    reset_all(kernel_mods)
    res = explore(space, engine="fused", chunk_size=CHUNK, k=3)
    launches = fs.COUNTS["kernel_launches"]
    twin_calls = fs.COUNTS["twin_calls"]
    by_cluster = {c: fs.COUNTS[f"cluster{c}_launches"]
                  for c in fs.CLUSTER_CHOICES}
    check(sum(by_cluster.values()) == launches,
          f"main path: launches by cluster size {by_cluster}")
    # folding stays on the device, so only prep and finalize may
    # synchronise, never once per chunk.  The sync debug mode's first use
    # in a process counts one sync more (seen on the card), so a probe
    # runs first and the counts that follow are exact.
    def event_wait():
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
    count_syncs(event_wait)
    wait_counted = count_syncs(event_wait)
    check(wait_counted in (0, 1), f"an event wait counts {wait_counted}")
    syncs = count_syncs(lambda: explore(space, engine="fused",
                                        chunk_size=CHUNK, k=3))
    check(syncs < launches, f"main path: {syncs} host syncs for "
          f"{launches} kernel launches")
    check(res.n_points == MEGA_POINTS, f"swept {res.n_points} points")
    check(res.backend == "cuda", f"main path ran backend {res.backend}")
    check(launches > 0 and twin_calls == 0,
          f"main path: {launches} kernel launches, {twin_calls} twin calls")
    check(len(res.topk) == 3 and all(
        math.isfinite(r[key]) for r in res.topk for key in r
        if isinstance(r[key], float)), "main path: top-k rows not finite")
    # progress fires once per dispatch with the host-known points covered;
    # pipeline_depth = 1 makes the host wait on the oldest dispatch's event
    # dispatches - 1 times, a wait that copies no data.  Whether the sync
    # debug mode counts an event wait is probed above, so the count is
    # exact.
    calls = []
    paced = explore(space, engine="fused", chunk_size=CHUNK, k=3,
                    pipeline_depth=1,
                    progress=lambda done, span: calls.append((done, span)))
    check(len(calls) == paced.dispatches == res.dispatches
          and calls[-1] == (MEGA_POINTS, MEGA_POINTS)
          and all(a[0] < b[0] for a, b in zip(calls, calls[1:])),
          f"main path: progress calls {calls}")
    compare_results("paced_vs_main", paced, res)
    paced_syncs = count_syncs(lambda: explore(
        space, engine="fused", chunk_size=CHUNK, k=3, pipeline_depth=1))
    want_syncs = syncs + wait_counted * max(0, res.dispatches - 1)
    check(paced_syncs == want_syncs, f"main path at pipeline_depth=1: "
          f"{paced_syncs} host syncs, want {want_syncs}")
    emit({"main_path": {
        "points": res.n_points, "n_feasible": res.n_feasible,
        "points_per_s": res.points_per_sec, "eval_s": res.eval_s,
        "compile_s": res.compile_s, "wall_s": res.wall_s,
        "dispatches": res.dispatches, "superchunk": res.superchunk,
        "occupancy": res.occupancy, "kernel_launches": launches,
        "launches_by_cluster": by_cluster,
        "twin_calls": twin_calls, "host_syncs": syncs,
        "progress_calls": len(calls), "event_wait_counts_as_sync":
        bool(wait_counted), "host_syncs_at_pipeline_depth_1": paced_syncs,
        "best_total_j": res.topk[0]["total_j"]}})

    fs.reset_counts()
    twin_res = explore(space, engine="fused", chunk_size=CHUNK, k=3,
                       backend="torch")
    check(fs.COUNTS["kernel_launches"] == 0, "twin lane launched the kernel")
    worst = compare_results("mega_kernel_vs_twin", res, twin_res)
    best = res.topk[0]
    oracle = scalar_total(best["algorithm"], best["variant"], best)
    oracle_err = abs(best["total_j"] - oracle) / abs(oracle)
    check(oracle_err <= 5e-4, f"scalar oracle rel err {oracle_err}")
    emit({"main_path_checks": {
        "kernel_vs_twin_max_rel_err": worst,
        "twin_eval_s": twin_res.eval_s,
        "scalar_oracle_total_j": oracle, "scalar_oracle_rel_err": oracle_err,
        "best": {k: best[k] for k in ("algorithm", "variant", "index")}}})

    wide_space = DesignSpace(["edgaze"], WIDE_GRIDS)
    rng = (WIDE_POINTS - 150, WIDE_POINTS)
    fs.reset_counts()
    w_ker = explore(wide_space, chunk_size=64, k=4, index_range=rng)
    w_launches = fs.COUNTS["kernel_launches"]
    w_twin = explore(wide_space, chunk_size=64, k=4, index_range=rng,
                     backend="torch")
    compare_results("int64_tail", w_ker, w_twin)
    check(w_launches > 0 and w_ker.n_points == 150
          and all(r["index"] >= 2 ** 31 for r in w_ker.topk),
          "int64 tail: wrong span or indices")
    emit({"int64_path": {"points": w_ker.n_points, "launches": w_launches,
                         "best_index": w_ker.topk[0]["index"]}})

    # ----- 4. staged at full width: K2 -> banked evaluator -> K3a -----------
    def staged():
        return explore(space, engine="staged", chunk_size=CHUNK, k=3)
    staged()                                  # warm-up
    reset_all(kernel_mods)
    st = staged()
    st_counts = dict(decode=gd.COUNTS["kernel_launches"],
                     decode_vec4=gd.COUNTS["vec4_launches"],
                     stats=sr.COUNTS["kernel_launches"],
                     stats_vec4=sr.COUNTS["vec4_launches"],
                     twins=sum(m.COUNTS[k] for m in kernel_mods
                               for k in m.COUNTS if "twin" in k))
    st_syncs = count_syncs(staged)
    n_chunks = 8 * cpv
    check(st.engine == "staged" and st.dispatches == n_chunks,
          f"staged: engine {st.engine}, {st.dispatches} dispatches")
    check(st_counts["decode"] == n_chunks and st_counts["stats"] == n_chunks
          and st_counts["twins"] == 0, f"staged: launches {st_counts}")
    # the staged metric vectors are fresh, aligned allocations, and every
    # chunk decodes 2^18 points
    check(st_counts["stats_vec4"] == n_chunks
          and st_counts["decode_vec4"] == n_chunks,
          f"staged: decode or block stats off the vec4 route {st_counts}")
    # the default pipeline_depth of 4 waits on an event after each of the
    # last n_chunks - 4 dispatches
    st_waits = wait_counted * max(0, n_chunks - 4)
    check(st_syncs - st_waits < st_counts["decode"], f"staged: {st_syncs} "
          f"host syncs ({st_waits} event waits) for {st_counts['decode']} "
          f"chunks")
    st_worst = compare_results("staged_vs_fused", st, res)
    emit({"staged_path": {
        "points": st.n_points, "eval_s": st.eval_s,
        "points_per_s": st.points_per_sec, "dispatches": st.dispatches,
        "grid_decode_launches": st_counts["decode"],
        "grid_decode_vec4_launches": st_counts["decode_vec4"],
        "block_stats_launches": st_counts["stats"],
        "block_stats_vec4_launches": st_counts["stats_vec4"],
        "twin_calls": st_counts["twins"], "host_syncs": st_syncs,
        "event_waits_counted": st_waits,
        "vs_fused_max_rel_err": st_worst}})

    # ----- 4b. campaigns at full width: fused shards on K1 ------------------
    camp = campaign_path(space, res, fs, kernel_mods, smi)

    # ----- 4c. serving at full width: coalesced tenants on K1 ---------------
    serve = serve_path(space, res, fs, gd, sr, kernel_mods, smi)
    serve_k1 = {"wave1": serve["wave1"]["k1_launches"],
                "wave2": serve["wave2"]["k1_launches"],
                "mega_stream": serve["mega_stream"]["k1_launches"]}
    serve_staged = serve["staged"]["launches"]

    # ----- 5. chunked through auto: K4 --------------------------------------
    ch_space = DesignSpace(["edgaze"], CHUNKED_GRIDS)
    check(ch_space.n_points == CHUNKED_POINTS, "chunked space size")
    reset_all(kernel_mods)
    ch = explore(ch_space, k=3)
    ch_counts = (cr.COUNTS["kernel_launches"], cr.COUNTS["twin_calls"])
    check(ch.engine == "chunked" and ch.chunk_size == CHUNK,
          f"auto picked {ch.engine} / chunk {ch.chunk_size}")
    check(ch_counts == (10, 0), f"chunked: K4 launches/twin {ch_counts}")
    ch_fused = explore(ch_space, engine="fused", chunk_size=CHUNK, k=3)
    ch_worst = compare_results("chunked_vs_fused", ch, ch_fused)
    emit({"chunked_path": {
        "points": ch.n_points, "eval_s": ch.eval_s, "wall_s": ch.wall_s,
        "points_per_s": ch.points_per_sec, "dispatches": ch.dispatches,
        "category_reduce_launches": ch_counts[0],
        "twin_calls": ch_counts[1], "vs_fused_max_rel_err": ch_worst}})

    # ----- 6. monolithic through auto: K4 -----------------------------------
    mo_space = DesignSpace(["edgaze", "rhythmic"], DESIGN_GRIDS)
    check(mo_space.n_points == DESIGN_POINTS, "design_sweep space size")
    reset_all(kernel_mods)
    mo = explore(mo_space, k=3)
    mo_counts = (cr.COUNTS["kernel_launches"], cr.COUNTS["twin_calls"])
    check(mo.engine == "monolithic", f"auto picked {mo.engine}")
    check(mo_counts == (8, 0), f"monolithic: K4 launches/twin {mo_counts}")
    mo_fused = explore(mo_space, engine="fused", chunk_size=CHUNK, k=3)
    mo_worst = compare_results("monolithic_vs_fused", mo, mo_fused)
    win = mo.topk[0]
    sp = scalar_point(win["algorithm"], win["variant"], **{
        ax: win[ax] for ax in ("cis_node", "soc_node", "mem_tech",
                               "sys_rows", "sys_cols", "frame_rate",
                               "active_fraction_scale", "pixel_pitch_um")})
    mo_oracle = abs(win["total_j"] - sp["total_j"]) / abs(sp["total_j"])
    check(mo_oracle <= 5e-4, f"monolithic winner vs scalar oracle "
          f"{mo_oracle}")
    emit({"monolithic_path": {
        "points": mo.n_points, "eval_s": mo.eval_s, "wall_s": mo.wall_s,
        "points_per_s": mo.points_per_sec, "dispatches": mo.dispatches,
        "category_reduce_launches": mo_counts[0],
        "twin_calls": mo_counts[1], "vs_fused_max_rel_err": mo_worst,
        "scalar_oracle_rel_err": mo_oracle}})

    # ----- 6b. the mesh split (P8): K1, K2/K3a and K4 once a shard ----------
    mesh = mesh_path(space, res, st, ch_space, ch, kmods, kernel_mods,
                     smi[0] if smi else None)
    mesh_launches = mesh["launches"]

    # ----- 7. the functional simulator: K5-K8 -------------------------------
    func, run_functional, func_inputs = functional_path(fmods, kernel_mods)

    # ----- 8. the attention path: K9 (timed there) --------------------------
    attn = attention_path(fa, kernel_mods)
    attn_f32 = attention_f32_timing(fa)

    # ----- 9. timing at the main paths' shapes ------------------------------
    kw = dict(compute=compute, metric="total_j",
              axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=n_var, total=prep.total,
              chunk=CHUNK, lmax=prep.lmax, block_points=4096, kk=3)
    row = prep.bank.fused[2]
    start = 2 * n_var + CHUNK
    def k1():
        return fs.fused_sweep_block(prep.table2, row, start, 0, 3 * n_var,
                                    **kw)
    kernel_ms = time_ms(k1)
    twin_ms = time_ms(lambda: fs.fused_sweep_block_torch(
        prep.table2, row, start, 0, 3 * n_var, **kw), reps=5)
    knots = tuple(len(xs) for xs, _ in interp_tables())
    n_blocks = CHUNK // 4096
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    k1_plan = fs.plan(4096, 3, CHUNK, n_sm)

    def k1_bounds(kk):
        nbytes = 4 * (prep.table2.numel() + row.numel()) \
            + n_blocks * (kk * 8 + 8)
        hoisted = hoisted_ops_per_point(
            prep.bank.dims, knots, prep.vgrids[0].shape, 1,
            k1_plan.rank_points)
        return (bound_ms(CHUNK, prep.bank.dims, knots, nbytes),
                bound_ms(CHUNK, prep.bank.dims, knots, nbytes, hoisted))

    (b_ms, b_by, fp, sfu), (h_ms, h_by, h_fp, h_sfu) = k1_bounds(3)
    kw16 = dict(kw, kk=16)
    (b16_ms, *_), (h16_ms, *_) = k1_bounds(16)

    def k1_16():
        return fs.fused_sweep_block(prep.table2, row, start, 0, 3 * n_var,
                                    **kw16)
    k1_kk16 = dict(
        ms=time_ms(k1_16), device_ms=device_ms(k1_16, "fused_sweep_kernel"),
        plain_ms=time_ms(lambda: fs.fused_sweep_block_torch(
            prep.table2, row, start, 0, 3 * n_var, **kw16), reps=5),
        bound_ms=b16_ms, hoisted_bound_ms=h16_ms,
        plan=fs.plan(4096, 16, CHUNK, n_sm)._asdict())
    probe = fused_probe(fs, sr, prep, compute, vals, mask, vid)

    dkw = dict(shape=prep.vgrids[0].shape, n_var=n_var, total=prep.total,
               chunk=CHUNK, lmax=prep.lmax)
    n_axes = len(prep.vgrids[0].shape)
    timed = {
        "grid_decode": (
            lambda: gd.grid_decode(prep.table2, start, **dkw),
            lambda: gd.grid_decode_torch(prep.table2, start, **dkw),
            None, 4 * prep.table2.numel() + CHUNK * 4 * (n_axes + 1), 0),
        "block_stats": (
            lambda: sr.block_stats(vals, mask, 4096),
            lambda: sr.block_stats_torch(vals, mask, 4096),
            None, CHUNK * 5 + n_blocks * 16, CHUNK * 3),
        "block_stats_banked": (
            lambda: sr.block_stats_banked(vals, mask, vid, 8, 4096),
            lambda: sr.block_stats_banked_torch(vals, mask, vid, 8, 4096),
            None, CHUNK * 9 + n_blocks * 8 * 16, CHUNK * 3),
        "category_reduce": (
            lambda: cr.category_reduce(e_main, w_main),
            lambda: cr.category_reduce_torch(e_main, w_main),
            lambda: torch.matmul(e_main, w_main),
            4 * (CHUNK * 11 + 11 * 10 + CHUNK * 10), 2 * CHUNK * 11 * 10),
    }
    # K2's kernels are grid_decode_{vec4,scalar}_kernel
    times = {name: timing_row(f"{CHUNK} points", ker, plain, lib, nbytes,
                              nops, "grid_decode_" if name == "grid_decode"
                              else f"{name}_kernel")
             for name, (ker, plain, lib, nbytes, nops) in timed.items()}
    # K2 on int64 indices, and the launch floors: K2 at a chunk of 4 and K7
    # on a frame of one 16-byte vector, one thread each
    dkw64 = dict(dkw, idx_dtype=torch.int64)
    k2_int64 = timing_row(
        f"{CHUNK} points int64",
        lambda: gd.grid_decode(prep.table2, start, **dkw64),
        lambda: gd.grid_decode_torch(prep.table2, start, **dkw64), None,
        *timed["grid_decode"][3:], "grid_decode_")
    fe = fmods["frame_event"]
    ev4 = gaussian((1, 4), 7), gaussian((1, 4), 8)
    ev8 = gaussian((1, 8), 7, torch.bfloat16), gaussian((1, 8), 8,
                                                        torch.bfloat16)
    lib_bn = fmods["binning"].load_kernel_library()
    stream = torch.cuda.current_stream().cuda_stream
    floors = {
        "empty_kernel": device_ms(
            lambda: lib_bn.repro_binning_launch_us(1, stream),
            "empty_kernel"),
        "grid_decode": {
            f"chunk 4 {dtype_name(dt)}": device_ms(
                lambda: gd.grid_decode(prep.table2, start,
                                       **dict(dkw, chunk=4, idx_dtype=dt)),
                "grid_decode_")
            for dt in (torch.int32, torch.int64)},
        "frame_event": {
            "1x4 float32": device_ms(lambda: fe.frame_event(*ev4, 0.5),
                                     "frame_event"),
            "1x8 bfloat16": device_ms(lambda: fe.frame_event(*ev8, 0.5),
                                      "frame_event")}}
    # K2's yardstick: the same bytes written by torch's fill kernel
    # (another function: no library call decodes the grid)
    filled = torch.empty((n_axes + 1, CHUNK), device="cuda")
    store_floor = library_device_ms(filled.zero_)
    emit({"launch_floor_device_ms": floors,
          "grid_decode_store_floor_device_ms": store_floor})
    k3b_timing = banked_timing(sr, gd, prep, vals, mask, vid, n_sm)

    profile_path("main_path", lambda: explore(space, engine="fused",
                                              chunk_size=CHUNK, k=3))
    profile_path("staged", staged)
    profile_path("chunked", lambda: explore(ch_space, k=3))
    profile_path("monolithic", lambda: explore(mo_space, k=3))
    ftimes = functional_timing(fmods, func_inputs)
    profile_path("functional", run_functional)

    src = "src/repro_torch/csrc/"
    power = smi[0] if smi else None
    entries = [{
        "name": "fused_sweep", "route": "cuda",
        "source": src + "fused_sweep.cu",
        "replaces": "src/repro/kernels/fused_sweep.py:47",
        "launches": launches + sum(serve_k1.values())
        + mesh_launches["fused_sweep"],
        "path": f"fused (main path {launches}) + serve (wave 1 "
                f"{serve_k1['wave1']}, wave 2 {serve_k1['wave2']}, mega "
                f"stream {serve_k1['mega_stream']}) + mesh "
                f"({mesh_launches['fused_sweep']})",
        "serve_launches": serve_k1,
        "mesh_launches": mesh_launches["fused_sweep"],
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "max_rel_err": max(r["max_rel_err"] for r in recs),
        "ms": kernel_ms, "plain_ms": twin_ms, "bound_ms": b_ms,
        "bound_by": b_by, "device_ms": device_ms(k1, "fused_sweep_kernel"),
        "library_ms": None, "points": CHUNK, "fp32_ops_per_point": fp,
        "sfu_calls_per_point": sfu, "hoisted_bound_ms": h_ms,
        "hoisted_bound_by": h_by, "hoisted_fp32_ops_per_point": h_fp,
        "hoisted_sfu_calls_per_point": h_sfu, "kk": 3,
        "plan": k1_plan._asdict(),
        "staging": k1_staging(fs, prep.bank.dims, prep.vgrids[0].shape,
                              n_var, prep.table2.shape[1] // prep.lmax,
                              k1_plan)._asdict(),
        "kk16": k1_kk16,
        "campaign_launches": camp["serial"]["k1_launches"]
        + camp["workers2_resumed"]["k1_launches"],
        "nan_cases": [r for r in recs if "nan_candidates" in r],
        "probe": probe["fused_sweep_kk3"]["by_cluster"],
        "power_limit": power,
    }]
    for name, source, replaces, n_launch, cases, path in (
            ("grid_decode", "grid_decode.cu",
             "src/repro/kernels/grid_decode.py:73",
             st_counts["decode"] + serve_staged["grid_decode"]
             + mesh_launches["grid_decode"], k2,
             f"staged ({st_counts['decode']}) + serve (staged request "
             f"{serve_staged['grid_decode']}) + mesh "
             f"({mesh_launches['grid_decode']})"),
            ("block_stats", "stream_reduce.cu",
             "src/repro/kernels/stream_reduce.py:30",
             st_counts["stats"] + serve_staged["block_stats"]
             + mesh_launches["block_stats"], k3a,
             f"staged ({st_counts['stats']}) + serve (staged request "
             f"{serve_staged['block_stats']}) + mesh "
             f"({mesh_launches['block_stats']})"),
            ("block_stats_banked", "stream_reduce.cu",
             "src/repro/kernels/stream_reduce.py:79", 0, k3b,
             "none (direct check only)"),
            ("category_reduce", "category_reduce.cu",
             "src/repro/kernels/category_reduce.py:22",
             ch_counts[0] + mo_counts[0] + mesh_launches["category_reduce"],
             k4, f"chunked ({ch_counts[0]}) + monolithic ({mo_counts[0]}) "
             f"+ mesh ({mesh_launches['category_reduce']})")):
        extra = {}
        if name == "grid_decode":
            keys = ("ms", "device_ms", "plain_ms", "bound_ms")
            extra = dict(
                store_floor_device_ms=store_floor,
                empty_kernel_device_ms=floors["empty_kernel"],
                route_launches={"vec4": st_counts["decode_vec4"],
                                "scalar": st_counts["decode"]
                                - st_counts["decode_vec4"]},
                floor_device_ms=floors[name]["chunk 4 int32"],
                floor_device_ms_by_shape=floors[name],
                by_idx={"int32": {k: times[name][k] for k in keys},
                        "int64": {k: k2_int64[k] for k in keys}})
        if name in ("block_stats", "block_stats_banked"):
            extra = dict(plan=probe[name]["chosen"],
                         probe=probe[name]["by_cluster"],
                         scalar_route=probe[name]["scalar_route"])
        if name == "block_stats_banked":
            extra.update(
                by_layout_device_ms=k3b_timing["by_layout_device_ms"],
                big=k3b_timing["big"],
                floor_device_ms=k3b_timing["floor_device_ms"],
                read_yardstick_device_ms=k3b_timing[
                    "read_yardstick_device_ms"],
                empty_kernel_device_ms=floors["empty_kernel"])
        entries.append(dict(
            name=name, route="cuda", source=src + source,
            replaces=replaces, launches=n_launch, path=path,
            max_abs_err=max(r["max_abs_err"] for r in cases),
            points=CHUNK, power_limit=power, **times[name], **extra))
    for name, line in zip(FUNC_KERNELS, (23, 26, 18, 21)):
        launches_f = sum(func[p]["kernel_launches"][name]
                         for p in ("edgaze", "fig5", "rhythmic"))
        head = ftimes[name][0]
        extra = {f"{r}_launches": sum(func[p]["route_launches"][name][r]
                                      for p in ("edgaze", "fig5", "rhythmic"))
                 for r in func["edgaze"]["route_launches"].get(name, {})}
        if name in ("matmul", "stencil_conv"):
            extra["probe"] = ftimes[f"{name}_probe"]
        if name == "frame_event":
            extra.update(floor_device_ms=floors[name]["1x4 float32"],
                         floor_device_ms_by_shape=floors[name],
                         empty_kernel_device_ms=floors["empty_kernel"])
        entries.append(dict(
            name=name, route="cuda", source=src + f"{name}.cu",
            replaces=f"src/repro/kernels/{name}.py:{line}",
            launches=launches_f,
            path="functional (edgaze + fig5 + rhythmic)",
            max_abs_err=max(r["max_abs_err"] for r in fcases[name]),
            power_limit=power, **head, **extra,
            by_shape=ftimes[name]))
    keys = ("shape", "ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by", "bytes",
            "operations", "half_operations")
    by_shape = [{k: r[k] for k in keys} for r in attn.values()]
    entries.append(dict(
        name="flash_attention", route="cuda",
        source=src + "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:35",
        kernel="flash_attention_wgmma_kernel (f16/bf16: wgmma, TMA)",
        launches=sum(r["wgmma_launches"] for r in attn.values()),
        path="attention",
        max_abs_err=max(r["max_abs_err"] for r in k9
                        if r["route"] == "wgmma"),
        power_limit=power, **by_shape[0], by_shape=by_shape))
    f32_by_shape = [{k: r[k] for k in keys} for r in attn_f32.values()]
    entries.append(dict(
        name="flash_attention_simt", route="cuda",
        source=src + "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:35",
        kernel="flash_attention_kernel (f32: FP32 FMAs); "
               "flash_attention_kernel_any (mixed dtypes, D > 128)",
        launches=0, path="none (f32 operands; checked directly)",
        max_abs_err=max(r["max_abs_err"] for r in k9
                        if r["route"] == "simt"),
        power_limit=power, **f32_by_shape[0], by_shape=f32_by_shape))
    # ----- 10. the LM stack's serving path (P12a): no port kernel ----------
    lm = lm_path(power, kernel_mods)
    # ----- 11. the LM stack's training path (P12b): no port kernel ---------
    train = train_path(power, kernel_mods)
    # ----- 12. the LM mesh (P12c-1, P12c-2): no port kernel ----------------
    lm_mesh_path(power, kernel_mods)
    # ----- 13. the dry run and the energy model (P12c-3): no port kernel ---
    dryrun_path(power, dryrun_start(), train["olmo_1b"], lm)
    # ----- 14. the examples (P15): K1, K4, K5, K6 ---------------------------
    examples = examples_path(power, kernel_mods)["kernel_launches"]
    # ----- 15. the static checks (P13) --------------------------------------
    static_checks(power)
    for entry in entries:
        n = examples.get(entry["name"], 0)
        entry["examples_launches"] = n
        if n:
            entry["launches"] += n
            entry["path"] += f" + examples ({n})"

    emit({"kernels": entries})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(probe_main() if "--launch-probe" in sys.argv[1:] else main())
