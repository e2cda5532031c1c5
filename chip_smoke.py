#!/usr/bin/env python3
"""Drive the PyTorch port's MoGe inference, export, serving (sequence-parallel and int8 too), panorama, eval, training (step, remat, command, MoGe-1, parallel) and probes on one CUDA GPU and check them.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one GPU, nvcc on
PATH or under $CUDA_HOME). Phases, any failure raising:

1. device: require CUDA, print the card's name and power limit, disable TF32;
   then the host packages of the training loader (every cv2 name it uses,
   PIL's LANCZOS, scipy's fftconvolve; each augmentation branch once);
2. build the hand-written kernels from ``moge_tpu_torch/csrc`` (in parallel);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes plus ragged edges, with errors and median times: K1 (also
   by device time, beside F.layer_norm's, and at M = 1370 the host's time
   per call beside F.layer_norm's; each launch's variant checked: vec16 at
   the ViT rows and the giant's D = 1536, scalar on a view with a storage
   offset), K2
   (and its logsumexp; B = 1 and 8 at the ViT token counts, B = 12 at the
   panorama's and B = 1 at eval's, times by CUDA events and by device time,
   then kv_valid at the bf16 kernel's key-tile edges, then the giant's 24
   heads at B = 1; then the fp32 kernel at MoGe-1's folder image, eval's and
   the panorama's shapes, timed beside SDPA's memory-efficient fp32 forward
   and the FP32 bound, and at its 32-key tile edges and a sequence-parallel
   chunk), K3 at every conv
   shape of the ViT-L forwards of ``infer`` (batch 1, 1369 tokens), the
   panorama (batch 12, 3600 tokens), eval (480x640, 3600 tokens) and the
   training command's two extreme grids (batch 2, 1200 tokens, aspect 2:1
   and 1:2) (each
   launch's variant checked, times by CUDA events and by device time, and
   per path K3 ms per forward against F.conv2d by device time; K1 also at
   the rows of those forwards), K3-grouped at the batched decoder heads' shapes (G=3,
   B0 = 1 and 8, bf16 and fp32, the grouped up2 form), then the flash
   backward K2b-dq/K2b-dkv (bf16 and fp32, each launch's variant checked,
   two calls bit-identical; bf16 also by device time, and the whole
   backward, delta + K2b-dq + K2b-dkv, against SDPA's flash backward) and
   the dense align objective K4
   at the v2 loss shapes; with each kernel's bound (the least time the card
   could take, from the bytes it must move and its operations at the peak
   rate of their type) and the time of one PyTorch call that computes the
   same function, where there is one;
3c. the camera solve K5 (``recover_focal_shift``, one launch) against its
   plain version on the card at batch 1 (480x640) and batch 8 (518^2),
   free focal with a mask: errors, the launch count per call, medians by
   CUDA events of both and the host's time per call of K5's route;
3a. the truncated align's forms at the four v2 loss shapes (label type A,
   batch 2), full rows: dense on K4, ``events`` and ``prefix``
   (``MOGE_ALIGN_TRUNC_IMPL``), scalar truncation and at patch_16 a
   per-element one; each sorted form's index attains K4's minimum, times
   and peak memory per form; the bitonic network against torch.sort on the
   events sort (3L <= 2048), bit for bit, and its time; then the v2 grad
   step (batch 2, 512^2, 1369 tokens) under dense, events and prefix from
   one state: loss and gradient norm against dense's, no K4 launch under
   the sorted forms, step times;
3b. probes: the ported TPU probes T1 (seven softmax variants of a flash
   forward, N = 3601 and a ragged 1201, and 1216 rows, not a multiple of
   the kernel's key tile; ``base`` at 3601 also by device time beside
   SDPA's), T2 (the FP32-pipe ceiling loop,
   both kinds) and T3-T6 (four layouts of K4's objective, at the three
   ``SHAPES`` of the loss's solves; T6 also by device time) against their
   plain versions,
   then the three probe tools' measurements at their default shapes (the
   ``probes`` path, counted);
4. inference at full width: ``moge-2-vitl-normal`` with random weights from
   a seed, bf16, four ``infer`` requests, launch counters per forward;
5. inference parity: ``moge-2-vits-normal`` decode, bf16 with the kernels on
   the card against fp32 with the plain versions on the CPU;
5b. export: the same ViT-L (a point map of known perspective in its points
   head) exported with ``models/export.py`` as the whole ``infer`` program,
   camera solve inside, bf16, 518^2 at 1369 tokens, batch 1, saved to bytes
   and loaded back: its outputs against live ``infer`` (points, depth and
   normal within 1e-3 relative L2, intrinsics within 1e-4, masks agreeing
   on 99.9% of the pixels; the largest elementwise difference and bit
   identity logged), launch counters per run (the kernels reached through
   the ``torch.ops.moge`` ops); then the raw bf16 forward's artifact against
   ``MoGeV2.forward``; export seconds, artifact MB, the artifact's warm
   latency against live ``infer`` in alternating turns;
6. batched heads: the same ViT-L with ``batched_heads=True`` (the three
   heads as one grouped pass on K3-grouped) at 518x518, 1369 and 3600
   tokens, batch 1 and 8, against the sequential heads, launch counters per
   forward, warm medians of both;
7. serving: the micro-batcher (``scripts/serve.py``) over the batched-heads
   model, 32 requests from 8 client threads (half with ``fov_x``), every
   answer against its image's own batch-1 ``infer``; requests/s, mean
   batch, p50/p90 latency, launch counters per batch;
7b. sequence parallelism: K2 at the SP shapes (3601 tokens over 2 ranks,
   1370 over 2 and over 4: Nq the chunk, Nkv ranks x chunk, the padding
   keys masked) against its plain version; then two gloo ranks on this one
   card, each ``moge-2-vitl-normal`` from the seed with a point map of
   known perspective, ``infer`` at 518^2 and 1369 and 3600 tokens against
   one process on the same weights and against each other, launch counters
   per rank and forward, warm latency of both; then 4 requests over HTTP
   to a server on rank 0 over a ``Leader`` (the other rank follows), each
   answer against its image's batch-1 ``infer``;
7c. int8: the W8A8 product (``torch._int_mm``) on the card against the
   CPU's plain version at the ViT-L projections (rows 1370 and 28808),
   operands, accumulators and outputs identical, times beside bf16
   F.linear; ViT-L int8 ``infer`` against bf16 at 1369 tokens batch 1 and
   3600 tokens batch 8 (launch counters, 96 int8 products a forward, warm
   medians, drift within tests/test_quant.py's bounds); 8 requests through
   the micro-batcher over the int8 model, each against its batch-1 infer;
8. MoGe-1: ``moge-vitl`` bf16 at full width with a point map of known
   perspective in its points head, three ``infer`` requests with launch
   counters per forward, each request's focal, shift and depth held to the
   injected ones and to a CPU solve of the card's raw points; then a ViT-S
   MoGe-1 (same head) forward, bf16 on the card against fp32 on the CPU;
8b. panorama: a seeded 960x1920 uint8 image through ``infer_panorama``
   (12 icosahedral views at 512^2, one ``moge-2-vitl-normal`` bf16 forward
   at 3600 tokens, the CG merge at 1920x960 on the card), a warm-up and a
   run, launch counters per run, wall time per stage and per merge level;
   the split on the card against the CPU, the 12-view forward (with the
   model's own heads) against each view's batch-1 forward, a known field
   recovered, CG on the card against LSMR on the host and against CG on
   the CPU;
8c. eval: a 4-sample synthetic benchmark at 480x640 written by the port's
   codecs, through the ``eval_baseline`` command and the port's MoGe
   adapter (ViT-L bf16), launch counters per sample, every metric finite,
   every solve on the card, ``compute_metrics`` on the card against the
   CPU's;
9. training at full width: ``configs/train/v2.json`` (model, optimizer, LR
   schedule, label type A losses), random weights from a seed, bf16 compute
   with fp32 parameters, batch 2 at 512x512, two ``make_train_step`` steps
   at 1369 tokens (3600 tokens: phase 10b's plain steps), launch counters
   per step, step time and peak memory;
10. training parity: ``moge-2-vits-normal``, one fp32 grad step on the card
    (kernels) against the CPU (plain versions) from the same weights, batch
    and random draws: loss, every alignment solve and the gradients;
10b. activation checkpointing (its kernels' shapes held in phase 3):
    v2.json's model at 3600 tokens, 512x512, batch 2 and 8, grad steps
    with ``remat`` off and on (a warm step, the median of 3, the peak),
    launch counters per step against the config's (the remat'd modules'
    K1, K2 and K3 twice), peak(remat) below peak(plain), and from one
    state the remat step's loss and gradients within 2x the plain step's
    own spread over repeats; then one plain and one remat grad step of
    MoGe-1 (v1.json, 512x1024, 1200 tokens) and of the giant (batch 2),
    with their peaks;
11. the training command: ``cli train`` in-process over a copy of
    ``configs/train/v2.json`` whose datasets are synthetic (labels A, B, C,
    metric and not, inf sky, NaN holes, the v2 per-dataset options), the
    threaded augmenting loader, random sizes, ViT-L bf16 batch 2: 12 steps
    and a checkpoint, the checkpoint loaded into a fresh state bit for bit,
    one step on a fixed batch repeated from one state (the card's spread)
    against the same step from the loaded state, ``infer`` from the
    checkpoint's model.pt, ``--checkpoint latest`` for step 20, then 2 steps
    of 2 micro-batches; launch counters per micro-batch; ms per step by
    token count, seconds waiting for data, peak memory, checkpoint and
    resume seconds;
11b. MoGe-1 training: ``cli train`` on ``configs/train/v1.json``
    (``moge-vitl``, its loss tables) over the synthetic datasets under v1's
    label types, batch 2, three steps and a checkpoint whose ``model.pt``
    and EMA load into ``models.v1.MoGeModel`` and pass the MoGe-1 gates;
11c. the parallel paths (v2.json's model over the synthetic datasets,
    its losses that draw nothing, a global batch of 2, two steps): two
    single-process runs (the card's spread), one NCCL rank
    (``--multihost --num_processes 1``; one gradient all-reduce a step
    through NCCL on the card), the same rank with the sharded (FSDP) code
    path on, and two DP ranks on this one card over gloo with CUDA tensors,
    each in its own process: the DP ranks' whole states equal, every run's
    parameters and EMA within 2x the spread of the single-process runs,
    peak memory and the own share of the training state per rank;
12. the giant: ``moge-2-vitl-normal`` on ``dinov2_vitg14`` (SwiGLU, 24
    heads), random weights, bf16, 518^2 at 1369 tokens, launch counters,
    warm latency and peak memory;
13. ``vis_data --ply`` on one synthetic instance: one vertex per finite
    depth pixel under ``--max_depth``.

Launches are read from the registry of ``moge_tpu_torch/ops/_build.py``
(``reset_counts``, ``read_counts``, ``read_variants``). On every counted run
of the paths below, each K1 launch must have taken the vec16 variant, each
K3 and K3-grouped launch a pipelined wgmma variant, each K2 launch the
wgmma kernel and each K2b-dq and K2b-dkv launch the wgmma kernels; every
inference run must have made its camera solve as one K5 launch.

Prints a ``[time] <phase> <seconds>`` line after each phase and the total
before the card's line, a JSON line with the kernels' numbers, the inference,
export, batched, serving, panorama, eval, training and remat numbers, the
card's name and power limit, and last
``{"ok": true, "device": {...}}``. Each kernel's ``launches`` is its count
summed over every counted run of the paths above; ``launches_by_path``
gives, per path, the count per run and the number of runs (a run is one
forward for ``infer``, ``batched_heads``, ``moge1_infer`` and ``giant``, one
run of the post-processed artifact for ``export`` and of the raw forward's
for ``export_raw``, one batch for ``serve``, one dense solve for ``align_forms``, one grad step
for ``train_events`` and ``train_prefix``, one 12-view panorama for
``panorama``, one sample for
``eval``, one step for ``train``, one remat grad step for ``train_remat``,
``train_remat_v1`` and ``train_remat_giant``, one micro-batch for ``train_cli``,
``train_v1``, ``train_single``, ``train_nccl`` and ``train_fsdp``, one
rank's micro-batch for ``train_dp``, the
three tools' measurements for ``probes``, one rank's forward or serving
batch for ``sp``, one forward or batch for ``int8``); ``bound_ms``/``bound_by`` and ``library_ms`` belong to the
reported case of phase 3; ``ms``, ``plain_ms`` and ``library_ms`` are
medians by CUDA events around each call for every kernel, and K1, K2,
K2b-dq, K2b-dkv, K3, K3-grouped and T1 add ``device_ms``,
``plain_device_ms`` and ``library_device_ms``, the same calls' device time
from torch.profiler (K2b's ``backward_device_ms``: the whole backward; T6
``device_ms`` alone); K1 adds ``host_us``/``library_host_us``, the host's
time per call, and K5 ``host_us``; K5's ``max_abs_err`` is its largest
relative error (focal ratio, shift over mean |z|); ``variants_by_path`` (K1, K2, K2b-dq and K2b-dkv together,
K3, K3-grouped)
gives each path's launches per run by kernel variant;
``infer_launches`` is the count per ``infer`` forward, as before. No CPU fallback: without a GPU, or without the package
beside it, it exits nonzero and prints no result.

``python3 chip_smoke.py --cards``, on a host with several cards, runs
phases 1-2 and then only the multi-card checks (``phase_cards``: the
training command over every card by NCCL at ``--fsdp`` 1, 2 and 4 against
one card; ``phase_sp_cards``: sequence-parallel ``infer`` over 2 and 4
cards by NCCL against one card) and prints their numbers as a JSON line.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda:0"  # the one card every phase runs on
# rtol of the relative L2 error of each raw map (bf16 on the card vs fp32 on the CPU)
MODEL_L2_RTOL = 3e-2
K2_MAX_ABS = 2e-2
K2_LSE_ABS = 1e-3  # fp32 logsumexp of the same bf16 products, summed in another order
# the fp32 K2 against its fp32 plain version: summation order only (out:
# |got - want| <= tol (1 + |want|), lse: <= lse_abs + tol |want|), as
# tests/test_torch_kernels_cuda.py holds it
K2_F32_TOL = 1e-5
K2_F32_LSE_ABS = 1e-4
# the fp32 K3 against its fp32 plain version: summation order only (|got -
# want| <= tol (max |want| + |want|)), as tests/test_torch_kernels_cuda.py holds it
K3_F32_TOL = 1e-5
FOLDER_HW, FOLDER_TOKENS = (480, 640), 2500  # MoGe-1's folder image: the benchmark's folder cell
K3_REL = 1e-2
# K2b vs autograd through the plain version in fp32, relative to the largest
# gradient: bf16 rounds P and dS before their products (as on the TPU); fp32
# differs in summation order only
K2B_REL = {"bfloat16": 3e-2, "float32": 1e-4}
K4_REL = 2e-5  # fp32 sums of up to 6912 terms in another order (and fma), relative to max |F|
# the sorted truncated-align forms (phase_align_forms): each form's chosen
# index must attain K4's minimum within K4_REL x max |F|; prefix's also
# within its fp32 cancellation error, PREFIX_CANCEL x max |A| x sum w|x| of
# the row (the bound of the JAX package's own form tests)
PREFIX_CANCEL = 4e-7
ALIGN_BITONIC_MAX = 2048  # the bitonic network timed on the events sort where 3L <= 2048: patch_16 and patch_64
ALIGN_TIMES = 5           # CUDA-event times per form and shape (their median)
BITONIC_TIMES = 3         # CUDA-event times of each sort of the events keys (their median)
ALIGN_STEP_TIMES = 3      # host-clock times of the grad step per form, after its checked call (their median)
# the events and prefix grad steps against the dense one. Each of their scale/
# shift solves is held to K4's minimum of that solve's objective as above
# (the solve's own inputs, every (anchor, candidate) pair of a row). The loss
# and the gradient norm, relative, only to a sanity bound: a row whose
# minimum is tied (a patch with every term truncated: any scale attains n t)
# or tied within the forms' fp32 rounding lets each form choose another
# (scale, shift) of equal objective, and the patch's loss follows that choice
# (an H100 read 4.3e-3 and 3.1e-3 for events against dense)
ALIGN_STEP_RTOL = 2e-2
# the probes T1-T6 are held to their tools' REL_TOL, relative to max |plain|
PROBE_KERNELS = ("exp_flash_softmax", "exp_vpu_ceiling", "exp_dense_v1", "exp_dense_v1_unroll", "exp_dense_v2",
                 "exp_dense_bf16")
# the kernels whose launches read_counts gives
COUNTED = ("layer_norm", "flash_attention", "flash_attention_dq", "flash_attention_dkv", "conv3x3",
           "conv3x3_grouped", "dense_align", "camera_solve") + PROBE_KERNELS
CLOCK_HZ = 1.98e9  # the card's maximum SM clock, read in main (FP32 and MUFU rates scale with it)
TRAIN_CONFIG = ROOT / "configs" / "train" / "v2.json"
TRAIN_TOKENS = (1369,)  # 3600 tokens: phase_train_remat's plain steps
TRAIN_STEPS = 2
TRAIN_HW = (512, 512)
# activation checkpointing (remat): v2.json's model at 3600 tokens, 512^2,
# batch 2 and 8, grad steps with remat off and on; MoGe-1 (v1.json) at the
# v1 training command's 2:1 grid (v1_path_grids) and the giant at batch 2
REMAT_TOKENS = 3600
REMAT_BATCHES = (2, 8)
REMAT_TIMES = 3  # timed grad steps per batch and mode, after a warm one (their median)
REMAT_V1_TOKENS = 1200
REMAT_V1_HW = (512, 1024)
# training parity, fp32 on the card vs fp32 on the CPU: loss, solver scale and
# shift (relative), gradients (relative L2 over all parameters)
PARITY_LOSS_RTOL = 1e-4
PARITY_SOLVE_RTOL = 1e-4
PARITY_GRAD_RTOL = 1e-3
# batched heads / serving: 518x518 images; answers after the focal/shift
# solve compared on a model whose point map is a known perspective
# (tests/torch_tiny_config.py::make_points_perspective), masks may flip
# where bf16 sums in another order tip the threshold
SERVE_HW = 518
SERVE_TOKENS = 1369
SERVE_REQUESTS = 32
SERVE_CLIENTS = 8
BATCHED_TOKENS = (1369, 3600)
BATCHED_SIZES = (1, 8)
MASK_AGREE = 0.99  # least share of pixels whose mask agrees
INTRINSICS_RTOL = 1e-3
# MoGe-1 ViT-L on a point map of known perspective (focal MOGE1_FOCAL, shift 0):
# the card's fx and depth against the injected ones, where the bf16 raw maps
# round the points by ~2^-9 (0.2-0.3% on a tiny MoGe-1 on the CPU); and against
# a CPU solve of the card's own raw points (fp32 LM solve, summation order only)
MOGE1_FOCAL = 1.5
MOGE1_FOCAL_RTOL = 1e-2
MOGE1_DEPTH_RTOL = 1e-2
MOGE1_SOLVE_RTOL = 1e-3
# panorama: a 960x1920 equirectangular image, the 12 views at 512^2 through one
# ViT-L infer at resolution level 9 (3600 tokens), the CG merge at 1920x960 on
# the card; a warm-up run, then the run. Its points head is a known
# perspective and its mask head a constant logit, so that the views' masks
# are whole (random weights give a noise mask of ~9k pieces, each its own
# gauge, on which no two solvers agree)
PANO_HW = (960, 1920)
PANO_SPLIT = 512
PANO_MERGE = (1920, 960)
PANO_LEVEL = 9
PANO_RUNS = 2
PANO_MASK_LOGIT = 3.0
PANO_SPLIT_LEVELS = 1  # card vs CPU split: uint8 levels (fp32 gathers, one rounding)
# known-field recovery after the median-scale gauge: tests/test_panorama.py's bounds
PANO_FIELD_MEDIAN, PANO_FIELD_MEAN = 0.02, 0.05
# CG vs LSMR: tests/test_panorama.py::test_merge_cg_matches_lsmr's bounds, at its
# size (views at 48^2, blocks knocked out, merged at 128x64), where both solvers
# converge. At 512x256 neither does on that field (CG's 300 iterations end 0.8%,
# LSMR at atol 1e-5 0.4% from an fp64 solve, median), and the JAX package's own
# pair parts by 1.1% median, 8% max (CPU runs against an fp64 CG solve)
PANO_CG_LSMR_SIZE, PANO_CG_LSMR_VIEWS = (128, 64), 48
PANO_CG_LSMR_MEDIAN, PANO_CG_LSMR_MAX = 1e-3, 2e-2
PANO_CG_CARD_CPU = 1e-4  # CG on the card vs on the CPU: dot products summed in another order
# eval: a synthetic benchmark of EVAL_SAMPLES samples at EVAL_HW written by the
# port's codecs, evaluated through the port's MoGe adapter (ViT-L, bf16)
EVAL_HW = (480, 640)
EVAL_SAMPLES = 4
EVAL_RTOL = 1e-5  # compute_metrics, card vs CPU on the same predictions
# the training command (phase_train_cli): TRAIN_CONFIG with its datasets replaced by synthetic
# ones (source images TRAIN_CLI_SRC_HW, TRAIN_CLI_INSTANCES per dataset) and steps 0-2 at the
# low-resolution token count; run A takes TRAIN_CLI_STEPS steps (more than the loader holds in
# its queues, so that the last ones wait on the loader's pace) and saves at the last, the resume
# takes one more step, run B two steps of two micro-batches each
TRAIN_CLI_BATCH = 2
TRAIN_CLI_LOW_RES = 2
TRAIN_CLI_STEPS = 12
TRAIN_CLI_SRC_HW = (768, 1024)
TRAIN_CLI_INSTANCES = 4
RESUME_TOKENS = 1800  # the fixed batch's step, uninterrupted vs resumed
RESUME_REPEATS = 2    # steps repeated from one state to measure the card's spread
RESUME_MARGIN = 2.0   # the resumed step may differ by this multiple of the measured spread
RESUME_RTOL = 1e-6    # ... or by this much relative when the spread is 0
# the giant: moge-2-vitl-normal on dinov2_vitg14 (its four layers, its cls width into the scale head)
TRAIN_V1_CONFIG = ROOT / "configs" / "train" / "v1.json"
TRAIN_V1_STEPS = 3
TRAIN_V1_LABELS = ("synthetic", "sfm", "lidar")  # v1.json's label types, given to the synthetic datasets
# the parallel runs: v2.json with its losses that draw nothing, a global
# batch of 2 (one instance per rank) for PARALLEL_STEPS steps
PARALLEL_STEPS = 2
PARALLEL_LOSSES = ("global", "normal", "mask")
PARALLEL_TIMEOUT = 900  # seconds for one two-process run
GIANT_TOKENS = 1369
GIANT_HW = 518
VIS_MAX_DEPTH = 1.5  # vis_data -m: keep points nearer than 1.5 x the nearest depth
# sequence parallelism: K2 at the SP shapes (real tokens, ranks, batch): Nq = the chunk, Nkv = ranks
# x chunk (batch 2: the served Leader's batches), and K1 on each shape's batch x chunk rows;
# SP_WORLD gloo ranks on the one card, each with moge-2-vitl-normal from SEED, infer at SP_HW^2 and
# SP_TOKENS against one process on the same weights (compare_answers' bounds: bf16 GEMMs round by
# shape), SP_REPEATS warm calls timed; SP_REQUESTS served through a Leader, SP_CLIENTS at a time
SP_K2_SHAPES = ((3601, 2, 1), (1370, 2, 1), (1370, 4, 1), (1370, 2, 2))
SP_WORLD = 2
SP_HW = 518
SP_TOKENS = (1369, 3600)
SP_REPEATS = 3
SP_REQUESTS = 4
SP_CLIENTS = 2
SP_TIMEOUT = 600  # seconds for one run of ranks
# int8: the product at the ViT-L projections' (K, N) (qkv, proj, fc1, fc2) and rows (batch 1 at 1369
# tokens, batch 8 at 3600), card against CPU; ViT-L int8 infer against bf16 at INT8_RUNS (tokens,
# batch), the drift held to tests/test_quant.py's bound; SERVE_REQUESTS through the micro-batcher
INT8_GEMMS = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))
INT8_ROWS = (1370, 8 * 3601)
# K5 against the plain camera solve: |focal ratio - 1| and |shift
# difference| / mean |z| (tests/test_torch_kernels_cuda.py::SOLVE_REL)
SOLVE_REL = 2e-5
SOLVE_CASES = ((1, 480, 640), (8, 518, 518))  # (batch, H, W): the folder path's map, a serving batch
INT8_RUNS = ((1369, 1), (3600, 8))
INT8_DRIFT = 0.05
INT8_REPEATS = 3


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(dtype=None, flops: float = 0.0, **work):
    """(least ms, "bytes" or "operations") of a piece of work on the card
    (``moge_tpu_torch.tools.roofline``): matrix flops at the bf16 tensor-core
    rate for bf16, as FP32 FMAs outside the tensor cores for fp32."""
    import torch

    from moge_tpu_torch.tools import roofline

    if flops:
        work["tensor_flops" if dtype == torch.bfloat16 else "fp32_instr"] = \
            flops if dtype == torch.bfloat16 else flops / 2
    return roofline.bound_ms(CLOCK_HZ, **work)


def library_layer_norm(x, s, b):
    """F.layer_norm in the input's dtype: K1's library call."""
    import torch.nn.functional as F

    sb, bb = s.to(x.dtype), b.to(x.dtype)
    return lambda: F.layer_norm(x, (x.shape[-1],), sb, bb, 1e-6)


def _heads_first(t):
    return t.transpose(1, 2).contiguous()


def library_sdpa(q, k, v, kv_valid=None, dout=None):
    """SDPA over the first ``kv_valid`` keys ((B, N, H, D) inputs moved to
    (B, H, N, D) outside the timed call), on the flash backend (bf16) or the
    memory-efficient one (fp32, which flash does not take): the forward, or
    with ``dout`` the backward (dq, dk and dv in one call, bf16)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    kv = k.shape[1] if kv_valid is None else kv_valid
    qt, kt, vt = _heads_first(q), _heads_first(k[:, :kv]), _heads_first(v[:, :kv])
    backend = SDPBackend.EFFICIENT_ATTENTION if q.dtype == torch.float32 else SDPBackend.FLASH_ATTENTION
    if dout is None:
        def fwd():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qt, kt, vt)
        return fwd
    leaves = [t.requires_grad_() for t in (qt, kt, vt)]
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        out = F.scaled_dot_product_attention(*leaves)
    dt = _heads_first(dout)
    return lambda: torch.autograd.grad(out, leaves, dt, retain_graph=True)


def library_conv(x, kern, bias):
    """F.conv2d, channels-last, in the input's dtype, on the replicate-padded
    input (padded outside the timed call); a grouped (G, 3, 3, C, O) kernel
    runs as groups=G with the batch groups moved to channels. The input ReLU
    and the residual of K3 are not part of it."""
    import torch
    import torch.nn.functional as F

    B, H, W, C = x.shape
    G = kern.shape[0] if kern.dim() == 5 else 1
    xc = x.reshape(G, B // G, H, W, C).permute(1, 0, 4, 2, 3).reshape(B // G, G * C, H, W)
    xp = F.pad(xc.float(), (1, 1, 1, 1), mode="replicate").to(x.dtype).contiguous(memory_format=torch.channels_last)
    w = kern.reshape(G, 3, 3, C, -1).permute(0, 4, 3, 1, 2).reshape(-1, C, 3, 3)
    w = w.to(x.dtype).contiguous(memory_format=torch.channels_last)
    b = None if bias is None else bias.reshape(-1).to(x.dtype)
    return lambda: F.conv2d(xp, w, b, groups=G)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    return smi.splitlines()[0]


def phase_build():
    from moge_tpu_torch.ops import _build

    times = _build.build_all()
    log("[build] " + ", ".join(f"{k} {v:.1f}s" for k, v in times.items()))
    for name, text in _build.BUILD_LOG.items():  # ptxas -v: registers and spills per library
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", text))
        log(f"[build] {name}: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
            f"{spills} bytes of spill stores")


def conv_bound(x, kern, res):
    """K3's (and K3-grouped's) bound: 2 * 9 * C * O flops per output pixel
    and group, x, the weights, the residual and the output moved once."""
    B, H, W, C = x.shape
    O = kern.shape[-1]
    moved = (x.numel() + kern.numel() + B * H * W * O * (2 if res is not None else 1)) * x.element_size()
    return bound(x.dtype, flops=2 * B * H * W * 9 * C * O, bytes_moved=moved)


def layer_norm_case(gen, m: int, d: int, offset: int = 0, variant: str = "vec16", label: str = "K1",
                    host: bool = False) -> tuple:
    """K1 on an (m, d) bf16 input (a view at ``offset`` elements into its
    storage) against its plain version: within one bf16 ulp at the output's
    largest magnitude, on ``variant``; times beside F.layer_norm (and the
    host's way to the launch with ``host``). Returns the case in phase 3's
    form."""
    import torch

    from moge_tpu_torch.ops import _build, norm
    from moge_tpu_torch.tools import roofline

    dev = torch.device(DEVICE)
    x = ((torch.randn(m * d + offset, generator=gen, device=dev) * 3.0).to(torch.bfloat16) + 1.0)[offset:].view(m, d)
    s = torch.randn(d, generator=gen, device=dev)
    b = torch.randn(d, generator=gen, device=dev)
    before = read_variants("layer_norm")
    got = norm.layer_norm_fp32(x, s, b).float()
    took = [k for k, v in read_variants("layer_norm").items() if v != before[k]]
    want = norm.layer_norm_plain(x.float(), s, b)
    err = (got - want).abs().max().item()
    tol = want.abs().max().item() * 2.0 ** -8
    ms, plain_ms, lib_ms, dev_ms = call_times(lambda: norm.layer_norm_fp32(x, s, b),
                                              lambda: norm.layer_norm_plain(x, s, b), library_layer_norm(x, s, b))
    bnd = bound(bytes_moved=2 * m * d * x.element_size() + 2 * d * 4, fp32_instr=4 * m * d)
    line = (f"[{label}] M={m} D={d}{f' offset {offset}' if offset else ''} ({took}, "
            f"{norm.ln_plan(m, d, x.dtype, x.data_ptr(), _build.sm_count(dev))}): max_abs_err {err:.3e} "
            f"(tol {tol:.3e}), {conv_times_text(ms, plain_ms, lib_ms, dev_ms, 'F.layer_norm')}; "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    if host:  # the host's way to the launch, beside the library call's
        host_us = {"host_us": roofline.host_us(lambda: norm.layer_norm_fp32(x, s, b)),
                   "library_host_us": roofline.host_us(library_layer_norm(x, s, b))}
        dev_ms = {**dev_ms, **host_us}
        line += (f"; host us per call: kernel {host_us['host_us']:.2f}, F.layer_norm "
                 f"{host_us['library_host_us']:.2f}")
    log(line)
    if not err <= tol:
        raise AssertionError(f"K1 LayerNorm disagrees at M={m} D={d}: {err} > {tol}")
    if took != [variant]:
        raise AssertionError(f"K1 at M={m} D={d} offset {offset} took {took}, not {variant}")
    return err, ms, plain_ms, lib_ms, bnd, dev_ms


def remat_vits() -> list:
    """(batch, tokens, heads, width) of each ViT forward of
    ``phase_train_remat``'s runs: ViT-L at REMAT_TOKENS on TRAIN_HW, batch
    2 and 8; the giant at batch 2; MoGe-1 at the v1 training command's 2:1
    grid (``v1_path_grids``, = REMAT_V1_HW at REMAT_V1_TOKENS), batch 2."""
    from moge_tpu_torch.models.dinov2 import VIT_ARCHS
    from moge_tpu_torch.models.v2 import base_token_grid

    gh, gw = base_token_grid(REMAT_TOKENS, TRAIN_HW[1] / TRAIN_HW[0])
    (ph, pw), _ = v1_path_grids()["train_v1 2:1"][1:]
    giant = VIT_ARCHS["dinov2_vitg14"]
    return [(b, gh * gw + 1, 16, 1024) for b in REMAT_BATCHES] + \
        [(2, gh * gw + 1, giant.num_heads, giant.embed_dim), (2, ph * pw + 1, 16, 1024)]


def phase_kernels():
    """Each kernel vs its plain version (fp32 from the same bf16 inputs)."""
    import torch

    from moge_tpu_torch.ops import attention, conv

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16)

    results = {}

    # the (batch, tokens) of the ViT-L forwards of the panorama and eval paths
    paths = {path: (batch, gh * gw + 1) for path, (batch, (gh, gw)) in path_grids().items() if path != "infer"}
    (pano_b, pano_n), (eval_b, eval_n) = paths["panorama"], paths["eval"]

    # K1 LayerNorm: tolerance one bf16 ulp at the output's largest magnitude; ViT-L rows at batch 1
    # and 8, those of the panorama's 12 views and of eval, and the ViT-T width on 37 rows (vec16),
    # then a view with a storage offset (scalar), then the giant's width at batch 1 (vec16), then
    # the rows of the remat runs' forwards not listed before
    k1 = []
    cases = [(1370, 1024, 0, "vec16"), (3601, 1024, 0, "vec16"), (8 * 3601, 1024, 0, "vec16"),
             (pano_b * pano_n, 1024, 0, "vec16"), (eval_b * eval_n, 1024, 0, "vec16"), (37, 192, 0, "vec16"),
             (1370, 1024, 1, "scalar"), (GIANT_TOKENS + 1, 1536, 0, "vec16")]
    cases += [(b * n, d, 0, "vec16") for b, n, _, d in remat_vits() if (b * n, d, 0, "vec16") not in cases]
    for m, d, offset, variant in cases:
        k1.append(layer_norm_case(gen, m, d, offset, variant, host=m == 1370 and not offset))
    results["layer_norm"] = k1

    # K2 flash attention: q/k/v as strided views of a (B, N, 3, H, 64) qkv tensor, at the ViT
    # token counts (batch 1 and 8, the panorama's 12 views, eval) with device times, then kv_valid
    # at the bf16 kernel's key-tile edges (one key, a tile less one, a tile, a tile and one) for
    # the errors alone, then the giant's 24 heads at batch 1 (timed), then the remat runs' forwards
    # (the errors alone)
    bc = attention.KEY_TILE
    k2 = []
    for b, n, kv_valid, timed, heads in [(1, 1370, None, True, 16), (1, 3601, None, True, 16),
                                         (1, 1201, None, True, 16), (1, 1370, 1000, True, 16),
                                         (8, 1370, None, True, 16), (pano_b, pano_n, None, True, 16),
                                         (eval_b, eval_n, None, True, 16)] + \
                                        [(1, 1370, kv, False, 16) for kv in (1, bc - 1, bc, bc + 1)] + \
                                        [(1, GIANT_TOKENS + 1, None, True, 24)] + \
                                        [(b, n, None, False, heads) for b, n, heads, _ in remat_vits()]:
        qkv = randn(b, n, 3, heads, 64)
        q, k, v = qkv[:, :, 0] * 2, qkv[:, :, 1], qkv[:, :, 2]  # sharper softmax than unit logits
        before = read_variants("flash_attention")["wgmma"]
        got, got_lse = attention.flash_attention_fwd(q, k, v, kv_valid)
        if read_variants("flash_attention")["wgmma"] != before + 1:
            raise AssertionError(f"K2 at B={b} N={n} kv_valid={kv_valid} did not launch the wgmma kernel")
        want, want_lse = attention.attention_plain(q.float(), k.float(), v.float(), kv_valid, return_lse=True)
        err = (got.float() - want).abs().max().item()
        lse_err = (got_lse - want_lse).abs().max().item()
        kv = kv_valid or n
        label = f"B={b} H={heads} N={n} kv_valid={kv}"
        line = (f"[K2] {label}: max_abs_err {err:.3e} (tol {K2_MAX_ABS}), lse max_abs_err {lse_err:.3e} "
                f"(tol {K2_LSE_ABS}), out max {want.abs().max().item():.3f}")
        case = (err, None, None, None, None)
        if timed:
            ms, plain_ms, lib_ms, dev_ms = attention_times(q, k, v, kv_valid)
            bnd = bound(bf16, flops=4 * b * heads * n * kv * 64, mufu=b * heads * n * kv,
                        bytes_moved=2 * b * heads * 64 * 2 * (n + kv) + b * heads * n * 4)
            line += f", {conv_times_text(ms, plain_ms, lib_ms, dev_ms, 'SDPA flash')}; bound {bnd[0]:.4f} ms ({bnd[1]})"
            case = (err, ms, plain_ms, lib_ms, bnd, dev_ms)
        log(line)
        if not err <= K2_MAX_ABS:
            raise AssertionError(f"K2 flash attention disagrees at {label}: {err} > {K2_MAX_ABS}")
        if not lse_err <= K2_LSE_ABS:
            raise AssertionError(f"K2 logsumexp disagrees at {label}: {lse_err} > {K2_LSE_ABS}")
        k2.append(case)
        del qkv, q, k, v, got, got_lse, want, want_lse
    torch.cuda.empty_cache()
    k2 += fp32_attention_cases(gen, paths)
    results["flash_attention"] = k2
    torch.cuda.empty_cache()

    results["conv3x3"] = conv_cases(gen)
    results["conv3x3_grouped"] = grouped_cases(gen)
    results["conv3x3"] += fp32_conv_cases(gen)
    torch.cuda.synchronize()
    return results


def fp32_attention_cases(gen, paths: dict) -> list:
    """The fp32 K2 (the register-blocked FFMA kernel of MoGe-1's and every
    fp32 ``infer``) against its plain version in fp32, q/k/v strided views of
    one fp32 (B, N, 3, H, 64) projection: timed at MoGe-1's folder image (B =
    1, 2501 tokens), eval's and the panorama's shapes, by CUDA events and
    device time beside SDPA's memory-efficient fp32 forward and the FP32
    bound; then, for the errors alone, kv_valid on and around the kernel's
    32-key tiles and a sequence-parallel chunk (1801 queries of 3602 keys,
    3601 live). Each launch counted under ``fp32``, with the build
    ``f32_plan`` took."""
    import torch

    from moge_tpu_torch.ops import _build, attention

    f32 = torch.float32
    dev = torch.device(DEVICE)
    (pano_b, pano_n), (eval_b, eval_n) = paths["panorama"], paths["eval"]
    cases = []
    for b, nq, n, kv_valid, timed in [(1, 2501, 2501, None, True), (eval_b, eval_n, eval_n, None, True),
                                      (pano_b, pano_n, pano_n, None, True)] + \
                                     [(1, 1370, 1370, kv, False) for kv in (1, 31, 32, 33, 127, 128, 129)] + \
                                     [(1, 1801, 3602, 3601, False)]:
        qkv = torch.randn(b, n, 3, 16, 64, generator=gen, device=dev, dtype=f32)
        q, k, v = qkv[:, :nq, 0] * 2, qkv[:, :, 1], qkv[:, :, 2]  # sharper softmax than unit logits
        before = read_variants("flash_attention")
        got, got_lse = attention.flash_attention_fwd(q, k, v, kv_valid)
        after = read_variants("flash_attention")
        if {key: c - before[key] for key, c in after.items()} != {"wgmma": 0, "fp32": 1}:
            raise AssertionError(f"fp32 K2 at B={b} Nq={nq} kv_valid={kv_valid} did not launch the fp32 kernel")
        want, want_lse = attention.attention_plain(q, k, v, kv_valid, return_lse=True)
        err = (got - want).abs().max().item()
        excess = ((got - want).abs() - K2_F32_TOL * (1 + want.abs())).max().item()
        lse_excess = ((got_lse - want_lse).abs() - K2_F32_LSE_ABS - K2_F32_TOL * want_lse.abs()).max().item()
        kv = kv_valid or n
        plan = attention.f32_plan(b, 16, nq, _build.sm_count(dev))
        label = f"B={b} H=16 Nq={nq} kv_valid={kv}"
        line = (f"[K2 fp32] {label}: max_abs_err {err:.3e}, lse max_abs_err "
                f"{(got_lse - want_lse).abs().max().item():.3e} (tol {K2_F32_TOL} x (1 + |want|) / {K2_F32_LSE_ABS} + "
                f"{K2_F32_TOL} x |want|), "
                f"the {plan.per_sm}-a-SM build")
        case = (err, None, None, None, None)
        if timed:
            ms, plain_ms, lib_ms, dev_ms = attention_times(q, k, v, kv_valid)
            bnd = bound(f32, flops=4 * b * 16 * nq * kv * 64, mufu=b * 16 * nq * kv,
                        bytes_moved=4 * b * 16 * 64 * 2 * (nq + kv) + b * 16 * nq * 4)
            line += (f", {conv_times_text(ms, plain_ms, lib_ms, dev_ms, 'SDPA efficient fp32')}; "
                     f"bound {bnd[0]:.4f} ms ({bnd[1]}), {bnd[0] / dev_ms['device_ms'] * 100:.1f}% of it by device time")
            case = (err, ms, plain_ms, lib_ms, bnd, dev_ms)
        log(line)
        if not (excess <= 0 and lse_excess <= 0):
            raise AssertionError(f"fp32 K2 disagrees at {label}: out excess {excess}, lse excess {lse_excess}")
        cases.append(case)
        del qkv, q, k, v, got, got_lse, want, want_lse
        torch.cuda.empty_cache()
    return cases


def fp32_conv_cases(gen) -> list:
    """The fp32 K3 (the register-blocked FFMA implicit GEMM of MoGe-1's and
    every fp32 ``infer``) against its plain version in fp32 (cuDNN, TF32
    off) at every distinct conv shape of MoGe-1's folder image (moge-vitl,
    FOLDER_HW at FOLDER_TOKENS, ``k3_shapes_v1``), then the heads' conv with
    a ReLU in (the error alone): each launch counted under ``fp32`` with the
    tile ``_f32_tile`` took, held to K3_F32_TOL; each timed shape by CUDA
    events and device time (one trace of 10 calls) beside F.conv2d in fp32
    by CUDA events and the FP32 bound, with the share of that bound; then
    the forward's 17 convs summed. F.conv2d is not traced: cuDNN's fp32
    channels-last call at 172x228 256 -> 128 takes ~0.2 s, its trace ~90 s,
    and the traces after it on the card came back short or empty. The plain
    version is not timed: it is F.conv2d behind a pad."""
    import torch

    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.ops import _build, conv
    from moge_tpu_torch.tools.roofline import device_ms

    dev = torch.device(DEVICE)
    config = get_preset("moge-vitl")["config"]
    patch, resized = v1_grid(FOLDER_TOKENS, *FOLDER_HW)
    shapes = k3_shapes_v1(config, patch, resized)
    heads = [s for s in shapes if s[:2] == resized]
    shapes += [(h, w, c, o, True, res, up2, 0) for h, w, c, o, _, res, up2, _ in heads]
    cases, per_forward = [], [0, 0.0, 0.0, 0.0, 0.0]
    for h, w, c, o, relu, use_res, _, n in shapes:
        started = time.perf_counter()
        x = torch.randn(1, h, w, c, generator=gen, device=dev)
        kern = torch.randn(3, 3, c, o, generator=gen, device=dev) * (9 * c) ** -0.5
        bias = torch.randn(o, generator=gen, device=dev) * 0.1
        res = torch.randn(1, h, w, o, generator=gen, device=dev) if use_res else None
        before = read_variants("conv3x3")
        got = conv.conv3x3_replicate(x, kern, bias, res, relu)
        moved = {k: v - before[k] for k, v in read_variants("conv3x3").items() if v != before[k]}
        want = conv.conv3x3_plain(x, kern, bias, res, relu)
        err = (got - want).abs().max().item()
        excess = ((got - want).abs() - K3_F32_TOL * (want.abs().max() + want.abs())).max().item()
        tile = conv._f32_tile(1, 1, h, w, c, o, _build.sm_count(dev))
        label = f"{h}x{w} {c}->{o} relu={relu} residual={use_res}"
        line = f"[K3 fp32] {label} ({moved}, {tile}): max_abs_err {err:.3e} (tol {K3_F32_TOL} x (max |want| + |want|))"
        del got, want
        case = (err, None, None, None, None)
        if n:
            def kernel():
                return conv.conv3x3_replicate(x, kern, bias, res, relu)

            ms, lib_ms = cuda_ms(kernel, 10), cuda_ms(library_conv(x, kern, bias), 10)
            dev_ms = {"device_ms": device_ms(kernel, 10, windows=1)}
            bnd = conv_bound(x, kern, res)
            line += (f", kernel {ms:.4f} ms by events / {dev_ms['device_ms']:.4f} by device time, F.conv2d fp32 "
                     f"{lib_ms:.4f} by events; bound {bnd[0]:.4f} ms ({bnd[1]}), {bnd[0] / ms * 100:.1f}% of it by "
                     f"events, {bnd[0] / dev_ms['device_ms'] * 100:.1f}% by device time; {n} a forward")
            case = (err, ms, None, lib_ms, bnd, dev_ms)
            for i, add in enumerate((n, n * ms, n * dev_ms["device_ms"], n * lib_ms, n * bnd[0])):
                per_forward[i] += add
        log(f"{line} ({time.perf_counter() - started:.1f} s)")
        if moved != {"fp32": 1}:
            raise AssertionError(f"fp32 K3 at {label} launched {moved}, not one tiled fp32 kernel")
        if not excess <= 0:
            raise AssertionError(f"fp32 K3 disagrees at {label}: excess {excess}")
        cases.append(case)
        del x, kern, bias, res
        torch.cuda.empty_cache()
    want_n = expected_v1_launches(config)["conv3x3"]
    if per_forward[0] != want_n:
        raise AssertionError(f"folder: the K3 shapes list {per_forward[0]} launches per forward, moge-vitl implies {want_n}")
    n, k_ms, k_dev, l_ms, b_ms = per_forward
    log(f"[K3 fp32 per forward] folder {FOLDER_HW[0]}x{FOLDER_HW[1]} at {FOLDER_TOKENS} tokens: {n} launches, kernel "
        f"{k_ms:.4f} ms by events / {k_dev:.4f} by device time, F.conv2d fp32 {l_ms:.4f} by events; bound "
        f"{b_ms:.4f} ms, {b_ms / k_ms * 100:.1f}% of it by events, {b_ms / k_dev * 100:.1f}% by device time")
    return cases


def path_grids() -> dict:
    """path -> (batch, (base_h, base_w) token grid) of the moge-2-vitl-normal
    forward of each inference path this script counts: the main path (518^2
    at 1369 tokens), the panorama (12 views at PANO_SPLIT^2, resolution level
    PANO_LEVEL) and eval (EVAL_HW at resolution level 9, the adapter's
    default); then the training command's two extreme grids at its
    low-resolution 1200 tokens, aspect 2:1 and 1:2 (the ends of v2.json's
    aspect_ratio_range), at its batch; then ``phase_train_remat``'s grid
    (REMAT_TOKENS on TRAIN_HW) at each of REMAT_BATCHES."""
    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import base_token_grid

    lo, hi = get_preset("moge-2-vitl-normal")["config"]["num_tokens_range"]
    tokens = {level: int(lo + (level / 9) * (hi - lo)) for level in (PANO_LEVEL, 9)}
    return {"infer": (1, base_token_grid(1369, 1.0)), "panorama": (12, base_token_grid(tokens[PANO_LEVEL], 1.0)),
            "eval": (1, base_token_grid(tokens[9], EVAL_HW[1] / EVAL_HW[0])),
            "train_cli 2:1": (TRAIN_CLI_BATCH, base_token_grid(lo, 2.0)),
            "train_cli 1:2": (TRAIN_CLI_BATCH, base_token_grid(lo, 0.5)),
            **{f"train_remat {b}": (b, base_token_grid(REMAT_TOKENS, TRAIN_HW[1] / TRAIN_HW[0]))
               for b in REMAT_BATCHES}}


def k3_shapes(grid_h: int, grid_w: int) -> list:
    """K3's shapes in one moge-2-vitl-normal forward on a grid_h x grid_w
    token grid. Per ConvStack level (2, 4 and 8 times the grid) the res
    blocks' convs with the input ReLU, with ReLU and residual, and the plain
    ones; then the up2 convs at the last level over parity-expanded weights:
    the neck's (4 x 32), the points and normal heads' (4 x 3, the 1x1 folded
    in) and the mask head's (4 x 1). (h, w, c, o, relu, residual, up2,
    launches per forward.)"""
    levels = [(2 * grid_h, 2 * grid_w, 256), (4 * grid_h, 4 * grid_w, 128), (8 * grid_h, 8 * grid_w, 64)]
    return [(h, w, c, c, relu, res, False, n) for h, w, c in levels
            for relu, res, n in ((True, False, 5), (True, True, 5), (False, False, 4))] + \
           [(8 * grid_h, 8 * grid_w, 64, 4 * o, False, False, True, n) for o, n in ((32, 1), (3, 2), (1, 1))]


def v1_path_grids() -> dict:
    """path -> (batch, (patch_h, patch_w), (resized_h, resized_w)) of the
    moge-vitl (MoGe-1) forward of each MoGe-1 path this script counts:
    moge1_infer's 518x518 request at 1369 tokens, and the v1 training
    command's two extreme images at its low-resolution 1200 tokens, 512x1024
    and 1024x512 (aspect 2:1 and 1:2, the ends of v1.json's
    aspect_ratio_range), at its batch. ``MoGeV1.forward``'s arithmetic: the
    image resized to the token budget, its patch grid, and the size the
    head's output blocks run at."""
    lo = json.loads(TRAIN_V1_CONFIG.read_text())["model"]["num_tokens_range"][0]
    return {"moge1_infer": (1, *v1_grid(1369, 518, 518)), "train_v1 2:1": (TRAIN_CLI_BATCH, *v1_grid(lo, 512, 1024)),
            "train_v1 1:2": (TRAIN_CLI_BATCH, *v1_grid(lo, 1024, 512))}


def v1_grid(num_tokens: int, img_h: int, img_w: int) -> tuple:
    """((patch_h, patch_w), (resized_h, resized_w)) of a MoGe-1 forward of an
    img_h x img_w image at ``num_tokens``: ``MoGeV1.forward``'s arithmetic."""
    factor = ((num_tokens * 14 ** 2) / (img_h * img_w)) ** 0.5
    resized_h, resized_w = int(img_h * factor), int(img_w * factor)
    return (resized_h // 14, resized_w // 14), (resized_h, resized_w)


def k3_shapes_v1(config: dict, patch: tuple, resized: tuple) -> list:
    """K3's shapes in one MoGe-1 forward of ``config`` on a patch grid, its
    output blocks at ``resized``, in ``k3_shapes``' form. Per upsample stage
    (2, 4, 8 ... times the grid) the 3x3 conv after the transposed conv,
    then per res block its conv into the hidden width with the input ReLU
    and its conv back with ReLU and residual; per output block (points,
    mask: 2) the conv_in over the features and the UV channels, the res
    blocks' convs, and a 3x3 conv_out (3 and 1 channels) when it has one."""
    hidden = config.get("dim_times_res_block_hidden", 1)
    n_res = config.get("num_res_blocks", 1)
    shapes = []
    for i, d in enumerate(config.get("dim_upsample", [256, 128, 128]), 1):
        h, w = patch[0] << i, patch[1] << i
        shapes += [(h, w, d, d, False, False, False, 1), (h, w, d, hidden * d, True, False, False, n_res),
                   (h, w, hidden * d, d, True, True, False, n_res)]
    (h, w), c = resized, config.get("last_conv_channels", 32)
    n_last = config.get("last_res_blocks", 0)
    shapes.append((h, w, config.get("dim_upsample", [256, 128, 128])[-1] + 2, c, False, False, False, 2))
    if n_last:
        shapes += [(h, w, c, hidden * c, True, False, False, 2 * n_last), (h, w, hidden * c, c, True, True, False,
                                                                           2 * n_last)]
    if config.get("last_conv_size", 1) == 3:
        shapes += [(h, w, c, o, False, False, False, 1) for o in (3, 1)]
    return [s for s in shapes if s[-1]]


K3_RAGGED = [(37, 53, 64, 64, True, True), (37, 53, 24, 20, True, False)]


def call_times(kernel, plain, library, iters: int = 20, plain_iters: int = None):
    """Times of a kernel, its plain version and the library call on the same
    inputs, two ways: CUDA events around each call (``cuda_ms``, as for every
    kernel: the kernels line's ``ms``/``plain_ms``/``library_ms``) and device
    time from torch.profiler (``roofline.device_ms``: the kernels' own
    durations, without the host's time to reach the launch), returned as the
    line's ``device_ms``/``plain_device_ms``/``library_device_ms``."""
    from moge_tpu_torch.tools.roofline import device_ms

    calls = {"": (kernel, iters), "plain_": (plain, plain_iters or iters), "library_": (library, iters)}
    events = [cuda_ms(fn, n) for fn, n in calls.values()]
    return (*events, {f"{k}device_ms": device_ms(fn, n) for k, (fn, n) in calls.items()})


def attention_times(q, k, v, kv_valid):
    """``call_times`` of K2, its plain version and SDPA flash."""
    from moge_tpu_torch.ops import attention

    return call_times(lambda: attention.flash_attention(q, k, v, kv_valid),
                      lambda: attention.attention_plain(q, k, v, kv_valid), library_sdpa(q, k, v, kv_valid))


def conv_times(x, kern, bias, res, relu, iters: int = 20):
    """``call_times`` of K3 (or K3-grouped), its plain version and F.conv2d."""
    from moge_tpu_torch.ops import conv

    return call_times(lambda: conv.conv3x3_replicate(x, kern, bias, res, relu),
                      lambda: conv.conv3x3_plain(x, kern, bias, res, relu), library_conv(x, kern, bias), iters)


def conv_times_text(ms, plain_ms, lib_ms, dev_ms, library="F.conv2d"):
    return (f"ms by events / device time: kernel {ms:.4f} / {dev_ms['device_ms']:.4f}, plain {plain_ms:.4f} / "
            f"{dev_ms['plain_device_ms']:.4f}, {library} {lib_ms:.4f} / {dev_ms['library_device_ms']:.4f}")


def conv_cases(gen):
    """K3 (bf16) against its plain version at every shape of the main path's
    forward (batch 1, 1369 tokens), then at ragged ones, then at every shape
    of the panorama's (12 views, 3600 tokens), eval's (480x640, 3600 tokens)
    and the training command's two extreme grids (batch 2, 1200 tokens,
    aspect 2:1 and 1:2) and ``phase_train_remat``'s (batch 2 and 8, 3600
    tokens) forwards (``path_grids``), then at every shape of
    the MoGe-1 forwards of moge1_infer and the v1 training command
    (``v1_path_grids``, ``k3_shapes_v1``: moge-vitl's head, res blocks twice
    as wide as their stage); times (``conv_times``) of the kernel, the plain
    version and F.conv2d (the remat and MoGe-1 shapes: kernel and F.conv2d
    by CUDA events alone, 5 calls); then per path K3 ms per forward by
    device time (remat, MoGe-1: by events), kernel against library: each
    shape's launches per forward x its time, and their sums, which must be
    the config's launches per forward."""
    import torch

    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.ops import _build, conv

    dev = torch.device(DEVICE)
    bf16 = torch.bfloat16
    grids, v1_grids = path_grids(), v1_path_grids()
    want = {"moge-2-vitl-normal": expected_launches(get_preset("moge-2-vitl-normal")["config"])["conv3x3"]}
    v1_config = get_preset("moge-vitl")["config"]
    want["moge-vitl"] = expected_v1_launches(v1_config)["conv3x3"]
    runs = [("infer", grids["infer"][0], k3_shapes(*grids["infer"][1]), "moge-2-vitl-normal"),
            (None, 1, [(*r, False, 0) for r in K3_RAGGED], None)] + \
           [(path, grids[path][0], k3_shapes(*grids[path][1]), "moge-2-vitl-normal")
            for path in ("panorama", "eval", "train_cli 2:1", "train_cli 1:2",
                         *(f"train_remat {b}" for b in REMAT_BATCHES))] + \
           [(path, batch, k3_shapes_v1(v1_config, patch, resized), "moge-vitl")
            for path, (batch, patch, resized) in v1_grids.items()]
    cases = []
    for path, batch, shapes, model in runs:
        events_only = model == "moge-vitl" or (path or "").startswith("train_remat")
        per_forward = {}
        for h, w, c, o, relu, use_res, up2, n in shapes:
            x = torch.randn(batch, h, w, c, generator=gen, device=dev).to(bf16)
            kern = torch.randn(3, 3, c, o // 4 if up2 else o, generator=gen, device=dev) * (9 * c) ** -0.5
            bias = torch.randn(kern.shape[-1], generator=gen, device=dev) * 0.1
            if up2:  # the operands conv3x3_up2_bilinear hands K3
                kern, bias = conv.up2_conv3_expanded(kern, bias, bf16)
            kern = kern.to(bf16).contiguous()
            res = torch.randn(batch, h, w, o, generator=gen, device=dev).to(bf16) if use_res else None
            before = read_variants("conv3x3", "conv3x3_grouped")
            got = conv.conv3x3_replicate(x, kern, bias, res, relu).float()
            variant = [k for k, v in read_variants("conv3x3", "conv3x3_grouped").items() if v != before[k]]
            want_out = conv.conv3x3_plain(x.float(), kern.float(), bias, None if res is None else res.float(), relu)
            err = (got - want_out).abs().max().item()
            rel = err / want_out.abs().max().item()
            del got, want_out
            if events_only:  # the check, and times by CUDA events alone (no profiler traces)
                ms = cuda_ms(lambda: conv.conv3x3_replicate(x, kern, bias, res, relu), 5)
                lib_ms = cuda_ms(library_conv(x, kern, bias), 5)
                plain_ms, dev_ms = None, {"device_ms": ms, "library_device_ms": lib_ms}
                times = f"ms by events: kernel {ms:.4f}, F.conv2d {lib_ms:.4f}"
            else:
                ms, plain_ms, lib_ms, dev_ms = conv_times(x, kern, bias, res, relu)
                times = conv_times_text(ms, plain_ms, lib_ms, dev_ms)
            bnd = conv_bound(x, kern, res)
            label = f"{'up2 ' if up2 else ''}B={batch} {h}x{w} {c}->{o} relu={relu} residual={use_res}"
            log(f"[K3] {label} ({variant[0] if len(variant) == 1 else variant}, "
                f"{conv._tile_config(1, batch, h, w, c, o, _build.sm_count(dev))}): max_abs_err {err:.3e} rel "
                f"{rel:.3e} (tol {K3_REL}), {times}; bound {bnd[0]:.4f} ms ({bnd[1]})")
            if not rel <= K3_REL:
                raise AssertionError(f"K3 conv disagrees at {label}: rel {rel} > {K3_REL}")
            if variant not in [[v] for v in conv.PIPELINED]:
                raise AssertionError(f"K3 at {label} took {variant}, not one pipelined wgmma variant")
            cases.append((err, ms, plain_ms, lib_ms, bnd, dev_ms))
            if n:
                row = per_forward.setdefault(f"{'up2 ' if up2 else ''}{h}x{w} {c}->{o}", [0, 0.0, 0.0])
                row[0] += n
                row[1] += n * dev_ms["device_ms"]
                row[2] += n * dev_ms["library_device_ms"]
            del x, kern, bias, res
        torch.cuda.empty_cache()
        if path is None:
            continue
        measure = "CUDA events" if events_only else "device time"
        for shape, (n, k_ms, l_ms) in per_forward.items():
            log(f"[K3 per forward] {path}: {shape}: {n} launches, {measure}: kernel {k_ms:.4f} ms, "
                f"F.conv2d {l_ms:.4f} ms")
        total = [sum(r[i] for r in per_forward.values()) for i in range(3)]
        if total[0] != want[model]:
            raise AssertionError(f"{path}: the K3 shapes list {total[0]} launches per forward, {model} implies "
                                 f"{want[model]}")
        grid = grids[path][1] if path in grids else v1_grids[path][1]
        log(f"[K3 per forward] {path}: {model}, batch {batch}, token grid {grid}: "
            f"{total[0]} launches, kernel {total[1]:.4f} ms vs F.conv2d {total[2]:.4f} ms ({measure})")
    return cases


# path -> the launches per run of each kernel variant (conv: K3 and K3-grouped; attention: K2;
# attention_bwd: K2b-dq and K2b-dkv together; norm: K1)
VARIANTS_BY_PATH = {}


def check_variants(path: str, label: str, counts: dict, runs: int = 1) -> dict:
    """Every K1 launch of a counted run took the vec16 variant, every K3 and
    K3-grouped launch a pipelined wgmma variant, and every K2, K2b-dq and
    K2b-dkv launch, bf16 on every counted path, the wgmma kernel (the
    registry's variants, set to 0 with the other counts). Records the run's
    variants under ``path``, divided by ``runs`` when ``counts`` covers that
    many runs."""
    from moge_tpu_torch.ops import conv

    variants = {"conv": read_variants("conv3x3", "conv3x3_grouped"), "attention": read_variants("flash_attention"),
                "attention_bwd": read_variants("flash_attention_dq", "flash_attention_dkv"),
                "norm": read_variants("layer_norm")}
    if variants["norm"] != {"vec16": counts["layer_norm"], "scalar": 0}:
        raise AssertionError(f"{label}: K1 launches by variant {variants['norm']}, count {counts['layer_norm']}: "
                             f"not all on the vec16 variant")
    pipelined = sum(variants["conv"][k] for k in conv.PIPELINED)
    if pipelined != counts["conv3x3"] + counts["conv3x3_grouped"] or pipelined != sum(variants["conv"].values()):
        raise AssertionError(f"{label}: K3 launches by variant {variants['conv']}, counts {counts['conv3x3']} + "
                             f"{counts['conv3x3_grouped']}: not all on the pipelined wgmma path")
    if variants["attention"] != {"wgmma": counts["flash_attention"], "fp32": 0}:
        raise AssertionError(f"{label}: K2 launches by variant {variants['attention']}, count "
                             f"{counts['flash_attention']}: not all on the wgmma kernel")
    bwd = counts["flash_attention_dq"] + counts["flash_attention_dkv"]
    if variants["attention_bwd"] != {"wgmma": bwd, "fp32": 0}:
        raise AssertionError(f"{label}: K2b launches by variant {variants['attention_bwd']}, counts "
                             f"{counts['flash_attention_dq']} + {counts['flash_attention_dkv']}: not all on the "
                             f"wgmma kernels")
    VARIANTS_BY_PATH[path] = {kind: {k: n // runs for k, n in v.items()} for kind, v in variants.items()}
    return variants


def grouped_cases(gen):
    """K3-grouped vs its plain version (the grouped ``conv3x3_plain``: one
    cuDNN fp32 conv per group) at the batched heads' shapes with ViT-L at
    1369 tokens, G = 3 heads and B0 = 1 and 8 images, bf16 and fp32, then a
    ragged case and the folded up2 conv (parity-expanded 64 -> 4x32)."""
    import torch

    from moge_tpu_torch.ops import conv

    dev = torch.device(DEVICE)
    cases = []
    shapes = [(74, 74, 256, 256, True, True), (148, 148, 128, 128, True, True), (296, 296, 64, 64, True, True),
              ("up2", 296, 64, 32, False, False), (37, 53, 24, 20, True, True)]
    for h, w, c, o, relu, use_res in shapes:
        for b0 in ((1, 8) if h != 37 else (3,)):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(3 * b0, w, w, c, generator=gen, device=dev).to(dtype) if h == "up2" else \
                    torch.randn(3 * b0, h, w, c, generator=gen, device=dev).to(dtype)
                kern = torch.randn(3, 3, 3, c, o, generator=gen, device=dev) * (9 * c) ** -0.5
                bias = torch.randn(3, o, generator=gen, device=dev) * 0.1
                if h == "up2":  # the operands of conv3x3_up2_bilinear's grouped conv
                    kern, bias = conv.up2_conv3_expanded(kern, bias, dtype)
                kern = kern.to(dtype).contiguous()
                res = torch.randn(*x.shape[:3], kern.shape[-1], generator=gen, device=dev).to(dtype) \
                    if use_res else None
                before = launches_of("conv3x3_grouped")
                got = conv.conv3x3_replicate(x, kern, bias, res, relu).float()
                if launches_of("conv3x3_grouped") != before + 1:
                    raise AssertionError("conv3x3_replicate with grouped weights did not launch K3-grouped")
                want = conv.conv3x3_plain(x.float(), kern.float(), bias, None if res is None else res.float(), relu)
                err = (got - want).abs().max().item()
                rel = err / want.abs().max().item()
                iters = 20 if dtype == torch.bfloat16 else 5
                ms, plain_ms, lib_ms, dev_ms = conv_times(x, kern, bias, res, relu, iters)
                bnd = conv_bound(x, kern, res)
                label = f"{'up2 ' if h == 'up2' else ''}{x.shape[1]}x{x.shape[2]} {c}->{kern.shape[-1]}"
                log(f"[K3g] G=3 B0={b0} {label} {str(dtype).split('.')[-1]} relu={relu} residual={use_res}: "
                    f"max_abs_err {err:.3e} rel {rel:.3e} (tol {K3_REL}), "
                    f"{conv_times_text(ms, plain_ms, lib_ms, dev_ms, 'F.conv2d(groups=3)')}; "
                    f"bound {bnd[0]:.4f} ms ({bnd[1]})")
                if not rel <= K3_REL:
                    raise AssertionError(f"K3-grouped disagrees at G=3 B0={b0} {label} {dtype}: rel {rel} > {K3_REL}")
                cases.append((err, ms, plain_ms, lib_ms, bnd, dev_ms))
                del x, kern, bias, res, got, want
    torch.cuda.empty_cache()
    return cases


def phase_kernels_train():
    """K2b-dq, K2b-dkv and K4 against their plain versions on the card; K2b
    bf16 also by device time, with the whole backward (delta + K2b-dq +
    K2b-dkv) against SDPA's flash backward; K2b also at the backward shapes
    of ``phase_train_remat``'s runs (``remat_vits``), for the errors alone."""
    import torch

    from moge_tpu_torch.ops import alignment, attention
    from moge_tpu_torch.tools.roofline import device_ms

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    results = {"flash_attention_dq": [], "flash_attention_dkv": [], "dense_align": []}

    # K2b at the ViT token counts, q/k/v strided views of one qkv projection;
    # "plain" is autograd's backward through attention_plain (graph built once)
    cases = [(dtype, 2, 16, n, kv_valid, True) for dtype in (torch.bfloat16, torch.float32)
             for n, kv_valid in ((1370, 1370), (3601, 3601), (1370, 1000))]
    # then the backward of the remat runs' forwards not among them, for the errors alone
    cases += [(torch.bfloat16, b, heads, n, n, False) for b, n, heads, _ in remat_vits()
              if (torch.bfloat16, b, heads, n, n, True) not in cases]
    for dtype, b, heads, n, kv_valid, timed in cases:
        qkv = torch.randn(b, n, 3, heads, 64, generator=gen, device=dev).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        dout = torch.randn(b, n, heads, 64, generator=gen, device=dev).to(dtype)
        out, lse = attention.flash_attention_fwd(q, k, v, kv_valid)
        delta = attention.attention_bwd_delta(out, dout)
        dq = attention.flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_valid)
        dk, dv = attention.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_valid)
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(attention.attention_plain(*leaves, kv_valid), leaves, dout.float())
        tol = K2B_REL[str(dtype).split(".")[-1]] * max(w.abs().max().item() for w in want)
        err_dq = (dq.float() - want[0]).abs().max().item()
        err_dkv = max((g.float() - w).abs().max().item() for g, w in zip((dk, dv), want[1:]))
        before = read_variants("flash_attention_dq", "flash_attention_dkv")
        again = (attention.flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_valid),
                 *attention.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_valid))
        variant = "wgmma" if dtype == torch.bfloat16 else "fp32"
        after = read_variants("flash_attention_dq", "flash_attention_dkv")
        if {key: c - before[key] for key, c in after.items()} != \
                {key: 2 * (key == variant) for key in before}:
            raise AssertionError(f"K2b at N={n} {dtype} did not launch the {variant} kernels")
        if not all(torch.equal(a, g) for a, g in zip(again, (dq, dk, dv))):
            raise AssertionError(f"K2b at N={n} {dtype}: two calls on the same inputs gave other bits")
        label = f"B={b} H={heads} N={n} kv_valid={kv_valid} {str(dtype).split('.')[-1]}"
        if not (err_dq <= tol and err_dkv <= tol):
            raise AssertionError(f"K2b flash backward disagrees at {label}: {err_dq}, {err_dkv} > {tol}")
        if not timed:
            log(f"[K2b] {label}: dq max_abs_err {err_dq:.3e}, dk/dv max_abs_err {err_dkv:.3e} (tol {tol:.3e}), "
                f"bit-identical twice")
            results["flash_attention_dq"].append((err_dq, None, None, None, None))
            results["flash_attention_dkv"].append((err_dkv, None, None, None, None))
            del qkv, q, k, v, dout, out, lse, delta, dq, dk, dv, leaves, want, again
            torch.cuda.empty_cache()
            continue
        dq_fn = functools.partial(attention.flash_attention_bwd_dq, q, k, v, dout, lse, delta, kv_valid)
        dkv_fn = functools.partial(attention.flash_attention_bwd_dkv, q, k, v, dout, lse, delta, kv_valid)
        plain_in = [t.detach().requires_grad_() for t in (q, k, v)]
        plain_out = attention.attention_plain(*plain_in, kv_valid)
        plain_dq_fn = functools.partial(torch.autograd.grad, plain_out, plain_in[0], dout, retain_graph=True)
        plain_dkv_fn = functools.partial(torch.autograd.grad, plain_out, plain_in[1:], dout, retain_graph=True)
        # SDPA's flash backward (bf16 only) computes dq, dk and dv in one call
        lib_fn = library_sdpa(q, k, v, kv_valid, dout) if dtype == torch.bfloat16 else None
        io = b * n * heads * 64 * qkv.element_size()  # one (B, N, H, 64) tensor
        stats = 2 * b * heads * n * 4               # lse and delta
        bnd_dq = bound(dtype, flops=6 * b * heads * n * kv_valid * 64, mufu=b * heads * n * kv_valid,
                       bytes_moved=5 * io + stats)
        bnd_dkv = bound(dtype, flops=8 * b * heads * n * kv_valid * 64, mufu=b * heads * n * kv_valid,
                        bytes_moved=6 * io + stats)
        if lib_fn is None:  # fp32: CUDA events only, as in PR 2-6
            ms_dq, ms_dkv = cuda_ms(dq_fn), cuda_ms(dkv_fn)
            plain_dq, plain_dkv = cuda_ms(plain_dq_fn, 10), cuda_ms(plain_dkv_fn, 10)
            lib_ms, dev_dq, dev_dkv = None, {}, {}
            times = f"dq kernel {ms_dq:.4f} ms, plain {plain_dq:.4f} ms; dk/dv kernel {ms_dkv:.4f} ms, " \
                    f"plain {plain_dkv:.4f} ms"
        else:  # bf16: events and device time, and the whole backward (delta + dq + dkv) against SDPA's
            ms_dq, plain_dq, lib_ms, dev_dq = call_times(dq_fn, plain_dq_fn, lib_fn, plain_iters=5)
            ms_dkv, plain_dkv, _, dev_dkv = call_times(dkv_fn, plain_dkv_fn, lib_fn, plain_iters=5)
            whole = device_ms(lambda: attention.flash_attention_bwd(q, k, v, out, lse, dout, kv_valid))
            bnd_all = bound(dtype, flops=10 * b * heads * n * kv_valid * 64, mufu=b * heads * n * kv_valid,
                            bytes_moved=8 * io + b * heads * n * 4)
            dev_dq["backward_device_ms"] = dev_dkv["backward_device_ms"] = whole
            times = (f"dq {conv_times_text(ms_dq, plain_dq, lib_ms, dev_dq, 'SDPA flash backward')}; dk/dv "
                     f"{conv_times_text(ms_dkv, plain_dkv, lib_ms, dev_dkv, 'SDPA flash backward')}")
            log(f"[K2b] {label}: the whole backward (delta + dq + dk/dv) {whole:.4f} ms against SDPA's flash "
                f"backward {dev_dq['library_device_ms']:.4f} ms (device time; "
                f"{whole / dev_dq['library_device_ms']:.3f}x); its bound {bnd_all[0]:.4f} ms ({bnd_all[1]})")
        del plain_out, plain_in
        log(f"[K2b] {label}: dq max_abs_err {err_dq:.3e}, dk/dv max_abs_err {err_dkv:.3e} (tol {tol:.3e}), "
            f"bit-identical twice; {times}; bound dq {bnd_dq[0]:.4f} ms ({bnd_dq[1]}), dk/dv {bnd_dkv[0]:.4f} ms "
            f"({bnd_dkv[1]})")
        if kv_valid < n and (dk[:, kv_valid:].any() or dv[:, kv_valid:].any()):
            raise AssertionError(f"K2b: masked keys got nonzero dk/dv at {label}")
        results["flash_attention_dq"].append((err_dq, ms_dq, plain_dq, lib_ms, bnd_dq, dev_dq))
        results["flash_attention_dkv"].append((err_dkv, ms_dkv, plain_dkv, lib_ms, bnd_dkv, dev_dkv))
        torch.cuda.empty_cache()

    # K4 at the v2 loss shapes (batch 2): rows bounded to ~2^32 pairs for the
    # comparison and the plain version's time; the kernel also at full rows
    for length, full_rows in loss_solve_shapes(json.loads(TRAIN_CONFIG.read_text())["loss"]["A"], 2):
        rows = min(full_rows, 2 ** 32 // length ** 2)
        A, wx, wy = torch.randn(3, rows, length, generator=gen, device=dev).unbind(0)
        got = alignment.dense_objective(A, wx, wy, 1.0)
        want = alignment.dense_objective_plain(A, wx, wy, 1.0)
        err = (got - want).abs().max().item()
        tol = K4_REL * want.abs().max().item()
        ms = cuda_ms(lambda: alignment.dense_objective(A, wx, wy, 1.0))
        plain_ms = cuda_ms(lambda: alignment.dense_objective_plain(A, wx, wy, 1.0), 5)
        A, wx, wy = torch.randn(3, full_rows, length, generator=gen, device=dev).unbind(0)
        full_ms = cuda_ms(lambda: alignment.dense_objective(A, wx, wy, 1.0), 5)
        bnd = bound(bytes_moved=4 * rows * length * 4, fp32_instr=3 * rows * length ** 2)
        log(f"[K4] L={length} rows={rows}: max_abs_err {err:.3e} (tol {tol:.3e}), kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); full rows={full_rows}: kernel "
            f"{full_ms:.4f} ms ({full_rows * length ** 2 / full_ms / 1e9:.3f} Tpair/s)")
        if not err <= tol:
            raise AssertionError(f"K4 dense objective disagrees at L={length}: {err} > {tol}")
        results["dense_align"].append((err, ms, plain_ms, None, bnd))
        del A, wx, wy
    torch.cuda.synchronize()
    return results


def phase_camera_solve() -> tuple:
    """K5 against the plain camera solve on the card (``SOLVE_CASES``, free
    focal, a mask keeping ~70% of the pixels): errors, launches per call,
    medians by CUDA events, and the host's time per call of K5's route (100
    calls enqueued back to back, before the synchronise). Returns K5's
    phase-3 cases (error: the larger of the two relative errors) and the
    cases' records."""
    import torch

    from moge_tpu_torch.ops import solvers
    from torch_tiny_config import camera_point_maps

    dev = torch.device(DEVICE)
    cases = []
    for b, h, w in SOLVE_CASES:
        points, mask, _ = camera_point_maps(b, h, w, SEED + b)
        points, mask = torch.from_numpy(points).to(dev), torch.from_numpy(mask).to(dev)
        before = launches_of("camera_solve")
        got = solvers.recover_focal_shift(points, mask)
        launches = launches_of("camera_solve") - before
        want = solvers._recover_plain(points, mask, None, (64, 64), 30)
        z_mean = points[..., 2].abs().mean((1, 2))
        focal_err = (got[0] / want[0] - 1).abs().max().item()
        shift_err = ((got[1] - want[1]).abs() / z_mean).max().item()
        if launches != 1 or not max(focal_err, shift_err) <= SOLVE_REL:
            raise RuntimeError(f"camera solve B={b} {h}x{w}: {launches} launches, focal {focal_err:.2e}, "
                               f"shift {shift_err:.2e} (limit {SOLVE_REL})")
        ms = cuda_ms(lambda: solvers.recover_focal_shift(points, mask))
        plain_ms = cuda_ms(lambda: solvers._recover_plain(points, mask, None, (64, 64), 30), iters=5, warmup=1)
        synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            solvers.recover_focal_shift(points, mask)
        host_us = (time.perf_counter() - t0) * 1e4
        synchronize()
        n = 64 * 64
        bound_ms, bound_by = bound(bytes_moved=b * n * (3 * 4 + 1) + n * 12 + 8 * b)
        cases.append({"batch": b, "hw": [h, w], "samples": n, "launches_per_call": launches,
                      "focal_rel_err": focal_err, "shift_rel_err": shift_err, "ms": ms, "plain_ms": plain_ms,
                      "host_us": host_us, "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"[camera_solve] B={b} {h}x{w}: K5 {ms:.4f} ms ({launches} launch, host {host_us:.1f} us a call), "
            f"plain {plain_ms:.3f} ms; focal {focal_err:.2e}, shift {shift_err:.2e} of mean |z|; "
            f"bound {bound_ms:.5f} ms ({bound_by})")
    k5 = [(max(c["focal_rel_err"], c["shift_rel_err"]), c["ms"], c["plain_ms"], None, (c["bound_ms"], c["bound_by"]),
           {"host_us": c["host_us"]}) for c in cases]
    return k5, cases


@contextlib.contextmanager
def align_form(impl: str):
    """Select a truncated-align form for the ``with`` block: set
    ``MOGE_ALIGN_TRUNC_IMPL``, restore it after."""
    saved = os.environ.get("MOGE_ALIGN_TRUNC_IMPL")
    os.environ["MOGE_ALIGN_TRUNC_IMPL"] = impl
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("MOGE_ALIGN_TRUNC_IMPL", None)
        else:
            os.environ["MOGE_ALIGN_TRUNC_IMPL"] = saved


def align_problem(gen, rows: int, length: int, dev):
    """A seeded truncated-align problem (rows, length) with the losses'
    structure: x mostly positive (a tenth negated, |x| >= 0.1), y near 1.3 x,
    a fifth of the weights 0, and ties at breakpoints (terms 1-7 of each row
    repeat term 0, so eight candidates are equal)."""
    import torch

    def uniform():
        return torch.rand(rows, length, generator=gen, device=dev)

    x = 2 * uniform() + 0.1
    x = torch.where(uniform() < 0.1, -x, x)
    y = 1.3 * x + 0.2 * torch.randn(rows, length, generator=gen, device=dev)
    w = uniform() * (uniform() > 0.2)
    x[:, 1:8], y[:, 1:8] = x[:, :1], y[:, :1]
    return x, y, w


def expected_align_launches() -> dict:
    """Kernel launches of one dense solve at one shape: one K4."""
    return {name: int(name == "dense_align") for name, _, _ in KERNELS}


def anchor_solve_excess(inputs, anchor, idx2, prefix: bool) -> tuple:
    """How far a scale/shift anchor solve's choice (``anchor``, ``idx2`` per
    row) lies above K4's minimum of the solve's objective over every (anchor
    with weight > 0, candidate) pair of its row, in units of the tolerance:
    K4_REL x the row's largest |F|, for prefix plus its cancellation error at
    the chosen anchor and at K4's best one. ``inputs``: the solve's (src,
    tgt, w, trunc, z_only). Returns (largest excess over the rows, rows)."""
    import torch

    from moge_tpu_torch.ops import alignment

    src, tgt, w, trunc, z_only = inputs
    p, n, _ = src.shape
    with torch.no_grad():
        mask = torch.tensor([0.0, 0.0, 1.0] if z_only else [1.0, 1.0, 1.0], device=src.device)
        x = (src[:, None] - (src * mask)[:, :, None]).reshape(p * n, 3 * n)  # row r, anchor a: src_r - src_a
        y = (tgt[:, None] - (tgt * mask)[:, :, None]).reshape(p * n, 3 * n)
        ww = w[:, None, :, None].expand(p, n, n, 3).reshape(p * n, 3 * n)
        xs, ys = x.abs(), y * torch.sign(x)
        A = ys / xs.clamp_min(1e-7)
        F = alignment.dense_objective(A, ww * xs, ww * ys, float(trunc)).reshape(p, n, 3 * n)
        cancel = (A.abs().amax(-1) * (ww * xs).sum(-1)).reshape(p, n)
        F = torch.where(w[:, :, None] > 0, F, torch.inf).reshape(p, -1)
        best = F.argmin(-1)
        f_min = F.gather(1, best[:, None])[:, 0]
        rows = torch.arange(p, device=src.device)
        picked = F[rows, anchor * 3 * n + idx2]
        tol = K4_REL * torch.where(F.isfinite(), F.abs(), 0.0).amax(-1)
        if prefix:
            tol = tol + PREFIX_CANCEL * (cancel[rows, anchor] + cancel[rows, best // (3 * n)])
        valid = f_min.isfinite()
        excess = torch.where(valid, (picked - f_min) / tol.clamp_min(1e-30), 0.0)
    return excess.max().item(), int(valid.sum())


def events_sort_inputs(x, y, w, trunc: float):
    """The events form's sort of an ``align`` problem with a scalar trunc:
    the keys (B, A, C) of its 3n breakpoint events and their payloads (the
    slope, intercept and count deltas, the candidate index), built as
    ``alignment._align_trunc_events`` builds them."""
    import torch

    n = x.shape[-1]
    sign = torch.sign(x)
    xs, ys = x * sign, y * sign
    wx, wy = w * xs, w * ys
    A = ys / xs.clamp_min(1e-7)
    B, C = (wy - trunc) / wx.clamp_min(1e-7), (wy + trunc) / wx.clamp_min(1e-7)
    one, zero = torch.ones_like(wx), torch.zeros_like(wx)
    idx = torch.full((3 * n,), n, dtype=torch.int32, device=x.device)
    idx[n:2 * n] = torch.arange(n, dtype=torch.int32, device=x.device)
    payloads = [torch.cat([-wx, 2 * wx, -wx], -1), torch.cat([wy, -2 * wy, wy], -1), torch.cat([-one, zero, one], -1),
                idx.expand(x.shape[0], 3 * n)]
    return torch.cat([B, A, C], -1), payloads


def phase_align_forms(card: str):
    """The truncated align's three forms on the card at the four v2 loss
    shapes (label type A, batch 2): dense on K4, events and prefix, each
    through ``alignment.align`` at full rows, with scalar truncation and, at
    patch_16, a per-element one. Each sorted form's chosen index must attain
    K4's minimum (K4's objective at the returned index against its row
    minimum, within the row's tolerance), and its ``a`` equal dense's
    wherever the two chose one index; median of ALIGN_TIMES CUDA-event times
    and peak memory per form and shape. Where 3L <= ALIGN_BITONIC_MAX, the
    events sort of the same problem by the bitonic network
    (``ops/bitonic.py``, which no path of the port calls) and by
    ``alignment.sort_stable``: bit for bit, median of BITONIC_TIMES each and
    the network's peak. Then the v2 grad step (type A, batch 2 at 512^2,
    TRAIN_TOKENS[0]) from one state, batch and generator under dense, events
    and prefix: loss and gradient norm against the dense step's, launches
    per step (the sorted steps launch no K4, the rest as the dense step),
    each sorted step's scale/shift solves against K4's minimum, and the
    median of ALIGN_STEP_TIMES more steps per form (dense's gradient norms
    over its repeats give the card's own spread)."""
    import numpy as np
    import torch

    from moge_tpu_torch.models.v2 import MoGeV2
    from moge_tpu_torch.ops import alignment, bitonic
    from moge_tpu_torch.train.step import make_grad_step

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    cfg = json.loads(TRAIN_CONFIG.read_text())
    names = [n for n, spec in cfg["loss"]["A"].items() if spec["function"].startswith("affine_invariant_")]
    shapes = loss_solve_shapes(cfg["loss"]["A"], 2)
    cases = [(n, length, rows, False) for n, (length, rows) in zip(names, shapes)]
    cases += [(n, length, rows, True) for n, (length, rows) in zip(names, shapes) if n == "patch_16"]
    expect = expected_align_launches()
    table, dense_runs = [], 0
    for name, length, rows, per_elem in cases:
        x, y, w = align_problem(gen, rows, length, dev)
        trunc = 0.5 + torch.rand(rows, length, generator=gen, device=dev) if per_elem else 1.0
        with torch.no_grad():
            sign = torch.sign(x)
            xs, ys = x * sign, y * sign
            A, wx, wy = ys / xs.clamp_min(1e-7), w * xs, w * ys
            F = alignment.dense_objective(A, wx, wy, trunc)  # K4's objective at every candidate
            f_min = F.amin(-1)
            cancel = A.abs().amax(-1) * (w * x.abs()).sum(-1)
            row_tol = K4_REL * F.abs().amax(-1)
        row = {"loss": name, "L": length, "rows": rows, "trunc": "per_element" if per_elem else 1.0, "forms": {}}
        for label in ("dense", "events", "prefix"):
            with align_form(label):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                reset_counts()
                a, loss, idx = alignment.align(x, y, w, trunc)
                torch.cuda.synchronize()
                counts = read_counts()
                peak_gib = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
                ms = cuda_ms(lambda: alignment.align(x, y, w, trunc), ALIGN_TIMES, 1)
            if label == "dense":
                if counts != expect:
                    raise AssertionError(f"align_forms {name}: dense launches {counts}, expected {expect}")
                check_variants("align_forms", f"align_forms {name}", counts)
                dense_runs += 1
                a_dense, idx_dense = a, idx
            elif any(counts.values()):
                raise AssertionError(f"align_forms {name}: {label} launched kernels {counts}")
            tol = row_tol + (PREFIX_CANCEL * cancel if label == "prefix" else 0.0)
            picked = F.gather(1, idx[:, None])[:, 0]
            excess = ((picked - f_min) / tol).max().item()  # <= 1: the index attains K4's minimum
            loss_excess = ((loss - picked).abs() / tol).max().item()
            same = idx == idx_dense
            a_ok = torch.equal(a[same], a_dense[same])
            other = int((~same).sum())
            row["forms"][label] = {"ms": ms, "peak_gib": peak_gib, "min_excess": excess, "loss_excess": loss_excess,
                                   "chosen_otherwise": other}
            log(f"[align_forms] {name} L={length} rows={rows} trunc {row['trunc']}: {label} {ms:.3f} ms, peak "
                f"{peak_gib:.3f} GiB, objective at its index within {excess:.3f} of the tolerance of K4's minimum, "
                f"its loss within {loss_excess:.3f}, {other} rows chose another index than dense, a as dense's "
                f"on the rest {a_ok}; {counts['dense_align']} K4 launches, {sum(counts.values())} in all ({card})")
            if not (excess <= 1 and loss_excess <= 1 and a_ok):
                raise AssertionError(f"align_forms {name} {label}: index off K4's minimum by {excess} of the "
                                     f"tolerance, loss by {loss_excess}, a as dense's where the index is {a_ok}")
            del a, loss, idx, picked, same
        del a_dense, idx_dense
        if 3 * length <= ALIGN_BITONIC_MAX and not per_elem:  # the network against torch.sort on the events sort
            with torch.no_grad():
                keys, payloads = events_sort_inputs(x, y, w, trunc)
                want = alignment.sort_stable(keys, payloads)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                got = bitonic.sort_with_payloads(keys, payloads)
                torch.cuda.synchronize()
                peak_gib = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
                equal = all(torch.equal(g, v) for g, v in zip(got, want))
                del got, want
                net_ms = cuda_ms(lambda: bitonic.sort_with_payloads(keys, payloads), BITONIC_TIMES, 0)
                sort_ms = cuda_ms(lambda: alignment.sort_stable(keys, payloads), BITONIC_TIMES, 1)
            row["bitonic"] = {"keys": keys.shape[-1], "ms": net_ms, "sort_stable_ms": sort_ms, "peak_gib": peak_gib}
            log(f"[align_forms] {name} events sort of {rows} rows x {keys.shape[-1]} keys, {len(payloads)} payloads: "
                f"bitonic network {net_ms:.3f} ms, peak {peak_gib:.3f} GiB; sort_stable (torch.sort) {sort_ms:.3f} ms; "
                f"bit for bit {equal} ({card})")
            if not equal:
                raise AssertionError(f"align_forms {name}: the bitonic network's sort differs from torch.sort's")
            del keys, payloads
        table.append(row)
        del x, y, w, trunc, sign, xs, ys, A, wx, wy, F, f_min, cancel, row_tol
        torch.cuda.empty_cache()

    # the v2 grad step under each form, from one state, batch and generator
    label_types = list(cfg["loss"])
    with torch.device(dev):
        module = MoGeV2(**cfg["model"]).init_random(seed=SEED)
    batch = train_batch(np.random.default_rng(SEED + 2), 2, TRAIN_HW, label_types.index("A"), dev)
    grad_step = make_grad_step(module, cfg["loss"], label_types, TRAIN_TOKENS[0], torch.bfloat16)
    expect_step = expected_train_launches(cfg["model"], cfg["loss"])
    steps, step_counts, choices = {}, {}, {}
    recorded, original = [], alignment._align_points_scale_shift

    def record(src, tgt, w, trunc, z_only):  # each scale/shift solve's inputs
        recorded.append((src.detach(), tgt.detach(), w.detach(), trunc, z_only))
        return original(src, tgt, w, trunc, z_only)

    def run_step():
        """One grad step: (ms by the host clock, gradients, metrics)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, metrics = grad_step(batch, torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, grads, metrics

    def grad_norm(grads):
        return torch.sqrt(sum(g.float().square().sum() for g in grads.values())).item()

    for label in ("dense", "events", "prefix"):
        recorded.clear()
        alignment.SOLVES, alignment._align_points_scale_shift = [], record
        try:
            with align_form(label):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_counts()
                first_ms, grads, metrics = run_step()
                counts = read_counts()
            choices[label] = [(inputs, rec[2], rec[3]) for inputs, rec in zip(recorded, alignment.SOLVES)]
        finally:
            alignment.SOLVES, alignment._align_points_scale_shift = None, original
        want = dict(expect_step, dense_align=expect_step["dense_align"] if label == "dense" else 0)
        if counts != want:
            raise AssertionError(f"align_forms {label} grad step launches {counts}, expected {want}")
        if label != "dense":
            check_variants(f"train_{label}", f"{label} grad step", counts)
            step_counts[f"train_{label}"] = (counts, 1)
        steps[label] = {"first_ms": first_ms, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                        "loss": float(metrics["total"]), "grad_norm": grad_norm(grads),
                        **{k: float(metrics[k]) for k in names}}
        del grads, metrics
        repeats, norms = [], []
        with align_form(label):
            for _ in range(ALIGN_STEP_TIMES):
                ms, grads, _ = run_step()
                repeats.append(ms)
                norms.append(grad_norm(grads))
                del grads
        steps[label].update(ms=statistics.median(repeats), repeat_ms=repeats,
                            repeat_grad_norm_rel=max(abs(v - steps[label]["grad_norm"]) for v in norms)
                            / steps[label]["grad_norm"])
        if label != "dense":  # each solve's choice against K4's minimum of its objective
            solves = []
            for (inputs, anchor, idx2), (_, d_anchor, d_idx2) in zip(choices[label], choices["dense"]):
                excess, rows = anchor_solve_excess(inputs, anchor, idx2, label == "prefix")
                other = int(((anchor != d_anchor) | (idx2 != d_idx2)).sum())
                solves.append({"rows": rows, "chosen_otherwise": other, "min_excess": excess})
                if not excess <= 1:
                    raise AssertionError(f"align_forms {label} grad step: a solve of {rows} rows chose off K4's "
                                         f"minimum by {excess} of the tolerance")
            steps[label]["solves"] = solves
            log(f"[align_forms] grad step {label}: per scale/shift solve, rows / chosen otherwise than dense / "
                f"objective at the choice within ... of the tolerance of K4's minimum: "
                + "; ".join(f"{v['rows']} / {v['chosen_otherwise']} / {v['min_excess']:.3f}" for v in solves))
    ref = steps["dense"]
    for label, st in steps.items():
        st["loss_rel"] = abs(st["loss"] - ref["loss"]) / abs(ref["loss"])
        st["grad_norm_rel"] = abs(st["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        log(f"[align_forms] grad step {label}: total {st['loss']:.7f} (relative {st['loss_rel']:.3e}), gradient "
            f"norm {st['grad_norm']:.6e} (relative {st['grad_norm_rel']:.3e}; tol {ALIGN_STEP_RTOL}; its own "
            f"repeats within {st['repeat_grad_norm_rel']:.3e}), " + ", ".join(f"{k} {st[k]:.6f}" for k in names)
            + f"; first call {st['first_ms']:.1f} ms, then median {st['ms']:.1f} ms of "
            + " / ".join(f"{v:.1f}" for v in st["repeat_ms"]) + f", peak {st['peak_gib']:.2f} GiB ({card})")
        if not (st["loss_rel"] <= ALIGN_STEP_RTOL and st["grad_norm_rel"] <= ALIGN_STEP_RTOL):
            raise AssertionError(f"align_forms {label} grad step off the dense one: loss {st['loss_rel']}, "
                                 f"gradient norm {st['grad_norm_rel']} > {ALIGN_STEP_RTOL}")
    del module, batch, grad_step, choices, recorded
    torch.cuda.empty_cache()
    stats = {"solves": table, "grad_steps": steps, "chunk_elems": alignment._SORTED_ELEMS,
             "seconds": time.perf_counter() - t_phase}
    print(json.dumps({"align_forms": stats}), flush=True)
    log(f"[align_forms] phase {stats['seconds']:.1f} s")
    return {"align_forms": (expect, dense_runs), **step_counts}, stats


def phase_probes(card: str):
    """The ported TPU probes against their plain versions on the card (T1 at
    N = 3601 and 1201, T2 both kinds, T3-T6 at the three shapes of
    ``exp_dense_pallas.SHAPES``), then the ``probes`` path: each probe tool's
    measurement at its default shapes, with the counters set to 0 just before
    and read just after. Returns (per-kernel cases, (launch counts, 1 run),
    the tools' rows)."""
    import torch

    from moge_tpu_torch.tools import exp_dense_pallas as dense
    from moge_tpu_torch.tools import exp_flash_softmax as fs
    from moge_tpu_torch.tools import exp_vpu_ceiling as vpu
    from moge_tpu_torch.tools import roofline

    dev = torch.device(DEVICE)
    results = {name: [] for name in PROBE_KERNELS}

    # T1: every variant at the ViT-L token count and at a ragged one (1201 -> 1280 rows), then
    # at 1216 rows (not a multiple of the kernel's 128-key tile) for the errors alone; base at
    # N = 3601 also by device time, beside SDPA's
    for n, n_pad, timed in ((3601, None, True), (1201, None, True), (1201, 1216, False)):
        q, k, v, v_ext, bias = fs.make_inputs(n, dev, n_pad=n_pad)
        n_pad = q.shape[1]
        for variant in fs.VARIANTS:
            vin = v_ext if variant.startswith("mxusum") else v
            got = fs.flash_softmax_variant(variant, q, k, vin, bias, n).float()
            want = fs.flash_softmax_variant_plain(variant, q, k, vin, bias, n).float()
            err = (got - want).abs().max().item()
            tol = fs.REL_TOL[variant] * want.abs().max().item()
            line = f"[T1] {variant} bh=16 N={n} (padded {n_pad}): max_abs_err {err:.3e} (tol {tol:.3e})"
            case = (err, None, None, None, None)
            if timed:
                kernel = functools.partial(fs.flash_softmax_variant, variant, q, k, vin, bias, n)
                plain = functools.partial(fs.flash_softmax_variant_plain, variant, q, k, vin, bias, n)
                bnd = fs.bounds(q.shape[0], n_pad, n, variant, CLOCK_HZ)
                if variant == "base":  # SDPA over the n real keys, unscaled logits as the probe has them
                    kr, vr = k[None, :, :n].contiguous(), v[None, :, :n].contiguous()
                    library = functools.partial(torch.nn.functional.scaled_dot_product_attention, q[None], kr, vr,
                                                scale=1.0)
                if variant == "base" and n == 3601:
                    ms, plain_ms, lib_ms, dev_ms = call_times(kernel, plain, library, plain_iters=3)
                    line += f", {conv_times_text(ms, plain_ms, lib_ms, dev_ms, 'SDPA')}"
                    case = (err, ms, plain_ms, lib_ms, bnd, dev_ms)
                else:
                    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, 3, 1)
                    lib_ms = cuda_ms(library) if variant == "base" else None
                    line += (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                             f"{'' if lib_ms is None else f', SDPA {lib_ms:.4f} ms'}")
                    case = (err, ms, plain_ms, lib_ms, bnd)
                line += f", bound {bnd[0]:.4f} ms ({bnd[1]})"
            log(line)
            if variant == "noexp" and (got.any() or want.any()):
                raise AssertionError(f"T1 noexp at N={n}: the output is not exactly 0")
            if not err <= tol:
                raise AssertionError(f"T1 {variant} disagrees at N={n} (padded {n_pad}): {err} > {tol}")
            results["exp_flash_softmax"].append(case)
        del q, k, v, v_ext, bias, got, want
        torch.cuda.empty_cache()

    # T2: the full 256 x 512 x 2000 loop; time per launch from 200 back-to-back launches
    x, y = vpu.inputs(dev)
    for kind, per in vpu.INSTRUCTIONS.items():
        got = vpu.vpu_ceiling(x, y, kind)
        want = vpu.vpu_ceiling_plain(x, y, kind)
        err = (got - want).abs().max().item()
        tol = vpu.REL_TOL * want.abs().max().item()
        ms = roofline.min_ms(lambda: vpu.vpu_ceiling(x, y, kind, launches=200), dev) / 200
        plain_ms = cuda_ms(lambda: vpu.vpu_ceiling_plain(x, y, kind), 2, 1)
        elems = x.numel() * vpu.ITERS
        bnd = bound(bytes_moved=3 * x.numel() * 4, fp32_instr=per * elems)
        log(f"[T2] {kind} 256x512 x {vpu.ITERS}: max_abs_err {err:.3e} (tol {tol:.3e}), kernel {ms:.4f} ms "
            f"({elems / ms / 1e9:.3f} Telem/s), plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        if not err <= tol:
            raise AssertionError(f"T2 {kind} disagrees: {err} > {tol}")
        results["exp_vpu_ceiling"].append((err, ms, plain_ms, None, bnd))

    # T3-T6 at the shapes the probes path gives them: the global and local loss's solves
    for shape, (R, L) in dense.SHAPES.items():
        _, _, _, A, wx, wy = dense.make_problem(R, L, dev)
        wants = {plain: plain(A, wx, wy, 1.0) for plain in set(dense.PLAINS.values())}
        for variant, fn in dense.FUNCTIONS.items():
            plain = dense.PLAINS[variant]
            got, want = fn(A, wx, wy, 1.0), wants[plain]
            err = (got - want).abs().max().item()
            tol = dense.REL_TOL * want.abs().max().item()
            ms = cuda_ms(lambda: fn(A, wx, wy, 1.0), 5)
            plain_ms = cuda_ms(lambda: plain(A, wx, wy, 1.0), 2, 1)
            bnd = dense.pairs_bound(R, L, variant, CLOCK_HZ)
            line = (f"[T3-T6] {variant} {shape} R={R} L={L}: max_abs_err {err:.3e} (tol {tol:.3e}), kernel "
                    f"{ms:.4f} ms ({R * L * L / ms / 1e9:.3f} Tpair/s), plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
                    f"({bnd[1]})")
            case = (err, ms, plain_ms, None, bnd)
            if variant == "bf16":  # T6 also by device time
                dev_ms = roofline.device_ms(lambda: fn(A, wx, wy, 1.0))
                line += f", device {dev_ms:.4f} ms ({bnd[0] / dev_ms:.1%} of the bound)"
                case += ({"device_ms": dev_ms},)
            log(line)
            if not err <= tol:
                raise AssertionError(f"dense_objective_{variant} disagrees at {shape}: {err} > {tol}")
            results[f"exp_dense_{variant}"].append(case)
        del A, wx, wy, wants, got, want
        torch.cuda.empty_cache()

    # the probes path: the three tools' measurements at their default shapes
    reset_counts()
    tables = {"exp_flash_softmax": fs.measure(dev, clock_hz=CLOCK_HZ),
              "exp_vpu_ceiling": vpu.measure(dev, clock_hz=CLOCK_HZ),
              "exp_dense_pallas": dense.measure(dev, clock_hz=CLOCK_HZ)}
    torch.cuda.synchronize()
    counts = read_counts()
    check_variants("probes", "probes", counts)
    t1 = tables["exp_flash_softmax"]
    for r in t1["rows"]:
        diff = "" if r["max_diff_vs_base"] is None else f", max|diff vs base| {r['max_diff_vs_base']:.3e}"
        log(f"[probes] exp_flash_softmax {r['variant']}: {r['ms']:.4f} ms per layer (N={t1['n']}, depth "
            f"{t1['depth']}, least of {t1['reps']}), bound {r['bound_ms']:.4f} ms{diff} ({card})")
    for r in tables["exp_vpu_ceiling"]:
        log(f"[probes] exp_vpu_ceiling {r['kind']}: {r['ms']:.4f} ms per launch, {r['telem_per_s']:.3f} Telem/s, "
            f"{r['tinstr_per_s']:.2f} T FP32 instr/s ({r['instructions_per']} per elem-iter), bound "
            f"{r['bound_ms']:.4f} ms ({card})")
    for r in tables["exp_dense_pallas"]:
        log(f"[probes] exp_dense_pallas {r['shape']} R={r['R']} L={r['L']} {r['what']}: {r['ms']:.4f} ms, "
            f"{r['tpair_per_s']:.3f} Tpair/s, bound {r['bound_ms']:.4f} ms ({card})")
    log(f"[probes] launches {counts}")
    idle = [name for name in PROBE_KERNELS + ("dense_align",) if counts[name] == 0]
    if idle:
        raise AssertionError(f"probes path: kernels {idle} were never launched")
    return results, (counts, 1), tables


def loss_solve_shapes(loss_table, batch: int):
    """(candidate length L, rows R) of each truncated solve of a label type's
    loss table: the global loss solves batch x align_resolution^2 anchors, a
    local loss batch x num_patches x align_resolution^2; L = 3 x align_resolution^2."""
    shapes = []
    for spec in loss_table.values():
        p = spec.get("params", {})
        if spec["function"] == "affine_invariant_global_loss":
            n = p.get("align_resolution", 64) ** 2
            shapes.append((3 * n, batch * n))
        elif spec["function"] == "affine_invariant_local_loss":
            n = p.get("align_resolution", 32) ** 2
            shapes.append((3 * n, batch * p.get("num_patches", 16) * n))
    return shapes


def _vit_launches(backbone: str, layers) -> dict:
    """K1 and K2 launches of one ViT forward: two LayerNorms and one
    attention per block, the final norm once per taken layer."""
    from moge_tpu_torch.models.dinov2 import VIT_ARCHS

    depth = VIT_ARCHS[backbone].depth
    n_take = layers if isinstance(layers, int) else len(layers)
    return {"layer_norm": 2 * depth + n_take, "flash_attention": depth, "flash_attention_dq": 0,
            "flash_attention_dkv": 0, "conv3x3": 0, "conv3x3_grouped": 0, "dense_align": 0, "camera_solve": 0,
            **dict.fromkeys(PROBE_KERNELS, 0)}


def expected_launches(config, batched_heads: bool = False) -> dict:
    """Kernel launches per inference forward implied by a MoGe-2 config: per
    ConvStack two 3x3 convs per res block and one per resampler; with
    batched heads the heads' convs run once each as K3-grouped; one camera
    solve (K5) in the post-processing, for the whole batch."""
    from moge_tpu_torch.models.multihead import heads_batchable

    counts = _vit_launches(config["encoder"]["backbone"], config["encoder"]["intermediate_layers"])
    heads = [config[name] for name in ("points_head", "normal_head", "mask_head") if config.get(name) is not None]

    def convs(stack):
        return 2 * sum(stack["num_res_blocks"]) + len(stack["dim_res_blocks"]) - 1

    counts["conv3x3"] = convs(config["neck"])
    if batched_heads and heads_batchable(heads):
        counts["conv3x3_grouped"] = convs(heads[0])
    else:
        counts["conv3x3"] += sum(convs(h) for h in heads)
    counts["camera_solve"] = 1
    return counts


def expected_v1_launches(config) -> dict:
    """Kernel launches per MoGe-1 forward: per upsample stage one 3x3 conv
    and two per res block; per output block (points, mask) the 3x3 conv_in,
    two per res block, and conv_out when it is 3x3; one camera solve (K5)."""
    counts = _vit_launches(config["encoder"], config.get("intermediate_layers", 4))
    stages = len(config.get("dim_upsample", [256, 128, 128])) * (1 + 2 * config.get("num_res_blocks", 1))
    outputs = 2 * (1 + 2 * config.get("last_res_blocks", 0) + (config.get("last_conv_size", 1) == 3))
    counts.update(conv3x3=stages + outputs, camera_solve=1)
    return counts


def expected_train_launches(config, loss_config, version: str = "v2", remat: bool = False) -> dict:
    """Kernel launches per train step implied by a MoGe-2 (or, ``version``
    'v1', MoGe-1) config and a loss config: one forward (K1, K2, K3; no
    camera solve), the flash backward per block (K2b-dq, K2b-dkv; K1 and K3 backward in plain
    PyTorch), and one K4 per truncated alignment solve: the global loss's,
    and the local losses' (one batched solve when they share trunc and
    align_resolution, else one each). With ``remat`` the backward runs the
    checkpointed modules' forwards again: each ViT block's two K1 and one K2
    (the final norm is outside), and for MoGe-2 every K3 of the neck and the
    heads (each in a residual block or a resampler); MoGe-1 checkpoints its
    backbone only."""
    from moge_tpu_torch.models.dinov2 import VIT_ARCHS

    if version == "v1":
        counts = expected_v1_launches(config)
        depth = VIT_ARCHS[config["encoder"]].depth
    else:
        counts = expected_launches(config)
        depth = VIT_ARCHS[config["encoder"]["backbone"]].depth
    entries = {name: spec for table in loss_config.values() for name, spec in table.items()}
    local = [spec.get("params", {}) for spec in entries.values() if spec["function"] == "affine_invariant_local_loss"]
    shared = len(local) >= 2 and len({(p.get("trunc", 1.0), p.get("align_resolution", 32)) for p in local}) == 1
    n_global = sum(spec["function"] == "affine_invariant_global_loss" for spec in entries.values())
    counts.update(flash_attention_dq=depth, flash_attention_dkv=depth, camera_solve=0,
                  dense_align=n_global + (1 if shared else len(local)))
    if remat:
        counts["layer_norm"] += 2 * depth
        counts["flash_attention"] += depth
        if version == "v2":
            counts["conv3x3"] *= 2
    return counts


def reset_counts():
    from moge_tpu_torch.ops import _build

    _build.reset_launches()


def read_variants(*kernels: str) -> dict:
    """Launches since the last reset by variant, summed over ``kernels``."""
    from moge_tpu_torch.ops import _build

    read = _build.read_launches()
    variants = {}
    for kernel in kernels:  # a kernel whose module is not imported has launched nothing
        for variant, n in read.get(kernel, {}).items():
            variants[variant] = variants.get(variant, 0) + n
    return variants


def launches_of(kernel: str) -> int:
    """Launches of ``kernel`` since the last reset."""
    return sum(read_variants(kernel).values())


def read_counts() -> dict:
    """Launches per kernel since the last reset, the probes' included."""
    from moge_tpu_torch.tools import exp_dense_pallas, exp_flash_softmax, exp_vpu_ceiling  # noqa: F401 (their kernels)

    return {kernel: launches_of(kernel) for kernel in COUNTED}


def phase_slice(card: str):
    """moge-2-vitl-normal at full width, random weights, bf16, four requests."""
    import math

    import numpy as np
    import torch

    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel

    config = get_preset("moge-2-vitl-normal")["config"]
    expect = expected_launches(config)
    t0 = time.perf_counter()
    model = MoGeModel(config, device=DEVICE, dtype=torch.bfloat16, batched_heads=False).init_random(seed=SEED)
    torch.cuda.synchronize()
    log(f"[slice] moge-2-vitl-normal init_random(seed={SEED}) on {DEVICE} in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(SEED)
    requests = [("518x518 num_tokens=1369", (518, 518), dict(num_tokens=1369)),
                ("518x518 resolution_level=9", (518, 518), dict()),
                ("480x960", (480, 960), dict()),
                ("960x480 fov_x=60", (960, 480), dict(fov_x=60.0))]
    counts_seen = []
    latencies = {}
    for label, (h, w), kwargs in requests:
        image = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(np.float32)).to(DEVICE)
        reset_counts()
        out = model.infer(image, **kwargs)
        torch.cuda.synchronize()
        counts = read_counts()
        counts_seen.append(counts)
        if counts != expect:
            raise AssertionError(f"{label}: kernel launches {counts}, expected {expect} per forward")
        variants = check_variants("infer", label, counts)
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        want = {"points": (h, w, 3), "depth": (h, w), "intrinsics": (3, 3), "mask": (h, w), "normal": (h, w, 3)}
        if shapes != want:
            raise AssertionError(f"{label}: output shapes {shapes}, expected {want}")
        if out["mask"].dtype != torch.bool:
            raise AssertionError(f"{label}: mask dtype {out['mask'].dtype}")
        if not torch.isfinite(out["intrinsics"]).all():
            raise AssertionError(f"{label}: intrinsics not finite: {out['intrinsics']}")
        mask = out["mask"]
        if not torch.isfinite(out["depth"][mask]).all() or not torch.isfinite(out["points"][mask]).all():
            raise AssertionError(f"{label}: non-finite depth or points inside the mask")
        if "fov_x" in kwargs:
            fx = out["intrinsics"][0, 0].item()
            want_fx = 0.5 / math.tan(math.radians(kwargs["fov_x"]) / 2)
            if abs(fx - want_fx) > 1e-5 * want_fx:
                raise AssertionError(f"{label}: fx {fx} does not follow fov_x (want {want_fx})")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.infer(image, **kwargs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        latencies[label] = statistics.median(times)
        log(f"[slice] {label}: mask {mask.float().mean().item():.3f} of pixels, "
            f"fx {out['intrinsics'][0, 0].item():.4f}, launches {counts}, variants {variants}, "
            f"warm median {latencies[label]:.2f} ms ({card})")
    return model, (counts_seen[0], len(counts_seen)), latencies


def phase_parity():
    """moge-2-vits-normal decode: card bf16 (kernels) vs CPU fp32 (plain versions)."""
    import numpy as np
    import torch

    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel
    from moge_tpu_torch.ops.resize import resize_2d

    config = get_preset("moge-2-vits-normal")["config"]
    gpu = MoGeModel(config, device=DEVICE, dtype=torch.bfloat16).init_random(seed=SEED)
    cpu = MoGeModel(config, device="cpu", dtype=torch.float32)
    cpu.module.load_state_dict({k: v.cpu() for k, v in gpu.module.state_dict().items()}, strict=True)
    image = torch.from_numpy(np.random.default_rng(SEED + 1).uniform(0, 1, (1, 518, 518, 3)).astype(np.float32))
    image_14 = resize_2d(image, (37 * 14, 37 * 14), mode="bilinear", antialias=True)
    with torch.inference_mode():
        got = gpu.module.decode(image_14.to(DEVICE), 37, 37, 1.0, torch.bfloat16)
        want = cpu.module.decode(image_14, 37, 37, 1.0, torch.float32)
    for key in sorted(want):
        a, b = got[key].float().cpu(), want[key]
        rel = ((a - b).norm() / b.norm()).item()
        log(f"[parity] moge-2-vits-normal {key}: relative L2 {rel:.3e} (tol {MODEL_L2_RTOL})")
        if not rel <= MODEL_L2_RTOL:
            raise AssertionError(f"{key}: bf16-on-card vs fp32-on-CPU relative L2 {rel} > {MODEL_L2_RTOL}")


EXPORT_HW = 518
EXPORT_TOKENS = 1369
EXPORT_L2_RTOL = 1e-3       # points, depth, normal: artifact vs live infer, relative L2 where both masks hold
EXPORT_INTRINSICS_TOL = 1e-4
EXPORT_MASK_AGREE = 0.999
EXPORT_TURNS = 5            # warm calls of the artifact and of live infer, in alternating turns


def phase_export(card: str, model):
    """Export (``models/export.py``): ``model`` (moge-2-vitl-normal bf16,
    sequential heads, a point map of known perspective) as the whole
    ``infer`` program, camera solve inside (``with_postprocess``), saved to
    bytes and loaded back; its outputs on one image against live ``infer``
    (points, depth and normal within EXPORT_L2_RTOL relative L2 where both
    masks hold, intrinsics within EXPORT_INTRINSICS_TOL, masks agreeing on
    EXPORT_MASK_AGREE of the pixels; the largest elementwise difference and
    whether the bits are equal, logged), its launches per run (counted under
    ``export``, each on its Hopper variant, one K5 for the solve); then the
    raw bf16 forward's artifact against ``MoGeV2.forward`` at MODEL_L2_RTOL,
    counted the same way under ``export_raw`` (no solve); export seconds, artifact MB and the artifact's warm latency against
    live ``infer`` in alternating turns."""
    import numpy as np
    import torch

    from moge_tpu_torch.models.export import export_program, load_program
    from moge_tpu_torch.models.presets import get_preset
    from torch_tiny_config import make_points_perspective

    t_phase = time.perf_counter()
    per_infer = expected_launches(get_preset("moge-2-vitl-normal")["config"])
    expect = {"export": per_infer, "export_raw": dict(per_infer, camera_solve=0)}
    make_points_perspective(model.module)
    image = torch.from_numpy(np.random.default_rng(SEED + 9).uniform(0, 1, (1, EXPORT_HW, EXPORT_HW, 3))
                             .astype(np.float32)).to(DEVICE)
    stats = {}

    def counted(path, label, program):
        reset_counts()
        out = program(image)
        synchronize()
        counts = read_counts()
        if counts != expect[path]:
            raise AssertionError(f"[export] {label}: launches {counts}, expected {expect[path]} per run")
        check_variants(path, label, counts)
        return out

    for form, post, path in (("infer", True, "export"), ("raw", False, "export_raw")):
        t0 = time.perf_counter()
        blob = export_program(model, EXPORT_HW, EXPORT_HW, EXPORT_TOKENS, with_postprocess=post,
                              use_fp16=None if post else True)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = load_program(blob)
        program(image)  # warm-up
        synchronize()
        load_s = time.perf_counter() - t0
        got = counted(path, f"{form} artifact", program)
        if post:
            want = model.infer(image, num_tokens=EXPORT_TOKENS)
            both = got["mask"] & want["mask"]
            errs = {"mask_agree": (got["mask"] == want["mask"]).float().mean().item()}
            for key in ("points", "depth", "normal"):
                a, b = got[key][both].float(), want[key][both].float()
                errs[key] = ((a - b).norm() / b.norm()).item()
            errs["intrinsics"] = (got["intrinsics"] - want["intrinsics"]).abs().max().item()
            ok = (errs["mask_agree"] >= EXPORT_MASK_AGREE and errs["intrinsics"] <= EXPORT_INTRINSICS_TOL
                  and all(errs[k] <= EXPORT_L2_RTOL for k in ("points", "depth", "normal")) and both.any())
        else:
            with torch.no_grad():
                want = model.module(image, EXPORT_TOKENS, torch.bfloat16)
            errs = {key: ((got[key].float() - want[key].float()).norm() / want[key].float().norm()).item()
                    for key in want}
            ok = all(e <= MODEL_L2_RTOL for e in errs.values())
        if set(got) != set(want):
            raise AssertionError(f"[export] {form}: keys {sorted(got)}, expected {sorted(want)}")
        finite = {k: torch.isfinite(v) for k, v in want.items() if v.is_floating_point()}
        largest = max(((got[k] - want[k])[f].abs().max().item() if f.any() else 0.0) for k, f in finite.items())
        identical = all(torch.equal(got[k], want[k]) for k in want)
        log(f"[export] {form} artifact: export {export_s:.1f} s, {len(blob) / 1e6:.1f} MB, load + warm-up "
            f"{load_s:.1f} s; against live {'infer' if post else 'MoGeV2.forward'}: {errs}, largest elementwise "
            f"difference {largest:.3e}, bit-identical {identical}; launches per run {expect[path]} ({card})")
        if not ok:
            raise AssertionError(f"[export] {form} artifact off live: {errs}")
        stats[form] = {"export_s": export_s, "mb": len(blob) / 1e6, "load_s": load_s, "errs": errs,
                       "largest_abs_diff": largest, "bit_identical": identical}
        if post:
            times = {"artifact": [], "live": []}
            for _ in range(EXPORT_TURNS):
                times["artifact"].append(wall_ms(lambda: program(image), 1))
                times["live"].append(wall_ms(lambda: model.infer(image, num_tokens=EXPORT_TOKENS), 1))
            stats[form].update({f"{k}_ms": statistics.median(v) for k, v in times.items()},
                               turns_ms=times)
            log(f"[export] warm latency in {EXPORT_TURNS} alternating turns: artifact "
                f"{stats[form]['artifact_ms']:.2f} ms, live infer {stats[form]['live_ms']:.2f} ms "
                f"(medians; {times}) ({card})")
        del program, blob
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"[export] phase {stats['seconds']:.1f} s")
    return {path: (counts, 1) for path, counts in expect.items()}, stats


def synchronize():
    """Wait for DEVICE's work (nothing when DEVICE is the CPU, as in a rehearsal)."""
    import torch

    if DEVICE.startswith("cuda"):
        torch.cuda.synchronize()


def wall_ms(fn, repeats: int) -> float:
    """Median host-clock time of ``fn`` in ms, each call ended by a synchronize."""
    times = []
    for _ in range(repeats):
        synchronize()
        t0 = time.perf_counter()
        fn()
        synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def compare_answers(label: str, got, want) -> dict:
    """One image's answer against a reference answer for it: the masks agree
    on at least MASK_AGREE of the pixels; depth, points and normal within
    MODEL_L2_RTOL (relative L2) where both masks hold; intrinsics within
    INTRINSICS_RTOL of their largest entry."""
    import torch

    got = {k: torch.as_tensor(v).float().cpu() for k, v in got.items()}
    want = {k: torch.as_tensor(v).float().cpu() for k, v in want.items()}
    if set(got) != set(want):
        raise AssertionError(f"{label}: keys {sorted(got)}, expected {sorted(want)}")
    m_got, m_want = got["mask"] > 0.5, want["mask"] > 0.5
    both = m_got & m_want
    errs = {"mask_agree": (m_got == m_want).float().mean().item()}
    if not errs["mask_agree"] >= MASK_AGREE or not both.any():
        raise AssertionError(f"{label}: masks agree on {errs['mask_agree']:.5f} of the pixels (least {MASK_AGREE})")
    for key in ("depth", "points", "normal"):
        a, b = got[key][both], want[key][both]
        errs[key] = ((a - b).norm() / b.norm()).item()
        if not errs[key] <= MODEL_L2_RTOL:
            raise AssertionError(f"{label}: {key} relative L2 {errs[key]} > {MODEL_L2_RTOL}")
    k_got, k_want = got["intrinsics"], want["intrinsics"]
    errs["intrinsics"] = ((k_got - k_want).abs().max() / k_want.abs().max()).item()
    if not errs["intrinsics"] <= INTRINSICS_RTOL:
        raise AssertionError(f"{label}: intrinsics {k_got.tolist()} vs {k_want.tolist()}")
    return errs


def worst(errs) -> str:
    keys = errs[0].keys()
    agg = {k: (min if k == "mask_agree" else max)(e[k] for e in errs) for k in keys}
    return ", ".join(f"{k} {v:.3e}" for k, v in agg.items())


def phase_batched(card: str, seq):
    """Batched heads: moge-2-vitl-normal bf16 with ``batched_heads=True``
    against the sequential heads of ``seq`` (the same weights), 518x518 at
    1369 and 3600 tokens, batch 1 and 8; launch counters per forward, warm
    medians of both. Both models first get a point map of known perspective
    (``make_points_perspective``), so that answers after the focal/shift
    solve compare what they mean to."""
    import numpy as np
    import torch

    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel
    from torch_tiny_config import make_points_perspective

    config = get_preset("moge-2-vitl-normal")["config"]
    make_points_perspective(seq.module)
    bat = MoGeModel(config, device=DEVICE, dtype=torch.bfloat16, batched_heads=True)
    bat.module.load_state_dict(seq.module.state_dict(), strict=True)
    if not bat.module.batched_heads or seq.module.batched_heads:
        raise AssertionError("moge-2-vitl-normal: heads not batchable, or the sequential model batches them")
    expect = {False: expected_launches(config), True: expected_launches(config, batched_heads=True)}
    rng = np.random.default_rng(SEED + 4)
    timings = {}
    for num_tokens in BATCHED_TOKENS:
        for batch in BATCHED_SIZES:
            label = f"{SERVE_HW}x{SERVE_HW} num_tokens={num_tokens} batch={batch}"
            images = torch.from_numpy(rng.uniform(0, 1, (batch, SERVE_HW, SERVE_HW, 3)).astype(np.float32))
            images = images.to(DEVICE)
            outs, ms = {}, {}
            for batched, model in ((False, seq), (True, bat)):
                reset_counts()
                outs[batched] = model.infer(images, num_tokens=num_tokens)
                torch.cuda.synchronize()
                counts = read_counts()
                if counts != expect[batched]:
                    raise AssertionError(f"{label} batched={batched}: launches {counts}, expected {expect[batched]}")
                check_variants("batched_heads", f"{label} batched={batched}", counts)
                ms[batched] = wall_ms(lambda: model.infer(images, num_tokens=num_tokens), 3)
            errs = [compare_answers(f"{label} image {i}", {k: v[i] for k, v in outs[True].items()},
                                    {k: v[i] for k, v in outs[False].items()}) for i in range(batch)]
            timings[label] = {"sequential_ms": ms[False], "batched_ms": ms[True]}
            log(f"[batched] {label}: batched vs sequential worst {worst(errs)}; launches per forward "
                f"{expect[True]}; warm median sequential {ms[False]:.2f} ms, batched {ms[True]:.2f} ms ({card})")
    return bat, (expect[True], len(BATCHED_TOKENS) * len(BATCHED_SIZES)), timings


def phase_serve(card: str, model, per_forward: dict, path: str = "serve", products: int = 0):
    """The micro-batcher over ``model``: warmup, then SERVE_REQUESTS
    requests from SERVE_CLIENTS client threads (half with fov_x=60), every
    one answered and each answer within tolerance of its image's own
    batch-1 ``infer``; the mean batch must exceed 1; every batch launches
    ``per_forward`` (on the Hopper variants, recorded under ``path``) and
    ``products`` int8 products (kernel ``int8_product`` in the registry)."""
    import threading

    import numpy as np
    import torch

    from moge_tpu_torch.scripts.serve import VALID_MAPS, InferenceBatcher

    rng = np.random.default_rng(SEED + 5)
    images = [rng.uniform(0, 1, (SERVE_HW, SERVE_HW, 3)).astype(np.float32) for _ in range(SERVE_REQUESTS)]
    fovs = [60.0 if i % 2 else None for i in range(SERVE_REQUESTS)]
    answers, latencies, failures = [None] * SERVE_REQUESTS, [None] * SERVE_REQUESTS, []

    def client(c):
        for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
            t0 = time.perf_counter()
            try:
                answers[i] = batcher.infer(images[i], fovs[i], VALID_MAPS)
            except Exception as e:  # reported below; the phase fails
                failures.append(f"request {i}: {type(e).__name__}: {e}")
            latencies[i] = (time.perf_counter() - t0) * 1e3

    batcher = InferenceBatcher(model, SERVE_HW, SERVE_HW, SERVE_TOKENS, max_batch=8, max_wait_ms=5.0)
    try:
        t0 = time.perf_counter()
        batcher.warmup()
        warmup_s = time.perf_counter() - t0
        stats0 = dict(batcher.stats)
        reset_counts()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts, products_run = read_counts(), launches_of("int8_product")
    finally:
        batcher.stop()
    if failures or any(a is None for a in answers):
        raise AssertionError(f"{path}: {sum(a is None for a in answers)} requests unanswered: {failures[:3]}")
    batches = batcher.stats["batches"] - stats0["batches"]
    mean_batch = (batcher.stats["batched_images"] - stats0["batched_images"]) / batches
    if not mean_batch > 1:
        raise AssertionError(f"{path}: mean batch {mean_batch}, expected more than 1")
    want_counts = {k: v * batches for k, v in per_forward.items()}
    if counts != want_counts or products_run != products * batches:
        raise AssertionError(f"{path}: launches {counts} and {products_run} int8 products over {batches} batches, "
                             f"expected {want_counts} and {products * batches}")
    check_variants(path, f"{path} serving", counts, runs=batches)
    errs = []
    for i, (image, fov) in enumerate(zip(images, fovs)):
        want = model.infer(torch.from_numpy(image), num_tokens=SERVE_TOKENS, fov_x=fov)
        errs.append(compare_answers(f"{path} request {i}", answers[i], want))
    p50, p90 = np.percentile(latencies, [50, 90]).tolist()
    stats = {"requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS, "requests_per_s": SERVE_REQUESTS / wall_s,
             "mean_batch": mean_batch, "batches": batches, "p50_ms": p50, "p90_ms": p90, "warmup_s": warmup_s}
    log(f"[{path}] served {SERVE_REQUESTS} requests from {SERVE_CLIENTS} clients at {SERVE_HW}x{SERVE_HW}, "
        f"{SERVE_TOKENS} tokens: {stats['requests_per_s']:.2f} requests/s, {batches} batches, mean batch "
        f"{mean_batch:.2f}, latency p50 {p50:.1f} ms p90 {p90:.1f} ms, warmup {warmup_s:.1f} s ({card}); "
        f"against batch-1 infer worst {worst(errs)}; launches {counts}, {products_run} int8 products")
    return (per_forward, batches), stats


def check_moge1_answer(model, image, out, label: str, kwargs: dict) -> float:
    """The MoGe-1 gates of one ``infer`` of ``model`` (a ``models.v1.MoGeModel``
    whose head ``make_points_perspective_v1`` set, focal MOGE1_FOCAL) on
    ``image`` (h, w, 3) with ``kwargs``: output shapes and types, the whole
    image in the mask, finite intrinsics and depth, not the solve's
    degenerate fallback, the injected focal and depth (without fov_x) or the
    given fov_x, and the card's solve against a CPU solve of the card's raw
    points. Returns fx."""
    import math

    import torch

    from moge_tpu_torch.ops.solvers import recover_focal_shift
    from torch_tiny_config import perspective_v1_answer

    h, w = image.shape[:2]
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    want = {"points": (h, w, 3), "depth": (h, w), "intrinsics": (3, 3), "mask": (h, w)}
    if shapes != want or out["mask"].dtype != torch.bool:
        raise AssertionError(f"{label}: output shapes {shapes} (mask {out['mask'].dtype}), expected {want}")
    mask = out["mask"]
    if not mask.all():
        raise AssertionError(f"{label}: mask holds {mask.float().mean().item():.4f} of the pixels, "
                             "expected all of them (the mask head outputs 1)")
    if not torch.isfinite(out["intrinsics"]).all() or not torch.isfinite(out["depth"]).all():
        raise AssertionError(f"{label}: non-finite intrinsics or depth")
    fx = out["intrinsics"][0, 0].item()
    aspect = w / h
    fallback_fx = 0.5 * (1 + aspect ** 2) ** 0.5 / aspect  # the solve's degenerate answer, focal 1
    if abs(fx - fallback_fx) <= 1e-6 * fallback_fx:
        raise AssertionError(f"{label}: fx {fx} is the solve's degenerate fallback")

    # the card's solve against the same solve on the CPU from the card's raw points
    with torch.inference_mode():
        raw = model.module(image[None], model.module.num_tokens_range[1], torch.bfloat16)
    raw_points = raw["points"][0].cpu()
    raw_mask = (raw["mask"][0] > model.module.mask_threshold).cpu()
    if "fov_x" in kwargs:
        want_fx = 0.5 / math.tan(math.radians(kwargs["fov_x"]) / 2)
        if abs(fx - want_fx) > 1e-5 * want_fx:
            raise AssertionError(f"{label}: fx {fx} does not follow fov_x (want {want_fx})")
        focal = torch.tensor(want_fx * 2 * aspect / (1 + aspect ** 2) ** 0.5)
        _, cpu_shift = recover_focal_shift(raw_points[None], raw_mask[None], focal=focal[None])
        cpu_fx = want_fx
    else:
        cpu_focal, cpu_shift = recover_focal_shift(raw_points[None], raw_mask[None])
        cpu_fx = cpu_focal.item() / 2 * (1 + aspect ** 2) ** 0.5 / aspect
        true_fx, _, true_depth = perspective_v1_answer(h, w, focal=MOGE1_FOCAL)
        focal_err = abs(fx - true_fx) / true_fx
        inner = (slice(2, -2), slice(2, -2))  # the resize to the image clamps at its border
        depth_err = ((out["depth"].cpu()[inner] - true_depth[inner]).norm() / true_depth[inner].norm()).item()
        log(f"[moge1] {label}: injected focal {MOGE1_FOCAL}: fx {fx:.5f} vs {true_fx:.5f} (rel "
            f"{focal_err:.3e}, tol {MOGE1_FOCAL_RTOL}), depth rel L2 {depth_err:.3e} (tol {MOGE1_DEPTH_RTOL})")
        if not (focal_err <= MOGE1_FOCAL_RTOL and depth_err <= MOGE1_DEPTH_RTOL):
            raise AssertionError(f"{label}: the solve missed the injected perspective")
    cpu_depth = raw_points[..., 2] + cpu_shift[0]
    solve_fx = abs(fx - cpu_fx) / cpu_fx
    solve_depth = ((out["depth"].cpu() - cpu_depth).norm() / cpu_depth.norm()).item()
    log(f"[moge1] {label}: card vs CPU solve of the same raw points: fx rel {solve_fx:.3e}, "
        f"depth rel L2 {solve_depth:.3e} (tol {MOGE1_SOLVE_RTOL}), shift card/CPU "
        f"{(out['depth'].cpu() - raw_points[..., 2]).mean().item():.3e}/{cpu_shift.item():.3e}")
    if not (solve_fx <= MOGE1_SOLVE_RTOL and solve_depth <= MOGE1_SOLVE_RTOL):
        raise AssertionError(f"{label}: the card's solve disagrees with the CPU's")
    return fx


def phase_moge1(card: str):
    """moge-vitl (MoGe-1 ViT-L) at full width, random weights, bf16: three
    ``infer`` requests (one with fov_x, one non-square), launch counters per
    forward. The points head first gets a point map of known perspective
    (``make_points_perspective_v1``: focal 1.5, shift 0, depth exp(0.3 +
    0.5 u)) and the mask head a constant 1, so that the focal/shift solve has
    one answer: each request must keep the whole image in the mask, miss the
    solve's degenerate fallback (focal 1), match the injected focal and depth
    (MOGE1_FOCAL_RTOL, MOGE1_DEPTH_RTOL) and a CPU solve of the card's own raw
    points (MOGE1_SOLVE_RTOL). Then a ViT-S MoGe-1 with the same head, bf16 on
    the card against fp32 on the CPU (``check_moge1_answer``)."""
    import numpy as np
    import torch

    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v1 import MoGeModel
    from torch_tiny_config import make_points_perspective_v1

    config = get_preset("moge-vitl")["config"]
    expect = expected_v1_launches(config)
    model = MoGeModel(config, device=DEVICE, dtype=torch.bfloat16).init_random(seed=SEED)
    make_points_perspective_v1(model.module, focal=MOGE1_FOCAL)
    rng = np.random.default_rng(SEED + 6)
    latencies, counts_seen = {}, []
    for label, (h, w), kwargs in (("518x518", (518, 518), {}), ("518x518 fov_x=60", (518, 518), {"fov_x": 60.0}),
                                  ("480x640", (480, 640), {})):
        image = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(np.float32)).to(DEVICE)
        reset_counts()
        out = model.infer(image, **kwargs)
        torch.cuda.synchronize()
        counts = read_counts()
        counts_seen.append(counts)
        if counts != expect:
            raise AssertionError(f"moge-vitl {label}: kernel launches {counts}, expected {expect} per forward")
        check_variants("moge1_infer", f"moge-vitl {label}", counts)
        fx = check_moge1_answer(model, image, out, f"moge-vitl {label}", kwargs)
        mask = out["mask"]
        latencies[label] = wall_ms(lambda: model.infer(image, **kwargs), 3)
        log(f"[moge1] moge-vitl {label}: mask {mask.float().mean().item():.3f} of pixels, "
            f"fx {fx:.4f}, launches {counts}, warm median {latencies[label]:.2f} ms ({card})")
    del model

    small = dict(config, encoder="dinov2_vits14")
    gpu = MoGeModel(small, device=DEVICE, dtype=torch.bfloat16).init_random(seed=SEED)
    cpu = MoGeModel(small, device="cpu", dtype=torch.float32)
    cpu.module.load_state_dict({k: v.cpu() for k, v in gpu.module.state_dict().items()}, strict=True)
    image = torch.from_numpy(rng.uniform(0, 1, (1, 392, 392, 3)).astype(np.float32))
    with torch.inference_mode():
        got = gpu.module(image.to(DEVICE), 784, torch.bfloat16)
        want = cpu.module(image, 784, torch.float32)
    for key in sorted(want):
        rel = ((got[key].float().cpu() - want[key]).norm() / want[key].norm()).item()
        log(f"[moge1-parity] ViT-S MoGe-1 {key}: relative L2 {rel:.3e} (tol {MODEL_L2_RTOL})")
        if not rel <= MODEL_L2_RTOL:
            raise AssertionError(f"MoGe-1 {key}: bf16-on-card vs fp32-on-CPU relative L2 {rel} > {MODEL_L2_RTOL}")
    return (counts_seen[0], len(counts_seen)), latencies


def panorama_image(rng):
    """A seeded smooth 960x1920 uint8 equirectangular image: low-frequency
    colour waves over the sphere plus a little noise."""
    import numpy as np

    h, w = PANO_HW
    yy, xx = np.mgrid[0:h, 0:w]
    u, v = xx / w, yy / h
    image = np.stack([128 + 90 * np.sin(2 * np.pi * u) * np.sin(np.pi * v), 128 + 90 * np.cos(6 * np.pi * u),
                      128 + 60 * np.sin(5 * np.pi * v)], -1)
    return np.clip(image + rng.normal(0, 6, image.shape), 0, 255).astype(np.uint8)


def phase_panorama(card: str):
    """The panorama path (``scripts.infer_panorama.infer_panorama``): a
    seeded smooth 960x1920 uint8 image, its 12 icosahedral views at 512^2
    through one ``moge-2-vitl-normal`` bf16 ``infer`` (random weights, the
    points head a known perspective and the mask head a constant logit, see
    PANO_MASK_LOGIT), the CG merge at 1920x960 on the card; a warm-up run and
    the run, launch counters per run (one 12-view forward). Gates: (a) the
    outputs finite, shaped, the mask not empty; (b) the card's split against
    the CPU's; (c) a known smooth field, seen by the 12 views at 512^2,
    merged by CG on the card at 1920x960, recovered to the JAX test's
    bounds; (d) CG on the card against LSMR on the host on that field with
    blocks knocked out, at the JAX test's size and bounds (see
    PANO_CG_LSMR_SIZE), and at 512x256 CG on the card against CG on the CPU
    from the model's own distance maps (the two solvers stop short of the
    least-squares answer there: their difference is printed); (e) before the
    heads are replaced, the 12-view forward against each view's batch-1
    forward."""
    import numpy as np
    import torch

    from moge_tpu_torch import panorama as pano
    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel
    from moge_tpu_torch.ops.resize import resize_2d
    from moge_tpu_torch.scripts.infer_panorama import infer_panorama
    from moge_tpu_torch.utils.geometry_numpy import uv_map_numpy
    from moge_tpu_torch.utils.tools import span_summary, timeit
    from torch_tiny_config import make_points_perspective, smooth_distance, smooth_field_views

    config = get_preset("moge-2-vitl-normal")["config"]
    expect = expected_launches(config)
    model = MoGeModel(config, device=DEVICE, dtype=torch.bfloat16).init_random(seed=SEED)
    image = panorama_image(np.random.default_rng(SEED + 7))
    extrinsics, intrinsics = pano.get_panorama_cameras()
    h, w = PANO_HW

    # (b) the split on the card against the CPU
    card_views = pano.split_panorama_image(torch.from_numpy(image).to(DEVICE), extrinsics, intrinsics, PANO_SPLIT)
    cpu_views = pano.split_panorama_image(torch.from_numpy(image), extrinsics, intrinsics, PANO_SPLIT)
    split_diff = (card_views.cpu().int() - cpu_views.int()).abs().max().item()
    log(f"[panorama] split {h}x{w} -> 12 x {PANO_SPLIT}^2 uint8, card vs CPU: max {split_diff} levels "
        f"(tol {PANO_SPLIT_LEVELS})")
    if card_views.dtype != torch.uint8 or split_diff > PANO_SPLIT_LEVELS:
        raise AssertionError(f"panorama split: card vs CPU {split_diff} levels ({card_views.dtype})")

    # (e) the 12-view forward with the model's own heads against each view's batch-1 forward:
    # raw maps within MODEL_L2_RTOL (bf16 sums in another order: the tiles and GEMMs differ with
    # the batch). A fault of a kernel at the batch-12 shapes shows here; phase_kernels holds each
    # of those shapes against its plain version
    batch, (grid_h, grid_w) = path_grids()["panorama"]
    with torch.inference_mode():
        image_14 = resize_2d(card_views.float() / 255.0, (grid_h * 14, grid_w * 14), mode="bilinear", antialias=True)
        views_raw = model.module.decode(image_14, grid_h, grid_w, 1.0, torch.bfloat16)
        single_raw = [model.module.decode(image_14[i:i + 1], grid_h, grid_w, 1.0, torch.bfloat16)
                      for i in range(batch)]
    forward_rel = {}
    for key in sorted(views_raw):
        rels = [((views_raw[key][i].float() - one[key][0].float()).norm() / one[key][0].float().norm()).item()
                for i, one in enumerate(single_raw)]
        forward_rel[key] = max(rels)
        if not (views_raw[key].shape[0] == batch and bool(torch.isfinite(views_raw[key]).all())
                and forward_rel[key] <= MODEL_L2_RTOL):
            raise AssertionError(f"panorama: the {batch}-view forward's {key} against each view's batch-1 "
                                 f"forward: relative L2 up to {forward_rel[key]} (tol {MODEL_L2_RTOL})")
    log(f"[panorama] {batch}-view forward ({grid_h}x{grid_w} tokens, the model's own heads) vs each view's "
        f"batch-1 forward, worst relative L2 per raw map: "
        f"{', '.join(f'{k} {v:.3e}' for k, v in forward_rel.items())} (tol {MODEL_L2_RTOL})")
    del image_14, views_raw, single_raw

    make_points_perspective(model.module)
    with torch.no_grad():
        mask_out = model.module.mask_head.output_blocks[-1]
        mask_out.weight.zero_()
        mask_out.bias.fill_(PANO_MASK_LOGIT)

    stages = ("panorama split", "panorama infer", "panorama merge", "panorama")
    levels = []
    size = PANO_MERGE
    while True:
        levels.append(size)
        if max(size) <= 256:
            break
        size = (size[0] // 2, size[1] // 2)
    timings = {}
    for run in range(PANO_RUNS):
        label = "warm-up" if run == 0 else "run"
        reset_counts()
        pano.CG_ITERATIONS.clear()
        out = infer_panorama(model, image, resolution_level=PANO_LEVEL, merge_solver="cg",
                             split_resolution=PANO_SPLIT, merge_size=PANO_MERGE)
        torch.cuda.synchronize()
        counts = read_counts()
        # the merge's level spans (CUDA events) in a pass of their own, which a
        # host-only profiler turns on: the stage times above carry no profiler
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            pano.merge_panorama_depth(*PANO_MERGE, out["distances"], out["view_masks"], extrinsics, intrinsics,
                                      solver="cg")
            torch.cuda.synchronize()
        spans = span_summary()
        if counts != expect:
            raise AssertionError(f"panorama {label}: kernel launches {counts}, expected {expect} per 12-view forward")
        variants = check_variants("panorama", f"panorama {label}", counts)
        # (a) outputs
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        want = {"depth": (h, w), "mask": (h, w), "points": (h, w, 3), "views": (12, PANO_SPLIT, PANO_SPLIT, 3),
                "distances": (12, PANO_SPLIT, PANO_SPLIT), "view_masks": (12, PANO_SPLIT, PANO_SPLIT)}
        if shapes != want:
            raise AssertionError(f"panorama {label}: output shapes {shapes}, expected {want}")
        mask = out["mask"]
        if not mask.any() or not bool(torch.isfinite(out["depth"]).all()) or not bool(torch.isfinite(out["points"]).all()):
            raise AssertionError(f"panorama {label}: empty mask ({mask.float().mean().item()}) or non-finite output")
        if not bool((out["depth"] > 0).all()) or not torch.equal(out["views"], card_views):
            raise AssertionError(f"panorama {label}: non-positive depth, or views other than the split's")
        stage_ms = {s: timeit.history(s)[-1] * 1e3 for s in stages}
        level_ms = {f"{lw}x{lh}": spans[f"moge.panorama.merge.{lw}x{lh}"]["device_s"] * 1e3 for lw, lh in levels}
        cg_ms = {f"{lw}x{lh}": spans[f"moge.panorama.cg.{lw}x{lh}"]["device_s"] * 1e3 for lw, lh in levels}
        iterations = {f"{lw}x{lh}": pano.CG_ITERATIONS[(lw, lh)] for lw, lh in levels}
        timings = {"stages_ms": stage_ms, "merge_levels_ms": level_ms, "cg_levels_ms": cg_ms,
                   "cg_iterations": iterations}
        log(f"[panorama] {label}: mask {mask.float().mean().item():.4f} of pixels, depth "
            f"{out['depth'].min().item():.3f}..{out['depth'].max().item():.3f}, launches {counts}, variants "
            f"{variants}")
        log(f"[panorama] {label}: wall ms {json.dumps({k: round(v, 2) for k, v in stage_ms.items()})}, merge by "
            f"level (CUDA events, a pass of its own) {json.dumps({k: round(v, 2) for k, v in level_ms.items()})}, "
            f"of it CG "
            f"{json.dumps({k: round(v, 2) for k, v in cg_ms.items()})}, CG iterations per level "
            f"{json.dumps(iterations)} ({card})")

    # (c) known-field recovery at the full merge size, CG on the card
    maps, masks = (torch.from_numpy(a) for a in smooth_field_views(PANO_SPLIT))
    merged, merged_mask = pano.merge_panorama_depth(*PANO_MERGE, maps.to(DEVICE), masks.to(DEVICE), extrinsics,
                                                    intrinsics, solver="cg")
    gt = smooth_distance(pano.spherical_uv_to_directions(uv_map_numpy(PANO_MERGE[1], PANO_MERGE[0])))
    merged = merged.cpu().numpy()
    rel = np.abs(merged * np.median(gt / merged) - gt) / gt
    log(f"[panorama] known field at {PANO_MERGE[0]}x{PANO_MERGE[1]}, CG on the card: relative error median "
        f"{np.median(rel):.3e} (tol {PANO_FIELD_MEDIAN}), mean {rel.mean():.3e} (tol {PANO_FIELD_MEAN})")
    if not (bool(merged_mask.all()) and np.median(rel) < PANO_FIELD_MEDIAN and rel.mean() < PANO_FIELD_MEAN):
        raise AssertionError("panorama: the CG merge on the card missed the known field")

    # (d) CG on the card against LSMR on the host, and against CG on the CPU
    def compare(a, b):
        r = ((a.cpu() - b.cpu()).abs() / b.cpu())
        return r.median().item(), r.max().item()

    maps, masks = (torch.from_numpy(a) for a in smooth_field_views(PANO_CG_LSMR_VIEWS, knock_out=True))
    cg, cg_mask = pano.merge_panorama_depth(*PANO_CG_LSMR_SIZE, maps.to(DEVICE), masks.to(DEVICE), extrinsics,
                                            intrinsics, solver="cg")
    lsmr, lsmr_mask = pano.merge_panorama_depth(*PANO_CG_LSMR_SIZE, maps, masks, extrinsics, intrinsics,
                                                solver="lsmr")
    med, mx = compare(cg, lsmr)
    log(f"[panorama] known field, blocks knocked out, views {PANO_CG_LSMR_VIEWS}^2, merged at "
        f"{PANO_CG_LSMR_SIZE[0]}x{PANO_CG_LSMR_SIZE[1]}: CG on the card vs LSMR on the host: relative "
        f"median {med:.3e} (tol {PANO_CG_LSMR_MEDIAN}), max {mx:.3e} (tol {PANO_CG_LSMR_MAX})")
    if not (torch.equal(cg_mask.cpu(), lsmr_mask) and med < PANO_CG_LSMR_MEDIAN and mx < PANO_CG_LSMR_MAX):
        raise AssertionError("panorama: CG on the card disagrees with LSMR on the host")
    dist, vmask = out["distances"], out["view_masks"]
    cg, cg_mask = pano.merge_panorama_depth(512, 256, dist, vmask, extrinsics, intrinsics, solver="cg")
    cpu_cg, cpu_mask = pano.merge_panorama_depth(512, 256, dist.cpu(), vmask.cpu(), extrinsics, intrinsics,
                                                 solver="cg")
    lsmr, lsmr_mask = pano.merge_panorama_depth(512, 256, dist.cpu(), vmask.cpu(), extrinsics, intrinsics,
                                                solver="lsmr")
    med, mx = compare(cg, cpu_cg)
    lmed, lmx = compare(cg, lsmr)
    log(f"[panorama] the model's distance maps, 512x256: CG card vs CPU relative median {med:.3e}, max {mx:.3e} "
        f"(tol {PANO_CG_CARD_CPU}); CG card vs LSMR host median {lmed:.3e}, max {lmx:.3e} (not gated: both "
        f"stop short of the least-squares answer at this size)")
    if not (torch.equal(cg_mask.cpu(), cpu_mask) and torch.equal(cpu_mask, lsmr_mask) and mx <= PANO_CG_CARD_CPU):
        raise AssertionError("panorama: CG on the card disagrees with CG on the CPU")
    timings.update(split_card_vs_cpu_levels=split_diff, forward_batch_vs_single_rel=forward_rel,
                   field_median_rel=float(np.median(rel)),
                   cg_vs_lsmr_model_maps={"median": lmed, "max": lmx})
    del model
    return (expect, PANO_RUNS), timings


def phase_eval(card: str):
    """The eval path: a seeded synthetic benchmark of EVAL_SAMPLES samples at
    480x640 (sample 0 with inf depth, sample 1 with segmentation) written by
    the port's codecs into a temp dir, evaluated by the ``eval_baseline``
    command through the port's MoGe adapter (``moge-2-vitl-normal``, random
    weights saved as a ``.pt``, bf16, 3600 tokens), the loader cropping to
    480x640 and the alignment solves on the card; launch counters over the
    command, per sample. Gates: every metric finite, every class the
    adapter's metric outputs imply present, every solve on the card; for
    sample 1, ``compute_metrics`` on the card equal to ``compute_metrics`` on
    the CPU on the same predictions (EVAL_RTOL; boundary F1 exactly)."""
    import tempfile

    import numpy as np
    import torch

    from moge_tpu_torch.eval import metrics
    from moge_tpu_torch.eval.dataloader import EvalDataLoaderPipeline
    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel
    from moge_tpu_torch.scripts import eval_baseline
    from moge_tpu_torch.utils.tools import flatten_nested_dict, import_file_as_module, span_summary
    from torch_tiny_config import write_benchmark

    config = get_preset("moge-2-vitl-normal")["config"]
    expect = expected_launches(config)
    adapter = ROOT / "moge_tpu_torch" / "baselines" / "moge.py"
    h, w = EVAL_HW
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_benchmark(tmp / "bench", n_samples=EVAL_SAMPLES, hw=EVAL_HW, seed=SEED)
        model = MoGeModel(config, device=DEVICE, dtype=torch.bfloat16).init_random(seed=SEED)
        torch.save({"model_config": config, "model": model.module.state_dict()}, tmp / "model.pt")
        del model
        bench = {"path": str(tmp / "bench"), "width": w, "height": h, "depth_unit": 1.0,
                 "has_sharp_boundary": True, "include_segmentation": True}
        (tmp / "config.json").write_text(json.dumps({"synthetic": bench}))
        args = ["--baseline", str(adapter), "--config", str(tmp / "config.json"), "--output",
                str(tmp / "result.json"), "--pretrained", str(tmp / "model.pt"), "--fp16", "--version", "v2",
                "--device", DEVICE]
        reset_counts()
        metrics.SOLVES.clear()
        t0 = time.perf_counter()
        eval_baseline.command().main(args, standalone_mode=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        solves = dict(metrics.SOLVES)
        want_counts = {k: v * EVAL_SAMPLES for k, v in expect.items()}
        if counts != want_counts:
            raise AssertionError(f"eval: launches {counts} over {EVAL_SAMPLES} samples, expected {want_counts}")
        variants = check_variants("eval", "eval", counts, runs=EVAL_SAMPLES)
        if set(solves) != {torch.device(DEVICE).type} or not solves[torch.device(DEVICE).type]:
            raise AssertionError(f"eval: alignment solves by device {solves}, expected all on the card")
        result = json.loads((tmp / "result.json").read_text())
        flat = flatten_nested_dict(result["synthetic"])
        bad = [k for k, v in flat.items() if not np.isfinite(v)]
        families = {k[0] for k in flat}
        want_families = {"depth_metric", "depth_scale_invariant", "depth_affine_invariant",
                         "disparity_affine_invariant", "points_metric", "points_scale_invariant",
                         "points_affine_invariant", "local_points", "fov_x", "boundary", "inference_time"}
        if bad or families != want_families:
            raise AssertionError(f"eval: non-finite metrics {bad}, or classes {sorted(families)} "
                                 f"!= {sorted(want_families)}")

        # one sample, compute_metrics on the card and on the CPU from the same predictions
        baseline = import_file_as_module(adapter, "moge_adapter").Baseline.load.main(
            ["--pretrained", str(tmp / "model.pt"), "--fp16", "--device", DEVICE], standalone_mode=False)
        loader_bench = dict(bench, num_load_workers=1, num_process_workers=1)
        t0 = time.perf_counter()
        with EvalDataLoaderPipeline(**loader_bench) as pipe:
            samples = [pipe.get() for _ in range(len(pipe))]
        load_s = (time.perf_counter() - t0) / EVAL_SAMPLES
        sample = samples[1]
        pred = baseline.infer_for_evaluation(sample["image"])
        del baseline
        torch.cuda.empty_cache()
        metrics_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            card_metrics, _ = metrics.compute_metrics(pred, sample, device=DEVICE)
            torch.cuda.synchronize()
            metrics_s.append(time.perf_counter() - t0)
        # the solves' spans in a pass of their own, which a host-only profiler turns on
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            metrics.compute_metrics(pred, sample, device=DEVICE)
            torch.cuda.synchronize()
        solve_s = span_summary()["moge.eval.solve"]["host_s"]
        t0 = time.perf_counter()
        cpu_metrics, _ = metrics.compute_metrics(pred, sample, device="cpu")
        cpu_s = time.perf_counter() - t0
    card_flat, cpu_flat = flatten_nested_dict(card_metrics), flatten_nested_dict(cpu_metrics)
    if card_flat.keys() != cpu_flat.keys() or "local_points" not in card_metrics:
        raise AssertionError(f"eval: card metrics {sorted(card_flat)} vs CPU {sorted(cpu_flat)}")
    worst_rel = max(abs(card_flat[k] - v) / max(abs(v), 1e-12) for k, v in cpu_flat.items() if k[0] != "boundary")
    boundary_same = all(card_flat[k] == v for k, v in cpu_flat.items() if k[0] == "boundary")
    log(f"[eval] sample_1 compute_metrics card vs CPU: worst relative {worst_rel:.3e} (tol {EVAL_RTOL}), "
        f"boundary F1 equal {boundary_same}")
    if not (worst_rel <= EVAL_RTOL and boundary_same):
        raise AssertionError("eval: compute_metrics on the card disagrees with the CPU")
    stats = {"samples": EVAL_SAMPLES, "hw": list(EVAL_HW), "command_s_per_sample": wall_s / EVAL_SAMPLES,
             "inference_s_per_sample": result["synthetic"]["inference_time"], "load_s_per_sample": load_s,
             "metrics_s_per_sample_card": metrics_s[-1], "solves_s_card": solve_s, "metrics_s_cpu": cpu_s,
             "solves": sum(solves.values()),
             "card_vs_cpu_worst_rel": worst_rel}
    log(f"[eval] {EVAL_SAMPLES} samples at {h}x{w} through eval_baseline (ViT-L bf16, 3600 tokens): "
        f"{stats['command_s_per_sample']:.3f} s per sample in the command; inference "
        f"{stats['inference_s_per_sample']:.3f} s, metrics on the card {metrics_s[-1]:.3f} s ({solve_s:.3f} s in "
        f"the alignment solves; first "
        f"{metrics_s[0]:.3f}; CPU {cpu_s:.3f}), load {load_s:.3f} s per sample; solves by device {solves}; "
        f"launches per sample {expect}, variants per sample {VARIANTS_BY_PATH['eval']} ({card})")
    return (expect, EVAL_SAMPLES), stats


def train_batch(rng, batch: int, hw, label_type_idx: int, device):
    """A seeded training batch shaped like ``__graft_entry__.dryrun_multichip``'s:
    smooth depth surfaces (so the local losses find 3D neighbours), ~10%
    invalid depth, unit normals, one label type for every instance."""
    import numpy as np
    import torch

    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    depth = np.stack([2 + 0.5 * np.sin(3 * xx + rng.uniform(0, 6)) + 0.3 * yy for _ in range(batch)])
    depth = depth + 0.01 * rng.standard_normal(depth.shape)
    fin = rng.uniform(0, 1, (batch, h, w)) > 0.1
    normal = rng.standard_normal((batch, h, w, 3))
    out = {
        "image": rng.uniform(0, 1, (batch, h, w, 3)),
        "depth": depth,
        "normal": normal / np.linalg.norm(normal, axis=-1, keepdims=True),
        "normal_mask": np.ones((batch, h, w), bool),
        "depth_mask_fin": fin,
        "depth_mask_inf": ~fin & (rng.uniform(0, 1, (batch, h, w)) > 0.5),
        "intrinsics": np.broadcast_to(np.asarray([[1.0, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1.0]]), (batch, 3, 3)),
        "label_type_idx": np.full((batch,), label_type_idx, np.int64),
        "is_metric": np.ones((batch,), bool),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32 if v.dtype == np.float64 else v.dtype)).to(device)
            for k, v in out.items()}


def train_setup(device):
    """TRAIN_CONFIG's module (random weights from SEED), optimizer and train
    state on ``device``: ``(cfg, module, tx, state)``."""
    import torch

    from moge_tpu_torch.models.v2 import MoGeV2
    from moge_tpu_torch.train.step import init_train_state
    from moge_tpu_torch.train.utils import build_optimizer

    cfg = json.loads(TRAIN_CONFIG.read_text())
    with torch.device(device):
        module = MoGeV2(**cfg["model"]).init_random(seed=SEED)
    tx = build_optimizer(module, cfg["optimizer"], cfg["lr_scheduler"])
    return cfg, module, tx, init_train_state(module, tx)


def phase_train(card: str):
    """configs/train/v2.json at full width: moge-2-vitl-normal, random weights,
    bf16 compute with fp32 parameters, label type A, batch 2 at 512x512,
    TRAIN_STEPS train steps at each of TRAIN_TOKENS."""
    import numpy as np
    import torch

    from moge_tpu_torch.train.step import make_grad_step, make_train_step

    dev = torch.device(DEVICE)
    cfg, module, tx, state = train_setup(dev)
    label_types = list(cfg["loss"])
    lt_a = label_types.index("A")
    expect = expected_train_launches(cfg["model"], cfg["loss"])
    trainable = {n: p for n, p in module.named_parameters() if p.requires_grad}
    before = {n: p.detach().clone() for n, p in trainable.items()}
    ema_before = {n: e.clone() for n, e in state.ema_params.items()}
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    log(f"[train] moge-2-vitl-normal, {sum(p.numel() for p in trainable.values())} trainable fp32 parameters, "
        f"bf16 compute; label type A losses {sorted(cfg['loss']['A'])}; expected launches per step {expect}")
    steps = []
    for num_tokens in TRAIN_TOKENS:
        train_step = make_train_step(module, tx, cfg["loss"], label_types, num_tokens, dtype=torch.bfloat16)
        for i in range(TRAIN_STEPS):
            batch = train_batch(rng, 2, TRAIN_HW, lt_a, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            total = float(metrics["total"])
            log(f"[train] {num_tokens} tokens step {i}: total {total:.5f}, grads_ok {float(metrics['grads_ok'])}, "
                f"global {float(metrics['global']):.4f}, patch_4/16/64 {float(metrics['patch_4']):.4f}/"
                f"{float(metrics['patch_16']):.4f}/{float(metrics['patch_64']):.4f}, "
                f"step {wall_ms:.1f} ms, peak {peak_gib:.2f} GiB ({card}); launches {counts}")
            if not np.isfinite(total):
                raise AssertionError(f"non-finite training loss {total} at {num_tokens} tokens, step {i}")
            if float(metrics["grads_ok"]) != 1.0:
                raise AssertionError(f"non-finite gradients (update skipped) at {num_tokens} tokens, step {i}")
            if counts != expect:
                raise AssertionError(f"train step launches {counts}, expected {expect}")
            check_variants("train", f"train {num_tokens} tokens step {i}", counts)
            steps.append({"num_tokens": num_tokens, "step": i, "ms": wall_ms, "peak_gib": peak_gib, "loss": total})
    if state.step != len(TRAIN_TOKENS) * TRAIN_STEPS or tx.count != state.step:
        raise AssertionError(f"step count {state.step}, optimizer updates {tx.count}")

    # parameters move where their group's LR was nonzero (the v2 warm-up holds
    # the backbone at 0 for its first 1000 updates); the EMA follows them
    lr_groups = {n: gi for gi, names in enumerate(tx.groups) for n in names}
    lrs_used = [max(base * (1.0 if s is None else s(c)) for c in range(tx.count))
                for base, s in zip(tx.base_lrs, tx.schedules)]
    for n, p in trainable.items():
        changed = not torch.equal(p.detach(), before[n])
        if changed != (lrs_used[lr_groups[n]] > 0):
            raise AssertionError(f"{n}: changed={changed} with learning rates up to {lrs_used[lr_groups[n]]}")
        if changed and torch.equal(state.ema_params[n], ema_before[n]):
            raise AssertionError(f"{n}: EMA does not follow the parameter")

    # every trainable parameter gets a finite, nonzero gradient (the backbone's
    # through K2b and the cast weights), also where the LR holds it still
    grads, _ = make_grad_step(module, cfg["loss"], label_types, TRAIN_TOKENS[0], torch.bfloat16)(
        train_batch(rng, 2, TRAIN_HW, lt_a, dev), gen)
    bad = [n for n, g in grads.items() if not (torch.isfinite(g).all() and g.abs().sum() > 0)]
    if bad:
        raise AssertionError(f"{len(bad)} trainable parameters without a finite nonzero gradient: {bad[:5]}")
    log(f"[train] {len(grads)} trainable parameters all got finite nonzero gradients; "
        f"{sum(lrs_used[lr_groups[n]] > 0 for n in trainable)} moved (nonzero LR) and their EMA followed")
    return (expect, len(steps)), steps


def phase_train_parity():
    """moge-2-vits-normal, one fp32 grad step: kernels on the card vs plain
    versions on the CPU, same weights, batch and random draws."""
    import copy

    import numpy as np
    import torch

    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeV2
    from moge_tpu_torch.ops import alignment
    from moge_tpu_torch.train import losses
    from moge_tpu_torch.train.step import make_grad_step

    # label type A's losses with the align resolutions reduced to 16/8/6/4
    # (from 48/24/12/6) and the patches to 4/16/64 per image (from
    # 16/256/4096), for a 224x224 image at 256 tokens
    loss = {"invalid": {}, "A": copy.deepcopy(json.loads(TRAIN_CONFIG.read_text())["loss"]["A"])}
    for name, res, patches in (("global", 16, None), ("patch_4", 8, 4), ("patch_16", 6, 16), ("patch_64", 4, 64)):
        loss["A"][name]["params"]["align_resolution"] = res
        if patches:
            loss["A"][name]["params"]["num_patches"] = patches
    config = get_preset("moge-2-vits-normal")["config"]
    with torch.device(DEVICE):
        gpu = MoGeV2(**config).init_random(seed=SEED)
    cpu = MoGeV2(**config)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, strict=True)
    batch = train_batch(np.random.default_rng(SEED + 3), 2, (224, 224), 1, "cpu")

    recorded, original_draw = [], losses.draw

    def record(gen, what, arg, size):
        value = original_draw(gen, what, arg, size)
        recorded.append(value)
        return value

    runs = []
    try:
        for module, dev, draw in ((cpu, "cpu", record), (gpu, DEVICE, lambda *a: recorded.pop(0))):
            losses.draw = draw
            alignment.SOLVES = []
            grads, metrics = make_grad_step(module, loss, ["invalid", "A"], 256, torch.float32)(
                {k: v.to(dev) for k, v in batch.items()}, torch.Generator().manual_seed(SEED))
            runs.append((grads, metrics, alignment.SOLVES))
    finally:
        losses.draw, alignment.SOLVES = original_draw, None
    (g_cpu, m_cpu, s_cpu), (g_gpu, m_gpu, s_gpu) = runs

    loss_rel = abs(float(m_gpu["total"]) - float(m_cpu["total"])) / abs(float(m_cpu["total"]))
    log(f"[train-parity] total loss card {float(m_gpu['total']):.7f} vs CPU {float(m_cpu['total']):.7f}: "
        f"relative {loss_rel:.3e} (tol {PARITY_LOSS_RTOL})")
    if not loss_rel <= PARITY_LOSS_RTOL:
        raise AssertionError(f"training loss card vs CPU relative {loss_rel} > {PARITY_LOSS_RTOL}")
    if len(s_gpu) != len(s_cpu) or not s_cpu:
        raise AssertionError(f"{len(s_gpu)} alignment solves on the card, {len(s_cpu)} on the CPU")
    for i, (a, b) in enumerate(zip(s_gpu, s_cpu)):
        a = [t.cpu() for t in a]
        for j, what in ((2, "anchor"), (3, "second index")):
            if not torch.equal(a[j], b[j]):
                raise AssertionError(f"solve {i}: {int((a[j] != b[j]).sum())} of {b[j].numel()} {what}s differ")
        rel = max(((x - y).norm() / y.norm().clamp_min(1e-12)).item() for x, y in zip(a[:2], b[:2]))
        log(f"[train-parity] solve {i}: {b[2].numel()} rows, same anchors and indices, scale/shift relative L2 "
            f"{rel:.3e} (tol {PARITY_SOLVE_RTOL})")
        if not rel <= PARITY_SOLVE_RTOL:
            raise AssertionError(f"solve {i}: scale/shift relative L2 {rel} > {PARITY_SOLVE_RTOL}")
    num = sum((g_gpu[k].cpu() - g_cpu[k]).square().sum() for k in g_cpu)
    den = sum(g.square().sum() for g in g_cpu.values())
    grad_rel = (num / den).sqrt().item()
    log(f"[train-parity] gradients of {len(g_cpu)} parameters: relative L2 {grad_rel:.3e} (tol {PARITY_GRAD_RTOL})")
    if not grad_rel <= PARITY_GRAD_RTOL:
        raise AssertionError(f"gradients card vs CPU relative L2 {grad_rel} > {PARITY_GRAD_RTOL}")


def grad_distance(a: dict, b: dict) -> float:
    """The L2 norm of a - b over every gradient tensor (float64 sums)."""
    return sum((a[k].double() - b[k].double()).square().sum().item() for k in a) ** 0.5


def phase_train_remat(card: str):
    """Activation checkpointing at full width: v2.json's model
    (moge-2-vitl-normal) with random weights from SEED, bf16 compute, label
    type A, REMAT_TOKENS tokens at TRAIN_HW, grad steps (forward, losses,
    backward) at each of REMAT_BATCHES with ``remat`` off and on (two
    modules, one state): a warm step and REMAT_TIMES timed ones each, their
    median time and largest peak; every step's launches against
    ``expected_train_launches`` (the remat steps counted under
    ``train_remat``), peak(remat) below peak(plain) at each batch; then from
    one state, batch and generator the plain step RESUME_REPEATS more times
    (the card's spread: the backward sums with atomics) and the remat step
    once, whose loss and gradients must fall within RESUME_MARGIN x that
    spread (RESUME_RTOL relative when it is 0). Then one plain and one
    remat step of MoGe-1 (v1.json, batch 2, REMAT_V1_HW at REMAT_V1_TOKENS)
    and of the giant (``giant_config``, batch 2, as the ViT-L), counted
    under ``train_remat_v1`` and ``train_remat_giant``, with their peaks."""
    import numpy as np
    import torch

    from moge_tpu_torch.models.v1 import MoGeV1, normalize_config
    from moge_tpu_torch.models.v2 import MoGeV2
    from moge_tpu_torch.train.step import make_grad_step

    dev = torch.device(DEVICE)
    cfg = json.loads(TRAIN_CONFIG.read_text())
    v1_cfg = json.loads(TRAIN_V1_CONFIG.read_text())
    rng = np.random.default_rng(SEED + 7)
    runs = {}

    def pair(build, config):
        """The plain module (random weights from SEED) and the remat one with its weights."""
        with torch.device(dev):
            plain = build(config).init_random(seed=SEED)
            remat = build(config, remat=True)
        remat.load_state_dict(plain.state_dict(), strict=True)
        return {False: plain, True: remat}

    def step(module, loss, batch, num_tokens, expect, path, label):
        """One grad step from the module's state, the losses' generator seeded
        SEED: (gradients, loss, ms, peak GiB, GiB held before it)."""
        grad_step = make_grad_step(module, loss, list(loss), num_tokens, torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) / 2 ** 30
        reset_counts()
        t0 = time.perf_counter()
        grads, metrics = grad_step(batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        total = float(metrics["total"])
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected {expect}")
        if path is not None:
            check_variants(path, label, counts)
            runs[path] = runs.get(path, 0) + 1
        if not np.isfinite(total) or not all(torch.isfinite(g).all() for g in grads.values()):
            raise AssertionError(f"{label}: non-finite loss {total} or gradients")
        return grads, total, ms, peak, held

    lt_a = list(cfg["loss"]).index("A")
    expect = {r: expected_train_launches(cfg["model"], cfg["loss"], remat=r) for r in (False, True)}
    modules = pair(lambda c, **kw: MoGeV2(**c, **kw), cfg["model"])
    log(f"[train_remat] moge-2-vitl-normal, bf16, {REMAT_TOKENS} tokens at {TRAIN_HW}: launches per grad step "
        f"plain {expect[False]}, remat {expect[True]}")
    stats = {}
    for batch_size in REMAT_BATCHES:
        batch = train_batch(rng, batch_size, TRAIN_HW, lt_a, dev)
        row = {}
        for remat in (False, True):
            mode = "remat" if remat else "plain"
            times, peaks = [], []
            for i in range(1 + REMAT_TIMES):
                grads, total, ms, peak, held = step(modules[remat], cfg["loss"], batch, REMAT_TOKENS, expect[remat],
                                                    "train_remat" if remat else None,
                                                    f"train_remat batch {batch_size} {mode} step {i}")
                del grads
                if i:
                    times.append(ms)
                    peaks.append(peak)
            row[mode] = {"ms": statistics.median(times), "ms_all": times, "peak_gib": max(peaks), "held_gib": held,
                         "loss": total}
        # the gradients from one state, batch and generator: the plain step's spread, the remat step within it
        ref, ref_loss, *_ = step(modules[False], cfg["loss"], batch, REMAT_TOKENS, expect[False], None,
                                 f"train_remat batch {batch_size} plain reference")
        repeats = []
        for i in range(RESUME_REPEATS):
            grads, total, *_ = step(modules[False], cfg["loss"], batch, REMAT_TOKENS, expect[False], None,
                                    f"train_remat batch {batch_size} plain repeat {i}")
            repeats.append((grad_distance(ref, grads), abs(total - ref_loss)))
            del grads
        grads, total, *_ = step(modules[True], cfg["loss"], batch, REMAT_TOKENS, expect[True], "train_remat",
                                f"train_remat batch {batch_size} remat against the reference")
        got = (grad_distance(ref, grads), abs(total - ref_loss))
        norm = sum(g.double().square().sum().item() for g in ref.values()) ** 0.5
        del grads, ref
        spread = tuple(max(r[i] for r in repeats) for i in range(2))
        bounds = tuple(RESUME_MARGIN * sp if sp > 0 else RESUME_RTOL * scale
                       for sp, scale in zip(spread, (norm, abs(ref_loss))))
        row["gradients"] = {"l2_norm": norm, "remat_l2": got[0], "repeats_l2": [r[0] for r in repeats],
                            "remat_loss_diff": got[1], "repeats_loss_diff": [r[1] for r in repeats]}
        plain, remat = row["plain"], row["remat"]
        log(f"[train_remat] batch {batch_size}: plain {plain['ms']:.1f} ms (of {[round(t, 1) for t in plain['ms_all']]})"
            f", peak {plain['peak_gib']:.2f} GiB; remat {remat['ms']:.1f} ms (of "
            f"{[round(t, 1) for t in remat['ms_all']]}), peak {remat['peak_gib']:.2f} GiB; "
            f"{plain['held_gib']:.2f} GiB held before each step; time x{remat['ms'] / plain['ms']:.3f}, peak "
            f"{remat['peak_gib'] - plain['peak_gib']:+.2f} GiB ({card})")
        log(f"[train_remat] batch {batch_size}: gradients (L2 {norm:.4e}) remat vs plain {got[0]:.3e}, plain repeats "
            f"{[f'{r[0]:.3e}' for r in repeats]} (bound {bounds[0]:.3e}); loss {ref_loss:.6f}, remat vs plain "
            f"{got[1]:.3e}, repeats {[f'{r[1]:.3e}' for r in repeats]} (bound {bounds[1]:.3e})")
        if not (got[0] <= bounds[0] and got[1] <= bounds[1]):
            raise AssertionError(f"batch {batch_size}: the remat step's gradients or loss ({got}) outside the card's "
                                 f"spread (bounds {bounds})")
        if not remat["peak_gib"] < plain["peak_gib"]:
            raise AssertionError(f"batch {batch_size}: remat peak {remat['peak_gib']} GiB not below plain's "
                                 f"{plain['peak_gib']}")
        stats[f"batch_{batch_size}"] = row
        torch.cuda.empty_cache()
    del modules
    torch.cuda.empty_cache()

    # MoGe-1 and the giant: one plain and one remat step each, batch 2
    others = (("v1", "moge-vitl (v1.json)", lambda c, **kw: MoGeV1(**normalize_config(c), **kw), v1_cfg["model"],
               v1_cfg["loss"], "synthetic", REMAT_V1_HW, REMAT_V1_TOKENS, "v1"),
              ("giant", "moge-2 on dinov2_vitg14", lambda c, **kw: MoGeV2(**c, **kw), giant_config(), cfg["loss"],
               "A", TRAIN_HW, REMAT_TOKENS, "v2"))
    for key, name, build, config, loss, label_type, hw, num_tokens, version in others:
        modules = pair(build, config)
        batch = train_batch(rng, 2, hw, list(loss).index(label_type), dev)
        row = {}
        for remat in (False, True):
            mode = "remat" if remat else "plain"
            want = expected_train_launches(config, loss, version, remat)
            grads, total, ms, peak, held = step(modules[remat], loss, batch, num_tokens, want,
                                                f"train_remat_{key}" if remat else None, f"{name} {mode} step")
            del grads
            row[mode] = {"ms": ms, "peak_gib": peak, "held_gib": held, "loss": total, "launches": want}
        log(f"[train_remat] {name}, batch 2, {hw} at {num_tokens} tokens, one step each (the first): plain "
            f"{row['plain']['ms']:.1f} ms, peak {row['plain']['peak_gib']:.2f} GiB; remat {row['remat']['ms']:.1f} "
            f"ms, peak {row['remat']['peak_gib']:.2f} GiB; {row['plain']['held_gib']:.2f} GiB held before each "
            f"({card})")
        stats[key] = row
        del modules
        torch.cuda.empty_cache()
    launches = {"train_remat": (expect[True], runs["train_remat"]),
                "train_remat_v1": (stats["v1"]["remat"]["launches"], runs["train_remat_v1"]),
                "train_remat_giant": (stats["giant"]["remat"]["launches"], runs["train_remat_giant"])}
    return launches, stats


def phase_host_packages():
    """The host packages the training loader needs, on the card's host: every
    cv2 function and flag that ``utils/data_augmentation.py``,
    ``geometry_numpy.depth_of_field`` and the loader use, PIL's LANCZOS
    resampling and scipy's fftconvolve (the run fails naming what is
    missing), then the augmentation itself once per branch."""
    import cv2
    import numpy as np
    import PIL
    import scipy
    from PIL import Image

    from moge_tpu_torch.utils.data_augmentation import image_color_augmentation, warp_perspective

    need = ["warpPerspective", "INTER_NEAREST", "INTER_LINEAR", "INTER_LANCZOS4", "INTER_LINEAR_EXACT",
            "INTER_CUBIC", "INTER_AREA", "inpaint", "INPAINT_TELEA", "imencode", "imdecode", "IMWRITE_JPEG_QUALITY",
            "IMREAD_COLOR", "cvtColor", "COLOR_RGB2HSV", "COLOR_HSV2RGB", "COLOR_BGR2RGB", "COLOR_RGB2BGR",
            "dilate", "getStructuringElement", "MORPH_ELLIPSE", "blur", "resize"]
    missing = [f"cv2.{n}" for n in need if not hasattr(cv2, n)]
    if not hasattr(getattr(Image, "Resampling", None), "LANCZOS"):
        missing.append("PIL.Image.Resampling.LANCZOS")
    try:
        from scipy.signal import fftconvolve  # noqa: F401
    except ImportError:
        missing.append("scipy.signal.fftconvolve")
    if missing:
        raise AssertionError(f"the training loader needs {missing} (cv2 {cv2.__version__}, PIL {PIL.__version__}, "
                             f"scipy {scipy.__version__})")
    rng = np.random.default_rng(SEED)
    image = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    depth = rng.uniform(1, 5, (96, 128)).astype(np.float32)
    depth[10:20, 10:20] = np.nan
    shrink = np.diag([0.5, 0.5, 1.0]).astype(np.float32)
    warped = warp_perspective(image, shrink, (48, 64), interpolation="lanczos")
    changed = {}
    for branch in ("jittering", "dof", "shot_noise", "blurring", "jpeg_loss"):
        outs = [image_color_augmentation(image, [branch], np.random.default_rng(seed), depth) for seed in range(6)]
        changed[branch] = sum(not np.array_equal(o, image) for o in outs)
        if not changed[branch] or any(o.shape != image.shape or o.dtype != np.uint8 for o in outs):
            raise AssertionError(f"augmentation {branch} did nothing or changed the image's shape or type")
    log(f"[host] cv2 {cv2.__version__}, PIL {PIL.__version__}, scipy {scipy.__version__}, numpy {np.__version__}: "
        f"the loader's {len(need)} cv2 names present; lanczos warp {warped.shape}, augmentations changed the "
        f"image in {changed} of 6 seeds")


def train_cli_config(tmp: Path) -> Path:
    """TRAIN_CONFIG with ``data.datasets`` replaced by the synthetic datasets
    (``write_train_dataset``: labels A, B and C, depth_unit 1 / 0.001 / none,
    only_known, dof and shot_noise, completed-depth files, inf sky and NaN
    holes) and ``low_resolution_training_steps`` TRAIN_CLI_LOW_RES; model,
    optimizer, LR schedule, losses and the rest of the data section as they
    are. Returns the written config's path."""
    from torch_tiny_config import write_train_dataset

    cfg = json.loads(TRAIN_CONFIG.read_text())
    cfg["data"]["datasets"] = write_train_dataset(tmp / "data", n_instances=TRAIN_CLI_INSTANCES,
                                                  hw=TRAIN_CLI_SRC_HW, seed=SEED)
    cfg["low_resolution_training_steps"] = TRAIN_CLI_LOW_RES
    path = tmp / "train.json"
    path.write_text(json.dumps(cfg))
    return path


def run_train_cli(config_path: Path, workspace: Path, expect: dict, accumulation: int, label: str, *extra,
                  path: str = "train_cli"):
    """``cli train`` in-process on the card with the counters set to 0 just
    before and read just after; the launches must be the expected count per
    micro-batch times the micro-batches, every one on its Hopper variant
    (recorded under ``path``). Returns (the command's result, this run's
    steps.jsonl lines, wall s, peak GiB, micro-batches)."""
    import math

    import torch

    from moge_tpu_torch.scripts import cli

    args = ["train", "--config", str(config_path), "--workspace", str(workspace), "--batch_size_forward",
            str(TRAIN_CLI_BATCH), "--gradient_accumulation_steps", str(accumulation), "--log_every", "1",
            "--seed", str(SEED), "--device", DEVICE, *extra]
    before = len((workspace / "steps.jsonl").read_text().splitlines()) if (workspace / "steps.jsonl").exists() else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    result = cli.command().main(args, standalone_mode=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    lines = [json.loads(x) for x in (workspace / "steps.jsonl").read_text().splitlines()[before:]]
    metrics = [json.loads(x) for x in (workspace / "metrics.jsonl").read_text().splitlines()[before:]]
    micro = len(lines) * accumulation
    want = {k: v * micro for k, v in expect.items()}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} over {micro} micro-batches, expected {want}")
    check_variants(path, label, counts, runs=micro)
    if [m["step"] for m in metrics] != [x["step"] for x in lines] or \
            [x["step"] for x in lines] != [x["step"] for x in result["steps"]]:
        raise AssertionError(f"{label}: steps.jsonl {lines}, metrics.jsonl {metrics}")
    for x, m in zip(lines, metrics):
        if not ({"num_tokens", "t", "data_wait"} <= set(x) and math.isfinite(x["total"]) and m["grads_ok"] == 1.0
                and len(x["sizes"]) == accumulation):
            raise AssertionError(f"{label}: step {x['step']}: {x}, grads_ok {m['grads_ok']}")
    log(f"[{path}] {label}: {len(lines)} steps of {accumulation} micro-batch(es) in {wall_s:.1f} s, peak "
        f"{peak_gib:.2f} GiB; per step (tokens, sizes, label types, s, s waiting for data, loss): "
        + "; ".join(f"{x['num_tokens']} {x['sizes']} {x['label_types']} {x['t']:.3f} {x['data_wait']:.3f} "
                    f"{x['total']:.4f}" for x in lines))
    return result, lines, wall_s, peak_gib, micro


def train_state_tensors(state, gen) -> dict:
    """Every tensor of a train state on its device, by name (the module's
    state dict, AdamW's moments and steps, the EMA), and its scalars
    (step, update count, learning rates, generator state)."""
    named = {f"model.{k}": v for k, v in state.module.state_dict().items()}
    for i, per in state.optimizer.adamw.state_dict()["state"].items():
        named.update({f"adamw.{i}.{k}": v for k, v in per.items()})
    named.update({f"ema.{k}": v for k, v in (state.ema_params or {}).items()})
    scalars = {"step": state.step, "count": state.optimizer.count, "lrs": state.optimizer.lrs(),
               "gen": gen.get_state().tolist()}
    return {"tensors": named, "scalars": scalars}


def state_distance(a: dict, b: dict) -> dict:
    """Per part of the state (model, adamw, ema), the L2 norm of a - b over
    all its tensors; and whether every tensor and scalar is bit-identical."""
    import torch

    if a["tensors"].keys() != b["tensors"].keys():
        raise AssertionError("train states with different tensors")
    sq = {}
    identical = a["scalars"] == b["scalars"]
    for k, x in a["tensors"].items():
        y = b["tensors"][k]
        identical &= torch.equal(x, y)
        part = k.split(".")[0]
        sq[part] = sq.get(part, 0.0) + (x.double() - y.double()).square().sum().item()
    return {"l2": {p: v ** 0.5 for p, v in sq.items()}, "identical": identical}


def phase_train_cli(card: str):
    """The training command at full width through ``cli train`` (click's
    standalone_mode=False) on the card: TRAIN_CONFIG (v2.json: moge-2-vitl-
    normal from random weights, bf16 compute, fp32 parameters) over the
    synthetic datasets (``train_cli_config``), batch 2, the threaded
    augmenting loader and random sizes. Run A: TRAIN_CLI_STEPS steps, a
    checkpoint at the last. The checkpoint loads into a fresh state bit for bit equal to the
    command's; one step on a fixed batch, repeated from that state, measures
    the card's spread, and the same step from the loaded state must fall
    within it. The checkpoint's model.pt runs ``infer``. ``--checkpoint
    latest`` resumes it for one more step. Run B: two steps of two
    micro-batches.
    Launch counters over each command, per micro-batch."""
    import shutil
    import statistics as st

    import torch

    from moge_tpu_torch.models.io import load_train_checkpoint, restore_train_state, snapshot_train_state
    from moge_tpu_torch.models.v2 import MoGeModel, MoGeV2
    from moge_tpu_torch.scripts.train import batch_to_device
    from moge_tpu_torch.train.dataloader import TrainDataLoaderPipeline
    from moge_tpu_torch.train.step import init_train_state, make_train_step
    from moge_tpu_torch.train.utils import build_optimizer

    dev = torch.device(DEVICE)
    root = ROOT / "workspace"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_", dir=root))
    try:
        config_path = train_cli_config(tmp)
        cfg = json.loads(config_path.read_text())
        expect = expected_train_launches(cfg["model"], cfg["loss"])
        lo = cfg["model"]["num_tokens_range"][0]
        ws = tmp / "run_a"
        res_a, lines_a, wall_a, peak_a, micro_a = run_train_cli(
            config_path, ws, expect, 1, "run A", "--num_iterations", str(TRAIN_CLI_STEPS),
            "--save_every", str(TRAIN_CLI_STEPS - 1))
        if [x["num_tokens"] for x in lines_a[:TRAIN_CLI_LOW_RES + 1]] != [lo] * (TRAIN_CLI_LOW_RES + 1) or \
                any(x["num_tokens"] != lo and x["num_tokens"] % 100 for x in lines_a):  # the default quantum
            raise AssertionError(f"run A: token counts {[x['num_tokens'] for x in lines_a]}")
        ckpt = ws / "checkpoints" / str(TRAIN_CLI_STEPS - 1)
        files = sorted(str(p.relative_to(ws / "checkpoints")) for p in (ws / "checkpoints").rglob("*.pt"))
        if files != [f"{ckpt.name}/model.pt", f"{ckpt.name}/train_state.pt", f"{ckpt.name}_ema/model.pt"]:
            raise AssertionError(f"run A wrote checkpoint files {files}")
        saves = res_a["saves"]

        # round trip: the checkpoint into a fresh state, bit for bit the command's
        live, live_gen = res_a["state"], res_a["gen"]
        t0 = time.perf_counter()
        with dev:
            module = MoGeV2(**cfg["model"])
        fresh = init_train_state(module, build_optimizer(module, cfg["optimizer"], cfg["lr_scheduler"]))
        fresh_gen = torch.Generator(device=dev)
        load_train_checkpoint(ckpt, fresh, fresh_gen)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        trip = state_distance(train_state_tensors(live, live_gen), train_state_tensors(fresh, fresh_gen))
        log(f"[train_cli] checkpoint {ckpt.name} loaded into a fresh state in {resume_s:.2f} s: bit-identical "
            f"{trip['identical']} (params, AdamW moments and steps, EMA, update count {fresh.optimizer.count}, "
            f"learning rates {fresh.optimizer.lrs()}, generator state)")
        if not trip["identical"]:
            raise AssertionError(f"checkpoint round trip differs: {trip}")

        # the card's spread: one step on a fixed batch, repeated from one state
        with TrainDataLoaderPipeline(cfg["data"], TRAIN_CLI_BATCH, random.Random(SEED + 7), 32) as pipe:
            batch = batch_to_device(pipe.get(), sorted(cfg["loss"]), dev)
        fixed_hw = list(batch["image"].shape[1:3])
        label_types = sorted(cfg["loss"])

        fixed_ms = []  # the same step with no loader running

        def step(state, gen):
            train_step = make_train_step(state.module, state.optimizer, cfg["loss"], label_types, RESUME_TOKENS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch, gen)
            ok = float(metrics["grads_ok"])
            torch.cuda.synchronize()
            fixed_ms.append((time.perf_counter() - t0) * 1e3)
            if ok != 1.0:
                raise AssertionError("the fixed batch's step skipped its update")
            return train_state_tensors(state, gen)

        snap = snapshot_train_state(live, live_gen)
        out = step(live, live_gen)
        first = {"tensors": {k: v.clone() for k, v in out["tensors"].items()}, "scalars": out["scalars"]}
        spread = []
        for _ in range(RESUME_REPEATS):
            restore_train_state(live, live_gen, snap)
            spread.append(state_distance(first, step(live, live_gen)))
        resumed = state_distance(first, step(fresh, fresh_gen))
        worst = {p: max(d["l2"][p] for d in spread) for p in resumed["l2"]}
        if all(d["identical"] for d in spread):
            norm = {p: max(sum(v.double().square().sum().item() for k, v in first["tensors"].items()
                               if k.split(".")[0] == p) ** 0.5, 1e-30) for p in worst}
            case = f"spread 0 (the repeats bit-identical): resumed within {RESUME_RTOL} relative L2"
            ok = all(resumed["l2"][p] <= RESUME_RTOL * norm[p] for p in worst)
        else:
            case = f"spread > 0: resumed within {RESUME_MARGIN} x the largest of {RESUME_REPEATS} repeats"
            ok = all(resumed["l2"][p] <= RESUME_MARGIN * worst[p] for p in worst)
        log(f"[train_cli] step {TRAIN_CLI_STEPS} on a fixed batch of {fixed_hw} at {RESUME_TOKENS} tokens (ms, no "
            f"loader running: {[round(t, 1) for t in fixed_ms]}): L2 distance to the "
            f"uninterrupted step, repeats {[d['l2'] for d in spread]} (bit-identical {[d['identical'] for d in spread]}), "
            f"resumed {resumed['l2']} (bit-identical {resumed['identical']}); {case}: {ok}")
        if not ok:
            raise AssertionError(f"the resumed step is outside the card's spread: {resumed['l2']} vs {worst}")
        # the same step once more while a fresh loader fills its queues: its 12 threads share the host
        with TrainDataLoaderPipeline(cfg["data"], TRAIN_CLI_BATCH, random.Random(SEED + 8), 32):
            step(live, live_gen)
        filling_ms = fixed_ms.pop()
        log(f"[train_cli] the fixed batch's step while a loader fills its queues: {filling_ms:.1f} ms (alone "
            f"{statistics.median(fixed_ms):.1f})")
        del live, fresh, module, first, out, snap, batch, res_a
        torch.cuda.empty_cache()

        # the checkpoint's model.pt is an inference checkpoint
        model = MoGeModel.from_pretrained(ckpt / "model.pt", device=DEVICE, dtype=torch.bfloat16)
        image = torch.rand(GIANT_HW, GIANT_HW, 3, generator=torch.Generator().manual_seed(SEED)).to(dev)
        out = model.infer(image, num_tokens=1369)
        if out["depth"].shape != (GIANT_HW, GIANT_HW) or not torch.isfinite(out["intrinsics"]).all():
            raise AssertionError(f"infer from the training checkpoint: {out['depth'].shape}, {out['intrinsics']}")
        del model, out
        torch.cuda.empty_cache()

        res_r, lines_r, wall_r, _, micro_r = run_train_cli(config_path, ws, expect, 1, "resume (--checkpoint latest)",
                                                           "--num_iterations", str(TRAIN_CLI_STEPS + 1),
                                                           "--checkpoint", "latest")
        if [x["step"] for x in lines_r] != [TRAIN_CLI_STEPS] or res_r["state"].optimizer.count != TRAIN_CLI_STEPS + 1:
            raise AssertionError(f"resume ran steps {[x['step'] for x in lines_r]}, "
                                 f"{res_r['state'].optimizer.count} updates")
        saves += res_r["saves"]
        del res_r
        shutil.rmtree(ws)
        torch.cuda.empty_cache()

        res_b, lines_b, wall_b, peak_b, micro_b = run_train_cli(config_path, tmp / "run_b", expect, 2,
                                                                "run B (accumulation 2)", "--num_iterations", "2",
                                                                "--save_every", "1000")
        if res_b["state"].optimizer.count != 2:
            raise AssertionError(f"run B took {res_b['state'].optimizer.count} optimizer steps, not 2")
        saves += res_b["saves"]
        del res_b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    lines = lines_a + lines_r + lines_b
    kinds = {lt for x in lines for b in x["label_types"] for lt in b if lt != "invalid"}
    sizes = {tuple(hw) for x in lines for hw in x["sizes"]}
    if len(kinds) < 2 or len(sizes) < 2:
        raise AssertionError(f"the batches had label types {kinds} and sizes {sizes}: not mixed")
    # run A's steps after its first two: a run's first steps share the host with the loader's
    # threads filling their queues (their times are reported apart)
    warm = lines_a[2:]
    by_tokens = {}
    for x in warm:
        by_tokens.setdefault(x["num_tokens"], []).append(x)
    stats = {
        "ms_per_step_by_tokens": {n: st.median(1e3 * x["t"] for x in xs) for n, xs in sorted(by_tokens.items())},
        "compute_ms_per_step_by_tokens": {n: st.median(1e3 * (x["t"] - x["data_wait"]) for x in xs)
                                          for n, xs in sorted(by_tokens.items())},
        "first_steps_s": {"run_a": [x["t"] for x in lines_a[:2]], "resume": [x["t"] for x in lines_r],
                          "run_b": [x["t"] for x in lines_b[:1]]},
        "data_wait_s": [x["data_wait"] for x in lines], "step_s": [x["t"] for x in lines],
        "num_tokens": [x["num_tokens"] for x in lines], "sizes": [x["sizes"] for x in lines],
        "accumulation_2_ms_per_step": [1e3 * x["t"] for x in lines_b],
        "peak_gib": {"run_a": peak_a, "run_b": peak_b}, "wall_s": {"run_a": wall_a, "resume": wall_r, "run_b": wall_b},
        "checkpoint_snapshot_s": [x["snapshot_s"] for x in saves], "checkpoint_write_s": [x["write_s"] for x in saves],
        "resume_load_s": resume_s, "resume_case": case, "label_types": sorted(kinds),
        "fixed_batch_step_ms": fixed_ms, "fixed_batch_hw": fixed_hw, "fixed_batch_step_ms_loader_filling": filling_ms,
    }
    log(f"[train_cli] moge-2-vitl-normal batch {TRAIN_CLI_BATCH}, {len(lines)} steps over label types {sorted(kinds)} "
        f"and {len(sizes)} sizes: ms per step by tokens (median of run A's steps after its first two) "
        f"{stats['ms_per_step_by_tokens']}, of it not waiting for data {stats['compute_ms_per_step_by_tokens']}; "
        f"first steps of each run, s {stats['first_steps_s']}; s waiting for data per step "
        f"{stats['data_wait_s']}; accumulation 2: ms per step {stats['accumulation_2_ms_per_step']}; peak "
        f"{peak_a:.2f} / {peak_b:.2f} GiB; checkpoint snapshot s {stats['checkpoint_snapshot_s']}, write s "
        f"{stats['checkpoint_write_s']}; resume load {resume_s:.2f} s ({card})")
    return (expect, micro_a + micro_r + micro_b), stats


def phase_train_v1(card: str):
    """MoGe-1 training through ``cli train`` on the card: v1.json (moge-vitl
    from random weights, bf16 compute, its loss tables) over the synthetic
    datasets under v1's label types, batch 2, TRAIN_V1_STEPS steps and a
    checkpoint at the last; launch counters over the command, per
    micro-batch. The checkpoint's model.pt (and the EMA's) loads into
    ``models.v1.MoGeModel``, whose ``infer``, on a point map of known
    perspective, passes the MoGe-1 gates (``check_moge1_answer``)."""
    import shutil

    import numpy as np
    import torch

    from moge_tpu_torch.models.v1 import MoGeModel, MoGeV1
    from torch_tiny_config import make_points_perspective_v1, write_train_dataset

    root = ROOT / "workspace"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_v1_", dir=root))
    try:
        cfg = json.loads(TRAIN_V1_CONFIG.read_text())
        datasets = write_train_dataset(tmp / "data", n_instances=TRAIN_CLI_INSTANCES, hw=TRAIN_CLI_SRC_HW, seed=SEED)
        for ds, label in zip(datasets, TRAIN_V1_LABELS):
            ds["label_type"] = label
        cfg["data"]["datasets"] = datasets
        config_path = tmp / "train_v1.json"
        config_path.write_text(json.dumps(cfg))
        expect = expected_train_launches(cfg["model"], cfg["loss"], version="v1")
        res, lines, wall_s, peak_gib, micro = run_train_cli(
            config_path, tmp / "ws", expect, 1, "MoGe-1 (v1.json)", "--num_iterations", str(TRAIN_V1_STEPS),
            path="train_v1")
        if not isinstance(res["state"].module, MoGeV1):
            raise AssertionError(f"train on v1.json built {type(res['state'].module).__name__}, not MoGeV1")
        del res
        torch.cuda.empty_cache()
        ckpt = tmp / "ws" / "checkpoints" / str(TRAIN_V1_STEPS - 1)
        image = torch.from_numpy(np.random.default_rng(SEED + 9).uniform(0, 1, (518, 518, 3)).astype(np.float32))
        fxs = {}
        for name in (ckpt.name, ckpt.name + "_ema"):
            model = MoGeModel.from_pretrained(ckpt.with_name(name) / "model.pt", device=DEVICE, dtype=torch.bfloat16)
            make_points_perspective_v1(model.module, focal=MOGE1_FOCAL)
            out = model.infer(image.to(DEVICE))
            fxs[name] = check_moge1_answer(model, image.to(DEVICE), out, f"train_v1 checkpoint {name} 518x518", {})
            del model, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    stats = {"step_s": [x["t"] for x in lines], "num_tokens": [x["num_tokens"] for x in lines],
             "sizes": [x["sizes"] for x in lines], "label_types": [x["label_types"] for x in lines],
             "total": [x["total"] for x in lines], "wall_s": wall_s, "peak_gib": peak_gib, "checkpoint_fx": fxs}
    log(f"[train_v1] moge-vitl on v1.json: steps (tokens, sizes, label types, s, loss) "
        + "; ".join(f"{x['num_tokens']} {x['sizes']} {x['label_types']} {x['t']:.3f} {x['total']:.4f}" for x in lines)
        + f"; peak {peak_gib:.2f} GiB; the checkpoint's infer fx {fxs} ({card})")
    return (expect, micro), stats


def parallel_config(tmp: Path) -> Path:
    """TRAIN_CONFIG (v2.json: moge-2-vitl-normal) over the synthetic
    datasets, with each label type's losses cut to PARALLEL_LOSSES (the
    global, edge and mask losses: no random draw) and TRAIN_CLI_LOW_RES
    low-resolution steps. Returns the written config's path."""
    from torch_tiny_config import write_train_dataset

    cfg = json.loads(TRAIN_CONFIG.read_text())
    cfg["data"]["datasets"] = write_train_dataset(tmp / "data", n_instances=TRAIN_CLI_INSTANCES,
                                                  hw=TRAIN_CLI_SRC_HW, seed=SEED)
    cfg["loss"] = {lt: {n: spec for n, spec in table.items() if n in PARALLEL_LOSSES}
                   for lt, table in cfg["loss"].items()}
    cfg["low_resolution_training_steps"] = TRAIN_CLI_LOW_RES
    path = tmp / "parallel.json"
    path.write_text(json.dumps(cfg))
    return path


def _digest(t) -> str:
    """A digest of a CPU tensor's bytes."""
    import hashlib

    import torch

    return hashlib.blake2b(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()).hexdigest()


def train_rank_worker() -> None:
    """One rank of a multi-process ``train`` run (run as ``python3 -c
    "import chip_smoke; chip_smoke.train_rank_worker()" <out> <rank> <world>
    <rendezvous> <path> <device type> <backend> <train args...>``): a
    process group of <backend> at the file rendezvous (gloo with CUDA
    tensors for ranks sharing one card, NCCL for one card per rank), on
    card <rank> modulo the host's cards, ``cli train --multihost`` in
    process (``torch_tiny_config.run_train_rank``), the launch counters set
    to 0 just before and read just after, every launch's variant checked.
    Writes to <out> (JSON): the counts, variants, peak memory, the rank's
    own share of the training state in GiB, each step's record, and a
    digest of every tensor of the whole (gathered) state."""
    import torch

    out, rank, world, rendezvous, path, device, backend, *train_args = sys.argv[1:]
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from moge_tpu_torch.parallel.mesh import local
    from torch_tiny_config import run_train_rank

    if device == "cuda":
        torch.cuda.set_device(int(rank) % torch.cuda.device_count())
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    result, whole = run_train_rank(train_args, int(rank), int(world), rendezvous, device=device, backend=backend)
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    micro = len(result["steps"])
    check_variants(path, f"{path} rank {rank}", counts, runs=micro)
    state = result["state"]
    own = [local(p) for p in state.module.parameters()] + [local(e) for e in state.ema_params.values()] + \
        [local(v) for per in state.optimizer.adamw.state.values() for v in per.values() if v.dim() > 0]
    record = {"counts": counts, "micro": micro, "variants": VARIANTS_BY_PATH[path], "wall_s": wall_s,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if device == "cuda" else 0.0,
              "state_gib": sum(t.numel() * t.element_size() for t in own) / 2 ** 30, "steps": result["steps"],
              "digests": {k: _digest(v) for k, v in whole["tensors"].items()},
              "scalars": {k: v for k, v in whole["scalars"].items() if k != "gen"}}
    Path(out).write_text(json.dumps(record))


def run_ranks(tmp: Path, config_path: Path, jobs: dict, world: int = 2, backend: str = "gloo") -> dict:
    """Multi-process ``train`` runs of ``world`` ranks, a global batch of
    one instance per rank, all jobs at once: for each job (label -> extra
    train args) ``world`` ``train_rank_worker`` processes over a file
    rendezvous of its own, in a ``backend`` group. Each job's records, in
    rank order."""
    code = f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; chip_smoke.train_rank_worker()"
    device = "cuda" if DEVICE.startswith("cuda") else "cpu"
    procs = {}
    for label, extra in jobs.items():
        args = ["--config", str(config_path), "--workspace", str(tmp / label), "--batch_size_forward", str(world),
                "--log_every", "1", "--seed", str(SEED), "--num_iterations", str(PARALLEL_STEPS), "--save_every",
                "1000", *extra]
        procs[label] = [subprocess.Popen([sys.executable, "-c", code, str(tmp / f"{label}_{r}.json"), str(r),
                                          str(world), f"file://{tmp / (label + '.rendezvous')}", f"train_{label}",
                                          device, backend, *args], cwd=str(ROOT)) for r in range(world)]
    every = [p for ps in procs.values() for p in ps]
    try:
        for p in every:
            p.wait(timeout=PARALLEL_TIMEOUT)
    finally:
        for p in every:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = {label: [p.returncode for p in ps] for label, ps in procs.items() if any(p.returncode for p in ps)}
    if failed:
        raise AssertionError(f"ranks exited with {failed}")
    return {label: [json.loads((tmp / f"{label}_{r}.json").read_text()) for r in range(world)] for label in jobs}


def check_ranks(label: str, ranks: list, expect: dict) -> list:
    """A multi-process run's gates: every rank's launches the expected
    count per micro-batch, and the ranks' whole states (FSDP's gathered)
    equal tensor for tensor. Records the run's variants under
    ``train_<label>``; returns each rank's wall s, peak and own state GiB,
    step seconds and losses."""
    for r, rec in enumerate(ranks):
        want = {k: v * rec["micro"] for k, v in expect.items()}
        if rec["counts"] != want:
            raise AssertionError(f"train_{label} rank {r}: launches {rec['counts']}, expected {want}")
    VARIANTS_BY_PATH[f"train_{label}"] = ranks[0]["variants"]
    for rec in ranks[1:]:
        differ = [k for k, d in ranks[0]["digests"].items() if rec["digests"].get(k) != d]
        if differ or ranks[0]["digests"].keys() != rec["digests"].keys() or ranks[0]["scalars"] != rec["scalars"]:
            raise AssertionError(f"train_{label}: the ranks' states differ in {len(differ)} tensors, e.g. "
                                 f"{differ[:3]}, or in {ranks[0]['scalars']} vs {rec['scalars']}")
    return [{k: rec[k] for k in ("wall_s", "peak_gib", "state_gib")} |
            {"step_s": [x["t"] for x in rec["steps"]], "total": [x["total"] for x in rec["steps"]]}
            for rec in ranks]


def checkpoint_tensors(workspace: Path) -> dict:
    """The parameters and EMA of a parallel run's last checkpoint (rank 0
    wrote it), in ``state_distance``'s form, on the card (where the
    distances' float64 sums take milliseconds, not the host's seconds)."""
    import torch

    ckpt = workspace / "checkpoints" / str(PARALLEL_STEPS - 1)
    named = {f"model.{k}": v for k, v in torch.load(ckpt / "model.pt", weights_only=True,
                                                    map_location=DEVICE)["model"].items()}
    ema = torch.load(ckpt.with_name(ckpt.name + "_ema") / "model.pt", weights_only=True, map_location=DEVICE)["model"]
    named.update({f"ema.{k}": v for k, v in ema.items()})
    return {"tensors": named, "scalars": {}}


def split_reference(config_path: Path) -> dict:
    """One process's PARALLEL_STEPS steps on the global batches the
    parallel runs see (the command's sampler and seeds, its token count of
    the low-resolution steps), each step's global batch taken as two
    micro-batches of one instance (``train_iteration``'s mean of their
    gradients): the ranks' arithmetic without the collectives. Its
    parameters and EMA, in ``state_distance``'s form, on the card."""
    import torch

    from moge_tpu_torch.models.io import _ema_state_dict
    from moge_tpu_torch.models.v2 import MoGeV2
    from moge_tpu_torch.parallel.mesh import shard_batch
    from moge_tpu_torch.scripts.train import batch_to_device, train_iteration
    from moge_tpu_torch.train.dataloader import TrainDataLoaderPipeline
    from moge_tpu_torch.train.step import init_train_state, make_apply_step, make_grad_step
    from moge_tpu_torch.train.utils import build_optimizer

    cfg = json.loads(config_path.read_text())
    label_types = sorted(cfg["loss"])
    dev = torch.device(DEVICE)
    with dev:
        module = MoGeV2(**cfg["model"]).init_random(seed=SEED)
    tx = build_optimizer(module, cfg["optimizer"], cfg["lr_scheduler"])
    state, apply_step = init_train_state(module, tx), make_apply_step(tx)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with TrainDataLoaderPipeline(dict(cfg["data"]), TRAIN_CLI_BATCH, random.Random(SEED), image_size_quantum=32) as pipe:
        for _ in range(PARALLEL_STEPS):
            while True:
                batch_np = pipe.get()
                if not all(lt == "invalid" for lt in batch_np["label_type"]):
                    break
            batch = batch_to_device(batch_np, label_types, dev)
            halves = iter([shard_batch(batch, i, TRAIN_CLI_BATCH) for i in range(TRAIN_CLI_BATCH)])
            grad_step = make_grad_step(module, cfg["loss"], label_types,
                                       cfg["model"].get("num_tokens_range", [1200, 3600])[0], torch.bfloat16)
            state, record, _ = train_iteration(state, grad_step, apply_step, lambda: next(halves), TRAIN_CLI_BATCH,
                                               gen)
            if record["grads_ok"] != 1.0:
                raise AssertionError("the split reference skipped an update")
    named = {f"model.{k}": v.detach() for k, v in module.state_dict().items()}
    named.update({f"ema.{k}": v.detach() for k, v in _ema_state_dict(module.state_dict(), state.ema_params).items()})
    del module, state, tx
    torch.cuda.empty_cache()
    return {"tensors": named, "scalars": {}}


def phase_parallel(card: str):
    """The training command's parallel paths at full width on this one card:
    v2.json's moge-2-vitl-normal over the synthetic datasets under a loss
    table that draws nothing (``parallel_config``), a global batch of 2
    for PARALLEL_STEPS steps. Two single-process runs (their difference is
    the card's spread), and the split reference (``split_reference``: the
    same steps in one process, each global batch as two micro-batches of
    one instance, the ranks' arithmetic without their collectives).
    ``train_nccl``: one rank of an NCCL group (``--multihost
    --num_processes 1``), whose gradient all-reduce, one per step, must go
    through the NCCL group with the gradients on the card. ``train_fsdp``:
    the same NCCL rank with the sharded code path on (``Parallel.join``'s
    ``shard``: FSDP2 units over a shard group of one, the DTensor
    optimizer, clip and EMA, the checkpoint gathered by DTensor): DTensor's
    gathers run on the functional collectives, which crash over gloo with
    CUDA tensors, so two sharded ranks cannot share this card (the
    multi-card check, ``phase_cards``, and the CPU tests run them).
    ``train_dp``: two ranks on the card over gloo with CUDA tensors (NCCL
    refuses two ranks on one device), each in its own process. Gates:
    launches per rank and micro-batch, every one on its Hopper variant; the
    sharded run's parameters all DTensors; the DP ranks' whole states equal
    tensor for tensor; the parameters and EMA of the NCCL and FSDP runs (a
    batch of 2 in one forward) within RESUME_MARGIN times the spread of the
    first single-process run, the spread the largest distance among the
    single-process runs and the other one-rank run, and of the DP run (a
    batch of 1 per forward: bf16 GEMMs of another shape round apart) of the
    split reference, the spread the largest distance among the
    single-process and NCCL runs (RESUME_RTOL relative when the spread is
    0); the split reference's
    distance to the single-process run is reported. Peak memory per rank
    and each rank's share of the training state are reported; the gloo
    run's step times stage every gradient through host memory and are no
    measure of NCCL."""
    import contextlib
    import shutil
    import socket
    from unittest import mock

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from moge_tpu_torch.parallel.distributed import Parallel
    from moge_tpu_torch.parallel.mesh import local

    root = ROOT / "workspace"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_", dir=root))
    launches, stats = {}, {}
    on_card = DEVICE.startswith("cuda")  # a CPU rehearsal's one rank is gloo's
    seconds, t0 = {}, time.perf_counter()

    def lap(name):  # seconds since the last lap, by part of the phase
        nonlocal t0
        seconds[name], t0 = time.perf_counter() - t0, time.perf_counter()

    try:
        config_path = parallel_config(tmp)
        cfg = json.loads(config_path.read_text())
        expect = expected_train_launches(cfg["model"], cfg["loss"])
        common = ["--num_iterations", str(PARALLEL_STEPS), "--save_every", "1000"]
        singles = []
        for i in range(2):
            res, lines, wall_s, peak_gib, micro = run_train_cli(config_path, tmp / f"single_{i}", expect, 1,
                                                                f"single process, run {i}", *common,
                                                                path="train_single")
            singles.append({"step_s": [x["t"] for x in lines], "total": [x["total"] for x in lines],
                            "peak_gib": peak_gib, "wall_s": wall_s})
            del res
            torch.cuda.empty_cache()
        launches["train_single"] = (expect, 2 * micro)
        stats["single"] = singles
        lap("single")

        all_reduce, join = dist.all_reduce, Parallel.join
        for label, shard in (("nccl", False), ("fsdp", True)):
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            calls = []

            def recorded(tensor, *args, **kwargs):  # every all-reduce: its group's backend, device, size
                group = kwargs.get("group", args[1] if len(args) > 1 else None)
                calls.append((dist.get_backend(group), tensor.device.type, tensor.numel()))
                return all_reduce(tensor, *args, **kwargs)

            sharded = mock.patch.object(Parallel, "join", staticmethod(
                lambda fsdp, device: join(fsdp, device, shard=True))) if shard else contextlib.nullcontext()
            dist.all_reduce = recorded
            try:
                with sharded, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    res, lines, wall_s, peak_gib, micro = run_train_cli(
                        config_path, tmp / label, expect, 1, f"{label}, one NCCL rank", *common, "--multihost",
                        "--coordinator", f"localhost:{port}", "--num_processes", "1", "--process_id", "0",
                        path=f"train_{label}")
            finally:
                dist.all_reduce = all_reduce
            state = res["state"]
            params = list(state.module.parameters())
            trainable = sum(p.numel() for p in params if p.requires_grad)
            n_sharded = sum(isinstance(p, DTensor) for p in params)
            if n_sharded != (len(params) if shard else 0):
                raise AssertionError(f"train_{label}: {n_sharded} of {len(params)} parameters sharded")
            own = [local(t) for t in params + list(state.ema_params.values())] + \
                [local(v) for per in state.optimizer.adamw.state.values() for v in per.values() if v.dim() > 0]
            state_gib = sum(t.numel() * t.element_size() for t in own) / 2 ** 30
            del res, state, params, own
            torch.cuda.empty_cache()
            nccl = {e.key: e.count for e in prof.key_averages() if "nccl" in e.key.lower()}
            grads = [c for c in calls if c == (("nccl", "cuda") if on_card else ("gloo", "cpu")) + (trainable,)]
            log(f"[train_{label}] all-reduces (backend, device, elements): {calls}; NCCL kernels in the profile "
                f"{nccl}; parameters sharded {n_sharded}; peak {peak_gib:.2f} GiB, own training state "
                f"{state_gib:.2f} GiB")
            if len(grads) != PARALLEL_STEPS:
                raise AssertionError(f"train_{label}: {len(grads)} NCCL all-reduces of the {trainable} gradients "
                                     f"on the card, expected one per step ({PARALLEL_STEPS}); all-reduces {calls}")
            launches[f"train_{label}"] = (expect, micro)
            stats[label] = {"step_s": [x["t"] for x in lines], "total": [x["total"] for x in lines],
                            "peak_gib": peak_gib, "state_gib": state_gib, "wall_s": wall_s, "nccl_kernels": nccl,
                            "all_reduces": calls}
            lap(label)

        ranks = run_ranks(tmp, config_path, {"dp": ()})["dp"]
        stats["dp"] = check_ranks("dp", ranks, expect)
        launches["train_dp"] = (expect, sum(rec["micro"] for rec in ranks))
        log(f"[train_dp] two ranks over gloo on one card: {len(ranks[0]['digests'])} tensors of the whole state "
            f"equal on both ranks; per rank peak {[round(x['peak_gib'], 2) for x in stats['dp']]} GiB, own "
            f"training state {[round(x['state_gib'], 2) for x in stats['dp']]} GiB; step s (gloo rehearsal, "
            f"gradients staged through host memory: not NCCL's) {[x['step_s'] for x in stats['dp']]} ({card})")
        lap("dp")

        # each run's parameters and EMA against a one-process run of the same
        # arithmetic, within RESUME_MARGIN x the card's spread, the largest
        # distance among three other runs of the batch-2 arithmetic (as the
        # resume check takes the largest repeat): NCCL's and FSDP's (one rank,
        # a batch of 2) against the first single-process run, the spread among
        # the two single-process runs and the other one-rank run; DP's (a
        # batch of 1 per rank) against the split reference, the spread among
        # the single-process runs and the NCCL rank's
        runs = {name: checkpoint_tensors(tmp / name) for name in ("single_0", "single_1", "nccl", "fsdp")}
        first = runs["single_0"]
        lap("load")
        split = split_reference(config_path)
        lap("split")

        def widest(names):  # the largest distance among these runs of one arithmetic
            pairs = [state_distance(runs[a], runs[b]) for i, a in enumerate(names) for b in names[i + 1:]]
            return {"l2": {p: max(d["l2"][p] for d in pairs) for p in pairs[0]["l2"]},
                    "identical": all(d["identical"] for d in pairs)}

        spreads = {"nccl": widest(["single_0", "single_1", "fsdp"]), "fsdp": widest(["single_0", "single_1", "nccl"]),
                   "dp": widest(["single_0", "single_1", "nccl"])}
        norm = {p: max(sum(v.double().square().sum().item() for k, v in first["tensors"].items()
                           if k.split(".")[0] == p) ** 0.5, 1e-30) for p in spreads["nccl"]["l2"]}
        stats["spread_l2"] = {label: d["l2"] for label, d in spreads.items()}
        stats["distance_l2"] = {"split_vs_single": state_distance(first, split)["l2"]}
        for label, ref, ref_name in (("nccl", first, "the single-process run"),
                                     ("fsdp", first, "the single-process run"), ("dp", split, "the split reference")):
            run_tensors = runs[label] if label in runs else checkpoint_tensors(tmp / label)
            d, spread = state_distance(ref, run_tensors), spreads[label]
            stats["distance_l2"][label] = d["l2"]
            stats["distance_l2"][f"{label}_vs_single"] = state_distance(first, run_tensors)["l2"]
            if spread["identical"]:
                ok = all(d["l2"][p] <= RESUME_RTOL * norm[p] for p in norm)
            else:
                ok = all(d["l2"][p] <= RESUME_MARGIN * spread["l2"][p] for p in norm)
            log(f"[train_{label}] parameters and EMA after {PARALLEL_STEPS} steps, L2 distance to {ref_name} "
                f"{d['l2']} (bit-identical {d['identical']}; to the single-process run "
                f"{stats['distance_l2'][f'{label}_vs_single']}); the card's spread {spread['l2']} (bit-identical "
                f"{spread['identical']}): within {RESUME_MARGIN} x the spread: {ok}")
            if not ok:
                raise AssertionError(f"train_{label}: {d['l2']} off {ref_name}, spread {spread['l2']}")
        log(f"[parallel] the split reference (a batch of 1 per forward) off the single-process run (a batch of 2): "
            f"{stats['distance_l2']['split_vs_single']}")
        lap("distances")
        stats["seconds"] = seconds
        log(f"[parallel] seconds by part: {seconds}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[parallel] step s: single process {[x['step_s'] for x in stats['single']]}, NCCL one rank "
        f"{stats['nccl']['step_s']}, FSDP one NCCL rank {stats['fsdp']['step_s']}; peak GiB: single "
        f"{[round(x['peak_gib'], 2) for x in stats['single']]}, NCCL {stats['nccl']['peak_gib']:.2f}, FSDP "
        f"{stats['fsdp']['peak_gib']:.2f}, DP per rank {[round(x['peak_gib'], 2) for x in stats['dp']]} ({card})")
    return launches, stats


def phase_cards(card: str, fsdps=(1, 2, 4)):
    """The training command's parallel paths over every card of this host
    by NCCL (``python3 chip_smoke.py --cards``, on a host with several
    cards; the one-card run does not take this phase): ``parallel_config``,
    a global batch of one instance per card, PARALLEL_STEPS steps. Two
    one-card runs on card 0 (one process, the global batch in one forward:
    their distance is the card's spread), then one process per card
    (``train_rank_worker`` in an NCCL group) at each ``--fsdp`` of
    ``fsdps`` that divides the card count, one run at a time. Gates:
    launches per rank and micro-batch on Hopper variants, the ranks' whole
    states equal, and each sharded run's parameters and EMA within
    RESUME_MARGIN times the spread of the ``--fsdp 1`` run's (the same
    arithmetic on each card, other collectives). Reports per rank peak
    memory, own share of the training state and step seconds, and the
    distances."""
    import shutil

    import torch

    cards = torch.cuda.device_count()
    if cards < 2:
        raise SystemExit(f"--cards needs several cards, this host has {cards}")
    root = ROOT / "workspace"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cards_", dir=root))
    stats = {"cards": cards}
    try:
        config_path = parallel_config(tmp)
        cfg = json.loads(config_path.read_text())
        expect = expected_train_launches(cfg["model"], cfg["loss"])
        for i in range(2):
            _, lines, wall_s, peak_gib, _ = run_train_cli(
                config_path, tmp / f"one_card_{i}", expect, 1, f"one card, run {i}", "--num_iterations",
                str(PARALLEL_STEPS), "--save_every", "1000", "--batch_size_forward", str(cards), path="train_single")
            stats[f"one_card_{i}"] = {"step_s": [x["t"] for x in lines], "total": [x["total"] for x in lines],
                                      "peak_gib": peak_gib, "wall_s": wall_s}
            torch.cuda.empty_cache()
        spread = state_distance(*(checkpoint_tensors(tmp / f"one_card_{i}") for i in range(2)))
        stats["spread_l2"] = spread["l2"]
        runs = [f for f in fsdps if cards % f == 0]
        for f in runs:
            ranks = run_ranks(tmp, config_path, {f"cards_fsdp{f}": ("--fsdp", str(f))}, world=cards,
                              backend="nccl")[f"cards_fsdp{f}"]
            stats[f"fsdp{f}"] = check_ranks(f"cards_fsdp{f}", ranks, expect)
            log(f"[cards] {cards} NCCL ranks at --fsdp {f}: per rank peak "
                f"{[round(x['peak_gib'], 2) for x in stats[f'fsdp{f}']]} GiB, own training state "
                f"{[round(x['state_gib'], 3) for x in stats[f'fsdp{f}']]} GiB, step s "
                f"{[x['step_s'] for x in stats[f'fsdp{f}']]} ({card})")
        first = checkpoint_tensors(tmp / f"cards_fsdp{runs[0]}")
        stats["distance_l2"], ok = {}, True
        for f in runs[1:]:
            d = state_distance(first, checkpoint_tensors(tmp / f"cards_fsdp{f}"))
            stats["distance_l2"][f"fsdp{f}"] = d["l2"]
            ok &= all(d["l2"][p] <= RESUME_MARGIN * spread["l2"][p] for p in d["l2"])
        stats["distance_l2"]["one_card"] = state_distance(first, checkpoint_tensors(tmp / "one_card_0"))["l2"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[cards] parameters and EMA, L2 distance to --fsdp {runs[0]}: {stats['distance_l2']}; the card's spread "
        f"{stats['spread_l2']}: the sharded runs within {RESUME_MARGIN} x the spread: {ok}")
    if not ok:
        raise AssertionError(f"--cards: {stats['distance_l2']} off --fsdp {runs[0]}, spread {stats['spread_l2']}")
    return stats


def giant_config() -> dict:
    """moge-2-vitl-normal on the giant DINOv2 (dinov2_vitg14, its layers 9,
    19, 29 and 39), the scale head reading its 1536-wide cls token."""
    from moge_tpu_torch.models.presets import get_preset

    cfg = get_preset("moge-2-vitl-normal")["config"]
    cfg["encoder"].update(backbone="dinov2_vitg14", intermediate_layers=[9, 19, 29, 39])
    cfg["scale_head"]["dims"][0] = 1536
    return cfg


def phase_giant(card: str):
    """The giant arch through ``MoGeModel.infer``: random weights from SEED,
    bf16, GIANT_HW^2 at GIANT_TOKENS tokens, batch 1; a warm-up, one counted
    run (launches, variants, keys, shapes, finiteness), then warm latency and
    peak memory."""
    import numpy as np
    import torch

    from moge_tpu_torch.models.v2 import MoGeModel

    cfg = giant_config()
    expect = expected_launches(cfg)
    t0 = time.perf_counter()
    model = MoGeModel(cfg, device=DEVICE, dtype=torch.bfloat16).init_random(seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = sum(p.numel() for p in model.module.parameters())
    rng = np.random.default_rng(SEED + 5)
    image = torch.from_numpy(rng.uniform(0, 1, (GIANT_HW, GIANT_HW, 3)).astype(np.float32)).to(DEVICE)
    model.infer(image, num_tokens=GIANT_TOKENS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = model.infer(image, num_tokens=GIANT_TOKENS)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if counts != expect:
        raise AssertionError(f"giant infer: launches {counts}, expected {expect}")
    variants = check_variants("giant", "giant infer", counts)
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    h = w = GIANT_HW
    want = {"points": (h, w, 3), "depth": (h, w), "intrinsics": (3, 3), "mask": (h, w), "normal": (h, w, 3)}
    mask = out["mask"]
    if shapes != want or not torch.isfinite(out["intrinsics"]).all() or \
            not torch.isfinite(out["depth"][mask]).all() or not torch.isfinite(out["points"][mask]).all():
        raise AssertionError(f"giant infer: shapes {shapes} (expected {want}), or non-finite output")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.infer(image, num_tokens=GIANT_TOKENS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    stats = {"params": params, "init_s": init_s, "ms": statistics.median(times), "ms_all": times,
             "peak_gib": peak_gib}
    log(f"[giant] moge-2 on dinov2_vitg14, {params} parameters (init {init_s:.1f} s), {h}x{w} at {GIANT_TOKENS} "
        f"tokens bf16: mask {mask.float().mean().item():.3f} of pixels, launches {counts}, variants {variants}, warm "
        f"median {stats['ms']:.2f} ms of {[round(t, 2) for t in times]}, peak {peak_gib:.2f} GiB ({card})")
    del model
    torch.cuda.empty_cache()
    return (expect, 1), stats


def phase_vis_data():
    """``cli vis_data --ply`` on one synthetic training instance (SynthA,
    480x640, inf sky and a NaN hole): the PLY holds one vertex per finite
    depth pixel nearer than VIS_MAX_DEPTH times the nearest (the card host
    has no matplotlib, so no colorized depth)."""
    import numpy as np

    from moge_tpu_torch.scripts import cli
    from moge_tpu_torch.utils.io import read_depth
    from torch_tiny_config import write_train_dataset

    with tempfile.TemporaryDirectory() as tmp:
        ds = write_train_dataset(Path(tmp) / "data", n_instances=1, hw=(480, 640), seed=SEED)[0]
        folder = Path(ds["path"]) / "instance_0"
        out = Path(tmp) / "out"
        cli.command().main(["vis_data", str(folder), "--ply", "-m", str(VIS_MAX_DEPTH), "-o", str(out)],
                           standalone_mode=False)
        header = (out / "pointcloud.ply").read_bytes().split(b"end_header\n")[0].decode()
        got = int(header.split("element vertex ")[1].split()[0])
        depth = read_depth(folder / "depth.png")
        finite = np.isfinite(depth)
        want = int((finite & (depth < depth[finite].min() * VIS_MAX_DEPTH)).sum())
        files = sorted(p.name for p in out.iterdir())
    log(f"[vis_data] {folder.name} 480x640: {files}, {got} vertices, {want} finite depth pixels nearer than "
        f"{VIS_MAX_DEPTH} x the nearest ({int(finite.sum())} finite)")
    if got != want or files != ["pointcloud.ply"] or not 0 < want < finite.sum():
        raise AssertionError(f"vis_data: {got} vertices, {want} expected, files {files}")


def sp_kernel_cases() -> tuple:
    """K1 and K2 at the sequence-parallel shapes (SP_K2_SHAPES). K1 on each
    shape's batch x chunk rows at ViT-L's width (``layer_norm_case``). K2
    with q a (B, chunk, H, 64) view of one rank's qkv and k, v views of the
    keys and values as ``gather_tokens`` joins them (a view of the
    (ranks, B, chunk, 2, H, 64) buffer for B = 1, a copy for B > 1), the
    padding keys masked by ``kv_valid`` (random values, so that a key let
    through shows); against the plain version within K2_MAX_ABS /
    K2_LSE_ABS, times beside SDPA on the real keys. Returns the K1 and the
    K2 cases in phase 3's form."""
    import torch

    from moge_tpu_torch.ops import attention

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows = sorted({batch * -(-n_total // sp) for n_total, sp, batch in SP_K2_SHAPES})
    k1 = [layer_norm_case(gen, m, 1024, label="K1 sp") for m in rows]
    heads, k2 = 16, []
    for n_total, sp, batch in SP_K2_SHAPES:
        chunk = -(-n_total // sp)
        qkv = torch.randn(batch, chunk, 3, heads, 64, generator=gen, device=dev).to(torch.bfloat16)
        qkv[:, :, 0] *= 2  # sharper softmax than unit logits
        kv = torch.randn(sp, batch, chunk, 2, heads, 64, generator=gen, device=dev).to(torch.bfloat16)
        kv = kv.transpose(0, 1).flatten(1, 2)
        q, k, v = qkv[:, :, 0], kv[:, :, 0], kv[:, :, 1]
        before = read_variants("flash_attention")["wgmma"]
        got, got_lse = attention.flash_attention_fwd(q, k, v, n_total)
        label = f"{n_total} tokens over {sp} ranks, batch {batch}"
        if read_variants("flash_attention")["wgmma"] != before + 1:
            raise AssertionError(f"K2 at the SP shape {label} did not launch the wgmma kernel")
        want, want_lse = attention.attention_plain(q.float(), k.float(), v.float(), n_total, return_lse=True)
        err = (got.float() - want).abs().max().item()
        lse_err = (got_lse - want_lse).abs().max().item()
        ms, plain_ms, lib_ms, dev_ms = attention_times(q, k, v, n_total)
        bnd = bound(torch.bfloat16, flops=4 * batch * heads * chunk * n_total * 64, mufu=batch * heads * chunk * n_total,
                    bytes_moved=2 * batch * heads * 64 * 2 * (chunk + n_total) + batch * heads * chunk * 4)
        log(f"[K2 sp] {label}: Nq {chunk}, Nkv {sp * chunk}, kv_valid {n_total}: "
            f"max_abs_err {err:.3e} (tol {K2_MAX_ABS}), lse max_abs_err {lse_err:.3e} (tol {K2_LSE_ABS}), "
            f"{conv_times_text(ms, plain_ms, lib_ms, dev_ms, 'SDPA flash')}; bound {bnd[0]:.4f} ms ({bnd[1]})")
        if not err <= K2_MAX_ABS or not lse_err <= K2_LSE_ABS:
            raise AssertionError(f"K2 at the SP shape {label} disagrees: {err}, lse {lse_err}")
        k2.append((err, ms, plain_ms, lib_ms, bnd, dev_ms))
    return k1, k2


def serve_through_leader(model, images, hw: int, num_tokens: int) -> tuple:
    """The server on rank 0 of an SP group: ``create_server`` over a
    ``Leader`` of ``model`` at ``hw``^2 and ``num_tokens``, ``images``
    (uint8) posted as PNG over HTTP from SP_CLIENTS threads (every map, as
    npz), then the leader's stop. Returns the batcher's stats and the
    answers."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from moge_tpu_torch.parallel.sp import Leader
    from moge_tpu_torch.scripts.serve import create_server
    from torch_tiny_config import png_bytes, post_npz

    leader = Leader(model)
    server, batcher = create_server(leader, "127.0.0.1", 0, hw, hw, num_tokens, max_batch=SP_CLIENTS,
                                    max_wait_ms=50.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SP_CLIENTS) as pool:
            answers = list(pool.map(lambda im: post_npz(url, png_bytes(im)), images))
        wall_s = time.perf_counter() - t0
        stats = dict(batcher.stats)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
        leader.stop()
    stats["requests_per_s"] = len(images) / wall_s
    return stats, answers


def sp_rank_worker() -> None:
    """One rank of the sequence-parallel run (run as ``python3 -c "import
    chip_smoke; chip_smoke.sp_rank_worker()" <out dir> <rank> <world>
    <rendezvous> <backend> <device type>``; the job is <out
    dir>/job.json): a process group of <backend> (gloo for ranks sharing
    one card, NCCL for one card per rank) on card <rank> modulo the host's
    cards, the job's model from SEED with a point map of known perspective
    (``make_points_perspective``), built with the group as its SP group;
    ``infer`` at each of the job's token counts with the launch counters
    set to 0 just before and read just after (every launch's variant
    checked), SP_REPEATS warm calls timed; rank 0 also holds the same
    weights without a group (one process), answers the same requests and is
    timed alone while the others wait; with the job's ``requests``, rank 0
    serves them through a ``Leader`` while the others ``follow``, launches
    counted over the batches. Writes rank<r>.json (launches per run, runs,
    variants, times, errors against one process) and rank<r>_<tokens>.pt
    (the answers)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    global DEVICE
    out_dir, rank, world, rendezvous, backend, device_type = sys.argv[1:]
    out_dir, rank, world = Path(out_dir), int(rank), int(world)
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from moge_tpu_torch.models.v2 import MoGeModel
    from moge_tpu_torch.parallel.sp import follow
    from torch_tiny_config import make_points_perspective

    if device_type == "cuda":
        DEVICE = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(DEVICE)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        DEVICE = "cpu"
    job = json.loads((out_dir / "job.json").read_text())
    dist.init_process_group(backend, init_method=rendezvous, world_size=world, rank=rank)
    try:
        model = MoGeModel(job["config"], device=DEVICE, dtype=torch.bfloat16, batched_heads=False,
                          sp_group=dist.group.WORLD).init_random(seed=SEED)
        make_points_perspective(model.module)
        single = None
        if rank == 0:
            single = MoGeModel(job["config"], device=DEVICE, dtype=torch.bfloat16, batched_heads=False)
            single.module.load_state_dict(model.module.state_dict(), strict=True)
        rng = np.random.default_rng(SEED + 6)
        record = {"counts": [], "sp_ms": {}, "single_ms": {}, "errs": {}}
        hw = job["hw"]
        for tokens in job["tokens"]:
            image = torch.from_numpy(rng.uniform(0, 1, (hw, hw, 3)).astype(np.float32)).to(DEVICE)
            reset_counts()
            out = model.infer(image, num_tokens=tokens)
            synchronize()
            counts = read_counts()
            check_variants("sp", f"sp rank {rank} at {tokens} tokens", counts)
            record["counts"].append((1, counts))
            torch.save({k: v.cpu() for k, v in out.items()}, out_dir / f"rank{rank}_{tokens}.pt")
            record["sp_ms"][tokens] = wall_ms(lambda: model.infer(image, num_tokens=tokens), SP_REPEATS)
            dist.barrier()
            if rank == 0:
                want = single.infer(image, num_tokens=tokens)
                record["errs"][tokens] = compare_answers(f"sp at {tokens} tokens against one process", out, want)
                record["single_ms"][tokens] = wall_ms(lambda: single.infer(image, num_tokens=tokens), SP_REPEATS)
            dist.barrier()
        if job["requests"]:
            serve_hw, serve_tokens = job["serve_hw"], job["serve_tokens"]
            images = [rng.integers(0, 256, (serve_hw, serve_hw, 3), dtype=np.uint8) for _ in range(job["requests"])]
            reset_counts()
            if rank == 0:
                served, answers = serve_through_leader(model, images, serve_hw, serve_tokens)
                batches = served["batches"]
            else:
                batches = follow(model)
            synchronize()
            counts = read_counts()
            check_variants("sp", f"sp serve rank {rank}", counts, runs=batches)
            record["counts"].append((batches, counts))
            if rank == 0:
                errs = [compare_answers(f"sp serve request {i}", answer,
                                        single.infer(torch.from_numpy(im.astype(np.float32) / 255.0),
                                                     num_tokens=serve_tokens))
                        for i, (im, answer) in enumerate(zip(images, answers))]
                record["serve"] = {**served, "errs": worst(errs)}
        record["variants"] = VARIANTS_BY_PATH["sp"]
        (out_dir / f"rank{rank}.json").write_text(json.dumps(record))
    finally:
        dist.destroy_process_group()


def run_sp_ranks(tmp: Path, world: int, backend: str, requests: int) -> list:
    """``world`` ``sp_rank_worker`` processes over a file rendezvous, in a
    ``backend`` group, on the moge-2-vitl-normal preset at SP_HW^2 and
    SP_TOKENS, ``requests`` served (at SERVE_HW^2, SERVE_TOKENS); every
    rank's record, in rank order, once each rank's launches are the
    preset's per forward (and per batch)."""
    from moge_tpu_torch.models.presets import get_preset

    tmp.mkdir(parents=True, exist_ok=True)
    config = get_preset("moge-2-vitl-normal")["config"]
    (tmp / "job.json").write_text(json.dumps({"config": config, "hw": SP_HW, "tokens": list(SP_TOKENS),
                                              "requests": requests, "serve_hw": SERVE_HW,
                                              "serve_tokens": SERVE_TOKENS}))
    code = f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; chip_smoke.sp_rank_worker()"
    device = "cuda" if DEVICE.startswith("cuda") else "cpu"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp), str(r), str(world),
                               f"file://{tmp / 'rendezvous'}", backend, device], cwd=str(ROOT)) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=SP_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"sp ranks exited with {[p.returncode for p in procs]}")
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
    expect = expected_launches(config)
    for r, rank in enumerate(ranks):
        for runs, counts in rank["counts"]:
            if counts != {k: v * runs for k, v in expect.items()}:
                raise AssertionError(f"sp rank {r}: launches {counts} over {runs} runs, expected {expect} per run")
        rank.update(per_run=expect, runs=sum(runs for runs, _ in rank["counts"]))
    return ranks


def compare_ranks(tmp: Path, world: int) -> dict:
    """Every rank's answers against rank 0's (compare_answers), by token
    count; they must be bit-identical, since every rank runs the decoder on
    the same gathered tokens."""
    import torch

    out = {}
    for tokens in SP_TOKENS:
        first = torch.load(tmp / f"rank0_{tokens}.pt")
        for r in range(1, world):
            other = torch.load(tmp / f"rank{r}_{tokens}.pt")
            errs = compare_answers(f"sp rank {r} against rank 0 at {tokens} tokens", other, first)
            errs["identical"] = all(torch.equal(other[k], first[k]) for k in first)
            if not errs["identical"]:
                raise AssertionError(f"sp rank {r} at {tokens} tokens: answers not bit-identical to rank 0's: {errs}")
            out[f"rank{r}_{tokens}"] = errs
    return out


def phase_sp(card: str):
    """Sequence parallelism on the one card: K1 and K2 at the SP shapes
    (``sp_kernel_cases``), then SP_WORLD gloo ranks
    (``sp_rank_worker``) with the moge-2-vitl-normal preset from SEED: each
    rank's launches per forward and serving batch, its answers against one
    process's and against rank 0's, warm latency, the served requests.
    Returns the K1 and K2 cases, (launches per run, runs over every rank),
    stats."""
    import shutil

    import torch

    t0 = time.perf_counter()
    k1_cases, k2_cases = sp_kernel_cases()
    torch.cuda.empty_cache()
    root = ROOT / "workspace"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sp_", dir=root))
    try:
        ranks = run_sp_ranks(tmp, SP_WORLD, "gloo", SP_REQUESTS)
        rank_errs = compare_ranks(tmp, SP_WORLD)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    VARIANTS_BY_PATH["sp"] = ranks[0]["variants"]
    first = ranks[0]
    stats = {"world": SP_WORLD, "backend": "gloo", "sp_ms": first["sp_ms"], "single_ms": first["single_ms"],
             "errs": first["errs"], "rank_errs": rank_errs, "serve": first["serve"],
             "runs_per_rank": [r["runs"] for r in ranks], "seconds": time.perf_counter() - t0}
    for tokens in SP_TOKENS:
        key = str(tokens)
        log(f"[sp] {SP_WORLD} gloo ranks on one card, {SP_HW}x{SP_HW} at {tokens} tokens: warm median "
            f"{first['sp_ms'][key]:.2f} ms against one process {first['single_ms'][key]:.2f} ms; answers against "
            f"one process {first['errs'][key]} ({card})")
    log(f"[sp] ranks against rank 0: {rank_errs}; served {SP_REQUESTS} requests in {first['serve']['batches']} "
        f"batches, {first['serve']['requests_per_s']:.2f} requests/s, against batch-1 infer {first['serve']['errs']}; "
        f"launches per rank and run {first['per_run']}, runs per rank {stats['runs_per_rank']}; "
        f"phase {stats['seconds']:.1f} s")
    return (k1_cases, k2_cases), (first["per_run"], sum(stats["runs_per_rank"])), stats


def phase_sp_cards(card: str) -> dict:
    """Sequence parallelism across the host's cards (``--cards``): at 2 and
    4 ranks (where the host has them), one NCCL rank per card, infer at
    SP_HW^2 and SP_TOKENS against one process on card 0: warm latency of
    both, the answers compared."""
    import shutil

    import torch

    cards = torch.cuda.device_count()
    stats = {}
    root = ROOT / "workspace"
    root.mkdir(exist_ok=True)
    for world in (w for w in (2, 4) if w <= cards):
        tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_sp{world}_", dir=root))
        try:
            first = run_sp_ranks(tmp, world, "nccl", 0)[0]
            compare_ranks(tmp, world)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        stats[f"sp{world}"] = {k: first[k] for k in ("sp_ms", "single_ms", "errs")}
        log(f"[cards] SP over {world} cards (NCCL): warm median ms by tokens {first['sp_ms']} against one card "
            f"{first['single_ms']} ({card})")
    return stats


def phase_int8(card: str):
    """W8A8 int8 on the card: the product (``torch._int_mm``) against the
    CPU's plain version at the ViT-L projections (INT8_ROWS x INT8_GEMMS:
    int8 operands, scales, int32 accumulators and fp32 outputs identical),
    with times beside the bf16 product; then moge-2-vitl-normal from SEED in
    int8 against bf16 at INT8_RUNS (launches per forward, every product on
    ``_int_mm``, warm medians of both, the last layer's tokens and the
    depth (no mask) within INT8_DRIFT, tests/test_quant.py's bounds); then
    SERVE_REQUESTS through the micro-batcher over the int8 model (with a
    point map of known perspective), each answer against its image's
    batch-1 int8 ``infer`` (``phase_serve``). Returns (launches per run,
    runs), stats."""
    import numpy as np
    import torch

    from moge_tpu_torch.models.dinov2 import VIT_ARCHS
    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel
    from moge_tpu_torch.ops import quant
    from moge_tpu_torch.ops.resize import resize_2d
    from torch_tiny_config import make_points_perspective

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    stats = {"gemms": {}}
    for m in INT8_ROWS:
        for k, n in INT8_GEMMS:
            x = (torch.randn(m, k, generator=gen, device=dev) * 2).to(torch.bfloat16)
            w = torch.randn(n, k, generator=gen, device=dev) * 0.02
            b = torch.randn(n, generator=gen, device=dev) * 0.02
            before = launches_of("int8_product")
            card_side = (*quant.quantize(x), *quant.quantize(w))
            card_side += (quant.int8_product(card_side[0], card_side[2]),
                          quant.quant_matmul(x, w, b, card_side[2:4]))
            if launches_of("int8_product") != before + 2:
                raise AssertionError(f"int8 product at ({m}, {k}) x ({k}, {n}) did not go through _int_mm")
            xc, wc, bc = x.cpu(), w.cpu(), b.cpu()
            cpu_side = (*quant.quantize(xc), *quant.quantize(wc))
            cpu_side += (quant.int8_product(cpu_side[0], cpu_side[2]), quant.quant_matmul(xc, wc, bc, cpu_side[2:4]))
            names = ("x_q", "x_scale", "w_q", "w_scale", "acc", "out")
            differ = [nm for nm, a, c in zip(names, card_side, cpu_side) if not torch.equal(a.cpu(), c)]
            if differ:
                raise AssertionError(f"int8 at ({m}, {k}) x ({k}, {n}): card and CPU differ in {differ}")
            x_q, _, w_q, w_scale = card_side[:4]
            w16 = w.to(torch.bfloat16)
            times = {"int_mm_ms": cuda_ms(lambda: quant.int8_product(x_q, w_q)),
                     "quant_matmul_ms": cuda_ms(lambda: quant.quant_matmul(x, w, b, (w_q, w_scale))),
                     "bf16_linear_ms": cuda_ms(lambda: torch.nn.functional.linear(x, w16))}
            bnd = bound(int8_ops=2 * m * k * n, bytes_moved=m * k + k * n + 4 * m * n)
            stats["gemms"][f"{m}x{k}x{n}"] = {**times, "int_mm_bound_ms": bnd[0], "bound_by": bnd[1]}
            log(f"[int8] ({m}, {k}) x ({k}, {n}): card = CPU in {names}; ms: _int_mm {times['int_mm_ms']:.4f} "
                f"(bound {bnd[0]:.4f}, {bnd[1]}), quant_matmul {times['quant_matmul_ms']:.4f}, bf16 F.linear "
                f"{times['bf16_linear_ms']:.4f} ({card})")
            del x, w, b, card_side, cpu_side, xc, wc, bc, x_q, w_q, w16
    torch.cuda.empty_cache()

    config = get_preset("moge-2-vitl-normal")["config"]
    expect = expected_launches(config)
    per_forward_int8 = 4 * VIT_ARCHS[config["encoder"]["backbone"]].depth  # qkv, proj, fc1, fc2 per block
    bf16 = MoGeModel(config, device=DEVICE, dtype=torch.bfloat16, batched_heads=False).init_random(seed=SEED)
    int8 = MoGeModel(config, device=DEVICE, dtype=torch.bfloat16, batched_heads=False, use_int8=True)
    int8.module.load_state_dict(bf16.module.state_dict(), strict=True)
    rng = np.random.default_rng(SEED + 8)
    runs, stats["infer"] = 0, {}
    for tokens, batch in INT8_RUNS:
        label = f"{SERVE_HW}x{SERVE_HW} num_tokens={tokens} batch={batch}"
        images = torch.from_numpy(rng.uniform(0, 1, (batch, SERVE_HW, SERVE_HW, 3)).astype(np.float32)).to(DEVICE)
        reset_counts()
        out = int8.infer(images, num_tokens=tokens, apply_mask=False)
        synchronize()
        counts, products = read_counts(), launches_of("int8_product")
        if counts != expect or products != per_forward_int8:
            raise AssertionError(f"int8 {label}: launches {counts} and {products} int8 products, expected "
                                 f"{expect} and {per_forward_int8}")
        check_variants("int8", f"int8 {label}", counts)
        runs += 1
        ref = bf16.infer(images, num_tokens=tokens, apply_mask=False)
        d_ref, d_q = ref["depth"].float().cpu().numpy(), out["depth"].float().cpu().numpy()
        fin = np.isfinite(d_ref) & np.isfinite(d_q)
        depth_drift = float(np.median(np.abs(d_q[fin] - d_ref[fin]) / np.maximum(d_ref[fin], 1e-3)))
        base_h = base_w = round(tokens ** 0.5)
        image_14 = resize_2d(images, (base_h * 14, base_w * 14), mode="bilinear", antialias=True)
        with torch.inference_mode():
            x = (image_14 - bf16.module.encoder.image_mean.view(3)) / bf16.module.encoder.image_std.view(3)
            last = [bf16.module.encoder.take_layers[-1]]
            (p_ref, _), = bf16.module.encoder.backbone(x, last, torch.bfloat16)
            (p_q, _), = int8.module.encoder.backbone(x, last, torch.bfloat16)
        token_drift = ((p_q.float() - p_ref.float()).norm() / p_ref.float().norm()).item()
        ms = {"int8_ms": wall_ms(lambda: int8.infer(images, num_tokens=tokens), INT8_REPEATS),
              "bf16_ms": wall_ms(lambda: bf16.infer(images, num_tokens=tokens), INT8_REPEATS)}
        stats["infer"][label] = {**ms, "token_drift": token_drift, "depth_drift": depth_drift,
                                 "finite": float(fin.mean())}
        log(f"[int8] ViT-L {label}: warm median int8 {ms['int8_ms']:.2f} ms, bf16 {ms['bf16_ms']:.2f} ms; drift "
            f"against bf16: last-layer tokens {token_drift:.4f}, depth median {depth_drift:.4f} "
            f"(bound {INT8_DRIFT}), finite {fin.mean():.3f}; launches {counts}, {products} _int_mm ({card})")
        if not (token_drift < INT8_DRIFT and depth_drift < INT8_DRIFT and fin.mean() > 0.9):
            raise AssertionError(f"int8 {label}: drift against bf16 {token_drift} (tokens), {depth_drift} (depth), "
                                 f"finite {fin.mean()}: beyond tests/test_quant.py's bounds")
        del images, out, ref, image_14, x, p_ref, p_q
    del bf16
    torch.cuda.empty_cache()

    make_points_perspective(int8.module)
    (_, batches), stats["serve"] = phase_serve(card, int8, expect, path="int8", products=per_forward_int8)
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"[int8] phase {stats['seconds']:.1f} s")
    return (expect, runs + batches), stats


KERNELS = [
    ("layer_norm", "moge_tpu_torch/csrc/layernorm.cu", "moge_tpu/ops/norm.py:40"),
    ("flash_attention", "moge_tpu_torch/csrc/flash_attn.cu", "moge_tpu/ops/attention.py:57"),
    ("flash_attention_dq", "moge_tpu_torch/csrc/flash_attn_bwd.cu", "moge_tpu/ops/attention.py:124"),
    ("flash_attention_dkv", "moge_tpu_torch/csrc/flash_attn_bwd.cu", "moge_tpu/ops/attention.py:154"),
    ("conv3x3", "moge_tpu_torch/csrc/conv3x3.cu", "moge_tpu/ops/conv.py:132"),
    ("conv3x3_grouped", "moge_tpu_torch/csrc/conv3x3.cu", "moge_tpu/ops/conv.py:304"),
    ("dense_align", "moge_tpu_torch/csrc/dense_align.cu", "moge_tpu/ops/alignment.py:90"),
    ("camera_solve", "moge_tpu_torch/csrc/camera_solve.cu", "moge_tpu/ops/solvers.py:37"),
    ("exp_flash_softmax", "moge_tpu_torch/csrc/exp_flash_softmax.cu", "tools/exp_flash_softmax.py:27"),
    ("exp_vpu_ceiling", "moge_tpu_torch/csrc/exp_vpu_ceiling.cu", "tools/exp_vpu_ceiling.py:33"),
    ("exp_dense_v1", "moge_tpu_torch/csrc/exp_dense.cu", "tools/exp_dense_pallas.py:37"),
    ("exp_dense_v1_unroll", "moge_tpu_torch/csrc/exp_dense.cu", "tools/exp_dense_pallas.py:86"),
    ("exp_dense_v2", "moge_tpu_torch/csrc/exp_dense.cu", "tools/exp_dense_pallas.py:132"),
    ("exp_dense_bf16", "moge_tpu_torch/csrc/exp_dense.cu", "tools/exp_dense_pallas.py:182"),
]
# which phase-3 case carries the reported time: the 1369-token shape (bf16;
# for K3 and K3-grouped 296^2 64->64 with ReLU and residual, at B0 = 1 for
# K3-grouped), for K4 the global loss's L = 6912, for K5 batch 1 at 480x640;
# for the probes T1 base at N = 3601, T2 align, T3-T6 the global shape
REPORT_CASE = {"layer_norm": 0, "flash_attention": 0, "flash_attention_dq": 0, "flash_attention_dkv": 0,
               "conv3x3": 7, "conv3x3_grouped": 8, "dense_align": 0, "camera_solve": 0, "exp_flash_softmax": 0,
               "exp_vpu_ceiling": 0,
               "exp_dense_v1": 0, "exp_dense_v1_unroll": 0, "exp_dense_v2": 0, "exp_dense_bf16": 0}


def timed(name: str, phase, *args):
    """``phase(*args)``, then a ``[time] <name> <seconds>`` line."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"[time] {name} {time.perf_counter() - t0:.1f}")
    return out


def main(argv=None) -> int:
    global CLOCK_HZ
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--cards"]):
        raise SystemExit(f"usage: python3 chip_smoke.py [--cards]; got {argv}")
    started = time.perf_counter()
    card = timed("device", phase_device)
    if not (ROOT / "moge_tpu_torch").is_dir():
        raise RuntimeError(f"moge_tpu_torch/ not found beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT))
    sys.path.append(str(ROOT / "tests"))  # torch_tiny_config: make_points_perspective, the synthetic datasets
    timed("host_packages", phase_host_packages)
    from moge_tpu_torch.tools import roofline

    CLOCK_HZ = roofline.sm_clock_hz()
    log(f"[device] max SM clock {CLOCK_HZ / 1e9:.3f} GHz: FP32 "
        f"{roofline.SMS * roofline.FP32_LANES_PER_SM * CLOCK_HZ / 1e12:.2f} T instr/s, MUFU "
        f"{roofline.SMS * roofline.MUFU_PER_SM * CLOCK_HZ / 1e12:.3f} T/s")
    timed("build", phase_build)
    if argv == ["--cards"]:
        print(json.dumps({"cards": timed("cards", phase_cards, card), "sp_cards": timed("sp_cards", phase_sp_cards, card)}))
        print(card)
        return 0
    kernel_results = {**timed("kernels", phase_kernels), **timed("kernels_train", phase_kernels_train)}
    kernel_results["camera_solve"], camera_solve = timed("camera_solve", phase_camera_solve)
    # each path is driven with the counters set to 0 just before each of its
    # runs and read just after; every run of a path launches the same counts
    launches = {}  # path -> (launches per run, runs)
    align_launches, align_stats = timed("align_forms", phase_align_forms, card)
    launches.update(align_launches)
    torch.cuda.empty_cache()
    probe_results, launches["probes"], probe_tables = timed("probes", phase_probes, card)
    kernel_results.update(probe_results)
    seq, launches["infer"], latencies = timed("slice", phase_slice, card)
    timed("parity", phase_parity)
    export_launches, export_stats = timed("export", phase_export, card, seq)
    launches.update(export_launches)
    bat, launches["batched_heads"], batched_ms = timed("batched", phase_batched, card, seq)
    del seq
    launches["serve"], serve_stats = timed("serve", phase_serve, card, bat, launches["batched_heads"][0])
    del bat
    torch.cuda.empty_cache()
    (sp_k1, sp_k2), launches["sp"], sp_stats = timed("sp", phase_sp, card)
    kernel_results["layer_norm"] += sp_k1
    kernel_results["flash_attention"] += sp_k2
    launches["int8"], int8_stats = timed("int8", phase_int8, card)
    torch.cuda.empty_cache()
    launches["moge1_infer"], moge1_ms = timed("moge1", phase_moge1, card)
    torch.cuda.empty_cache()
    launches["panorama"], panorama_stats = timed("panorama", phase_panorama, card)
    torch.cuda.empty_cache()
    launches["eval"], eval_stats = timed("eval", phase_eval, card)
    torch.cuda.empty_cache()
    launches["train"], train_steps = timed("train", phase_train, card)
    timed("train_parity", phase_train_parity)
    torch.cuda.empty_cache()
    remat_launches, remat_stats = timed("train_remat", phase_train_remat, card)
    launches.update(remat_launches)
    torch.cuda.empty_cache()
    launches["train_cli"], train_cli_stats = timed("train_cli", phase_train_cli, card)
    launches["train_v1"], train_v1_stats = timed("train_v1", phase_train_v1, card)
    parallel_launches, parallel_stats = timed("parallel", phase_parallel, card)
    launches.update(parallel_launches)
    launches["giant"], giant_stats = timed("giant", phase_giant, card)
    timed("vis_data", phase_vis_data)
    kernels = []
    for name, source, replaces in KERNELS:
        cases = kernel_results[name]
        _, ms, plain_ms, library_ms, (bound_ms, bound_by), *device = cases[REPORT_CASE[name]]
        by_path = {path: {"per_run": per_run[name], "runs": runs} for path, (per_run, runs) in launches.items()}
        kind = {"flash_attention": "attention", "flash_attention_dq": "attention_bwd",
                "flash_attention_dkv": "attention_bwd", "conv3x3": "conv", "conv3x3_grouped": "conv",
                "layer_norm": "norm"}.get(name)
        variants = {"variants_by_path": {p: v[kind] for p, v in VARIANTS_BY_PATH.items()}} if kind else {}
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(p["per_run"] * p["runs"] for p in by_path.values()),
                        "infer_launches": by_path["infer"]["per_run"], "launches_by_path": by_path,
                        "max_abs_err": max(c[0] for c in cases), "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, **dict(*device),
                        **variants})
    print(json.dumps({"kernels": kernels, "infer_ms": latencies, "batched_heads_ms": batched_ms,
                      "serve": serve_stats, "export": export_stats, "sp": sp_stats, "int8": int8_stats,
                      "moge1_infer_ms": moge1_ms, "panorama": panorama_stats,
                      "eval": eval_stats, "train_steps": train_steps, "train_cli": train_cli_stats,
                      "train_v1": train_v1_stats, "parallel": parallel_stats, "giant": giant_stats,
                      "probes": probe_tables, "align_forms": align_stats, "train_remat": remat_stats,
                      "camera_solve": camera_solve}))
    log(f"[time] total {time.perf_counter() - started:.1f}")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
