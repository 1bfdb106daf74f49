#!/usr/bin/env python3
"""Drive the PyTorch port (hdenseunet_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line of output each or more (the script catches nothing; any
failure exits non-zero):
1. the card (nvidia-smi name and power limit), torch and CUDA versions;
   raises without a card;
2. build of the port's CUDA kernels from csrc/ (one nvcc per source);
3. every kernel against its plain PyTorch version on the card, with its
   time, the plain version's and its bound: K1 (affine_relu) at the serving
   shapes (K5 in phase 4's k5 part), K1's backward at the end2end training
   shapes, K2 (weighted CE) forward and backward at the training stages'
   row counts, K6 (training's live BN∘[Scale]∘[ReLU], forward and
   backward) at every live BN shape of the graphed training cells, timed
   from CUDA graph replays beside the pre-K6 ATen chain (also alone:
   ``python3 chip_smoke.py k6``), K7 (training's dropout, forward and
   backward) at the dropout of each graphed training cell, bit for bit
   against the ATen chain it replaced and timed from CUDA graph replays
   beside it (also alone: ``python3 chip_smoke.py k7``); each wrapper
   call runs one kernel (torch.profiler); calls of other shapes queued back
   to back give the plain answers and the same bits when repeated (each
   kernel's last block resets the counter it took a ticket from);
4. the serving path: VolumePredictor.segment on two synthetic 512x512x96 CT
   volumes, full-preset H-DenseUNet in bfloat16 with seeded random weights,
   the shipped InferConfig (its 3D branch: the space-to-depth stem in the
   canonical layout), host CC postprocess (native/postprocess.cpp), K1 4
   and K5 111 launches a window batch; then
   - serve_dpp: the same volumes with ``device_postprocess`` (the CC
     postprocess on the card, K4), sparse wire on and off: labelmaps
     byte-identical to the host postprocess's, K4's launches per volume
     (2 largest components, 3 hole fills, one prep, one finish), peak memory
     and s/volume beside the host path's;
   - one volume each through the per-window path (``dedup_2d=False``), the
     shared-2D mode and the uint8 wire: probabilities finite in [0, 1],
     times; the uint8 wire's labelmap equal to the host path's;
   - serve_host_loop: the same volume through the host-loop WindowPredictor
     (``device_resident=False``), its labelmap against the per-window
     path's in the host loop's form, the direct stem (byte-identical, or
     within HOST_LOOP_BOUND), s/volume split into scoring and postprocess;
   - serve_tiled: the same volume through TiledPredictor with 256x256x8
     windows (207 in 26 batches of 8, reckoned from tile_origins): every
     voxel covered, probabilities finite in [0, 1], device scoring s,
     s/volume, peak memory;
   - mfu: device scoring's MFU on the first volume: ``estimate_flops``
     (TFLOP), ``compute_seconds(detail=True)`` and their ratio against
     ``peak_flops_per_chip()`` (the card's bf16 data-sheet peak), beside the
     serve path's synchronised device scoring of the same run;
   - trace: one ``VolumePredictor.segment`` inside ``utils.profiling.trace``
     (torch.profiler): the trace names K1's and K5's kernels and the predictor's
     scoring, fetch and postprocess scopes; the program's recorder
     (``utils.profiling.snapshot``: each span's count, host and self
     seconds and syncs, and the scorer's counters, ``window_batches``
     equal to K3a's launches); the ten device ops with the most time;
   - K4 (cc_label 26 and 6, largest_component, fill_holes, compose_prep,
     compose_finish) against its plain versions on the card and
     native/postprocess.cpp at 512x512x112 (random masks at four densities,
     an ellipsoid liver with a tumour), on the brick-boundary cases of
     ops/cc_cases.py (at two bricks an axis and at shapes one voxel off a
     brick multiple, also against the plain versions; at 512x512x112
     against native/postprocess.cpp and scipy's labels) and on the first
     volume's real thresholded labelmask, every kernel twice; compose_finish
     alone on the edges of its grid (ops/cc_cases.py: empty, 8 corners,
     full; z lengths 4, 8, 12 modulo 16; a 4-byte offset); times warm and
     with the L2 flushed (K4a-c also at random p=0.3), bounds and kernels
     per call;
   - k3 (window_accumulate and score_finish, ops/score.py) against their
     plain versions on the card, bit for bit: K3a on the first two live
     window batches of the first volume (the scorer's own logits, the
     plan's starts and weights) and on seeded batches at the served shape
     (a stride-2 run with a weight-0 window and multiplicities 2-3, the
     per-window grid's non-aligned starts, float32 logits, logits in the
     dhwc route's memory order); K3b on that volume's summed score buffer
     at the served zp and pack_z, labels and wire, with scores set on the
     thresholds' ties; times warm and with the L2 flushed, the plain
     versions' in turns, bounds, kernels per call; then both volumes
     through ``segment`` with K3's plain versions (serve_plain_k3):
     labelmaps byte-identical to phase 4's, device scoring s/volume in
     turns with K3 and with its plain versions;
   - k5 (affine_gemm, ops/affine_gemm.py; ``check_k5``): at the first and
     last bottleneck of every stage of both branches and every transition,
     at the served window batch's rows, K5 and its plain version against a
     float64 product of the kernel's own operand within its stated bound;
     ms warm and L2-flushed, the plain version's in turns, cuDNN's 1x1
     convolution alone (library_ms), the unfused chain (K1, cuDNN, K1),
     the bound over the bf16 peak, kernels per call, the form (tile width,
     persistent blocks) and host us a call; one float32 case;
     then the served path: K1's inputs only the stems' and last blocks'
     widths, both volumes' labelmasks on the concatenation route
     (serve_unfused: K1 220 a window batch, no K5) and their voxels
     differing from K5's,
     device scoring s/volume and MFU with K5 and unfused in turns, and
     float32 probabilities through both routes within DP_FLOAT32_GAP;
   - forms (the 3D branch's execution forms, phase 4's weights; TF32 off
     for every float32 comparison): the stem alone at the serving shape (8
     windows of 512x512x8, 4 channels, bfloat16), the direct conv against
     conv3d_s2d in both kernel orders, timed in turns (ms, TFLOP/s of the
     direct conv's FLOPs, bfloat16 differences, float32 agreement); the 3D
     branch and the HFF head on one window batch in five forms (hwdc,
     hwdc_s2d, dhwc, dhwc_s2d, fold_z: ms in turns, peak memory, K1
     launches, bfloat16 and float32 logits against hwdc's); device scoring
     of the first volume in the four forms InferConfig reaches (s/volume
     in turns, K1 launches, labelmask voxels differing from the shipped
     default's, which phase 4 ran);
5. the training path: ``train`` for 4 end2end steps at full width (global
   batch 8 of 224x224x8 sub-volumes, bfloat16, remat), then 4 steps of the
   2D stage at bench.py's configuration (batch 8 of 224x224 slabs; each
   run's ms/step over steps 2-4), then
   the end2end steps again under ``remat_policy='convs'`` (launches per
   step; ms/step, peak memory and losses beside the 'full' run's and a
   second 'full' run's, equal to the first bit for bit; one step of each
   policy from the same weights and batch within phase 7's bars). A
   recording wrapper on the autograd Functions notes the shape of every
   K1-backward and K2 call; each class of shape is then held against the
   plain version and timed alone with the L2 cache flushed, and the step's
   summed kernel time is printed against its summed bound; then the graph
   phase (train_graph_end2end, train_graph_2d): ``train`` with
   ``steps_per_dispatch`` 8 for 16 steps of each stage (the first group
   eager, then one captured CUDA graph of the step replayed 8 times),
   dropout live, against the same 16 steps eager, and a second eager run:
   losses, parameters, moving statistics and momentum buffers equal bit for
   bit; the ops torch names as nondeterministic in one step; the kernels'
   launches inside the capture (one step's) and each kernel's first call
   there held to its plain version after the last replay; eager against
   graphed ms/step, the capture's seconds and pool bytes, peak memory,
   device busy ms a step and idle share (torch.profiler); then the forms
   phase's training part: the graphed end2end step (steps_per_dispatch 8)
   with the 3D branch in hwdc, hwdc_s2d and dhwc_s2d, in turns (ms/step,
   device busy ms a step), and (forms_train_end2end) the end2end run with
   layout3d='dhwc' and the s2d stem, twice, ms/step and losses beside the
   'full' run's, the two runs equal bit for bit, no nondeterministic op;
6. the CLI path: ``hdenseunet_tpu_torch.cli.main`` in this process, in a
   temporary directory under build/ that it removes: synth-data (two
   512x512x64 volumes), train 2d (4 steps, checkpoints), train end2end
   warm-started from the 2D checkpoint (4 steps, a save every 2), the same
   run resumed (2 steps), the end2end run warm-started again with
   ``--set train.steps_per_dispatch 8`` (16 steps: one eager group, one
   replayed from a captured graph; cli_train_graph counts the captured
   launches times the replays), test on one 512x512x64 NIfTI volume from the
   end2end checkpoint, the same test with ``--tiled 256``, and evaluate;
   full preset, bfloat16, batch 8 of
   real guided crops (224x224 slabs, 224x224x8 sub-volumes) through the
   CropSampler (8 crop threads) and the prefetch pipeline. It checks the
   launches of each command, the warm start (every 2D layer loaded, none
   skipped), the resume (the restored state equals the saved one bit for
   bit) and the labelmap, and times the steps next to phase 5's synthetic
   feed, the sampler alone, the saves and restores, and the test volume;
7. model-level checks of the kernel paths: the tiny-preset scorer in each
   scoring path (dedup-2D, per-window, shared-2D), the tiled scorer, the
   host-loop window predictor and the uint8-wire labelmask, and one tiny
   end2end train step, in float32 on the CPU (plain versions) and on the
   card (kernels), TF32 off;
8. parity: ``python -m hdenseunet_tpu_torch.weights.parity`` on seeded
   full-preset weights written as an .npz: the 2D model at 224x224 and the
   end2end hybrid at 224x224x8 dumped in float32 on the card and on the
   CPU, ``compare`` exiting 0 at the tool's defaults; then the variants
   (``variants_path``): the legacy skip-connection DenseUNet-167 in
   serving form (batch 8 of 224x224, batch 1 of 512x512, bfloat16, K1)
   against the same forward through K1's plain version, and its
   training-mode step (K2, K6); ``DilatedResNet`` at widths 64-512, forward and
   training-mode step (K6); both card against CPU in float32 through the parity
   tool; ms, peak memory and FLOPs per forward;
9. data parallelism over the 'data' mesh, full width (one step of each
   stage from the seeded weights on the first global batch is the
   one-process reference):
   - train_dp_w1: this process joins a group of one rank over NCCL; one
     step of each stage through the mesh held to the one-process step at
     phase 7's bars, then phase 5's runs through ``train(..., mesh=)`` with
     phase 5's launches per step and the all-reduces timed;
   - train_dp_w2: two processes (``chip_smoke.py dp-rank``) share the card
     over gloo, 4 rows each of global batch 8, 3 steps of end2end and of
     the 2D stage: the ranks' parameters and statistics bit-identical,
     launches per step as one process's, K6's included (live BN merges
     its statistics across the ranks between K6's passes), ms/step and
     the all-reduce share
     of a step; step 1 held to the one-process step in float32 (TF32 off),
     the bfloat16 step 1's difference reported. Two ranks on one card
     check the semantics, not scaling;
   - serve_dp_w2: the same two processes score phase 4's first volume
     through ``VolumePredictor(mesh=)``, window_batch 8 (4 a rank): in
     float32 the probabilities within DP_FLOAT32_GAP of one process's; in
     float32 and in bfloat16 (phase 4's) the ranks' labelmaps equal each
     other's, their difference from one process's reported; K1 launches
     and s/volume of each rank;
   - cli_train_dp: ``torchrun --standalone --nproc_per_node 1`` runs
     ``train --arch end2end`` (2 steps, a checkpoint) through the port's
     CLI over NCCL (``chip_smoke.py cli-rank``), then this process resumes
     it for a step with no torchrun: the restored state equals the saved
     one bit for bit;
10. bench: ``bench_torch.main`` (the port's counterpart of bench.py) in
   this process at the full preset and bench.py's 512x512x192 volume, its
   reps cut to fit this script's time (BENCH_ENV): every phase's cumulative
   line, the last carrying every key of bench.py's line, no ``*_error``,
   exit status 0, every served digest finite, ``value`` at least
   ``compute_s_per_volume``; ``*_unreliable`` keys printed, not failed on.
   bench_serve (its serving phases: headline, compute slope, attribution,
   pipelined loop) counts K3a = the plans' live batches summed over every
   scoring, K3b = the pipelined loop's labelmasks, K1 4 and K5 111 a
   live batch; bench_train (the 2D stage, live BN, so no K1)
   counts K2 and K6's per-step launches once a step run eagerly or
   captured, never a replayed one.
   The phase's wall seconds and the line are printed;
then a JSON line describing the kernels, and the last line
{"ok": true, "device": {...}}.

Each path of phases 4-6 and 8-10 (serve, serve_dpp, serve_dpp_dense, serve_plain_k3, serve_unfused,
serve_per_window, serve_shared_2d, serve_uint8, serve_host_loop, serve_tiled,
mfu, trace, forms_* (one branch forward or one scoring a form), forms_score_*,
forms_train_end2end, train_*, train_end2end_convs, train_graph_*, cli_*, cli_test_tiled, parity,
variants_legacy_serve, variants_legacy_train, variants_dilated,
variants_parity, train_dp_w1_*, train_dp_w2_*, serve_dp_w2, cli_train_dp,
cli_train_dp_resume, bench_serve, bench_train)
runs with every launch counter set to 0 just before it and read just after
(in the process that runs it), and fails if a kernel of that path did not
launch. K6's counts are held on every path: on one rank, a forward for each
live BN a step and each one remat recomputes, a backward for each live BN
(``k6_per_step``), as many under a mesh of several ranks; 0 when serving.
K7's likewise: a forward and a backward a training step, the one dropout
of every training forward (``k7_per_step``); 0 when serving. A replayed
CUDA graph launches its kernels without the wrappers:
train_graph_* counts the eager group's launches and the captured step's
times its replays.
"""
from __future__ import annotations

import contextlib
import copy
import datetime
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

SEED = 0
VOLUME_SHAPE = (512, 512, 96)
LIVER_Z = (20, 76)  # synthetic liver mask covers z 20..75
HU_RANGE = (-200, 250)  # the preprocessing window (DataConfig.hu_window)
# ≤ 1 ulp of the result in the working dtype, plus one fp32 ulp of x*A for the
# kernel's fused multiply-add against the plain version's separate mul and add
ULP_FP32 = 2.0**-23
# CPU float32 vs cuDNN float32 (TF32 off): the same arithmetic summed in
# another order through ~60 conv layers, probabilities in [0, 1]
MODEL_TOL = 1e-4
# One tiny end2end step, card against CPU, float32: each tensor's update
# within 5e-2 of its own norm, after one ulp of the parameter per element
# (an update is read as the difference of two float32 parameters) and 1e-9
# (a conv bias in front of a live BN has a zero gradient in exact
# arithmetic). At 32x32x8 and batch 2 the hybrid's float32 gradients hang
# on summation order: on the CPU, two steps of the port that differ only in
# the convs' memory format differ by 2.1 % of a tensor's norm
# (tests/test_torch_train_hybrid.py), and cuDNN sums in yet another order
TRAIN_UPDATE_RTOL = 5e-2
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor fp32 FLOP/s and
# the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989.4e12
TRAIN_STEPS = 4
K6_EPS = 1.1e-5  # the encoder BNs' eps (models/denseunet2d.py EPS_ENCODER)
# K6's stage shapes (rows, C) for PERF.md: d167.train.graphed's first and
# last stage, one of each middle stage, the decoder's last BN; end2end's
# head BN and 3D stages 2 and 5
STAGE_SHAPES_K6 = (
    ("d167 conv1", (125_440, 96)), ("d167 stage 2", (31_360, 288)), ("d167 stage 3", (7_840, 720)),
    ("d167 stage 4", (1_960, 2_112)), ("d167 stage 5", (490, 2_160)), ("d167 bn_up4", (501_760, 64)),
    ("end2end 3D stage 2", (401_408, 96)), ("end2end 3D stage 5", (784, 504)),
    ("end2end head", (3_211_264, 64)),
)
# steps_per_dispatch of the graph phase and its run: the first group runs
# eagerly (the warm-up), the second replays one captured step
GRAPH_K, GRAPH_STEPS = 8, 16
CLI_SHAPE = (512, 512, 64)  # LiTS in-plane size; 64 slices
CLI_STEPS, CLI_RESUME_STEPS = 4, 2
LAYERS_2D = 493  # layers of the full 2D DenseUNet, every one named in the hybrid
BSR_2D = 161  # bn_scale_relu calls per 2D-branch forward (full preset)
REMAT_2D = 156  # of them inside the 78 rematerialised conv blocks
BUILD = Path(__file__).resolve().parent / "build"
K12_NAMES = ("affine_relu", "affine_relu_backward", "wce_forward", "wce_backward")
K6_NAMES = ("bn_live_forward", "bn_live_backward")
K7_NAMES = ("dropout_forward", "dropout_backward")
# K7's shapes, bf16 at rate 0.3: hdu.train.end2end's HFF head and
# d167.train.*'s decoder dropout
SHAPES_K7 = (("end2end head", (8, 64, 224, 224, 8)), ("d167 decoder", (10, 64, 224, 224)))
K4_NAMES = ("cc_label", "largest_component", "fill_holes", "compose_prep", "compose_finish")
K4_SHAPE = (512, 512, 112)  # LiTS in-plane size, 112 slices
K3_NAMES = ("window_accumulate", "score_finish")
# The served window batch's K5 shapes: 36 stacks of 512x512 through the 2D
# branch (stages at 128^2 to 16^2) and 8 windows of 512x512x8 through the 3D
# one (128^2x2 to 16^2x2); the first and last bottleneck of every stage and
# every transition, as (label, rows, K, row stride, N, epilogue, ndim)
K5_STACKS, K5_WINDOWS = 36, 8
# K3's operations, for its bound: per voxel and window, for each of the 3
# classes a subtract, an exp, a divide and a fused multiply-add (2), then 2
# max and 2 adds across the classes (K3a); per voxel an add, 2 divides and
# 2 compares (K3b)
K3A_OPS, K3B_OPS = 19, 5
# K4 wrapper calls per served volume as compose_labels makes them: 2 largest
# components and 3 hole fills, each counted once as a labelling (its brick
# and merge kernels are cc_label's), one prep and one finish
K4_PER_VOLUME = dict(cc_label=5, largest_component=2, fill_holes=3, compose_prep=1, compose_finish=1)
# kernels per wrapper call: brick, merge, (roots,) finish; prep and finish one each
K4_KERNELS = dict(cc_label=3, largest_component=4, fill_holes=4, compose_prep=1, compose_finish=1)
TILE = 256  # the tiled scorer's in-plane window (serve_tiled, cli_test_tiled)
# The forms phase: the execution forms of the 3D branch and the HFF head (the
# hybrid's keywords), at the serving shape: window_batch windows of 512x512x8
FORMS = {
    "hwdc": {}, "hwdc_s2d": dict(stem_s2d=True), "dhwc": dict(layout3d="dhwc"),
    "dhwc_s2d": dict(layout3d="dhwc", stem_s2d=True), "fold_z": dict(fold_z=True),
}
WINDOW_BATCH, FORMS_WINDOW = 8, (512, 512, 8)
FORMS_TRAIN = ("hwdc", "hwdc_s2d", "dhwc_s2d")  # the graphed end2end steps compared
# float32 (TF32 off), the same multiply-accumulate set summed in another
# order: the stem's forms within 1e-4 of its largest output (a sum of 1372
# products, each form's rounding a few float32 ulps of the partial sums);
# each form's logits within 1e-4 of hwdc's largest (~60 convs deep, each
# adding a few ulps of its partial sums)
FORMS_STEM_RTOL = 1e-4
FORMS_LOGIT_RTOL = 1e-4
# The host loop against the per-window device path, when not byte-identical:
# both run the same windows in bfloat16 through the same kernels and average
# in the same order in float32, so a difference can only come from cuDNN
# taking another algorithm for the last batch (other padding windows), a few
# bfloat16 roundings of an activation; allow a probability gap of 2^-5
# (several bfloat16 ulps of a logit near 1) and 1e-4 of the voxels, which
# thresholds and the largest-component rule can flip
HOST_LOOP_BOUND = dict(prob=2.0**-5, voxels=1e-4)
SCOPES = ("scoring", "fetch", "postprocess")  # VolumePredictor's annotate scopes
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
# cuDNN's and CUTLASS's convolution kernels (implicit GEMM and GEMM forms)
CONV_KERNEL = re.compile(r"xmma|cutlass|cudnn|conv(?!ert)|gemm", re.IGNORECASE)
DP_RANKS, DP_STEPS = 2, 3  # processes sharing the card over gloo; their steps a stage
DP_TIMEOUT = datetime.timedelta(seconds=300)  # each rendezvous and collective
DP_WALL = 900  # seconds for a group of rank processes, then the phase fails
# Window-parallel float32 scoring (TF32 off) against one process's: cuDNN
# picks its kernels by batch shape (4 windows a rank, 8 in one process), and
# the 2D logits enter the 3D branch times 250, so the probabilities part by
# up to ~6e-4 (measured with either stem); a voxel that close to a threshold
# may change its label. The largest gap is held under this bound
DP_FLOAT32_GAP = 2.0**-9
# A bfloat16 forward of the full 2D model through K1 against the same
# forward through K1's plain version: K1 rounds x*A+B with one fused
# multiply-add, the plain version with two roundings, so a BN output may
# differ by one bfloat16 ulp (2^-8 relative); 161 such layers and the convs
# after them carry it to the logits. Relative L2 of the logits within 2^-5
VARIANT_BF16_RTOL = 2.0**-5
# The bench phase: bench_torch.main at the full preset and bench.py's
# 512x512x192 volume, its reps cut to fit this script's time
BENCH_ENV = dict(
    BENCH_PRESET="full", BENCH_Z="192", BENCH_REPS="2", BENCH_COMPUTE_REPS="2",
    BENCH_TRAIN_REPS="1", BENCH_TRAIN_STEPS="10", BENCH_TRAIN_SLOPE_REPS="2",
    BENCH_TRAIN_K_SMALL="4", BENCH_TRAIN_K_BIG="16", BENCH_PIPELINE_VOLUMES="2",
)
# bench.py's keys (bench.py:450-462) when every phase runs; then for each
# slope, the set it prints when the slope is reliable and the one when not
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "model_tflops", "achieved_tflops", "mfu",
    "compute_spread", "compute_t_small_s", "compute_t_big_s", "compute_k_big",
    "dispatch_s", "h2d_s", "wire_mb",
    "pipelined_s_per_volume", "pipelined_volumes", "pipelined_vs_baseline",
    "train_ms_per_step", "train_slices_per_s_chip", "train_mfu", "train_compute_spread",
)
BENCH_EITHER = (
    (("compute_s_per_volume", "compute_mfu", "decomp_gap_s"), ("compute_unreliable",)),
    (("train_compute_ms_per_step", "train_compute_slices_per_s_chip", "train_compute_mfu"),
     ("train_compute_unreliable", "train_compute_t_small_s", "train_compute_t_big_s")),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over iters calls in a row. The stream is held
    (a ~3 ms sleep kernel, before the first event) while the host queues the
    calls, so the host's time per call does not pace them."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(6_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int = 10) -> float:
    """Mean device time of one call of fn with the L2 cache flushed before
    it. The flush reads 256 MiB, five times the L2: a write would leave the
    L2 full of dirty lines, whose write-back the timed call would pay for.
    A ~0.2 ms sleep kernel after it holds the stream while the host queues
    the call, so the host's time per call does not enter the interval."""
    flush = torch.ones(2**26, dtype=torch.float32, device="cuda")
    fn()
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in marks:
        flush.sum()
        torch.cuda._sleep(400_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in marks) / iters


def kernels_per_call(fn, expect: int = 1) -> int:
    """Kernels one call of fn launches, counted by torch.profiler (host and
    device activities) after a first call (which may make the stream's
    scratch buffer): the runtime's launch calls (cudaLaunchKernel), which
    the profiler records on the host; they must be ``expect``, and so must
    the device's kernel events where the profiler kept any. It keeps none
    for a lone kernel in a process older than some seconds: it maps the
    kernel's device time stamps far from its launch on the host timeline,
    then drops it as outside the profile's window (kineto's out-of-range
    count), however long the window is held open around the call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    launched = [e.name for e in events if e.name in LAUNCH_CALLS]
    names = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(launched) == expect, f"one call launched {len(launched)} kernels: {launched}"
    assert len(names) in (0, expect), f"one call ran {len(names)} kernels: {names}"
    if not names:
        print(f"  kernels per call: {expect} launch calls; the profiler kept no device event")
    return expect


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds per call of fn, queued while a ~50 ms sleep kernel
    holds the stream, so that the host never waits on the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def in_turns(kernel, plain) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    t = [cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the fp32 operations over the fp32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def counters() -> dict:
    from hdenseunet_tpu_torch.ops import affine_gemm as K5, bn_live as K6, cc, dropout as K7, fused_affine as K
    from hdenseunet_tpu_torch.ops import score as S, wce as W

    return {
        "affine_relu": K.affine_relu, "affine_relu_backward": K.affine_relu_backward,
        "affine_gemm": K5.affine_gemm,
        "bn_live_forward": K6.bn_live_forward, "bn_live_backward": K6.bn_live_backward,
        "dropout_forward": K7.dropout_forward, "dropout_backward": K7.dropout_backward,
        "wce_forward": W.wce_forward, "wce_backward": W.wce_backward,
        **{name: getattr(cc, name) for name in K4_NAMES},
        **{name: getattr(S, name) for name in K3_NAMES},
    }


def only(**counts) -> dict:
    """Launch counts with every kernel not named at 0."""
    return {**dict.fromkeys(counters(), 0), **counts}


def route_counts(model) -> dict:
    """K1 and K5 launches of one inference forward of ``model`` (a branch,
    the hybrid, the legacy 2D): one K5 launch for every bottleneck, its x2
    BN∘Scale∘ReLU inside, and every transition; K1 for every other frozen
    BN∘Scale∘ReLU (the stems' and the last blocks')."""
    from hdenseunet_tpu_torch.models import layers as L

    convs = [name for name, m in model.named_modules() if isinstance(m, L.Conv)]
    x1 = sum(name.endswith("_x1") for name in convs)
    blk = sum(name.endswith("_blk") for name in convs)
    scales = sum(isinstance(m, L.Scale) for m in model.modules())
    return dict(affine_relu=scales - 2 * x1 - blk, affine_gemm=x1 + blk)


def k6_per_step(arch: str) -> dict:
    """K6 launches of one training step on one rank under remat
    (models/layers.live_bn): a forward for every live BatchNorm and one
    more for each inside a conv block that remat recomputes (``*_x1_bn``,
    ``*_x2_bn``), a backward for each. The live BNs: DenseUNet-167's for
    '2d' (the legacy skip-connection network has the same), the 3D branch's
    and the head's for 'end2end' (the 2D branch is frozen), every one of
    DilatedResNet's for 'dilated' (no remat). A mesh of several ranks
    launches as many: K6 merges the statistics between its passes."""
    from hdenseunet_tpu_torch.models import layers as L
    from hdenseunet_tpu_torch.models.denseunet2d import DenseUNet2D
    from hdenseunet_tpu_torch.models.dilated_resnet import DilatedResNet
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    make, frozen, remat = {"2d": (DenseUNet2D, "-", True), "end2end": (HDenseUNet, "net2d.", True),
                           "dilated": (DilatedResNet, "-", False)}[arch]
    bns = [name for name, m in make(device="meta").named_modules()
           if isinstance(m, L.BatchNorm) and not name.startswith(frozen)]
    rerun = sum(name.endswith(("_x1_bn", "_x2_bn")) for name in bns) if remat else 0
    return dict(bn_live_forward=len(bns) + rerun, bn_live_backward=len(bns))


def k7_per_step(arch: str) -> dict:
    """K7 launches of one training step: a forward and a backward for the
    one dropout of the forward, the 2D decoder's ('2d'; the legacy
    skip-connection network's too) or the HFF head's ('end2end',
    '3dpart'), outside every rematerialised block; none in DilatedResNet."""
    n = 0 if arch == "dilated" else 1
    return dict(dropout_forward=n, dropout_backward=n)


def live_per_step(arch: str) -> dict:
    """K6's and K7's launches of one training step."""
    return {**k6_per_step(arch), **k7_per_step(arch)}


def scaled(counts: dict, n: int) -> dict:
    """Launch counts of n forwards."""
    return {k: v * n for k, v in counts.items()}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def check_k1(card: str) -> dict:
    from hdenseunet_tpu_torch.ops import fused_affine as K

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # (label, JAX-layout shape (..., C), dtype, relu)
        ("2d conv1 36x256x256x96", (36, 256, 256, 96), torch.bfloat16, True),
        ("2d block1 36x128x128x384", (36, 128, 128, 384), torch.bfloat16, True),
        ("3d 8x128x128x2x192", (8, 128, 128, 2, 192), torch.bfloat16, True),
        ("fp32 36x128x128x96", (36, 128, 128, 96), torch.float32, True),
        ("fp32 no-relu 8x64x64x35", (8, 64, 64, 35), torch.float32, False),
        ("odd C 36x64x64x36", (36, 64, 64, 36), torch.bfloat16, True),
        ("unaligned rows 4096x96", (4096, 96), torch.bfloat16, True),
    ]
    paths = set()
    worst = 0.0
    first = None
    for label, shape, dtype, relu in cases:
        c = shape[-1]
        if label.startswith("unaligned"):
            flat = torch.randn(int(np.prod(shape)) + 1, device="cuda", generator=gen)
            x = flat.to(dtype)[1:].view(shape)  # storage offset: 2-byte aligned
        else:
            x = (2 * torch.randn(shape, device="cuda", generator=gen)).to(dtype)
        x = x.movedim(-1, 1)  # PyTorch shape, channels-last memory
        scale = 1 + 0.5 * torch.randn(c, device="cuda", generator=gen)
        shift = 0.5 * torch.randn(c, device="cuda", generator=gen)
        got = K.affine_relu(x, scale, shift, relu=relu)
        want = K.affine_relu_reference(x, scale, shift, relu=relu)
        torch.cuda.synchronize()
        err = k1_error(got, want, x, scale, label)
        worst = max(worst, err)
        a = scale.to(dtype).float()
        path = "vector" if K.vector_path(x, got, a, a) else "scalar"
        paths.add(path)
        ms, plain_ms = in_turns(
            lambda: K.affine_relu(x, scale, shift, relu=relu),
            lambda: K.affine_relu_reference(x, scale, shift, relu=relu),
        )
        b = bound(2 * x.numel() * x.element_size() + 2 * 4 * c, 3 * x.numel())
        print(
            f"K1 {label} {str(dtype)[6:]} {path}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]"
        )
        first = first or dict(ms=ms, plain_ms=plain_ms, **b)
        if label.startswith("2d conv1"):
            first["kernels_per_call"] = kernels_per_call(lambda: K.affine_relu(x, scale, shift))
    assert paths == {"vector", "scalar"}, paths
    return dict(max_abs_err=worst, **first)


def k1_error(got, want, x, scale, label: str) -> float:
    """Hold K1 to its plain version: within one ulp of the result in the
    working dtype, plus one float32 ulp of x*A (the kernel's fused
    multiply-add against two roundings). Returns the largest error."""
    a = scale.to(x.dtype).float().view([1, -1] + [1] * (x.dim() - 2))
    tol = (
        torch.finfo(x.dtype).eps * want.float().abs()
        + ULP_FP32 * (x.float() * a).abs()
        + torch.finfo(x.dtype).tiny
    )
    diff = (got.float() - want.float()).abs()
    assert got.stride() == x.stride(), (label, got.stride(), x.stride())
    assert bool((diff <= tol).all()), f"K1 disagrees at {label}: max {diff.max()}"
    return float(diff.max())


def k2_errors(loss, cnt, d, logits, labels, mask, w, g, label: str) -> tuple[float, float]:
    """Hold K2's forward (loss, sum of the mask) and backward (d) to their
    plain versions: the sum of the mask exact; the loss, float32 sums of n
    terms in other orders, within 1e-5 of it; dlogits within one ulp of the
    dtype plus 8 float32 ulps of the largest class weight over the sum of
    the mask. Returns the loss's and dlogits' largest errors."""
    from hdenseunet_tpu_torch.ops import wce as W

    loss_p, cnt_p = W.weighted_ce_reference(logits, labels, mask, w)
    d_p = W.weighted_ce_backward_reference(logits, labels, mask, w, cnt, g)
    assert float(cnt) == float(cnt_p), (label, float(cnt), float(cnt_p))
    loss_err = abs(float(loss) - float(loss_p))
    assert loss_err <= 1e-5 * abs(float(loss_p)), (label, float(loss), float(loss_p))
    d_err = (d.float() - d_p.float()).abs()
    tol = torch.finfo(logits.dtype).eps * d_p.float().abs() + 8 * ULP_FP32 * float(w.max()) / float(cnt_p)
    assert bool((d_err <= tol).all()), f"K2 backward at {label}: max {d_err.max()}"
    return loss_err, float(d_err.max())


def k1_backward_case(rows: int, c: int, dtype, relu: bool, gen):
    """(g, x, scale, y) as (rows, C) matrices on the card; y is None
    without relu."""
    from hdenseunet_tpu_torch.ops.fused_affine import affine_relu_reference

    x = (2 * torch.randn((rows, c), device="cuda", generator=gen)).to(dtype)
    g = torch.randn((rows, c), device="cuda", generator=gen).to(dtype)
    scale = 1 + 0.5 * torch.randn(c, device="cuda", generator=gen)
    shift = 0.5 * torch.randn(c, device="cuda", generator=gen)
    return g, x, scale, affine_relu_reference(x, scale, shift) if relu else None


def k1_backward_error(got, want, g, x, label: str) -> float:
    """Hold K1's backward to its plain version: dx the same bits (g*A
    rounded once in both); dA and dB, float32 sums in other orders (row
    blocks, then in double in the last block, against PyTorch's reduction)
    rounded once to the working dtype, within one ulp of that dtype plus
    256 float32 ulps of sum |g*x| (sum |g|). Returns the largest error."""
    eps = torch.finfo(x.dtype).eps
    dims = [d for d in range(x.dim()) if d != 1]
    assert torch.equal(got[0], want[0]), f"K1 bwd dx at {label}"
    for k, mag in ((1, (g.float() * x.float()).abs().sum(dims)), (2, g.float().abs().sum(dims))):
        tol = eps * want[k].abs() + 256 * ULP_FP32 * mag + 1e-30
        assert bool(((got[k] - want[k]).abs() <= tol).all()), f"K1 bwd d{'AB'[k - 1]} at {label}"
    return max(float((got[k] - want[k]).abs().max()) for k in (1, 2))


def check_k1_backward(card: str) -> dict:
    """K1's backward at the end2end training shapes (B*D = 64 slices)."""
    from hdenseunet_tpu_torch.ops import fused_affine as K

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = [  # (label, JAX-layout shape, dtype)
        ("conv1_bn 64x112x112x96", (64, 112, 112, 96), torch.bfloat16),
        ("conv2_blk 64x56x56x384", (64, 56, 56, 384), torch.bfloat16),
        ("odd C 64x56x56x36", (64, 56, 56, 36), torch.bfloat16),
        ("fp32 64x56x56x96", (64, 56, 56, 96), torch.float32),
    ]
    worst = 0.0
    first = None
    paths = set()
    for label, shape, dtype in cases:
        c = shape[-1]
        x = (2 * torch.randn(shape, device="cuda", generator=gen)).to(dtype).movedim(-1, 1)
        g = torch.randn(shape, device="cuda", generator=gen).to(dtype).movedim(-1, 1)
        scale = 1 + 0.5 * torch.randn(c, device="cuda", generator=gen)
        shift = 0.5 * torch.randn(c, device="cuda", generator=gen)
        y = K.affine_relu_reference(x, scale, shift)
        got = K.affine_relu_backward(g, x, scale, y)
        want = K.affine_relu_backward_reference(g, x, scale, y)
        torch.cuda.synchronize()
        err = k1_backward_error(got, want, g, x, label)
        worst = max(worst, err)
        path = "vector" if K.vector_path(x, g, got[0], y) else "scalar"
        paths.add(path)
        ms, plain_ms = in_turns(
            lambda: K.affine_relu_backward(g, x, scale, y),
            lambda: K.affine_relu_backward_reference(g, x, scale, y),
        )
        # reads g, x and y, writes dx; A in, dA and dB out
        b = bound(4 * x.numel() * x.element_size() + 3 * 4 * c, 5 * x.numel())
        print(
            f"K1 backward {label} {str(dtype)[6:]} {path}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]"
        )
        if first is None:
            first = dict(ms=ms, plain_ms=plain_ms, **b)
            first["kernels_per_call"] = kernels_per_call(lambda: K.affine_relu_backward(g, x, scale, y))
    assert paths == {"vector", "scalar"}, paths
    return dict(max_abs_err=worst, **first)


def graph_ms(fn, iters: int = 10) -> float:
    """Mean device time of one call of fn, from replays of a CUDA graph
    that captures ``iters`` calls: the host's launch cost, which paces
    cuda_ms for a chain of small launches, stays out of the interval."""
    from hdenseunet_tpu_torch.ops import build

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    build.reserve_scratch(stream)
    with torch.cuda.stream(stream):
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


def live_bn_sites(model, run) -> list:
    """The live BN sites of one training step of ``model`` on the meta
    device (``run(model)`` makes the step): (rows, C, scale, relu, forward
    calls) each, a checkpoint's recompute counted as a call."""
    from hdenseunet_tpu_torch.models import layers as L

    seen = {}
    live_bn = L.live_bn

    def recorded(x, bn, sc, ctx, *, relu):
        site = seen.setdefault(id(bn), [x.numel() // x.shape[1], x.shape[1], sc is not None, relu, 0])
        site[-1] += 1
        return live_bn(x, bn, sc, ctx, relu=relu)

    L.live_bn = recorded
    try:
        run(model)
    finally:
        L.live_bn = live_bn
    return [tuple(site) for site in seen.values()]


def k6_sites() -> dict:
    """Each graphed training cell's live BN sites: d167.train.graphed's
    DenseUNet-167 at batch 10 of 224x224x3, hdu.train.end2end's hybrid at
    8 x 224x224x8 (its 3D branch and head), both under remat 'full'."""
    from hdenseunet_tpu_torch.models import layers as L
    from hdenseunet_tpu_torch.models.denseunet2d import DenseUNet2D
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    def d167(model):
        x = torch.empty((10, 224, 224, 3), device="meta", dtype=torch.bfloat16)
        _, logits = model(x, L.Ctx(0, device="meta", remat=True), decoder_dropout=0.3)
        logits.float().sum().backward()

    def end2end(model):
        vol = torch.empty((8, 224, 224, 8, 1), device="meta", dtype=torch.bfloat16)
        model(vol, L.Ctx(0, device="meta", remat=True), arch="end2end").float().sum().backward()

    return {"d167.train.graphed": live_bn_sites(DenseUNet2D(device="meta"), d167),
            "hdu.train.end2end": live_bn_sites(HDenseUNet(device="meta"), end2end)}


def aten_bn_chain(x, gb, bb, gs, bs, relu: bool):
    """The live BN∘[Scale]∘[ReLU] as models/layers.py ran it before K6, on
    a (rows, C) x: torch.var_mean of a float32 copy, the BN and Scale
    affines in x's dtype, the ReLU."""
    var, mean = torch.var_mean(x.float(), dim=0, correction=0)
    inv = torch.rsqrt(var + K6_EPS) * gb
    y = x * inv.to(x.dtype) + (bb - mean * inv).to(x.dtype)
    if gs is not None:
        y = y * gs.to(x.dtype) + bs.to(x.dtype)
    return torch.relu(y) if relu else y


def k6_errors(x, g, gb, bb, gs, bs, relu: bool, got, label: str) -> dict:
    """Hold K6's forward and backward (``got``: y, mean, var, coef, dx and
    grads of one call each) to their plain versions at the card tests'
    bars (tests/test_torch_bn_live.py::test_cuda_kernel_matches_plain).
    The statistics, the kernel's fp32 Welford folded in double against
    torch.var_mean: mean within 2^-20 of sqrt(mean^2 + var), var within
    2^-18 relative; inv and A within 2^-16 relative, B within 2^-16 of its
    terms' magnitudes (it may cancel). From the kernel's own statistics: y
    the same bits as the plain multiply and add; dx within one ulp of the
    dtype plus 2^-20 of its three terms' magnitudes (fmaf against separate
    roundings); the four parameter gradients, fp32 sums in other orders,
    within 2^-16 of the sums of magnitudes. Returns each one's largest
    error against its scale."""
    from hdenseunet_tpu_torch.ops import bn_live as K

    y, mean, var, coef, dx, grads = got
    rows = x.shape[0]
    _, want_mean, want_var, want_coef = K.bn_live_reference(x, gb, bb, gs, bs, eps=K6_EPS, relu=relu)
    inv, a, b = coef
    gsv = torch.ones_like(gb) if gs is None else gs
    terms_b = (bb.abs() + (want_mean * want_coef[0] * gb).abs()) * gsv.abs() + (0 if bs is None else bs.abs())
    errors = {
        "mean": (mean - want_mean).abs() / torch.sqrt(want_mean**2 + want_var),
        "var": (var - want_var).abs() / want_var,
        "inv": (inv - want_coef[0]).abs() / want_coef[0].abs(),
        "A": (a - want_coef[1]).abs() / want_coef[1].abs(),
        "B": (b - want_coef[2]).abs() / terms_b,
    }
    bars = {"mean": 2**-20, "var": 2**-18, "inv": 2**-16, "A": 2**-16, "B": 2**-16}
    want_y = x.float() * a + b
    assert torch.equal(y, (torch.relu(want_y) if relu else want_y).to(x.dtype)), f"K6 y at {label}"
    want_dx, want_grads = K.bn_live_backward_reference(g, x, mean, coef, gb, bb, gs, relu=relu)
    xf, gf = x.float(), g.float()
    if relu:
        gf = torch.where(xf * a + b > 0, gf, 0.0)
    c1 = gb * gsv * inv
    s1, s2 = gf.abs().sum(0), (gf * (xf - mean) * inv).abs().sum(0)
    terms = c1.abs() * gf.abs() + (c1 * s1 / rows).abs() + (c1 * s2 * inv / rows).abs() * (xf - mean).abs()
    tol = torch.finfo(x.dtype).eps * want_dx.float().abs() + 2**-20 * terms
    errors["dx"] = (dx.float() - want_dx.float()).abs() / tol
    mags = torch.stack([gsv.abs() * s2, gsv.abs() * s1, gb.abs() * s2 + bb.abs() * s1, s1])
    if gs is None:
        mags[2:] = 0
    errors["grads"] = (grads - want_grads).abs() / (2**-16 * mags + 1e-30)
    bars.update(dx=1.0, grads=1.0)  # both already over their tolerance
    # each error over its scale; an element whose error and scale are both 0 reads 0
    worst = {k: float(torch.where(v.isnan(), 0.0, v).max()) for k, v in errors.items()}
    bad = {k: v for k, v in worst.items() if not v <= bars[k]}
    assert not bad, f"K6 at {label}: {bad} past {bars}"
    return worst


def check_k6(card: str) -> dict:
    """K6 (ops/bn_live.py) at every live BN shape of the two graphed
    training cells, bfloat16: each call held to its plain version
    (``k6_errors``), then timed warm from CUDA graph replays (``graph_ms``),
    forward and backward, beside the plain version's forward and backward
    and the pre-K6 ATen chain's (library_ms: ``aten_bn_chain`` and its
    autograd), each alone on its inputs. The bound reads x and writes y
    forward, reads g and x and writes dx backward: 4 + 6 B an element. A
    cell's step sums each site's forward calls (recompute included) and its
    backward; the sites found on the meta device must match ``k6_per_step``.
    Returns, per kernel, d167.train.graphed's step sums and the largest
    errors over every shape, and each cell's step."""
    from hdenseunet_tpu_torch.ops import bn_live as K

    sites = k6_sites()
    for cell, arch in (("d167.train.graphed", "2d"), ("hdu.train.end2end", "end2end")):
        found = dict(bn_live_forward=sum(site[-1] for site in sites[cell]), bn_live_backward=len(sites[cell]))
        assert found == k6_per_step(arch), (cell, found, k6_per_step(arch))
    shapes = sorted({site[:4] for found in sites.values() for site in found})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    times, worst = {}, {}
    for rows, c, scale, relu in shapes:
        x = (0.7 + 2 * torch.randn((rows, c), device="cuda", generator=gen)).to(torch.bfloat16)
        g = torch.randn((rows, c), device="cuda", generator=gen).to(torch.bfloat16)
        gb, gs = (1 + 0.3 * torch.randn((2, c), device="cuda", generator=gen)).unbind()
        bb, bs = (0.5 * torch.randn((2, c), device="cuda", generator=gen)).unbind()
        gs, bs = (gs, bs) if scale else (None, None)
        y, mean, var, coef = K.bn_live_forward(x, gb, bb, gs, bs, eps=K6_EPS, relu=relu)
        dx, grads = K.bn_live_backward(g, x, mean, coef, gb, bb, gs, relu=relu)
        torch.cuda.synchronize()
        errors = k6_errors(x, g, gb, bb, gs, bs, relu, (y, mean, var, coef, dx, grads), f"{rows}x{c}")
        worst = {k: max(worst.get(k, 0.0), v) for k, v in errors.items()}
        xr = x.detach().requires_grad_()
        leaves = [t.detach().requires_grad_() for t in (gb, bb) + ((gs, bs) if scale else ())]
        chain_leaves = leaves + ([] if scale else [None, None])
        fwd = graph_ms(lambda: K.bn_live_forward(x, gb, bb, gs, bs, eps=K6_EPS, relu=relu))
        bwd = graph_ms(lambda: K.bn_live_backward(g, x, mean, coef, gb, bb, gs, relu=relu))
        plain_fwd = graph_ms(lambda: K.bn_live_reference(x, gb, bb, gs, bs, eps=K6_EPS, relu=relu))
        plain_bwd = graph_ms(lambda: K.bn_live_backward_reference(g, x, mean, coef, gb, bb, gs, relu=relu))
        aten_fwd = graph_ms(lambda: aten_bn_chain(x, gb, bb, gs, bs, relu))
        aten_both = graph_ms(lambda: torch.autograd.grad(
            aten_bn_chain(xr, *chain_leaves, relu), [xr, *leaves], g))
        times[(rows, c, scale, relu)] = dict(
            fwd=fwd, bwd=bwd, plain_fwd=plain_fwd, plain_bwd=plain_bwd, aten_fwd=aten_fwd,
            aten_bwd=aten_both - aten_fwd, bound_fwd=rows * c * 4 / HBM_BYTES_PER_S * 1e3,
            bound_bwd=rows * c * 6 / HBM_BYTES_PER_S * 1e3)
        del x, g, y, dx, xr
    steps = {}
    for cell, found in sites.items():
        total = dict.fromkeys((f"{k}_{d}" for k in ("card", "plain", "aten", "bound") for d in ("fwd", "bwd")), 0.0)
        for rows, c, scale, relu, calls in found:
            t = times[(rows, c, scale, relu)]
            for k, name in (("card", ""), ("plain", "plain_"), ("aten", "aten_"), ("bound", "bound_")):
                total[f"{k}_fwd"] += calls * t[f"{name}fwd"]
                total[f"{k}_bwd"] += t[f"{name}bwd"]
        steps[cell] = dict(sites=len(found), calls=sum(site[-1] for site in found),
                           elements=sum(site[0] * site[1] for site in found), **total)
        both = {k: total[f"{k}_fwd"] + total[f"{k}_bwd"] for k in ("card", "plain", "aten", "bound")}
        print(
            f"K6 step {cell}: {len(found)} live sites, {steps[cell]['calls']} forward calls, "
            f"{steps[cell]['elements'] / 1e9:.4f} G elements a forward; card {total['card_fwd']:.3f} + "
            f"{total['card_bwd']:.3f} = {both['card']:.3f} ms, bound {both['bound']:.3f} ms "
            f"({100 * both['bound'] / both['card']:.1f} %), plain {both['plain']:.3f} ms, ATen chain "
            f"(library_ms) {total['aten_fwd']:.3f} + {total['aten_bwd']:.3f} = {both['aten']:.3f} ms; "
            f"each site alone from graph replays [{card}]"
        )
    for (rows, c, scale, relu), t in sorted(times.items(), key=lambda kv: -kv[0][0] * kv[0][1])[:12]:
        b = t["bound_fwd"] + t["bound_bwd"]
        print(
            f"K6 {rows}x{c} bf16 scale {int(scale)} relu {int(relu)}: card {t['fwd']:.4f} + "
            f"{t['bwd']:.4f} ms, bound {b:.4f} ms ({100 * b / (t['fwd'] + t['bwd']):.1f} "
            f"%), plain {t['plain_fwd']:.4f} + {t['plain_bwd']:.4f}, ATen chain (library_ms) "
            f"{t['aten_fwd']:.4f} + {t['aten_bwd']:.4f} [{card}]"
        )
    for label, (rows, c) in STAGE_SHAPES_K6:
        t = next(v for k, v in times.items() if k[:2] == (rows, c))
        print(
            f"K6 stage {label} {rows}x{c}: card {t['fwd'] + t['bwd']:.4f} ms, bound "
            f"{t['bound_fwd'] + t['bound_bwd']:.4f}, plain {t['plain_fwd'] + t['plain_bwd']:.4f}, "
            f"library_ms {t['aten_fwd'] + t['aten_bwd']:.4f} [{card}]"
        )
    x = torch.randn((31_360, 288), device="cuda").to(torch.bfloat16)
    gb = torch.ones(288, device="cuda")
    y, mean, var, coef = K.bn_live_forward(x, gb, gb, gb, gb, eps=K6_EPS, relu=True)
    per_call = {"bn_live_forward": kernels_per_call(
        lambda: K.bn_live_forward(x, gb, gb, gb, gb, eps=K6_EPS, relu=True), 2)}
    per_call["bn_live_backward"] = kernels_per_call(
        lambda: K.bn_live_backward(x, x, mean, coef, gb, gb, gb, relu=True), 2)
    print(f"K6 worst over {len(shapes)} shapes (of each bar: mean, var, inv, A, B relative; dx, grads "
          f"over their tolerance): { {k: float(f'{v:.3g}') for k, v in worst.items()} } [{card}]")
    d167 = steps["d167.train.graphed"]
    return {
        name: dict(ms=d167[f"card_{d}"], plain_ms=d167[f"plain_{d}"], library_ms=d167[f"aten_{d}"],
                   bound_ms=d167[f"bound_{d}"], bound_by="bytes", kernels_per_call=per_call[name],
                   max_errors={k: worst[k] for k in keys}, steps=steps)
        for name, d, keys in (("bn_live_forward", "fwd", ("mean", "var", "inv", "A", "B")),
                              ("bn_live_backward", "bwd", ("dx", "grads")))
    }


def check_k7(card: str) -> dict:
    """K7 (ops/dropout.py) at the dropout of each graphed training cell
    (SHAPES_K7), bfloat16 at rate 0.3 from a hashed step seed: y and dx
    against the ATen chain it replaced (the plain version on the card, and
    autograd of it) bit for bit, then forward and backward timed warm from
    CUDA graph replays (``graph_ms``) beside the chain's forward and its
    forward and backward (library_ms). The bound reads x and writes y
    forward, reads g and writes dx backward: 4 + 4 B an element. Returns,
    per kernel, the end2end head's numbers and each shape's."""
    from hdenseunet_tpu_torch.models import layers as L
    from hdenseunet_tpu_torch.ops import dropout as K

    seed, rate = L.Ctx(SEED, device="cuda").seed, 0.3
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    shapes = {}
    for label, shape in SHAPES_K7:
        fmt = {4: torch.channels_last, 5: torch.channels_last_3d}[len(shape)]
        x, g = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16).contiguous(memory_format=fmt)
                for _ in range(2))
        y = K.dropout_forward(x, seed, rate)
        dx = K.dropout_backward(g, seed, rate, 0, x.stride())
        xr = x.detach().requires_grad_()
        want = K.dropout_reference(xr, seed, rate)
        (want_dx,) = torch.autograd.grad(want, xr, g)
        assert torch.equal(y.view(torch.int16), want.view(torch.int16)), f"K7 y at {label}"
        assert torch.equal(dx.view(torch.int16), want_dx.view(torch.int16)), f"K7 dx at {label}"
        kept = float((y != 0).float().mean())
        del y, dx, want, want_dx
        fwd = graph_ms(lambda: K.dropout_forward(x, seed, rate))
        bwd = graph_ms(lambda: K.dropout_backward(g, seed, rate, 0, x.stride()))
        aten_fwd = graph_ms(lambda: K.dropout_reference(x, seed, rate))
        aten_both = graph_ms(lambda: torch.autograd.grad(K.dropout_reference(xr, seed, rate), xr, g))
        bound = x.numel() * 4 / HBM_BYTES_PER_S * 1e3
        shapes[label] = dict(elements=x.numel(), fwd=fwd, bwd=bwd, aten_fwd=aten_fwd,
                             aten_bwd=aten_both - aten_fwd, bound=bound)
        print(
            f"K7 {label} {x.numel():,} bf16 rate {rate}: card {fwd:.4f} + {bwd:.4f} = {fwd + bwd:.4f} ms, "
            f"bound {2 * bound:.4f} ms ({100 * 2 * bound / (fwd + bwd):.1f} %), ATen chain (library_ms) "
            f"{aten_fwd:.4f} + {aten_both - aten_fwd:.4f} = {aten_both:.4f} ms; y and dx the chain's bits, "
            f"kept {kept:.5f}; graph replays [{card}]"
        )
        del x, g, xr
        torch.cuda.empty_cache()
    x = torch.randn((10, 64, 56, 56), device="cuda").to(torch.bfloat16)
    per_call = {"dropout_forward": kernels_per_call(lambda: K.dropout_forward(x, seed, rate)),
                "dropout_backward": kernels_per_call(lambda: K.dropout_backward(x, seed, rate, 0, x.stride()))}
    head = shapes[SHAPES_K7[0][0]]
    return {
        name: dict(ms=head[d], library_ms=head[f"aten_{d}"], bound_ms=head["bound"], bound_by="bytes",
                   kernels_per_call=per_call[name], shapes=shapes)
        for name, d in (("dropout_forward", "fwd"), ("dropout_backward", "bwd"))
    }


def phase_main(name: str, check) -> None:
    """``python3 chip_smoke.py <name>``: the build, then that phase alone."""
    if not torch.cuda.is_available():
        raise SystemExit(f"chip_smoke {name}: torch.cuda.is_available() is false; this script needs a card")
    from hdenseunet_tpu_torch.ops import build

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; cuda {torch.version.cuda}")
    so, seconds = build.build()
    print(f"build: {so.name} in {seconds:.1f} s")
    t0 = time.perf_counter()
    print(json.dumps({name: check(card)}))
    print(f"{name} phase: {time.perf_counter() - t0:.1f} s [{card}]")


def wce_case(n: int, dtype, gen, *, depth: int | None):
    """(N, 3) logits, int32 labels and a float32 mask on the card. With a
    depth, rows are z-fastest voxels and the mask drops z 0 and depth-1, as
    the hybrid loss does; else every fourth row is masked. Row 0 is
    clip-active (its label's log-probability is below ln 1e-10)."""
    logits = 3 * torch.randn((n, 3), device="cuda", generator=gen)
    logits[0] = torch.tensor([0.0, 40.0, -40.0], device="cuda")
    labels = torch.randint(0, 3, (n,), device="cuda", generator=gen, dtype=torch.int32)
    labels[0] = 2
    rows = torch.arange(n, device="cuda")
    if depth:
        z = rows % depth
        mask = ((z >= 1) & (z < depth - 1)).float()
    else:
        mask = (rows % 4 != 3).float()
    mask[0] = 1.0
    return logits.to(dtype), labels, mask


def check_k2(card: str) -> tuple[dict, dict]:
    from hdenseunet_tpu_torch.ops import wce as W

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    w = torch.tensor((0.78, 0.65, 8.57), device="cuda")
    cases = [  # (label, rows, dtype, depth)
        ("end2end 8x224x224x8", 8 * 224 * 224 * 8, torch.bfloat16, 8),
        ("end2end fp32", 8 * 224 * 224 * 8, torch.float32, 8),
        ("2d stage 8x224x224", 8 * 224 * 224, torch.bfloat16, None),
        ("2d stage fp32", 8 * 224 * 224, torch.float32, None),
    ]
    fwd_out = bwd_out = None
    for label, n, dtype, depth in cases:
        logits, labels, mask = wce_case(n, dtype, gen, depth=depth)
        g = torch.tensor(1.0, device="cuda")
        loss, cnt = W.wce_forward(logits, labels, mask, w)
        d = W.wce_backward(logits, labels, mask, w, cnt, g)
        torch.cuda.synchronize()
        loss_err, d_err = k2_errors(loss, cnt, d, logits, labels, mask, w, g, label)
        assert not d[0].any(), "the clip-active row took a gradient"
        fwd = in_turns(lambda: W.wce_forward(logits, labels, mask, w),
                       lambda: W.weighted_ce_reference(logits, labels, mask, w))
        bwd = in_turns(lambda: W.wce_backward(logits, labels, mask, w, cnt, g),
                       lambda: W.weighted_ce_backward_reference(logits, labels, mask, w, cnt, g))
        row = 3 * logits.element_size() + 4 + 4  # logits, label, mask
        b_fwd = bound(n * row + 3 * 4 + 2 * 4, n * (6 * 3 + 6))
        b_bwd = bound(n * (row + 3 * logits.element_size()) + 3 * 4 + 2 * 4, n * (8 * 3 + 8))
        print(
            f"K2 {label} {str(dtype)[6:]} N={n}: loss err {loss_err:.3g}, dlogits max_abs_err "
            f"{d_err:.3g}; forward {fwd[0]:.4f} ms vs plain {fwd[1]:.4f} ms, "
            f"bound {b_fwd['bound_ms']:.4f} ms ({b_fwd['bound_by']}); backward {bwd[0]:.4f} ms "
            f"vs plain {bwd[1]:.4f} ms, bound {b_bwd['bound_ms']:.4f} ms ({b_bwd['bound_by']}) [{card}]"
        )
        if fwd_out is None:  # the end2end bf16 case gives the times
            fwd_out = dict(max_abs_err=0.0, ms=fwd[0], plain_ms=fwd[1], **b_fwd)
            bwd_out = dict(max_abs_err=0.0, ms=bwd[0], plain_ms=bwd[1], **b_bwd)
            fwd_out["kernels_per_call"] = kernels_per_call(lambda: W.wce_forward(logits, labels, mask, w))
            bwd_out["kernels_per_call"] = kernels_per_call(
                lambda: W.wce_backward(logits, labels, mask, w, cnt, g))
        fwd_out["max_abs_err"] = max(fwd_out["max_abs_err"], loss_err)
        bwd_out["max_abs_err"] = max(bwd_out["max_abs_err"], d_err)
    return fwd_out, bwd_out


def check_back_to_back(card: str) -> None:
    """K1's backward at three shapes with K2's forward between them, all
    queued before one sync, twice: every call agrees with its plain version
    and the second round gives the same bits as the first. Both kernels take
    tickets from the stream's scratch counters (K1 one per channel tile, K2
    one), so a counter a last block failed to reset would show here."""
    from hdenseunet_tpu_torch.ops import fused_affine as K, wce as W

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    shapes = ((12544, 2064, torch.bfloat16), (200704, 192, torch.bfloat16), (3136, 1056, torch.float32))
    cases = [k1_backward_case(rows, c, dtype, True, gen) for rows, c, dtype in shapes]
    logits, labels, mask = wce_case(8 * 224 * 224, torch.bfloat16, gen, depth=None)
    w = torch.tensor((0.78, 0.65, 8.57), device="cuda")

    def round_():
        out = []
        for g, x, scale, y in cases:
            out += [K.affine_relu_backward(g, x, scale, y), W.wce_forward(logits, labels, mask, w)]
        return out

    first, second = round_(), round_()
    torch.cuda.synchronize()
    for (rows, c, dtype), (g, x, scale, y), got in zip(shapes, cases, first[0::2]):
        k1_backward_error(got, K.affine_relu_backward_reference(g, x, scale, y), g, x, f"{rows}x{c}")
    loss_p, cnt_p = W.weighted_ce_reference(logits, labels, mask, w)
    for loss, cnt in first[1::2]:
        assert float(cnt) == float(cnt_p) and abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    assert all(torch.equal(u, v) for a, b in zip(first, second) for u, v in zip(a, b)), "repeat differs"
    print(f"back to back: K1 backward at {[s[:2] for s in shapes]} with K2 forward between, "
          f"twice: plain answers, bit-identical repeats [{card}]")


@contextlib.contextmanager
def recorded_calls():
    """Note (rows, C, dtype, relu) of every K1-backward call and (rows, C,
    dtype) of every K2 call made through the autograd Functions, by wrapping
    AffineReLU.backward and WeightedCE.forward for the duration; launch
    counts are untouched. The K1 record is read from the incoming gradient:
    under remat, ctx.saved_tensors may be unpacked only once."""
    from hdenseunet_tpu_torch.ops import fused_affine as K, wce as W

    calls = {"k1": [], "k2": []}
    k1_backward, k2_forward = K.AffineReLU.backward, W.WeightedCE.forward

    def k1(ctx, g):
        calls["k1"].append((g.numel() // g.shape[1], g.shape[1], g.dtype, ctx.relu))
        return k1_backward(ctx, g)

    def k2(ctx, logits2, *rest):
        calls["k2"].append((*logits2.shape, logits2.dtype))
        return k2_forward(ctx, logits2, *rest)

    K.AffineReLU.backward, W.WeightedCE.forward = staticmethod(k1), staticmethod(k2)
    try:
        yield calls
    finally:
        K.AffineReLU.backward = staticmethod(k1_backward)
        W.WeightedCE.forward = staticmethod(k2_forward)


def sweep_k1_backward(card: str, calls: list, steps: int) -> dict:
    """K1's backward at every (rows, C, dtype, relu) class of one end2end
    step: each held against its plain version and timed alone with the L2
    cache flushed; the step's summed time against its summed bound."""
    from hdenseunet_tpu_torch.ops import fused_affine as K

    classes = Counter(calls)
    assert len(calls) == BSR_2D * steps and all(n % steps == 0 for n in classes.values()), classes
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    timed, worst = [], 0.0
    for (rows, c, dtype, relu), n in sorted(classes.items(), key=lambda kv: (-kv[0][0], kv[0][1])):
        g, x, scale, y = k1_backward_case(rows, c, dtype, relu, gen)
        got = K.affine_relu_backward(g, x, scale, y, relu=relu)
        want = K.affine_relu_backward_reference(g, x, scale, y, relu=relu)
        torch.cuda.synchronize()
        worst = max(worst, k1_backward_error(got, want, g, x, f"{rows}x{c}"))
        ms = cold_ms(lambda: K.affine_relu_backward(g, x, scale, y, relu=relu))
        elems = rows * c * ((4 if relu else 3) * x.element_size())
        b = bound(elems + 3 * 4 * c, 5 * rows * c)["bound_ms"]
        timed.append((n // steps, ms, b, f"{rows}x{c} {str(dtype)[6:]}"))
        del g, x, y, got, want
    step_ms = sum(n * ms for n, ms, _, _ in timed)
    step_bound = sum(n * b for n, _, b, _ in timed)
    print(
        f"K1 backward over one end2end step: {sum(n for n, *_ in timed)} calls in {len(timed)} "
        f"classes, each held to its plain version (worst dA/dB err {worst:.3g}); kernel "
        f"{step_ms:.4f} ms against a summed bound of {step_bound:.4f} ms "
        f"({100 * step_bound / step_ms:.1f} % of bound), L2 flushed before each call [{card}]"
    )
    for n, ms, b, label in sorted(timed, key=lambda t: -t[0] * t[1])[:6]:
        print(f"  {label}: {n} x {ms:.4f} ms, bound {b:.4f} ms ({100 * b / ms:.1f} %)")
    return dict(step_ms=step_ms, step_bound_ms=step_bound, step_classes=len(timed))


def sweep_k2(card: str, calls: dict, steps: int) -> tuple[dict, dict]:
    """K2 forward and backward at each training stage's row count, timed
    alone with the L2 cache flushed; per stage, the step's time against
    its bound."""
    from hdenseunet_tpu_torch.ops import wce as W

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    w = torch.tensor((0.78, 0.65, 8.57), device="cuda")
    g = torch.tensor(1.0, device="cuda")
    fwd, bwd = {}, {}
    for path, recorded in calls.items():
        (n, c, dtype), = set(recorded)
        assert c == 3 and len(recorded) == steps, recorded
        logits, labels, mask = wce_case(n, dtype, gen, depth=None)
        _, cnt = W.wce_forward(logits, labels, mask, w)
        ms_f = cold_ms(lambda: W.wce_forward(logits, labels, mask, w))
        ms_b = cold_ms(lambda: W.wce_backward(logits, labels, mask, w, cnt, g))
        row = 3 * logits.element_size() + 4 + 4
        b_f = bound(n * row + 3 * 4 + 2 * 4, n * (6 * 3 + 6))["bound_ms"]
        b_b = bound(n * (row + 3 * logits.element_size()) + 3 * 4 + 2 * 4, n * (8 * 3 + 8))["bound_ms"]
        fwd[path] = dict(launches=1, ms=ms_f, bound_ms=b_f)
        bwd[path] = dict(launches=1, ms=ms_b, bound_ms=b_b)
        print(
            f"K2 in one {path} step (N={n}, {str(dtype)[6:]}, L2 flushed): forward {ms_f:.4f} ms "
            f"against {b_f:.4f} ms ({100 * b_f / ms_f:.1f} % of bound), backward {ms_b:.4f} ms "
            f"against {b_b:.4f} ms ({100 * b_b / ms_b:.1f} %) [{card}]"
        )
    return fwd, bwd


def synthetic_case(seed: int):
    """A CT volume of integer HU in the preprocessing window and an external
    liver mask, both (X, Y, Z)."""
    rng = np.random.default_rng(seed)
    vol = rng.integers(HU_RANGE[0], HU_RANGE[1] + 1, VOLUME_SHAPE).astype(np.float32)
    ext = np.zeros(VOLUME_SHAPE, np.int16)
    ext[150:370, 120:360, LIVER_Z[0] : LIVER_Z[1]] = 1
    ext[230:260, 200:230, 40:50] = 2  # a tumor label, merged into the mask
    return vol, ext


def serve_path(card: str) -> dict:
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    model = init_model(HDenseUNet(preset=cfg.model.preset, device="cuda"), SEED)
    per_batch = route_counts(model)
    assert per_batch == dict(affine_relu=4, affine_gemm=111), per_batch
    predictor = VolumePredictor(model, cfg, arch="end2end", device="cuda")
    cases = [synthetic_case(SEED + i) for i in range(2)]
    runs = 0
    for vol, ext in cases:
        _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
        plan = predictor.windows.plan(vol.shape, z_lo, z_hi)
        runs += int((plan["weights"].sum(axis=1) > 0).sum())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds, labelmaps = [], []
    for vol, ext in cases:
        t0 = time.perf_counter()
        labelmaps.append(predictor.segment(vol, ext))
        seconds.append(time.perf_counter() - t0)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    scoring = []  # device scoring alone per volume, synchronised (PERF.md §2)
    for vol, ext in cases:
        _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
        img = np.asarray(vol, np.float32) - cfg.infer.mean
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.windows.labelmask_async(img, z_lo, z_hi)
        torch.cuda.synchronize()
        scoring.append(time.perf_counter() - t0)

    assert launches == only(**scaled(per_batch, runs), window_accumulate=runs,
                            score_finish=len(cases)), (launches, per_batch, runs)
    for (vol, _), lab in zip(cases, labelmaps):
        assert lab.dtype == np.uint8 and lab.shape == vol.shape, (lab.dtype, lab.shape)
        assert set(np.unique(lab).tolist()) <= {0, 1, 2}, np.unique(lab)
    vol, ext = cases[0]
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    probs = predictor.windows.score(vol - cfg.infer.mean, z_lo, z_hi)
    assert bool(torch.isfinite(probs).all()), "non-finite scores"
    assert float(probs.min()) >= 0.0 and float(probs.max()) <= 1.0 + 1e-5
    counts = [np.bincount(lab.ravel(), minlength=3).tolist() for lab in labelmaps]
    host_pp = "native" if postprocess.native.pp_available() else "scipy"
    assert all(launches[name] == 0 for name in K4_NAMES), launches
    print(
        f"serve path: 2 volumes {VOLUME_SHAPE} full preset bf16, {runs} window runs, "
        f"s/volume {[round(s, 3) for s in seconds]}, device scoring s/volume {[round(s, 4) for s in scoring]}, "
        f"peak {peak / 2**30:.2f} GiB, "
        f"launches {launches} (K1 {per_batch['affine_relu']} and K5 {per_batch['affine_gemm']} x {runs}), "
        f"label counts {counts}, host postprocess {host_pp} [{card}]"
    )
    return dict(launches=launches, model=model, predictor=predictor, cases=cases, labelmaps=labelmaps,
                probs=probs.cpu(), seconds=seconds, scoring=scoring, peak=peak, runs=runs // len(cases),
                per_batch=per_batch)


def mfu_path(card: str, serve: dict) -> dict:
    """Device scoring's MFU on phase 4's first volume with its predictor
    (shipped InferConfig, bfloat16): ``estimate_flops`` over
    ``compute_seconds`` (12 scorings: both k warmed, two reps of k=1 and of
    k=3) over the card's bf16 peak, beside phase 4's synchronised device
    scoring. Returns the launch counts."""
    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.utils.flops import peak_flops_per_chip

    sc, icfg = serve["predictor"].windows, serve["predictor"].cfg.infer
    vol, ext = serve["cases"][0]
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    flops = sc.estimate_flops(vol.shape, z_lo, z_hi)
    peak = peak_flops_per_chip()
    reset_counts()
    d = sc.compute_seconds(np.asarray(vol, np.float32) - icfg.mean, z_lo, z_hi, detail=True)
    launches = read_counts()
    # both phase 4 volumes share one plan, so each scoring runs half its K1 launches
    assert launches == only(**scaled(serve["per_batch"], 12 * serve["runs"]),
                            window_accumulate=12 * serve["runs"]), launches
    mfu = flops / d["seconds"] / peak
    assert 0.0 < mfu < 1.0, mfu
    print(
        f"mfu: serve volume {vol.shape} ({serve['runs']} window runs), estimate_flops "
        f"{flops / 1e12:.4f} TFLOP; compute_seconds {d['seconds']:.4f} s (slopes "
        f"{[round(v, 4) for v in d['slopes']]}, t(k=1) {[round(v, 4) for v in d['t_small']]}, t(k=3) "
        f"{[round(v, 4) for v in d['t_big']]}); {flops / d['seconds'] / 1e12:.1f} TFLOP/s, MFU "
        f"{100 * mfu:.2f} % of the {peak / 1e12:.1f} TFLOP/s bf16 peak; phase 4's device scoring "
        f"{[round(s, 4) for s in serve['scoring']]} s/volume, MFU "
        f"{[round(100 * flops / s / peak, 2) for s in serve['scoring']]} % [{card}]"
    )
    return launches


def trace_path(card: str, serve: dict) -> dict:
    """One ``VolumePredictor.segment`` of phase 4's first volume inside
    ``utils.profiling.trace``: its labelmap as phase 4's, a trace file that
    names K1's and K5's kernels and the predictor's scoring, fetch and postprocess
    scopes; the program's recorder over the segment (each span's count,
    host and self seconds and syncs; ``window_batches`` equal to K3a's
    launches); the device time of the convolution kernels (their rate of
    estimate_flops), of K5, of K1, of cat and copies and of the rest, and the
    ten device ops with the most time. Returns the launch counts."""
    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.utils import profiling
    from hdenseunet_tpu_torch.utils.flops import peak_flops_per_chip
    from hdenseunet_tpu_torch.utils.profiling import trace

    vol, ext = serve["cases"][0]
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_", dir=BUILD) as logdir:
        reset_counts()
        profiling.reset()
        t0 = time.perf_counter()
        with trace(logdir) as prof:
            lab = serve["predictor"].segment(vol, ext)
        wall = time.perf_counter() - t0
        launches = read_counts()
        recorded = profiling.snapshot()
        files = list(Path(logdir).glob("*.pt.trace.json"))
        assert len(files) == 1, files
        text = files[0].read_text()
    assert np.array_equal(lab, serve["labelmaps"][0]), "the traced segment differs from phase 4's"
    assert launches == only(**scaled(serve["per_batch"], serve["runs"]),
                            window_accumulate=serve["runs"], score_finish=1), launches
    missing = [n for n in [f'"{scope}"' for scope in SCOPES] + ["affine_relu", "affine_gemm"]
               if n not in text]
    assert not missing, f"the trace names none of {missing}"
    assert recorded["counts"].get("window_batches") == launches["window_accumulate"], (recorded, launches)
    by_op, spans = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a scope's span on the device timeline is no op of its own
            scope = e.name in SCOPES or e.name in recorded["spans"] or getattr(e, "is_user_annotation", False)
            table = spans if scope else by_op
            n, ms = table.get(e.name, (0, 0.0))
            table[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    busy = sum(ms for _, ms in by_op.values())
    assert busy > 0, "the profiler saw no device time"
    k5_ms = sum(ms for name, (_, ms) in by_op.items() if "affine_gemm" in name)
    conv_ms = sum(ms for name, (_, ms) in by_op.items()
                  if CONV_KERNEL.search(name) and "affine_gemm" not in name)
    k1_ms = sum(ms for name, (_, ms) in by_op.items() if "affine_relu" in name)
    cat_ms = sum(ms for name, (_, ms) in by_op.items() if "CatArray" in name)
    copy_ms = sum(ms for name, (_, ms) in by_op.items() if "copy" in name.lower())
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    # estimate_flops counts every convolution, the 1x1s that K5 runs too
    conv_rate = serve["predictor"].windows.estimate_flops(vol.shape, z_lo, z_hi) / ((conv_ms + k5_ms) / 1e3)
    print(f"trace: one segment of {vol.shape}, traced wall {wall:.3f} s against phase 4's "
          f"{[round(s, 3) for s in serve['seconds']]} untraced, {len(text) / 2**20:.1f} MiB of trace, "
          f"{sum(n for n, _ in by_op.values())} device events, device busy {busy:.1f} ms; scopes on the "
          f"device timeline {dict((k, round(ms, 2)) for k, (_, ms) in spans.items())} ms; cuDNN's "
          f"convolution kernels {conv_ms:.1f} ms ({100 * conv_ms / busy:.1f} %), K5 {k5_ms:.2f} ms "
          f"({100 * k5_ms / busy:.1f} %), together at {conv_rate / 1e12:.1f} TFLOP/s of estimate_flops, "
          f"{100 * conv_rate / peak_flops_per_chip():.2f} % of the bf16 peak; K1 {k1_ms:.2f} ms "
          f"({100 * k1_ms / busy:.1f} %); cat {cat_ms:.2f} ms; copies {copy_ms:.2f} ms; the rest "
          f"{busy - conv_ms - k5_ms - k1_ms:.1f} ms; the ten device ops with the most time [{card}]:")
    for name, (n, ms) in sorted(by_op.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {ms:9.2f} ms {100 * ms / busy:5.1f} % x{n:<5d} {name[:110]}")
    print(f"trace: the program's spans (count, host s, self s, syncs), counters {recorded['counts']}:")
    for name, r in sorted(recorded["spans"].items(), key=lambda kv: -kv[1]["total_s"]):
        print(f"  {name:<14s} x{r['count']:<4d} {r['total_s']:9.4f} s {r['self_s']:9.4f} s {r['syncs']:4d}")
    return launches


def exit_code(main, argv: list[str]) -> int:
    """The code a command-line ``main`` exits with."""
    try:
        main(argv)
    except SystemExit as e:
        return e.code
    raise AssertionError(f"{argv[0]} returned without an exit code")


def parity_path(card: str, per_batch: dict) -> dict:
    """``python -m hdenseunet_tpu_torch.weights.parity`` at full width: the
    2D model at 224x224 and the end2end hybrid at 224x224x8, from seeded
    weights written as an .npz, dumped in float32 on the card and on the
    CPU; ``compare`` must exit 0 at the tool's defaults. Returns the launch
    counts of the dumps."""
    from hdenseunet_tpu_torch.core import params as P
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
    from hdenseunet_tpu_torch.weights import parity

    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parity_", dir=BUILD) as tmp:
        root = Path(tmp)
        params, state = P.to_numpy(init_model(HDenseUNet(preset="full"), SEED))
        np.savez(root / "weights.npz", **{f"{layer}/{leaf}": v for tree in (params, state)
                                          for layer, leaves in tree.items() for leaf, v in leaves.items()})
        del params, state
        reset_counts()
        for model in ("2d", "hybrid"):
            dumps, seconds = [], []
            for device in ("cuda", "cpu"):
                out = root / f"{model}_{device}" / "acts.npz"
                out.parent.mkdir()
                t0 = time.perf_counter()
                parity.main(["dump", "--weights", str(root / "weights.npz"), "--out", str(out),
                             "--model", model, "--input-size", "224", "--input-cols", "8", "--device", device])
                seconds.append(time.perf_counter() - t0)
                dumps.append(str(out))
            code = exit_code(parity.main, ["compare", *dumps])
            assert code == 0, f"parity compare of the {model} dumps, card against CPU, exited {code}"
            print(f"parity: {model} at 224x224{'x8' if model == 'hybrid' else ''} float32, card against CPU "
                  f"at the tool's defaults (rtol = atol = 1e-3): exit 0; dump s card {seconds[0]:.2f}, "
                  f"CPU {seconds[1]:.2f} [{card}]")
        launches = read_counts()
    from hdenseunet_tpu_torch.models.denseunet2d import DenseUNet2D

    per_2d = route_counts(DenseUNet2D(device="meta"))
    assert launches == only(**{k: per_2d[k] + per_batch[k] for k in per_batch}), launches
    return launches


@contextlib.contextmanager
def plain_k1_k5():
    """Every frozen BN∘Scale∘ReLU of the models through K1's and K5's plain
    versions for the block, on the card too: the yardstick a forward through
    K1 and K5 is held to. The plain versions count no launch."""
    import types

    from hdenseunet_tpu_torch.models import layers as L
    from hdenseunet_tpu_torch.ops.affine_gemm import affine_gemm_reference
    from hdenseunet_tpu_torch.ops.fused_affine import affine_relu_reference

    saved = L.AffineReLU, L.K5
    L.AffineReLU = types.SimpleNamespace(
        apply=lambda x, a, b, relu: affine_relu_reference(x, a, b, relu=relu))
    L.K5 = types.SimpleNamespace(affine_gemm=affine_gemm_reference)
    try:
        yield
    finally:
        L.AffineReLU, L.K5 = saved


def with_plain_k1_k5(fn):
    """fn run under :func:`plain_k1_k5`."""
    def run():
        with plain_k1_k5():
            return fn()
    return run


@contextlib.contextmanager
def unfused():
    """Every dense block of the models through the concatenation route for
    the block, at inference too: each bottleneck and transition K1, then
    cuDNN's 1x1 convolution, then K1, the route K5 replaced."""
    from hdenseunet_tpu_torch.models import layers as L

    saved = L.fused_1x1
    L.fused_1x1 = lambda ctx: False
    try:
        yield
    finally:
        L.fused_1x1 = saved


@contextlib.contextmanager
def plain_k3():
    """The device scorer's window accumulate and finish through K3's plain
    versions for the block, on the card too: the yardstick the served path
    through K3 is held to. The plain versions count no launch."""
    import types

    from hdenseunet_tpu_torch.infer import device_pipeline as D
    from hdenseunet_tpu_torch.ops import score as S

    saved = D.K3
    D.K3 = types.SimpleNamespace(
        window_accumulate=S.window_accumulate_reference, score_finish=S.score_finish_reference)
    try:
        yield
    finally:
        D.K3 = saved


def tie_scores(count: np.ndarray, rows: int, zs: int) -> tuple:
    """Index arrays (x, y, z) and float32 scores (liver, tumour) that put
    voxels of the first ``zs`` slices on the thresholds' ties, for the
    per-z ``count``: at x = 0 an average of exactly 0.5 in the liver
    channel, at x = 1 one ulp below, at x = 2 exactly float32(0.9) in the
    tumour channel, at x = 3 the next score below, each at y = z % rows with
    the other channel 0. A slice whose count + 1e-4 no score divides to
    exactly float32(0.9) gets the 0.5 ties only."""
    t, down, up = np.float32(0.9), np.float32(0), np.float32(np.inf)
    xs, ys, zz, values = [], [], [], []
    for z in range(zs):
        d = np.float32(count[z] + np.float32(1e-4))
        half = np.float32(0.5) * d
        ties = [(0, half, 0), (1, np.nextafter(half, down), 0)]
        cand = np.float32(t * d)
        while np.float32(cand / d) < t:
            cand = np.nextafter(cand, up)
        while np.float32(cand / d) > t:
            cand = np.nextafter(cand, down)
        if np.float32(cand / d) == t:
            lower = cand
            while np.float32(lower / d) == t:
                lower = np.nextafter(lower, down)
            ties += [(2, 0, cand), (3, 0, lower)]
        for x, liver, tumor in ties:
            xs.append(x), ys.append(z % rows), zz.append(z), values.append((liver, tumor))
    return np.array(xs), np.array(ys), np.array(zz), np.float32(values)


def check_k3(card: str, serve: dict) -> dict:
    """K3 on the card against its plain versions, bit for bit:
    window_accumulate (K3a) on the first two live window batches of phase
    4's first volume (the scorer's own logits, the plan's starts and
    weights) and on seeded batches at the served shape (a stride-2 run with
    a weight-0 window and multiplicities 2-3, the per-window grid's
    non-aligned overlapping starts, float32 logits, logits in the dhwc
    route's memory order), each into a seeded partly filled buffer;
    score_finish (K3b) on that volume's summed score buffer at the served
    zp (labels over zp and over pack_z, the wire over pack_z) with voxels
    set on the thresholds' ties. Times at the first served batch and the
    served finish, warm and L2-flushed, the plain versions' in turns,
    bounds, kernels per call. Then both volumes through ``segment`` with
    K3's plain versions: labelmaps byte-identical to phase 4's, device
    scoring s/volume in turns with K3 and without. Returns the JSON numbers
    per kernel and the plain path's launch counts."""
    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.ops import score as S

    predictor = serve["predictor"]
    sc, icfg = predictor.windows, predictor.cfg.infer
    cols, t_l, t_t = icfg.input_cols, icfg.thres_liver, icfg.thres_tumor
    vol, ext = serve["cases"][0]
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    img = np.asarray(vol, np.float32) - icfg.mean
    plan = sc.plan(vol.shape, z_lo, z_hi)
    wb = plan["wb"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    with torch.inference_mode():
        vol_d = sc._wire(img, plan)
        x, y, zp = vol_d.shape
        run = sc._dedup_batch(vol_d, wb)
        live = [(s.astype(np.int64), w) for s, w in zip(plan["starts"], plan["weights"]) if w.any()]
        served = [(run(s), s, w) for s, w in live[:2]]

        def synth(dtype, order=None):
            lg = 3 * torch.randn((wb, x, y, cols, 3), device="cuda", generator=gen)
            if order == "dhwc":  # the same logical tensor, d-major in memory
                lg = lg.permute(0, 3, 1, 2, 4).contiguous().permute(0, 2, 3, 1, 4)
            return lg.to(dtype)

        run2 = (np.arange(wb) * 2 + 20, np.float32([1, 0, 2, 1, 3, 1, 1, 2]))
        grid = [(np.int64([3, 4, 9, 10, 11, 17, 25, 40]), np.float32([1, 2, 1, 1, 3, 1, 1, 2])),
                (np.int64([41, 47, 50, 53, 55, 56, 62, zp - cols]), np.float32([1, 1, 2, 1, 0, 1, 0, 3]))]
        cases = {
            "served batches 1-2 (bf16)": served,
            "stride-2 run, weight 0, multiplicities 2-3 (bf16)": [(synth(torch.bfloat16), *run2)],
            "per-window grid, non-aligned starts (bf16)": [(synth(torch.bfloat16), *g) for g in grid],
            "float32 logits": [(synth(torch.float32), *run2)],
            "dhwc memory order (bf16)": [(synth(torch.bfloat16, "dhwc"), *run2)],
        }
        base = torch.rand((x, y, zp, 3), device="cuda", generator=gen)
        base_count = torch.randint(0, 4, (zp,), device="cuda", generator=gen).float()
        for label, batches in cases.items():
            got = (base.clone(), base_count.clone())
            want = (base.clone(), base_count.clone())
            for lg, s, w in batches:
                S.window_accumulate(*got, lg, s, w, cols=cols)
                S.window_accumulate_reference(*want, lg, s, w, cols=cols)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"K3a {label}"
        print(f"K3 window_accumulate: {len(cases)} cases at {x}x{y}, zp {zp}, {cols} columns, "
              f"window batch {wb} ({', '.join(cases)}): score and count equal the plain version bit "
              f"for bit [{card}]")

        score, count = sc._sums(vol_d, plan)
        tied = score.clone()
        ix, iy, iz, values = tie_scores(count.cpu().numpy(), y, plan["zw"])
        idx = [torch.from_numpy(a).cuda() for a in (ix, iy, iz)]
        tied[idx[0], idx[1], idx[2], 1:] = torch.from_numpy(values).cuda()
        finishes = [("labels", None), ("labels", plan["zw"]), ("wire", plan["zw"])]
        for buf, label in ((score, "served"), (tied, "ties")):
            for out, pack_z in finishes:
                got = S.score_finish(buf, count, t_l, t_t, out=out, pack_z=pack_z)
                want = S.score_finish_reference(buf, count, t_l, t_t, out=out, pack_z=pack_z)
                assert torch.equal(got, want), f"K3b {label} {out} pack_z={pack_z}"
        lab = S.score_finish(tied, count, t_l, t_t, out="labels", pack_z=plan["zw"])[idx[0], idx[1], idx[2]]
        tie_labels = [sorted(set(lab[idx[0] == r].tolist())) for r in range(4)]
        assert tie_labels == [[1], [0], [3], [0]], tie_labels
        print(f"K3 score_finish: served score buffer {tuple(score.shape)} and with {len(ix)} voxels on "
              f"the thresholds' ties (0.5 and float32(0.9) exactly, one ulp under), labels over zp "
              f"and over pack_z {plan['zw']}, the wire over pack_z: equal the plain version byte for "
              f"byte; tie labels {tie_labels} [{card}]")

        # times: the first served batch into a copy of the summed buffer, the served finish
        lg, s, w = served[0]
        acc_k, acc_p = (score.clone(), count.clone()), (score.clone(), count.clone())
        n_live = int((w != 0).sum())
        lo, hi = int(s[w != 0].min()) + 1, int(s[w != 0].max()) + cols - 1
        calls = {  # name: (kernel, plain, bytes in + out, operations)
            "window_accumulate": (
                lambda: S.window_accumulate(*acc_k, lg, s, w, cols=cols),
                lambda: S.window_accumulate_reference(*acc_p, lg, s, w, cols=cols),
                n_live * x * y * (cols - 2) * 3 * lg.element_size() + 2 * (x * y * 3 + 1) * (hi - lo) * 4,
                K3A_OPS * n_live * x * y * (cols - 2)),
            "score_finish": (
                lambda: S.score_finish(score, count, t_l, t_t, out="wire", pack_z=plan["zw"]),
                lambda: S.score_finish_reference(score, count, t_l, t_t, out="wire", pack_z=plan["zw"]),
                x * y * plan["zw"] * (3 * 4 + 0.25) + plan["zw"] * 4,
                K3B_OPS * x * y * plan["zw"]),
        }
        out = {}
        for name, (kernel, plain, n_bytes, n_ops) in calls.items():
            ms, plain_ms = in_turns(kernel, plain)
            b = bound(n_bytes, n_ops)
            out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, cold_ms=cold_ms(kernel), **b,
                             kernels_per_call=kernels_per_call(kernel, 1), cases=len(cases) if
                             name == "window_accumulate" else 2 * len(finishes))
            print(f"K3 {name} (served: {n_live} live windows of {wb}, z-span {hi - lo}; finish over "
                  f"pack_z {plan['zw']} of zp {zp}): kernel {ms:.4f} ms, L2 flushed "
                  f"{out[name]['cold_ms']:.4f} ms (1 kernel), plain {plain_ms:.4f} ms (in turns), bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {n_bytes / 1e6:.1f} MB) [{card}]")
        del acc_k, acc_p, served, cases, base, score, count, tied

    # the served path with K3's plain versions
    reset_counts()
    with plain_k3():
        labelmaps = [predictor.segment(v, e) for v, e in serve["cases"]]
    launches = read_counts()
    assert launches["window_accumulate"] == 0 and launches["score_finish"] == 0, launches
    assert all(launches[k] == serve["launches"][k] for k in ("affine_relu", "affine_gemm")), launches
    for got, want in zip(labelmaps, serve["labelmaps"]):
        assert np.array_equal(got, want), "serve_plain_k3: the labelmap differs from phase 4's"
    scoring = {"k3": [], "plain": []}
    for v, e in serve["cases"]:
        _, lo_z, hi_z = postprocess.liver_mask_extent(e)
        v_img = np.asarray(v, np.float32) - icfg.mean
        for way in ("k3", "plain", "plain", "k3"):  # in turns
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with plain_k3() if way == "plain" else contextlib.nullcontext():
                sc.labelmask_async(v_img, lo_z, hi_z)
                torch.cuda.synchronize()
            scoring[way].append(time.perf_counter() - t0)
    print(f"K3 served path: both volumes through segment with K3's plain versions: labelmaps "
          f"byte-identical to phase 4's (K3); device scoring s/volume in turns, with K3 "
          f"{[round(v, 4) for v in scoring['k3']]}, plain {[round(v, 4) for v in scoring['plain']]} "
          f"(volume 1 then 2, two each) [{card}]")
    return dict(numbers=out, launches=launches, scoring=scoring)


def k5_shapes() -> list:
    """K5's calls in one served window batch at the full preset, the first
    and last bottleneck of every stage and every transition: (label, rows,
    K, row stride, N, epilogue, ndim). A bottleneck reads the first K
    channels of its block's buffer, whose width is the row stride."""
    from hdenseunet_tpu_torch.models import denseunet2d as D2, denseunet3d as D3

    shapes = []
    for branch, net, rows, ndim in (("2d", D2, K5_STACKS * 128 * 128, 4),
                                    ("3d", D3, K5_WINDOWS * 128 * 128 * 2, 5)):
        c, g = net.INITIAL_FILTERS, net.GROWTH_RATE
        for i, nb in enumerate(net.ENC_BLOCKS):
            width = c + nb * g
            shapes.append((f"{branch} stage {i + 2} first", rows, c, width, 4 * g, True, ndim))
            shapes.append((f"{branch} stage {i + 2} last", rows, width - g, width, 4 * g, True, ndim))
            if i < len(net.ENC_BLOCKS) - 1:
                shapes.append((f"{branch} transition {i + 2}", rows, width, width, width // 2, False, ndim))
                c, rows = width // 2, rows // 4
    return shapes


def k5_case(rows: int, k: int, ld: int, n: int, epi: bool, ndim: int, dtype, gen):
    """Seeded K5 inputs: x the first k channels of a (rows, ld) buffer seen
    as (1, k, rows, 1[, 1]), w (n, k), the folded pairs."""
    buf = (2 * torch.randn(rows, ld, device="cuda", generator=gen)).to(dtype)
    x = buf[:, :k].view(1, rows, *[1] * (ndim - 3), k).movedim(-1, 1)
    w = (torch.randn(n, k, device="cuda", generator=gen) * k**-0.5).to(dtype)
    pairs = [(1 + 0.5 * torch.randn(c, device="cuda", generator=gen),
              0.5 * torch.randn(c, device="cuda", generator=gen)) for c in (k, n)]
    return x, w, (*pairs[0], *(pairs[1] if epi else ()))


def k5_errors(x, w, args, got, plain, label: str) -> tuple[float, float]:
    """Hold K5's result and its plain version's to the float64 chain
    (``affine_gemm.float64_reference``): the kernel within its bound, the
    plain version within its own (its prologue rounds twice), so the two
    within the sum. Returns (largest error against the plain version,
    largest against float64)."""
    from hdenseunet_tpu_torch.ops import affine_gemm as K5

    rows, n = x.numel() // x.shape[1], w.shape[0]
    as_rows = lambda t: t.movedim(1, -1).reshape(rows, n).double()  # noqa: E731
    want, tol = K5.float64_reference(x, w, *args)
    err = (as_rows(got) - want).abs()
    assert bool((err <= tol).all()), f"K5 disagrees with float64 at {label}: max {float(err.max())}"
    worst64 = float(err.max())
    if plain is None:
        return 0.0, worst64
    _, tol_plain = K5.float64_reference(x, w, *args, fused=False)
    err = (as_rows(plain) - want).abs()
    assert bool((err <= tol_plain).all()), f"K5's plain version at {label}: max {float(err.max())}"
    err = (as_rows(got) - as_rows(plain)).abs()
    assert bool((err <= tol + tol_plain).all()), f"K5 disagrees with its plain version at {label}"
    return float(err.max()), worst64


def check_k5(card: str, serve: dict) -> dict:
    """K5 (affine_gemm, ops/affine_gemm.py) on the card, then the served
    path through it against the concatenation route it replaced.

    At every shape of :func:`k5_shapes`, bfloat16 (and one float32 case):
    the kernel and its plain version against the float64 chain
    (:func:`k5_errors`); ms warm and L2-flushed, the plain version's in
    turns, ``library_ms`` (cuDNN's 1x1 convolution alone on the prologue's
    output, the one PyTorch call for the product, which the port never
    makes), the unfused chain's (K1, cuDNN, K1 on the concatenation), the
    bound (the larger of (MK + NK + MN) 2 bytes over 3.35 TB/s and 2MNK over
    the bf16 peak), kernels per call, the form the launch took (the output
    tile's width and the persistent grid, ``affine_gemm.form``) and the
    wrapper's host microseconds a call (:func:`host_us`). Then phase 4's
    first volume scored once
    with every K1 input's channels recorded: only the stems' and the last
    blocks' widths, none between a bottleneck and its 3x3 (an x2
    BN∘Scale∘ReLU would show 192 or 128); both volumes' labelmasks through
    K5 and on the concatenation route (serve_unfused: K1 220 a window
    batch, no K5), the voxels that differ; device scoring s/volume and MFU
    with K5 and unfused, in turns; phase 4's model and first volume in
    float32 (TF32 off, :func:`serve_float32`) through both routes, the
    largest probability gap held to DP_FLOAT32_GAP. Returns the JSON
    numbers, serve_unfused's launch counts, the scoring times and the
    float32 run through K5 (phase 9's reference)."""
    import types

    import torch.nn.functional as F

    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.models import layers as L
    from hdenseunet_tpu_torch.ops import affine_gemm as K5, fused_affine as K
    from hdenseunet_tpu_torch.utils.flops import peak_flops_per_chip

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    shapes = k5_shapes()
    numbers, worst = None, 0.0
    for label, rows, k, ld, n, epi, ndim in shapes:
        x, w, args = k5_case(rows, k, ld, n, epi, ndim, torch.bfloat16, gen)
        got, plain = K5.affine_gemm(x, w, *args), K5.affine_gemm_reference(x, w, *args)
        torch.cuda.synchronize()
        err, err64 = k5_errors(x, w, args, got, plain, label)
        worst = max(worst, err)
        del got, plain
        kernel = lambda: K5.affine_gemm(x, w, *args)  # noqa: E731
        ms, plain_ms = in_turns(kernel, lambda: K5.affine_gemm_reference(x, w, *args))
        xc = L.channels_last(x)  # the concatenation the unfused route reads
        conv = F.conv2d if ndim == 4 else F.conv3d
        wc = w.view(n, k, *[1] * (ndim - 2))
        h = K.affine_relu(xc, args[0], args[1])

        def chain():
            y = conv(K.affine_relu(xc, args[0], args[1]), wc)
            return K.affine_relu(y, args[2], args[3]) if epi else y

        library_ms, chain_ms = cuda_ms(lambda: conv(h, wc)), cuda_ms(chain)
        flushed = cold_ms(kernel)
        t_bytes = (rows * k + n * k + rows * n) * 2 / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * rows * n * k / BF16_OPS_PER_S * 1e3
        b = dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        form, us = K5.form(rows, n, torch.bfloat16), host_us(kernel)
        print(f"K5 {label}: rows {rows}, K {k} of {ld}, N {n}, epilogue {epi}: max_abs_err {err:.3g} "
              f"against the plain version ({err64:.3g} against float64), kernel {ms:.4f} ms, L2 flushed "
              f"{flushed:.4f}, plain {plain_ms:.4f} (in turns), library (cuDNN 1x1 alone) "
              f"{library_ms:.4f}, unfused chain (K1, cuDNN, K1) {chain_ms:.4f}, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), {100 * b['bound_ms'] / ms:.1f} % of it; form: "
              f"TMA and wgmma, 128 x {form['tile_n']} tiles, {form['blocks']} persistent blocks; host "
              f"{us:.1f} us a call [{card}]")
        if label == "2d stage 2 last":
            numbers = dict(ms=ms, plain_ms=plain_ms, cold_ms=flushed, library_ms=library_ms,
                           chain_ms=chain_ms, **b, kernels_per_call=kernels_per_call(kernel),
                           shape=f"{label}: rows {rows}, K {k} of {ld}, N {n}")
        del x, w, args, xc, h
    # float32 (the audit paths' dtype) at 2D stage 5's last bottleneck
    label, rows, k, ld, n, epi, ndim = next(sh for sh in shapes if sh[0] == "2d stage 5 last")
    x, w, args = k5_case(rows, k, ld, n, epi, ndim, torch.float32, gen)
    _, err64 = k5_errors(x, w, args, K5.affine_gemm(x, w, *args), None, f"{label} float32")
    ms = cuda_ms(lambda: K5.affine_gemm(x, w, *args))
    print(f"K5 {label} float32: rows {rows}, K {k} of {ld}, N {n}: {err64:.3g} against float64, "
          f"kernel {ms:.4f} ms [{card}]")
    numbers["max_abs_err"] = worst
    del x, w, args

    # the served path: K1's inputs, then the concatenation route
    predictor = serve["predictor"]
    sc, icfg = predictor.windows, predictor.cfg.infer
    vol, ext = serve["cases"][0]
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    img = np.asarray(vol, np.float32) - icfg.mean
    widths, saved = Counter(), L.AffineReLU
    m2, m3 = predictor.windows.model.net2d, predictor.windows.model.net3d
    want = Counter(int(layer.gamma.shape[0]) for layer in (
        m2["conv1_scale"], m2[f"conv{len(m2.blocks) + 1}_blk_scale"],
        m3["3dconv1_scale"], m3[f"3dconv{len(m3.blocks) + 1}_blk_scale"]))
    L.AffineReLU = types.SimpleNamespace(
        apply=lambda x_, *a: widths.update([int(x_.shape[1])]) or saved.apply(x_, *a))
    try:
        sc.labelmask(img, z_lo, z_hi)
    finally:
        L.AffineReLU = saved
    assert widths == Counter({c: n * serve["runs"] for c, n in want.items()}), (widths, want)
    masks = {}
    for way in ("k5", "unfused"):
        reset_counts()
        with unfused() if way == "unfused" else contextlib.nullcontext():
            masks[way] = [sc.labelmask(np.asarray(v, np.float32) - icfg.mean,
                                       *postprocess.liver_mask_extent(e)[1:]) for v, e in serve["cases"]]
        launches = read_counts()
    runs = serve["runs"] * len(serve["cases"])
    k1_unfused = sum(isinstance(m, L.Scale) for m in predictor.windows.model.modules())
    assert launches == only(affine_relu=k1_unfused * runs, window_accumulate=runs,
                            score_finish=len(serve["cases"])), launches
    differ = [int((a != b).sum()) for a, b in zip(masks["k5"], masks["unfused"])]
    scoring = {"k5": [], "unfused": []}
    flops = []
    for v, e in serve["cases"]:
        _, lo_z, hi_z = postprocess.liver_mask_extent(e)
        v_img = np.asarray(v, np.float32) - icfg.mean
        flops.append(sc.estimate_flops(v.shape, lo_z, hi_z))
        for way in ("k5", "unfused", "unfused", "k5"):  # in turns
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with unfused() if way == "unfused" else contextlib.nullcontext():
                sc.labelmask_async(v_img, lo_z, hi_z)
                torch.cuda.synchronize()
            scoring[way].append(time.perf_counter() - t1)
    peak = peak_flops_per_chip()
    mfu = {way: [round(100 * flops[i // 2] / s / peak, 2) for i, s in enumerate(t)] for way, t in scoring.items()}
    float32 = serve_float32()
    with unfused():
        float32_unfused = serve_float32(labelmap=False)
    gap = float((float32["probs"] - float32_unfused["probs"]).abs().max())
    print(f"K5 served path: K1's inputs in one scoring of {vol.shape}: {dict(widths)} channels (the stems' "
          f"and last blocks', {serve['runs']} window batches), none between a bottleneck and its 3x3; "
          f"serve_unfused (K1, cuDNN, K1 and cat; the scorer's labelmasks): launches {launches}, bf16 "
          f"labelmask voxels differing from K5's {differ} of {vol.size}; device scoring s/volume in turns, K5 "
          f"{[round(v, 4) for v in scoring['k5']]}, unfused {[round(v, 4) for v in scoring['unfused']]} "
          f"(volume 1 then 2, two each), MFU % K5 {mfu['k5']}, unfused {mfu['unfused']}; float32 (TF32 "
          f"off) probabilities' largest gap {gap:.3g} (bound {DP_FLOAT32_GAP:.3g}) [{card}]")
    assert gap <= DP_FLOAT32_GAP, gap
    print(f"k5 phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return dict(numbers=numbers, launches=launches, scoring=scoring, float32=float32)


def timed_steps(step, steps: int = 2) -> tuple[list[float], float]:
    """(ms of each of ``steps`` calls of step after one warm-up, each
    synchronised, peak device memory in GiB over them)."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, torch.cuda.max_memory_allocated() / 2**30


def variants_path(card: str) -> dict:
    """The models the serving and training paths do not run, at full width:
    - the legacy DenseUNet-167 (``DenseUNet2D(skip_connections=True)``,
      'line0' and the encoder's skip adds), seeded weights, in serving form
      (``prepare_serving``: bfloat16 convs, BN∘Scale folded, K1 and K5):
      batch 8 of 224x224 and batch 1 of 512x512, each held to the same
      forward through K1's and K5's plain versions on the card (relative L2
      of the logits within
      VARIANT_BF16_RTOL); then training-mode steps, live BN, decoder
      dropout 0.3, remat, the 2D stage's weighted CE (K2 both ways), batch 8
      of 224x224 in bfloat16: ms, peak memory;
    - ``DilatedResNet`` (widths 64-512, one channel): forward of batch 2 of
      224x224x8 in bfloat16 (serving form) and training-mode steps (live BN,
      plain cross-entropy); it has no kernel of its own;
    - both at float32 through the parity tool, card against CPU at its
      defaults: the legacy 2D at 64x64, the dilated network at 32x32x8.
    FLOPs per forward from ``utils.flops.conv_flops`` (meta device). Returns
    the launch counts of each path."""
    import torch.nn.functional as F

    from hdenseunet_tpu_torch.core import params as P
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.models import layers as L
    from hdenseunet_tpu_torch.models.denseunet2d import DenseUNet2D
    from hdenseunet_tpu_torch.models.dilated_resnet import DilatedResNet
    from hdenseunet_tpu_torch.train.loss import weighted_crossentropy_2d
    from hdenseunet_tpu_torch.utils.flops import conv_flops
    from hdenseunet_tpu_torch.weights import parity

    paths = {}
    rng = np.random.default_rng(SEED + 9)
    legacy = init_model(DenseUNet2D(skip_connections=True, device="cuda"), SEED)
    serving = L.prepare_serving(copy.deepcopy(legacy), "cuda", torch.bfloat16)
    inputs = {shape: torch.from_numpy(rng.normal(0, 60, shape).astype(np.float32)).cuda().to(torch.bfloat16)
              for shape in ((8, 224, 224, 3), (1, 512, 512, 3))}
    with torch.inference_mode():
        for shape, x in inputs.items():
            flops = conv_flops(DenseUNet2D(skip_connections=True, device="meta"), shape)
            forward = lambda: serving(x)  # noqa: E731
            kernel_ms, plain_ms = in_turns(forward, with_plain_k1_k5(forward))
            torch.cuda.reset_peak_memory_stats()
            got = serving(x)[1].float()
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = with_plain_k1_k5(forward)()[1].float()
            rel = float((got - want).norm() / want.norm())
            assert bool(torch.isfinite(got).all()) and rel <= VARIANT_BF16_RTOL, (shape, rel)
            print(f"variants: legacy DenseUNet-167 serving bf16 {shape}: {kernel_ms:.3f} ms a forward "
                  f"(plain K1 and K5 {plain_ms:.3f}), {flops / 1e12:.4f} TFLOP ({flops / kernel_ms / 1e9:.1f} "
                  f"TFLOP/s), peak {peak:.2f} GiB; logits against the plain-K1-K5 forward: relative L2 "
                  f"{rel:.3g}, max abs {float((got - want).abs().max()):.3g} [{card}]")
        reset_counts()
        for x in inputs.values():
            serving(x)
        torch.cuda.synchronize()
        launches = paths["variants_legacy_serve"] = read_counts()
    per_legacy = route_counts(legacy)
    assert launches == only(**scaled(per_legacy, 2)), launches
    del serving

    image = torch.from_numpy(rng.normal(0, 60, (8, 224, 224, 3)).astype(np.float32)).cuda().to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, 3, (8, 224, 224)).astype(np.int32)).cuda()

    def legacy_step():
        legacy.zero_grad(set_to_none=True)
        ctx = L.Ctx(SEED, device="cuda", remat=True)
        _, logits = legacy(image, ctx, decoder_dropout=0.3)
        loss = weighted_crossentropy_2d(logits, labels)
        loss.backward()
        return loss

    reset_counts()
    times, peak = timed_steps(legacy_step)
    launches = paths["variants_legacy_train"] = read_counts()
    # the warm-up and 2 timed steps
    assert launches == only(wce_forward=3, wce_backward=3, **scaled(live_per_step("2d"), 3)), launches
    assert all(bool(torch.isfinite(t.grad).all()) for t in legacy.parameters() if t.grad is not None)
    print(f"variants: legacy DenseUNet-167 train step (live BN, remat, weighted CE) batch 8 of 224x224 "
          f"bf16: {[round(t, 2) for t in times]} ms, peak {peak:.2f} GiB, launches "
          f"{ {k: v for k, v in launches.items() if v} } [{card}]")

    dilated = init_model(DilatedResNet(device="cuda"), SEED)
    shape = (2, 224, 224, 8, 1)
    flops = conv_flops(DilatedResNet(device="meta"), shape)
    x = torch.from_numpy(rng.normal(0, 60, shape).astype(np.float32)).cuda().to(torch.bfloat16)
    target = torch.from_numpy(rng.integers(0, 2, shape[:4])).cuda()
    serving = L.prepare_serving(copy.deepcopy(dilated), "cuda", torch.bfloat16)
    reset_counts()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: serving(x), iters=5, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        out = serving(x)
        fwd_peak = torch.cuda.max_memory_allocated() / 2**30
    assert out.shape == shape[:4] + (2,) and bool(torch.isfinite(out).all()), out.shape
    del serving

    def dilated_step():
        dilated.zero_grad(set_to_none=True)
        logits = dilated(x, L.Ctx(SEED, device="cuda"))
        loss = F.cross_entropy(logits.float().reshape(-1, 2), target.reshape(-1))
        loss.backward()
        return loss

    times, peak = timed_steps(dilated_step)
    launches = paths["variants_dilated"] = read_counts()
    # inference runs no kernel of the port's on this network; training, K6 (3 steps)
    assert launches == only(**scaled(live_per_step("dilated"), 3)), launches
    print(f"variants: DilatedResNet (64, 128, 256, 512) bf16 batch 2 of 224x224x8: forward "
          f"{fwd_ms:.3f} ms, {flops / 1e12:.4f} TFLOP ({flops / fwd_ms / 1e9:.1f} TFLOP/s), peak "
          f"{fwd_peak:.2f} GiB; train step (live BN, cross-entropy) {[round(t, 2) for t in times]} ms, "
          f"peak {peak:.2f} GiB; launches { {k: v for k, v in launches.items() if v} } [{card}]")

    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_", dir=BUILD) as tmp:
        reset_counts()
        for name, model, x_shape, dump in (
            ("legacy 2D", legacy, (1, 64, 64, 3),
             lambda p, s, v, d: parity.dump_activations(p, s, v, skip_connections=True, device=d)),
            ("DilatedResNet", dilated, (1, 32, 32, 8, 1),
             lambda p, s, v, d: parity.dump_activations_dilated(p, s, v, device=d)),
        ):
            params, state = P.to_numpy(model)
            v = rng.normal(0, 60, x_shape).astype(np.float32)
            files = []
            for device in ("cuda", "cpu"):
                files.append(str(Path(tmp) / f"{name}_{device}.npz".replace(" ", "_")))
                np.savez(files[-1], **dump(params, state, v, device))
            code = exit_code(parity.main, ["compare", *files])
            assert code == 0, f"parity compare of the {name} dumps, card against CPU, exited {code}"
            print(f"variants: {name} {x_shape} float32 through the parity tool, card against CPU at "
                  f"its defaults (rtol = atol = 1e-3): exit 0 [{card}]")
        launches = paths["variants_parity"] = read_counts()
    assert launches == only(**per_legacy), launches
    return paths


def ellipsoid_case(shape):
    """An ellipsoid liver with a hole inside, a spherical tumour in it, and
    an external mask a little larger than the liver, bool (X, Y, Z)."""
    x, y, z = np.ogrid[: shape[0], : shape[1], : shape[2]]
    cx, cy, cz = shape[0] / 2, shape[1] / 2, shape[2] / 2

    def ball(c, r):
        return sum(((a - ca) / ra) ** 2 for a, ca, ra in zip((x, y, z), c, r)) <= 1

    liver = ball((cx, cy, cz), (0.35 * shape[0], 0.3 * shape[1], 0.4 * shape[2]))
    liver &= ~ball((cx + 40, cy - 30, cz), (6, 6, 4))  # an enclosed hole
    liver[20:24, 30:34, 10:14] = True  # a rival speck
    tumor = ball((cx - 30, cy + 20, cz + 5), (25, 25, 12))
    ext = ball((cx, cy, cz), (0.37 * shape[0], 0.32 * shape[1], 0.42 * shape[2]))
    return liver, tumor, ext


def plain_compose(packed, ext_bits, pack_z: int):
    """The compose through the plain versions only (device_postprocess with
    every K4 call replaced by its *_reference): (labelmap, wire, bbox)."""
    from hdenseunet_tpu_torch.ops import cc

    liver, tumor, ext = cc.compose_prep_reference(packed, ext_bits, pack_z=pack_z)
    liver_cc = cc.largest_component_reference(liver)
    ext_cc = cc.fill_holes_reference(cc.largest_component_reference(ext))
    tumor_final = cc.fill_holes_reference(tumor & ext_cc)
    return cc.compose_finish_reference(cc.fill_holes_reference(liver_cc), tumor_final)


def compose_inputs(liver, tumor, ext, pack_z: int):
    """(packed scores {0,1,3}, ext bits) on the card from bool masks."""
    packed = (liver | tumor).astype(np.uint8) + 2 * tumor.astype(np.uint8)
    ext_bits = np.packbits(ext[:, :, :pack_z].astype(np.uint8), axis=2)
    return torch.from_numpy(packed).cuda(), torch.from_numpy(ext_bits).cuda()


def at_offset(t, offset: int):
    """A copy of t whose storage starts ``offset`` bytes into a buffer (an
    alignment the kernels' vector paths do not take)."""
    flat = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8, device=t.device)
    out = flat[offset:offset + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


def k4_agree(label: str, m, *, plain: bool) -> int:
    """cc_label (26, 6), largest_component and fill_holes on the card for
    bool mask m, each twice (the same bits), against native/postprocess.cpp
    (scipy's labels for cc_label) and, with ``plain``, the plain versions on
    the card. Returns the mask's 26-connected component count."""
    from hdenseunet_tpu_torch import native
    from hdenseunet_tpu_torch.ops import cc
    from hdenseunet_tpu_torch.ops.cc_cases import scipy_min_labels

    t = torch.from_numpy(np.ascontiguousarray(m)).cuda()
    for conn in (26, 6):
        got = cc.cc_label(t, conn)
        assert torch.equal(got, cc.cc_label(t, conn)), f"cc_label {conn} repeat differs at {label}"
        if plain:
            assert torch.equal(got, cc.cc_label_reference(t, conn)), f"cc_label {conn} at {label}"
        else:
            assert np.array_equal(got.cpu().numpy(), scipy_min_labels(m, conn)), f"cc_label {conn} at {label}"
    largest, fill = cc.largest_component(t), cc.fill_holes(t)
    assert torch.equal(largest, cc.largest_component(t)), f"largest repeat differs at {label}"
    assert torch.equal(fill, cc.fill_holes(t)), f"fill repeat differs at {label}"
    if plain:
        assert torch.equal(largest, cc.largest_component_reference(t)), f"largest at {label}"
        assert torch.equal(fill, cc.fill_holes_reference(t)), f"fill at {label}"
    assert np.array_equal(largest.cpu().numpy(), native.pp_largest_component(m)), f"largest vs native at {label}"
    assert np.array_equal(fill.cpu().numpy(), native.pp_fill_holes(m)), f"fill vs native at {label}"
    return int((cc.cc_label(t, 26).view(-1)[t.view(-1)].unique()).numel())


def check_k4(card: str, serve: dict) -> dict:
    """K4a-d on the card against their plain versions on the card and the
    host's native/postprocess.cpp, at 512x512x112 (random masks at four
    densities, an ellipsoid liver with a tumour), on the brick-boundary
    cases (ops/cc_cases.py: at two bricks an axis and at shapes one voxel
    off a brick multiple against the plain versions too; at 512x512x112
    against native/postprocess.cpp and scipy's labels, since the plain
    propagation is slow on a long snake) and on phase 4's real thresholded
    labelmask; every kernel twice, the same bits both times. Times at the
    ellipsoid case (K4a-c also at random p=0.3), warm and with the L2
    flushed. Returns the JSON numbers per kernel."""
    from hdenseunet_tpu_torch import native
    from hdenseunet_tpu_torch.infer import device_postprocess as D, postprocess
    from hdenseunet_tpu_torch.infer.device_pipeline import pack_labels
    from hdenseunet_tpu_torch.ops import cc, cc_cases

    assert native.pp_available(), "the host oracle native/postprocess.cpp did not build"
    rng = np.random.default_rng(SEED + 6)
    liver, tumor, ext = ellipsoid_case(K4_SHAPE)
    masks = {f"random p={p}": rng.random(K4_SHAPE) < p for p in (0.05, 0.1, 0.3, 0.6)}
    masks["ellipsoid liver"] = liver | tumor
    mismatches = 0
    for label, m in masks.items():
        t0 = time.perf_counter()
        n_cc = k4_agree(label, m, plain=True)
        print(f"K4 {label} {K4_SHAPE}: {n_cc} components; cc_label (26, 6), largest_component, "
              f"fill_holes equal their plain versions, native/postprocess.cpp and a repeat; "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
    small = tuple(2 * b for b in cc.BRICK)
    t0 = time.perf_counter()
    for shape in cc_cases.off_by_one_shapes() + cc_cases.off_by_one_shapes((2, 3, 2)):
        for p in (0.1, 0.3, 0.6):
            k4_agree(f"random p={p} {shape}", rng.random(shape) < p, plain=True)
    for label, m in cc_cases.cases(small).items():
        k4_agree(f"{label} {small}", m, plain=True)
    print(f"K4 brick cases (brick {cc.BRICK}): 24 random masks at 8 shapes one voxel off a brick "
          f"multiple and {len(cc_cases.cases(small))} cases at {small}: cc_label (26, 6), "
          f"largest_component, fill_holes equal their plain versions, native/postprocess.cpp "
          f"and a repeat; {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    for label, m in cc_cases.cases(K4_SHAPE).items():
        k4_agree(f"{label} {K4_SHAPE}", m, plain=False)
    print(f"K4 brick cases at {K4_SHAPE}: {len(cc_cases.cases(K4_SHAPE))} cases, cc_label (26, 6) "
          f"equal scipy's labels, largest_component and fill_holes native/postprocess.cpp, each "
          f"twice the same; {time.perf_counter() - t0:.1f} s [{card}]")

    # the compose: ellipsoid case at K4_SHAPE and phase 4's real labelmask
    vol, ext_raw = serve["cases"][0]
    predictor = serve["predictor"]
    sc, icfg = predictor.windows, predictor.cfg.infer
    ext_once, z_lo, z_hi = postprocess.liver_mask_extent(ext_raw)
    plan = sc.plan(vol.shape, z_lo, z_hi)
    with torch.inference_mode():
        real = pack_labels(sc._score(sc._wire(vol - icfg.mean, plan), plan), icfg.thres_liver, icfg.thres_tumor)
    real_bits = sc._ext_bits(ext_once, plan, vol.shape)
    compose_cases = {
        "ellipsoid": (*compose_inputs(liver, tumor, ext, K4_SHAPE[2]), K4_SHAPE[2]),
        "real labelmask": (real.clone(), real_bits, plan["zw"]),
    }
    for label, (packed, ext_bits, pack_z) in compose_cases.items():
        labels, bbox = D.compose_final(packed, ext_bits, pack_z=pack_z)
        wire = D.compose_packed(packed, ext_bits, pack_z=pack_z)
        want = plain_compose(packed, ext_bits, pack_z)
        assert torch.equal(labels, want[0]) and torch.equal(wire, want[1]), f"compose at {label}"
        assert torch.equal(bbox, want[2]), (label, bbox, want[2])
        x0, y0 = ext_bits.shape[:2]
        m = packed[:x0, :y0, :pack_z].cpu().numpy()
        ext_np = np.unpackbits(ext_bits.cpu().numpy(), axis=2)[:, :, :pack_z].astype(bool)
        host = postprocess.compose_from_masks(m >= 1, m >= 3, ext_np)
        assert np.array_equal(labels[:x0, :y0].cpu().numpy(), host), f"compose vs host at {label}"
        print(f"K4 compose {label} {tuple(packed.shape[:2]) + (pack_z,)}: labelmap, 2-bit wire and "
              f"bbox {bbox.tolist()} equal the plain compose and the host postprocess "
              f"(native), label counts {np.bincount(host.ravel(), minlength=3).tolist()} [{card}]")
        mismatches += int((labels != want[0]).sum())

    # compose_finish alone on the edges of its grid, at 512x512x112 and at z
    # lengths 4, 8 and 12 modulo 16; also from a 4-byte offset (the kernel's
    # quad path) and twice each (the counters reset)
    t0 = time.perf_counter()
    n_cases = 0
    for shape in [K4_SHAPE] + cc_cases.compose_shapes():
        for label, (lv, tv) in cc_cases.compose_cases(shape, seed=SEED + sum(shape)).items():
            for offset in (0, 4):
                args = [at_offset(torch.from_numpy(a).cuda(), offset) for a in (lv, tv)]
                want = cc.compose_finish_reference(*args)
                for _ in range(2):
                    got = cc.compose_finish(*args)
                    assert all(torch.equal(g, w) for g, w in zip(got, want)), (label, shape, offset, got[2], want[2])
                n_cases += 1
    print(f"K4 compose_finish edges: {n_cases} cases (empty, 8 corners, full, random; offsets 0 and 4 "
          f"bytes) at {K4_SHAPE} and {cc_cases.compose_shapes()}: labelmap, wire and bbox equal the "
          f"plain version bit for bit, twice; {time.perf_counter() - t0:.1f} s [{card}]")

    # times at the ellipsoid case, the kernels' own inputs
    packed, ext_bits, pack_z = compose_cases["ellipsoid"]
    l_in, t_in, e_in = cc.compose_prep(packed, ext_bits, pack_z=pack_z)
    r_in = torch.from_numpy(masks["random p=0.3"]).cuda()
    n = l_in.numel()
    calls = {  # name: (kernel, plain, bytes in + out, the kernel on random p=0.3 or None)
        "cc_label": (lambda: cc.cc_label(l_in), lambda: cc.cc_label_reference(l_in), 5 * n,
                     lambda: cc.cc_label(r_in)),
        "largest_component": (lambda: cc.largest_component(l_in),
                              lambda: cc.largest_component_reference(l_in), 2 * n,
                              lambda: cc.largest_component(r_in)),
        "fill_holes": (lambda: cc.fill_holes(e_in), lambda: cc.fill_holes_reference(e_in), 2 * n,
                       lambda: cc.fill_holes(r_in)),
        "compose_prep": (lambda: cc.compose_prep(packed, ext_bits, pack_z=pack_z),
                         lambda: cc.compose_prep_reference(packed, ext_bits, pack_z=pack_z),
                         n + n // 8 + 3 * n, None),
        "compose_finish": (lambda: cc.compose_finish(l_in, t_in),
                           lambda: cc.compose_finish_reference(l_in, t_in), 2 * n + n + n // 4 + 24,
                           None),
    }
    out = {}
    for name, (kernel, plain, n_bytes, speckle) in calls.items():
        t = [cuda_ms(plain, iters=2, warmup=1), cuda_ms(kernel, iters=10), cuda_ms(kernel, iters=10),
             cuda_ms(plain, iters=2, warmup=1)]
        b = bound(n_bytes, 0)
        out[name] = dict(max_abs_err=float(mismatches), ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                         cold_ms=cold_ms(kernel), **b,
                         kernels_per_call=kernels_per_call(kernel, K4_KERNELS[name]))
        line = (f"K4 {name} {K4_SHAPE}: kernel {out[name]['ms']:.4f} ms, L2 flushed "
                f"{out[name]['cold_ms']:.4f} ms ({out[name]['kernels_per_call']} kernels), plain "
                f"{out[name]['plain_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        if speckle is not None:
            out[name].update(random_p03_ms=cuda_ms(speckle, iters=10), random_p03_cold_ms=cold_ms(speckle))
            line += (f"; random p=0.3: {out[name]['random_p03_ms']:.4f} ms, L2 flushed "
                     f"{out[name]['random_p03_cold_ms']:.4f} ms")
        print(f"{line} [{card}]")
    compose = lambda: D.compose_final(packed, ext_bits, pack_z=pack_z)  # noqa: E731
    t_compose = [cuda_ms(compose, iters=5) for _ in range(2)]
    reset_counts()
    compose()
    calls_made = {k: v for k, v in read_counts().items() if k in K4_NAMES and k != "cc_label"}
    assert calls_made == {k: K4_PER_VOLUME[k] for k in calls_made}, calls_made
    kernels = sum(K4_KERNELS[k] * n for k, n in calls_made.items())
    print(f"K4 whole compose_final {K4_SHAPE} ellipsoid: {min(t_compose):.3f} ms, L2 flushed "
          f"{cold_ms(compose):.3f} ms ({sum(calls_made.values())} calls, {kernels} K4 kernels: "
          f"the calls times their kernels per call) [{card}]")
    return out


def serve_dpp_path(card: str, serve: dict) -> dict:
    """Phase 4's two volumes with device_postprocess on, sparse wire on and
    off: labelmaps byte-identical to phase 4's host-postprocess ones, K4's
    launches per volume as compose_labels makes them, peak memory beside
    phase 4's. Returns the launch counts per path."""
    import dataclasses

    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor

    paths = {}
    for path, sparse in (("serve_dpp", True), ("serve_dpp_dense", False)):
        cfg = Config()
        cfg.model.compute_dtype = "bfloat16"
        cfg.infer = dataclasses.replace(cfg.infer, device_postprocess=True, sparse_wire=sparse)
        predictor = VolumePredictor(serve["model"], cfg, arch="end2end", device="cuda")
        predictor.segment(*serve["cases"][1])  # first calls of this predictor's shapes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        seconds, labelmaps = [], []
        for vol, ext in serve["cases"]:
            t0 = time.perf_counter()
            labelmaps.append(predictor.segment(vol, ext))
            seconds.append(time.perf_counter() - t0)
        launches = paths[path] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        for got, want in zip(labelmaps, serve["labelmaps"]):
            assert np.array_equal(got, want), f"{path}: the labelmap differs from the host postprocess's"
        vols = len(serve["cases"])
        assert all(launches[k] == n * vols for k, n in K4_PER_VOLUME.items()), launches
        assert all(launches[k] == serve["launches"][k] for k in ("affine_relu", "affine_gemm")), launches
        assert launches["window_accumulate"] == serve["runs"] * vols and launches["score_finish"] == vols, launches
        # the compose's buffers: 3 bool masks, int32 labels and sizes, outputs
        n = 512 * 512 * 128
        assert peak <= serve["peak"] + 16 * n + 2**30, (peak, serve["peak"])
        print(f"serve path {path} (device_postprocess, sparse_wire={sparse}): s/volume "
              f"{[round(s, 3) for s in seconds]} against the host postprocess's "
              f"{[round(s, 3) for s in serve['seconds']]}, labelmaps byte-identical, peak "
              f"{peak / 2**30:.2f} GiB (host path {serve['peak'] / 2**30:.2f}), launches {launches} [{card}]")
    return paths


def serve_modes(card: str, serve: dict) -> dict:
    """One full-width volume each through the per-window path
    (dedup_2d=False), the shared-2D mode and the uint8 wire: probabilities
    finite in [0, 1], s/volume; the uint8 wire's labelmap byte-identical to
    phase 4's (the same scoring, another wire). Returns launches per path."""
    import dataclasses

    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor

    paths = {}
    vol, ext = serve["cases"][0]
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    for path, knobs in (("serve_per_window", dict(dedup_2d=False)),
                        ("serve_shared_2d", dict(shared_2d=True)), ("serve_uint8", dict(wire_bits=8))):
        cfg = Config()
        cfg.model.compute_dtype = "bfloat16"
        cfg.infer = dataclasses.replace(cfg.infer, **knobs)
        predictor = VolumePredictor(serve["model"], cfg, arch="end2end", device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        lab = predictor.segment(vol, ext)  # with the new shapes' first calls
        seconds = [time.perf_counter() - t0]
        launches = paths[path] = read_counts()
        assert launches["affine_relu"] > 0 and launches["affine_gemm"] > 0, launches
        assert all(launches[k] == 0 for k in K4_NAMES), launches
        live = int(predictor.windows.plan(vol.shape, z_lo, z_hi)["weights"].any(axis=1).sum())
        assert launches["window_accumulate"] == live and launches["score_finish"] == 1, (launches, live)
        probs = predictor.windows.score(vol - cfg.infer.mean, z_lo, z_hi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.windows.score(vol - cfg.infer.mean, z_lo, z_hi)
        torch.cuda.synchronize()
        scoring = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        assert bool(torch.isfinite(probs).all()), path
        assert float(probs.min()) >= 0.0 and float(probs.max()) <= 1.0 + 1e-5, path
        if path == "serve_uint8":
            assert np.array_equal(lab, serve["labelmaps"][0]), "the uint8 wire's labelmap differs"
        print(f"serve path {path} {knobs}: s/volume {[round(s, 3) for s in seconds]}, device scoring "
              f"{scoring:.3f} s, peak {peak / 2**30:.2f} GiB, probabilities finite in [0, 1], "
              f"label counts {np.bincount(lab.ravel(), minlength=3).tolist()} [{card}]")
        del probs
    return paths


def serve_host_loop(card: str, serve: dict) -> dict:
    """Phase 4's first volume through the host-loop WindowPredictor
    (``device_resident=False``): its labelmap against the per-window device
    path's in the host loop's form, the direct stem (``dedup_2d=False``,
    ``stem_s2d=False``: the same windows in the same batches of 8, scored by
    the same kernels, averaged in the same order, so the same bits unless
    cuDNN picks another algorithm for the last batch, whose padding
    differs: repeats of the last window here, window 0 there). If they
    differ, the count of differing voxels and the largest probability gap
    are printed and held to HOST_LOOP_BOUND. Returns the launch counts."""
    import dataclasses

    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor
    from hdenseunet_tpu_torch.infer.sliding_window import window_starts

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    cfg.infer = dataclasses.replace(cfg.infer, device_resident=False)
    predictor = VolumePredictor(serve["model"], cfg, arch="end2end", device="cuda")
    vol, ext = serve["cases"][0]
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    n_batches = -(-len(set(window_starts(vol.shape[2], z_lo, z_hi, cfg.infer))) // cfg.infer.window_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds, split = [], []
    for _ in range(2):  # the first pays the first calls of the batch shape
        t0 = time.perf_counter()
        handle = predictor.dispatch(vol, ext)  # scores: windows up, probabilities down
        t1 = time.perf_counter()
        lab = predictor.collect(handle)  # thresholds and postprocesses on the host
        seconds.append(time.perf_counter() - t0)
        split.append((t1 - t0, seconds[-1] - (t1 - t0)))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    assert launches == only(**scaled(serve["per_batch"], 2 * n_batches)), (launches, n_batches)
    cfg_w = Config()
    cfg_w.model.compute_dtype = "bfloat16"
    cfg_w.infer = dataclasses.replace(cfg_w.infer, dedup_2d=False, stem_s2d=False)
    per_window = VolumePredictor(serve["model"], cfg_w, arch="end2end", device="cuda")
    differ = int((lab != per_window.segment(vol, ext)).sum())
    gap = 0.0
    if differ:
        want = per_window.windows.score(vol - cfg.infer.mean, z_lo, z_hi)
        got = predictor.windows.predict_volume(vol - cfg.infer.mean, z_lo, z_hi)
        gap = max(float((torch.from_numpy(g).cuda() - want[..., c]).abs().max()) for g, c in zip(got, (1, 2)))
        del want
    assert differ <= HOST_LOOP_BOUND["voxels"] * lab.size and gap <= HOST_LOOP_BOUND["prob"], (differ, gap)
    print(f"serve path serve_host_loop (device_resident=False): {n_batches} batches of "
          f"{cfg.infer.window_batch} windows, s/volume {[round(t, 3) for t in seconds]}, scoring and "
          f"postprocess s {[(round(a, 3), round(b, 3)) for a, b in split]}, peak {peak / 2**30:.2f} GiB; "
          f"labelmap against the per-window device path's: {differ} voxels differ, largest probability "
          f"gap {gap:.3g}{' (byte-identical)' if not differ else ''} [{card}]")
    return launches


def tiled_batches(shape, tile: int, cols: int, wb: int) -> tuple[int, int]:
    """(windows, batches) of the tiled scorer over a volume of ``shape``,
    from tile_origins, as TiledVolumeScorer.plan lays them out."""
    from hdenseunet_tpu_torch.infer.device_pipeline import tile_origins

    win = (tile, tile, cols)
    steps = ((tile // 3) * 2, (tile // 3) * 2, max(1, (cols // 3) * 2))
    n = int(np.prod([len(tile_origins(max(d, w), w, st)) for d, w, st in zip(shape, win, steps)]))
    return n, -(-n // wb)


def serve_tiled(card: str, serve: dict) -> dict:
    """Phase 4's first volume through TiledPredictor with tile 256: windows
    of 256x256x8 stepping 170 in x and y and 4 in z over the whole volume.
    The probabilities are finite in [0, 1] and every voxel's count is above
    0. Prints device scoring s, s/volume and peak memory. Returns the launch
    counts."""
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.infer.predictor import TiledPredictor

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    predictor = TiledPredictor(serve["model"], cfg, tile=TILE, arch="end2end", device="cuda")
    vol, ext = serve["cases"][0]
    windows, batches = tiled_batches(vol.shape, TILE, cfg.infer.input_cols, cfg.infer.window_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds = []
    for _ in range(2):  # the first pays the first calls of the tile shape
        t0 = time.perf_counter()
        lab = predictor.segment(vol, ext)
        seconds.append(time.perf_counter() - t0)
    launches = read_counts()
    assert launches == only(**scaled(serve["per_batch"], 2 * batches)), (launches, batches)
    assert lab.shape == vol.shape and set(np.unique(lab).tolist()) <= {0, 1, 2}
    scorer = predictor.scorer
    plan = scorer.plan(vol.shape)
    assert len(plan["origins"]) == windows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score, count = scorer._score_tiles(vol - cfg.infer.mean, plan)
    torch.cuda.synchronize()
    scoring = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    probs = score / count.clamp_min(1e-4)[..., None]
    assert bool((count > 0).all()), "a voxel no window covers"
    assert bool(torch.isfinite(probs).all()) and float(probs.min()) >= 0.0 and float(probs.max()) <= 1.0 + 1e-5
    print(f"serve path serve_tiled (tile {TILE}): {windows} windows of {TILE}x{TILE}x{cfg.infer.input_cols} "
          f"in {batches} batches of {cfg.infer.window_batch}, s/volume {[round(t, 3) for t in seconds]}, "
          f"device scoring {scoring:.3f} s, peak {peak / 2**30:.2f} GiB, probabilities finite in [0, 1], "
          f"every voxel's count in [{int(count.min())}, {int(count.max())}], label counts "
          f"{np.bincount(lab.ravel(), minlength=3).tolist()} [{card}]")
    del score, count, probs
    return launches


def forms_stem(card: str, conv, conv32) -> None:
    """The 3D stem alone at the serving shape (8 windows of 512x512x8, 4
    channels, bfloat16): the direct conv against ``conv3d_s2d`` in both
    kernel orders (the d-major one on the d-major input), timed warm in
    turns with CUDA events; TFLOP/s of the direct conv's FLOPs; their
    largest bfloat16 difference, and in float32 (TF32 off) their agreement
    within FORMS_STEM_RTOL of the largest output."""
    from hdenseunet_tpu_torch.models import dmajor, s2d
    from hdenseunet_tpu_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shape = (WINDOW_BATCH, 4) + FORMS_WINDOW
    x32 = L.channels_last(50 * torch.randn(shape, device="cuda", generator=gen))
    outs = {}
    for dtype, c, ctx in ((torch.bfloat16, conv, contextlib.nullcontext),
                          (torch.float32, conv32, exact_float32)):
        x = x32.to(dtype)
        xd = dmajor.fold(x)
        fns = {
            "direct": lambda: c(x),
            "s2d": lambda: s2d.conv3d_s2d(c, x),
            "s2d_dmajor": lambda: s2d.conv3d_s2d(c, xd, kernel_perm=dmajor.PERM),
        }
        with torch.inference_mode(), ctx():
            outs[dtype] = {name: fn() for name, fn in fns.items()}
            outs[dtype]["s2d_dmajor"] = dmajor.unfold(outs[dtype]["s2d_dmajor"])
            if dtype == torch.bfloat16:
                times = {name: [] for name in fns}
                for name in list(fns) + list(fns)[::-1]:  # in turns
                    times[name].append(cuda_ms(fns[name], iters=10, warmup=2))
    y = outs[torch.bfloat16]["direct"]
    flops = 2.0 * y.shape[0] * float(np.prod(y.shape[2:])) * y.shape[1] * float(np.prod(conv.kernel_size)) * 4
    ref32 = outs[torch.float32]["direct"]
    scale = float(ref32.abs().max())
    err32 = {n: float((o - ref32).abs().max()) for n, o in outs[torch.float32].items() if n != "direct"}
    err16 = {n: float((o.float() - y.float()).abs().max()) for n, o in outs[torch.bfloat16].items()
             if n != "direct"}
    assert all(e <= FORMS_STEM_RTOL * scale for e in err32.values()), (err32, scale)
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    print(f"forms stem: {tuple(x32.shape)} -> {tuple(y.shape)} bf16, "
          + ", ".join(f"{n} {ms[n]:.3f} ms ({[round(v, 3) for v in times[n]]}, "
                      f"{flops / ms[n] / 1e9:.1f} TFLOP/s)" for n in fns)
          + f" of the direct conv's {flops / 1e9:.1f} GFLOP; bf16 largest difference from direct "
          f"{ {n: round(e, 4) for n, e in err16.items()} } (outputs up to {float(y.abs().max()):.1f}); "
          f"float32 (TF32 off) {err32} of outputs up to {scale:.1f} [{card}]")


def forms_branch(card: str, model, model32) -> dict:
    """The 3D branch and the HFF head (``HDenseUNet.fuse``) on one window
    batch at the serving shape in each of FORMS: ms (CUDA events around 3
    calls, warm, in turns), peak memory of one forward beyond what was
    allocated before it, K1 and K5 launches of one forward (the 3D branch's
    frozen BN∘Scale∘ReLU), the bfloat16 logits' largest difference from hwdc's
    and in float32 (TF32 off) within FORMS_LOGIT_RTOL of hwdc's largest.
    Returns the launch counts per form."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shape = (WINDOW_BATCH,) + FORMS_WINDOW
    vol = 50 * torch.randn(shape + (1,), device="cuda", generator=gen)
    res2d = torch.randn(shape + (3,), device="cuda", generator=gen)
    fea2d = torch.randn(shape + (model.head["fianl_conv"].kernel.shape[1],), device="cuda", generator=gen)
    per_3d = route_counts(model.net3d)
    paths, peaks, logits = {}, {}, {torch.bfloat16: {}, torch.float32: {}}
    inputs = [t.to(torch.bfloat16) for t in (vol, res2d, fea2d)]
    fns = {name: (lambda kw=kw: model.fuse(*inputs, **kw)) for name, kw in FORMS.items()}
    with torch.inference_mode():
        for name, kw in FORMS.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            logits[torch.bfloat16][name] = fns[name]()
            torch.cuda.synchronize()
            paths[f"forms_{name}"] = read_counts()
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
            assert paths[f"forms_{name}"] == only(**per_3d), (name, paths[f"forms_{name}"])
        times = {name: [] for name in FORMS}
        for name in list(FORMS) + list(FORMS)[::-1]:  # in turns
            times[name].append(cuda_ms(fns[name], iters=3, warmup=1))
        with exact_float32():
            for name, kw in FORMS.items():
                logits[torch.float32][name] = model32.fuse(vol, res2d, fea2d, **kw)
    err = {dt: {n: float((y.float() - got["hwdc"].float()).abs().max())
                for n, y in got.items() if n != "hwdc"} for dt, got in logits.items()}
    scale = float(logits[torch.float32]["hwdc"].abs().max())
    assert all(e <= FORMS_LOGIT_RTOL * scale for e in err[torch.float32].values()), (err, scale)
    for name in FORMS:
        ms = sum(times[name]) / len(times[name])
        print(f"forms branch {name}: 3D branch + HFF head on {shape} bf16, {ms:.2f} ms "
              f"({[round(v, 2) for v in times[name]]}), peak {peaks[name]:.2f} GiB beyond the inputs, "
              f"K1 and K5 launches {paths[f'forms_{name}']['affine_relu']} and "
              f"{paths[f'forms_{name}']['affine_gemm']} a forward; logits' largest "
              f"difference from hwdc: bf16 {err[torch.bfloat16].get(name, 0.0):.4g}, float32 "
              f"{err[torch.float32].get(name, 0.0):.3g} (logits up to {scale:.3g}) [{card}]")
    return paths


def forms_scoring(card: str, serve: dict) -> dict:
    """Device scoring of phase 4's first volume by a DeviceVolumeScorer in
    each form InferConfig reaches (layout3d x stem_s2d) on phase 4's model:
    s/volume (``labelmask_async`` to a synchronise, warm, two turns), K1
    launches of one scoring, and the voxels of the thresholded labelmask
    that differ from the shipped default's (hwdc with the s2d stem).
    Returns the launch counts per form."""
    import dataclasses

    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer

    predictor = serve["predictor"]
    vol, ext = serve["cases"][0]
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    img = np.asarray(vol, np.float32) - predictor.cfg.infer.mean
    forms = {f"{layout}{'_s2d' if stem else ''}": dict(layout3d=layout, stem_s2d=stem)
             for layout in ("hwdc", "dhwc") for stem in (False, True)}
    scorers, labels, paths = {}, {}, {}
    for name, kw in forms.items():
        cfg = dataclasses.replace(predictor.cfg.infer, **kw)
        scorers[name] = DeviceVolumeScorer(predictor.windows.model, cfg, arch="end2end",
                                           compute_dtype="bfloat16", device="cuda")
        reset_counts()
        labels[name] = scorers[name].labelmask(img, z_lo, z_hi)
        paths[f"forms_score_{name}"] = read_counts()
        assert paths[f"forms_score_{name}"] == only(
            **scaled(serve["per_batch"], serve["runs"]), window_accumulate=serve["runs"],
            score_finish=1), (name, paths[f"forms_score_{name}"])
    seconds = {name: [] for name in forms}
    for name in list(forms) + list(forms)[::-1]:  # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorers[name].labelmask_async(img, z_lo, z_hi)
        torch.cuda.synchronize()
        seconds[name].append(time.perf_counter() - t0)
    shipped = labels["hwdc_s2d"]
    for name in forms:
        differ = int((labels[name] != shipped).sum())
        print(f"forms scoring {name}: device scoring {[round(v, 4) for v in seconds[name]]} s/volume "
              f"of {vol.shape}, K1 launches {paths[f'forms_score_{name}']['affine_relu']}, labelmask "
              f"voxels differing from the shipped default's (hwdc_s2d) {differ} of {shipped.size} "
              f"[{card}]")
    print(f"forms scoring: phase 4 (the shipped default, hwdc_s2d) {[round(v, 4) for v in serve['scoring']]} "
          f"s/volume; the direct stem (hwdc) here {[round(v, 4) for v in seconds['hwdc']]} [{card}]")
    return paths


def forms_serve_path(card: str, serve: dict) -> dict:
    """The forms phase's serving part: :func:`forms_stem`,
    :func:`forms_branch` and :func:`forms_scoring` on phase 4's seeded
    full-preset weights (a float32 copy for the float32 comparisons).
    Returns the launch counts per path."""
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.models import layers as L
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    t0 = time.perf_counter()
    model = serve["predictor"].windows.model
    model32 = L.prepare_serving(init_model(HDenseUNet(preset="full", device="cuda"), SEED), "cuda",
                                torch.float32)
    forms_stem(card, model.net3d["3dconv1"], model32.net3d["3dconv1"])
    paths = forms_branch(card, model, model32)
    del model32
    paths.update(forms_scoring(card, serve))
    print(f"forms phase, serving part: {time.perf_counter() - t0:.1f} s [{card}]")
    return paths


def forms_train_path(card: str, full: dict) -> dict:
    """The forms phase's training part: ``train`` for TRAIN_STEPS end2end
    steps of phase 5's configuration with layout3d='dhwc' and the s2d
    stem, twice: ms/step and losses beside phase 5's ('full'), the two runs
    equal bit for bit (losses and weights), and the ops torch names as
    nondeterministic in one such step: none. Then the graphed step (the
    device's time, which the host-bound eager step hides) of the forms
    FORMS_TRAIN in turns: ``graph_run`` at GRAPH_K, graphed ms/step and
    device busy ms a step. Returns the launch counts."""
    t0 = time.perf_counter()
    graphed = {name: [] for name in FORMS_TRAIN}
    for name in list(FORMS_TRAIN) + list(FORMS_TRAIN)[::-1]:  # in turns
        run = graph_run("end2end", GRAPH_K, profile=True, **FORMS[name])
        graphed[name].append((run["ms"], run["busy_ms"]))
        del run
    for name, runs in graphed.items():
        print(f"forms train graphed end2end {name}: steps_per_dispatch {GRAPH_K}, "
              f"{[round(ms, 1) for ms, _ in runs]} ms/step, device busy "
              f"{[round(busy, 1) for _, busy in runs]} ms a step [{card}]")
    forms = dict(layout3d="dhwc", stem_s2d=True)
    named = nondeterministic_ops("end2end", **forms)
    assert not named, named
    runs = [train_path(card, "end2end", label="forms train", **forms) for _ in range(2)]
    assert runs[0]["losses"] == runs[1]["losses"], [r["losses"] for r in runs]
    differ = [k for k, v in runs[0]["weights"].items() if not torch.equal(v, runs[1]["weights"][k])]
    assert not differ, differ[:10]
    print(f"forms train end2end {forms}: {[round(r['ms'], 1) for r in runs]} ms/step against phase 5's "
          f"{full['ms']:.1f}; losses {[round(v, 5) for v in runs[0]['losses']]} against phase 5's "
          f"{[round(v, 5) for v in full['losses']]}; two runs equal bit for bit "
          f"({len(runs[0]['weights'])} tensors); nondeterministic ops {named}; peak "
          f"{runs[0]['peak'] / 2**30:.2f} GiB against {full['peak'] / 2**30:.2f}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return {"forms_train_end2end": runs[0]["launches"]}


def train_config(arch: str, policy: str = "full", **forms):
    """Phase 5's training configuration: full preset, bfloat16, global
    batch 8, remat under ``policy``, a loss drain (sync) every step;
    ``forms`` sets the 3D branch's form (ModelConfig.layout3d, stem_s2d)."""
    from hdenseunet_tpu_torch.core.config import Config

    cfg = Config()
    for field, value in forms.items():
        setattr(cfg.model, field, value)
    cfg.model.compute_dtype = "bfloat16"
    cfg.train.arch = arch
    cfg.train.batch = 8
    cfg.train.remat = True
    cfg.train.remat_policy = policy
    cfg.train.log_every_steps = 1
    return cfg


def global_batches(cfg, n: int) -> list:
    """The first n synthetic global batches of phase 5's feed."""
    from hdenseunet_tpu_torch.data.sampler import synthetic_batches

    gen = synthetic_batches(
        mode="2d" if cfg.train.arch == "2d" else "hybrid", batch=cfg.train.batch,
        input_size=cfg.model.input_size, input_cols=cfg.model.input_cols, seed=SEED,
    )
    return [next(gen) for _ in range(n)]


def train_path(
    card: str, arch: str, policy: str = "full", mesh=None, label: str = "train path", **forms,
) -> dict:
    """``train`` for TRAIN_STEPS steps at full width under ``remat_policy``
    ``policy`` (over ``mesh`` when given; the 3D branch in ``forms``); ms/step
    over steps 2-4 (each step ends in the loss drain's sync:
    log_every_steps = 1). Returns the launch counts, the recorded kernel
    calls, the ms/step, the losses, the peak memory and the final model's
    state_dict."""
    from hdenseunet_tpu_torch.train.trainer import train

    cfg = train_config(arch, policy, **forms)
    suffix = "".join(f"_{k}-{v}" for k, v in sorted(forms.items()))
    cfg.train.save_path = str(BUILD / "chip_smoke_train" / f"{arch}_{policy}{suffix}")
    batches = global_batches(cfg, TRAIN_STEPS)
    asked = []

    def timed():
        for batch in batches:
            asked.append(time.perf_counter())
            yield batch

    history = Path(cfg.train.save_path) / "history" / "lossbatch.txt"
    history.unlink(missing_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with recorded_calls() as calls:
        state = train(cfg, timed(), mesh=mesh, max_steps=TRAIN_STEPS, device="cuda", log_fn=lambda *a: None)
    torch.cuda.synchronize()
    end = time.perf_counter()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in history.read_text().split()]
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    steps = TRAIN_STEPS
    if arch == "end2end":
        want = only(affine_relu=(BSR_2D + REMAT_2D) * steps, affine_relu_backward=BSR_2D * steps,
                    wce_forward=steps, wce_backward=steps, **scaled(live_per_step(arch), steps))
    else:
        want = only(wce_forward=steps, wce_backward=steps, **scaled(live_per_step(arch), steps))
    assert launches == want, (arch, launches, want)
    ms = (end - asked[1]) / (steps - 1) * 1e3
    slices = cfg.train.batch * (cfg.model.input_cols if arch != "2d" else 1)
    shape = f"{cfg.model.input_size}^2" + (f"x{cfg.model.input_cols}" if arch != "2d" else "")
    print(
        f"{label} {arch}: {steps} steps, full preset bf16 remat ({policy}), batch {cfg.train.batch} x "
        f"{shape}: first step {(asked[1] - asked[0]) * 1e3:.1f} ms, {ms:.1f} ms/step over steps "
        f"2-{steps}, {slices / ms * 1e3:.1f} slices/s, peak {peak / 2**30:.2f} GiB, losses "
        f"{[round(v, 5) for v in losses]}, launches {launches} "
        f"(K1 forward {launches['affine_relu'] // steps}/step, K6 forward "
        f"{launches['bn_live_forward'] // steps}/step) [{card}]"
    )
    weights = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return dict(launches=launches, calls=calls, ms=ms, losses=losses, peak=peak, weights=weights)


def train_convs_path(card: str, full: dict) -> dict:
    """Phase 5's end2end run again under ``remat_policy='convs'`` (each conv
    block's checkpoint keeps its convolutions' outputs; only the
    BN/Scale/ReLU/dropout chain reruns): the same launches per step as the
    'full' run; ms/step and peak memory beside the 'full' run's; its losses
    beside the 'full' run's and a second 'full' run's, which must equal
    the first run's bit for bit (the step repeats itself). Then one
    step of each policy from the same seeded weights and batch, held to
    phase 7's bars for a step against another. Returns the launch counts."""
    steps = TRAIN_STEPS
    per_step = dict(affine_relu=BSR_2D + REMAT_2D, affine_relu_backward=BSR_2D, wce_forward=1, wce_backward=1,
                    **live_per_step("end2end"))
    convs = train_path(card, "end2end", "convs")
    again = train_path(card, "end2end")
    assert convs["launches"] == full["launches"] == only(**{k: n * steps for k, n in per_step.items()}), (
        convs["launches"], full["launches"])
    assert abs(convs["losses"][0] - full["losses"][0]) <= 1e-5 * abs(full["losses"][0])
    gap = max(abs(a - b) for a, b in zip(convs["losses"], full["losses"]))
    spread = max(abs(a - b) for a, b in zip(again["losses"], full["losses"]))
    assert again["losses"] == full["losses"], ("two 'full' runs differ", again["losses"], full["losses"])
    del again

    runs = {}
    for policy in ("full", "convs"):
        runs[policy] = one_step("end2end", policy)
        assert runs[policy]["launches"] == only(**per_step), (policy, runs[policy]["launches"])
    loss_f, loss_c = runs["full"]["loss"], runs["convs"]["loss"]
    worst = step_error(runs["full"], runs["convs"])
    print(f"train path end2end remat_policy='convs': {convs['ms']:.1f} ms/step against 'full' "
          f"{full['ms']:.1f}, peak {convs['peak'] / 2**30:.2f} GiB against {full['peak'] / 2**30:.2f}; "
          f"launches per step as 'full'; losses {[round(v, 6) for v in convs['losses']]} against 'full' "
          f"{[round(v, 6) for v in full['losses']]}: largest gap {gap:.3g}, against {spread:.3g} between "
          f"two 'full' runs; one step from the same weights and batch: loss {loss_c:.7g} against "
          f"{loss_f:.7g}, worst update error {worst:.3g} of its tensor's update norm [{card}]")
    return convs["launches"]


@contextlib.contextmanager
def first_calls():
    """While open, keep the arguments and outputs of the first call of each
    of K1, K1's backward, K2's and K7's forward and backward: the module's
    wrappers are swapped for recorders that call them (the launch counts
    carry over). Tensors made inside a CUDA graph's capture stay held, so
    after a replay they hold that replay's values."""
    from hdenseunet_tpu_torch.ops import dropout as D, fused_affine as K, wce as W

    kept, swapped = {}, []
    for module, name in ((K, "affine_relu"), (K, "affine_relu_backward"),
                         (W, "wce_forward"), (W, "wce_backward"),
                         (D, "dropout_forward"), (D, "dropout_backward")):
        wrapped = getattr(module, name)

        def recorder(*args, _fn=wrapped, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            kept.setdefault(_name, (args, kwargs, out))
            return out

        recorder.launches = wrapped.launches
        setattr(module, name, recorder)
        swapped.append((module, name, wrapped, recorder))
    try:
        yield kept
    finally:
        for module, name, wrapped, recorder in swapped:
            wrapped.launches = recorder.launches
            setattr(module, name, wrapped)


def hold_graphed_calls(kept: dict) -> dict:
    """Each kernel's output at its first call inside the captured step, as
    the last replay left it, against its plain version on the same inputs
    (phase 3's bars; K7's: the same bits). Returns each kernel's largest
    error (K7's: elements that differ)."""
    from hdenseunet_tpu_torch.ops import dropout as D, fused_affine as K

    errors = {}
    if "affine_relu" in kept:
        (x, scale, shift), kw, y = kept["affine_relu"]
        want = K.affine_relu_reference(x, scale, shift, **kw)
        errors["affine_relu"] = k1_error(y, want, x, scale, "graphed K1")
    if "affine_relu_backward" in kept:
        (g, x, scale, y), kw, got = kept["affine_relu_backward"]
        want = K.affine_relu_backward_reference(g, x, scale, y, **kw)
        errors["affine_relu_backward"] = k1_backward_error(got, want, g, x, "graphed K1 backward")
    (logits, labels, mask, w), _, (loss, cnt) = kept["wce_forward"]
    (_, _, _, _, cnt_b, g), _, d = kept["wce_backward"]
    errors["wce_forward"], errors["wce_backward"] = k2_errors(
        loss, cnt, d, logits, labels, mask, w, g, "graphed K2")
    assert float(cnt_b) == float(cnt)
    (x, seed, rate, offset), _, y = kept["dropout_forward"]
    (g, _, _, _, stride), _, dx = kept["dropout_backward"]
    for name, got, want in (("dropout_forward", y, D.dropout_reference(x, seed, rate, offset)),
                            ("dropout_backward", dx, D.dropout_backward_reference(g, seed, rate, offset, stride))):
        bits = torch.int16 if got.element_size() == 2 else torch.int32
        errors[name] = int((got.view(bits) != want.view(bits)).sum())
        assert errors[name] == 0, f"graphed K7 ({name}): {errors[name]} elements differ from the plain version"
    return errors


def nondeterministic_ops(arch: str, **forms) -> list[str]:
    """The ops torch names as having no deterministic CUDA form in one step
    of phase 5's configuration, the 3D branch in ``forms``
    (``torch.use_deterministic_algorithms(True, warn_only=True)``, which
    also makes cuDNN take deterministic algorithms)."""
    from hdenseunet_tpu_torch.train.trainer import create_train_state, train_step

    cfg = train_config(arch, **forms)
    batch = global_batches(cfg, 1)[0]
    state = create_train_state(cfg, arch, device="cuda", seed=SEED)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            float(train_step(state, batch, cfg))
        finally:
            torch.use_deterministic_algorithms(False)
    named = {str(w.message).split(" does not have a deterministic")[0]
             for w in caught if "deterministic" in str(w.message)}
    return sorted(named)


def device_busy_ms(prof) -> tuple[float, int]:
    """Summed device time of the kernels, copies and sets a torch.profiler
    profile recorded, and their number."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in events) / 1e3, len(events)


def graph_run(arch: str, k: int, *, profile: bool = False, **forms) -> dict:
    """``train`` for GRAPH_STEPS steps of phase 5's configuration (dropout
    live; the 3D branch in ``forms``) at ``steps_per_dispatch`` k, the
    losses drained (a sync) every GRAPH_K steps. Returns the losses, the final parameters, buffers and
    momentum buffers (clones on the card), the launches, the ms/step over
    steps 9-16 (from the fetch of batch 9 to the end, less the capture)
    and the peak memory; for k > 1 the capture's seconds, the memory it
    reserved (the graph's pool), its launches and the first kernel calls
    inside it (``first_calls``), and the replayed group's wall; with
    ``profile``, device busy ms a step over steps 9-16 and the idle share
    of their wall (torch.profiler)."""
    from hdenseunet_tpu_torch.train import trainer as T

    cfg = train_config(arch, **forms)
    cfg.train.steps_per_dispatch, cfg.train.log_every_steps = k, GRAPH_K
    suffix = "".join(f"_{key}-{v}" for key, v in sorted(forms.items()))
    cfg.train.save_path = str(BUILD / "chip_smoke_graph" / f"{arch}_{k}{suffix}")
    batches = global_batches(cfg, GRAPH_STEPS)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = dict(losses=[], capture=None)
    fetched, prof = [], []

    def start_profile():
        if profile:
            prof.append(torch.profiler.profile(activities=acts))
            prof[0].__enter__()
            out["profiled_from"] = time.perf_counter()

    def feed():
        for i, batch in enumerate(batches):
            if i == GRAPH_K and k == 1:
                start_profile()
            fetched.append(time.perf_counter())
            yield batch

    check, capture, call = T.NaNGuard.check, T.MultiStep._capture, T.MultiStep.__call__

    def checked(self, loss, step):
        out["losses"].append(loss)
        return check(self, loss, step)

    def captured(self, stacked):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved, before = torch.cuda.memory_reserved(), read_counts()
        with first_calls() as kept:
            capture(self, stacked)
        out["capture"] = dict(
            seconds=self.capture_seconds, pool_bytes=torch.cuda.memory_reserved() - reserved,
            launches={n: c - before[n] for n, c in read_counts().items()}, kept=kept,
        )
        start_profile()
        out["replay_from"] = time.perf_counter()

    def called(self, stacked):
        losses = call(self, stacked)
        if self.replays and "replay_wall" not in out:
            torch.cuda.synchronize()
            out["replay_wall"] = time.perf_counter() - out["replay_from"]
        return losses

    history = Path(cfg.train.save_path) / "history" / "lossbatch.txt"
    history.unlink(missing_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    T.NaNGuard.check, T.MultiStep._capture, T.MultiStep.__call__ = checked, captured, called
    try:
        state = T.train(cfg, feed(), max_steps=GRAPH_STEPS, device="cuda", log_fn=lambda *a: None)
        torch.cuda.synchronize()
        end = time.perf_counter()
    finally:
        T.NaNGuard.check, T.MultiStep._capture, T.MultiStep.__call__ = check, capture, call
        if prof:
            prof[0].__exit__(None, None, None)
    out["launches"] = read_counts()
    out["peak"] = torch.cuda.max_memory_allocated()
    capture_s = out["capture"]["seconds"] if out["capture"] else 0.0
    out["ms"] = (end - fetched[GRAPH_K] - capture_s) / (GRAPH_STEPS - GRAPH_K) * 1e3
    if prof:
        busy, events = device_busy_ms(prof[0])
        wall = (out["replay_wall"] if k > 1 else end - out["profiled_from"]) * 1e3
        n = GRAPH_STEPS - GRAPH_K
        out.update(busy_ms=busy / n, idle=1 - busy / wall, events=events // n, profiled_ms=wall / n)
    assert len(out["losses"]) == GRAPH_STEPS and all(np.isfinite(out["losses"])), out["losses"]
    out["state"] = {
        **{f"model.{name}": t.detach().clone() for name, t in state.model.state_dict().items()},
        **{f"momentum.{i}": slot["momentum_buffer"].clone()
           for i, slot in enumerate(state.optimizer.state.values())},
    }
    return out


def differing(a: dict, b: dict) -> list[str]:
    """Names of the tensors of two ``graph_run`` states that differ in any bit."""
    assert a.keys() == b.keys()
    return [name for name in a if not torch.equal(a[name], b[name])]


def graph_path(card: str) -> dict:
    """The graph phase: end2end and the 2D stage at full width, K = GRAPH_K,
    GRAPH_STEPS steps (the first group eager, then one captured step
    replayed GRAPH_K times) against the same steps eager (K = 1) from the
    same seeded weights and batches, dropout live: losses, parameters,
    moving statistics and momentum buffers equal bit for bit; a second
    eager run equal to the first bit for bit. The ops torch names as having
    no deterministic CUDA form in one step. Inside the capture each kernel
    launches its per-step count, and each one's first call there, after the
    last replay, is held to its plain version. Prints ms/step eager and
    graphed, the capture's seconds and the graph pool's bytes, peak memory,
    device busy ms a step and the idle share (torch.profiler: the eager
    repeat's steps 9-16, the replayed group). Returns the launches per
    path: the eager group's through the wrappers' counters, the replayed
    steps' as the captured launches times the replays."""
    per_step = {
        "end2end": dict(affine_relu=BSR_2D + REMAT_2D, affine_relu_backward=BSR_2D,
                        wce_forward=1, wce_backward=1, **live_per_step("end2end")),
        "2d": dict(wce_forward=1, wce_backward=1, **live_per_step("2d")),
    }
    replays = GRAPH_STEPS - GRAPH_K
    paths = {}
    for arch in ("end2end", "2d"):
        named = nondeterministic_ops(arch)
        eager = graph_run(arch, 1)
        graphed = graph_run(arch, GRAPH_K, profile=True)
        cap = graphed.pop("capture")
        errors = hold_graphed_calls(cap.pop("kept"))
        again = graph_run(arch, 1, profile=True)
        want = only(**{n: c * GRAPH_STEPS for n, c in per_step[arch].items()})
        assert eager["launches"] == again["launches"] == want, (arch, eager["launches"], want)
        assert cap["launches"] == only(**per_step[arch]), (arch, cap["launches"])
        assert graphed["launches"] == only(**{n: c * (GRAPH_K + 1) for n, c in per_step[arch].items()}), (
            arch, graphed["launches"])
        ran = {n: graphed["launches"][n] - cap["launches"][n] + cap["launches"][n] * replays
               for n in graphed["launches"]}
        assert ran == want, (arch, ran)
        paths[f"train_graph_{arch}"] = ran
        repeat = differing(eager["state"], again["state"])
        graph_vs_eager = differing(eager["state"], graphed["state"])
        print(
            f"graph {arch}: steps_per_dispatch {GRAPH_K}, {GRAPH_STEPS} steps (steps 1-{GRAPH_K} eager, "
            f"{GRAPH_K + 1}-{GRAPH_STEPS} replayed), full preset bf16 remat, batch 8, dropout live: "
            f"eager {eager['ms']:.1f} ms/step, graphed {graphed['ms']:.1f} ms/step over steps "
            f"{GRAPH_K + 1}-{GRAPH_STEPS} (replayed group alone {graphed['replay_wall'] / replays * 1e3:.1f}); "
            f"capture {cap['seconds']:.2f} s, graph pool {cap['pool_bytes'] / 2**30:.2f} GiB, peak "
            f"{graphed['peak'] / 2**30:.2f} GiB against eager {eager['peak'] / 2**30:.2f}; device busy "
            f"{graphed['busy_ms']:.1f} ms/step, idle {100 * graphed['idle']:.1f} % ({graphed['events']} device "
            f"events a step) against eager {again['busy_ms']:.1f} ms/step, idle {100 * again['idle']:.1f} % "
            f"({again['events']} events; profiled {again['profiled_ms']:.1f} ms/step); captured launches "
            f"a step {cap['launches']}, ran {ran}; graphed calls against plain {errors}; "
            f"torch's nondeterministic ops in a step: {named or 'none'} [{card}]"
        )
        print(f"graph {arch}: losses eager {eager['losses']}")
        assert graphed["losses"] == eager["losses"], (arch, graphed["losses"])
        assert not graph_vs_eager, (arch, "graphed steps differ from eager ones", graph_vs_eager[:10])
        assert again["losses"] == eager["losses"], (arch, "eager steps do not repeat", again["losses"])
        assert not repeat, (arch, "eager steps do not repeat", repeat[:10])
        print(f"graph {arch}: graphed and repeated eager runs equal the eager run bit for bit: "
              f"{GRAPH_STEPS} losses, {len(eager['state'])} tensors (parameters, moving statistics, "
              f"momentum buffers) [{card}]")
        del eager, graphed, again
        torch.cuda.empty_cache()
    return paths


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and matmuls while open (float32 is float32)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def one_step(arch: str, policy: str = "full", mesh=None, dtype: str = "bfloat16") -> dict:
    """One ``train_step`` of phase 5's configuration, in ``dtype`` (float32:
    TF32 off), from the seeded weights on the first global batch (this
    rank's rows of it under ``mesh``): the loss, the launches, and the
    state_dict before and after, on the host."""
    from hdenseunet_tpu_torch.core.mesh import shard_batch
    from hdenseunet_tpu_torch.train.trainer import create_train_state, train_step

    cfg = train_config(arch, policy)
    cfg.model.compute_dtype = dtype
    batch = global_batches(cfg, 1)[0]
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    with exact_float32() if dtype == "float32" else contextlib.nullcontext():
        st = create_train_state(cfg, arch, device="cuda")
        host = lambda: {k: v.detach().to("cpu", copy=True) for k, v in st.model.state_dict().items()}
        before = host()
        reset_counts()
        loss = float(train_step(st, batch, cfg, mesh))
    return dict(loss=loss, launches=read_counts(), before=before, after=host())


def step_report(ref: dict, got: dict) -> tuple[float, list]:
    """Phase 7's bars for one step (``one_step``'s result) against another
    from the same weights: the loss within 1e-5 of its value, the moving
    statistics within 1e-4, and each other tensor's update within
    TRAIN_UPDATE_RTOL of its norm, after an allowance of two float32 ulps
    of the parameter per element. Returns the worst update error as a
    share of its tensor's update norm, and what failed a bar."""
    failed = []
    if abs(got["loss"] - ref["loss"]) > 1e-5 * abs(ref["loss"]):
        failed.append(("loss", got["loss"], ref["loss"]))
    worst = 0.0
    for name, w_ref in ref["after"].items():
        before, w_got = ref["before"][name], got["after"][name]
        if not torch.equal(before, got["before"][name]):
            failed.append((name, "differs before the step"))
        if name.endswith(("moving_mean", "moving_variance")):
            if not torch.allclose(w_got, w_ref, rtol=1e-4, atol=1e-4):
                failed.append((name, float((w_got - w_ref).abs().max())))
            continue
        d_ref, d_got = w_ref - before, w_got - before
        allowed = 2 * ULP_FP32 * w_ref.abs() + 1e-9
        excess = float(((d_got - d_ref).abs() - allowed).clamp_min(0).norm())
        share = excess / float(d_ref.norm()) if d_ref.any() else (0.0 if excess == 0 else float("inf"))
        if excess > TRAIN_UPDATE_RTOL * float(d_ref.norm()):
            failed.append((name, share))
        worst = max(worst, share)
    return worst, failed


def step_error(ref: dict, got: dict) -> float:
    """:func:`step_report`, failing on any tensor past its bar."""
    worst, failed = step_report(ref, got)
    assert not failed, failed[:20]
    return worst


@contextlib.contextmanager
def cli_clock():
    """Note the host clock at every ``trainer.train_step`` call, and the
    span and bytes of every ``Checkpointer.save`` and ``restore_latest``;
    a restore also keeps the snapshot of the state it restored."""
    from hdenseunet_tpu_torch.train import checkpoint as C, trainer as T

    marks = {"steps": [], "saves": [], "restores": []}
    step, save, restore = T.train_step, C.Checkpointer.save, C.Checkpointer.restore_latest

    def timed_step(*args, **kwargs):
        marks["steps"].append(time.perf_counter())
        return step(*args, **kwargs)

    def timed_save(self, at, state, metric=None):
        writes = int(at) > max(self.all_steps(), default=-1)  # else save skips it
        t0 = time.perf_counter()
        save(self, at, state, metric=metric)
        if writes:
            size = (self.dir / f"step-{int(at)}.pt").stat().st_size
            marks["saves"].append((t0, time.perf_counter() - t0, size))

    def timed_restore(self, state):
        steps = C.step_files(self.dir)
        t0 = time.perf_counter()
        out = restore(self, state)
        torch.cuda.synchronize()
        if out is not None:
            marks["restores"].append(
                (time.perf_counter() - t0, steps[max(steps)].stat().st_size, C.snapshot(out)))
        return out

    T.train_step, C.Checkpointer.save, C.Checkpointer.restore_latest = timed_step, timed_save, timed_restore
    try:
        yield marks
    finally:
        T.train_step, C.Checkpointer.save, C.Checkpointer.restore_latest = step, save, restore


def step_ms(marks: dict) -> list[float]:
    """ms from each step's start to the next one's in the same run, less
    any save between the two: steps 1 to n-1 (the first pays first-call
    costs)."""
    starts, out = marks["steps"], []
    for a, b in zip(starts, starts[1:]):
        saved = sum(d for t, d, _ in marks["saves"] if a < t < b)
        out.append((b - a - saved) * 1e3)
    return out


def run_cli(argv: list[str]):
    """(what cli.main returns, its standard output), with that output also
    echoed with a prefix, its launch counts set to 0 just before."""
    from hdenseunet_tpu_torch import cli

    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        result = cli.main(argv)
    torch.cuda.synchronize()
    for line in out.getvalue().splitlines():
        print(f"  | {line}")
    return result, out.getvalue()


def payloads_equal(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for k, v in a.items():
        w = b[k]
        if isinstance(v, dict):
            if not payloads_equal(v, w):
                return False
        elif isinstance(v, torch.Tensor):
            if not torch.equal(v, w):
                return False
        elif v != w:
            return False
    return True


def sampler_rate(prep: Path, mode: str, threads: int = 8, batches: int = 6) -> float:
    """Samples/s of CropSampler.batches(8, threads) over the prepared data,
    after one batch to warm the page cache and the pool."""
    from hdenseunet_tpu_torch.core.config import DataConfig
    from hdenseunet_tpu_torch.data.preprocess import PreparedDataset
    from hdenseunet_tpu_torch.data.sampler import CropSampler

    gen = CropSampler(PreparedDataset(prep), DataConfig(), mode=mode, seed=SEED).batches(8, threads=threads)
    next(gen)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(gen)
    rate = 8 * batches / (time.perf_counter() - t0)
    gen.close()
    return rate


def cli_path(card: str, synthetic_ms: dict, per_batch: dict) -> dict:
    """The staged workflow through the port's CLI at full width (phase 6),
    ``test`` once more with ``--tiled 256``. Returns the launch counts of
    each command."""
    from hdenseunet_tpu_torch.core import params as P
    from hdenseunet_tpu_torch.data import nifti
    from hdenseunet_tpu_torch.train import checkpoint as C

    BUILD.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=BUILD))
    try:
        prep, ck2d, cke = root / "prep", root / "ck2d", root / "cke"
        t0 = time.perf_counter()
        run_cli(["synth-data", "--out", str(prep), "--num-volumes", "2",
                 "--shape", ",".join(map(str, CLI_SHAPE)), "--seed", str(SEED)])
        synth_s = time.perf_counter() - t0
        rates = {mode: sampler_rate(prep, mode) for mode in ("hybrid", "2d")}
        print(f"cli: synth-data 2 x {CLI_SHAPE} in {synth_s:.1f} s; CropSampler alone, 8 crop threads, "
              f"batch 8: {rates['hybrid']:.1f} samples/s of 224x224x8, {rates['2d']:.1f} samples/s "
              f"of 224x224x3 [{card}]")

        common = ["--data", str(prep), "--batch", "8", "--set", "model.compute_dtype", "bfloat16",
                  "--set", "train.log_every_steps", "1"]
        launches, timing = {}, {}
        with cli_clock() as marks:
            state2d, _ = run_cli(["train", "--arch", "2d", "--max-steps", str(CLI_STEPS),
                                  "--checkpoint-dir", str(ck2d),
                                  "--set", "train.save_path", str(root / "exp2d"), *common])
        launches["cli_train_2d"], timing["2d"] = read_counts(), (step_ms(marks), marks)
        assert state2d.step == CLI_STEPS and len(P.layers(state2d.model)) == LAYERS_2D
        assert launches["cli_train_2d"] == only(wce_forward=CLI_STEPS, wce_backward=CLI_STEPS,
                                                **scaled(live_per_step("2d"), CLI_STEPS)), launches["cli_train_2d"]
        del state2d

        with cli_clock() as marks:
            state, text = run_cli(["train", "--arch", "end2end", "--max-steps", str(CLI_STEPS),
                                   "--checkpoint-dir", str(cke), "--init-from", str(ck2d),
                                   "--set", "train.checkpoint_every_steps", "2",
                                   "--set", "train.save_path", str(root / "expe"), *common])
        launches["cli_train_end2end"], timing["end2end"] = read_counts(), (step_ms(marks), marks)
        m = re.search(r"warm start: (\d+) layers loaded, (\d+) skipped, (\d+) shape-mismatched", text)
        assert m and tuple(map(int, m.groups())) == (LAYERS_2D, 0, 0), text
        per_step = {"affine_relu": BSR_2D + REMAT_2D, "affine_relu_backward": BSR_2D,
                    "wce_forward": 1, "wce_backward": 1, **live_per_step("end2end")}
        assert launches["cli_train_end2end"] == only(**{k: n * CLI_STEPS for k, n in per_step.items()})
        assert C.Checkpointer(cke).all_steps() == [2, CLI_STEPS] and state.step == CLI_STEPS
        saved = C.snapshot(state)
        del state

        with cli_clock() as marks:
            state, text = run_cli(["train", "--arch", "end2end", "--max-steps", str(CLI_RESUME_STEPS),
                                   "--checkpoint-dir", str(cke), "--resume",
                                   "--set", "train.save_path", str(root / "expe"), *common])
        launches["cli_train_resume"], timing["resume"] = read_counts(), (step_ms(marks), marks)
        assert f"resumed from step {CLI_STEPS}" in text, text
        (restore_s, restore_bytes, restored), = marks["restores"]
        assert payloads_equal(restored, saved), "the restored state differs from the saved one"
        assert launches["cli_train_resume"] == only(**{k: n * CLI_RESUME_STEPS for k, n in per_step.items()})
        assert state.step == CLI_STEPS + CLI_RESUME_STEPS
        del state, saved, restored

        # steps_per_dispatch through the CLI and the device prefetch: the
        # first group eager, the second replayed from the captured step
        state, text = run_cli(["train", "--arch", "end2end", "--max-steps", str(GRAPH_STEPS),
                               "--init-from", str(ck2d), "--set", "train.save_path", str(root / "expg"),
                               *common, "--set", "train.steps_per_dispatch", str(GRAPH_K)])
        counted = read_counts()
        replays = GRAPH_STEPS - GRAPH_K
        assert f"steps_per_dispatch {GRAPH_K}: {GRAPH_STEPS} steps in groups, {replays} of them replayed" in text, text
        assert counted == only(**{k: n * (GRAPH_K + 1) for k, n in per_step.items()}), counted
        launches["cli_train_graph"] = only(**{k: n * GRAPH_STEPS for k, n in per_step.items()})
        assert state.step == GRAPH_STEPS
        del state

        dirs = {d: root / d for d in ("tv", "tm", "truth")}
        for d in dirs.values():
            d.mkdir()
        vol = np.load(prep / "volumes" / "volume-0.npy")
        seg = np.load(prep / "segmentations" / "segmentation-0.npy")
        nifti.write(dirs["tv"] / "test-volume-0.nii", vol)
        nifti.write(dirs["tm"] / "0-ori.nii", (seg >= 1).astype(np.int16))
        nifti.write(dirs["truth"] / "segmentation-0.nii", seg)
        seconds, _ = run_cli(["test", "--data", str(dirs["tv"]), "--livermask", str(dirs["tm"]),
                              "--weights", str(cke), "--save-path", str(root / "res"),
                              "--num-volumes", "1", "--set", "model.compute_dtype", "bfloat16"])
        launches["cli_test"] = read_counts()
        assert launches["cli_test"]["affine_relu"] > 0 and launches["cli_test"]["affine_relu_backward"] == 0
        assert not any(launches["cli_test"][k] for k in K6_NAMES), launches["cli_test"]
        assert launches["cli_test"]["affine_gemm"] == launches["cli_test"]["affine_relu"] // 4 * 111
        assert all(launches["cli_test"][k] == 0 for k in ("wce_forward", "wce_backward", *K4_NAMES))
        assert launches["cli_test"]["window_accumulate"] > 0 and launches["cli_test"]["score_finish"] == 1
        out, _ = nifti.read(root / "res" / "test-segmentation-0.nii")
        out = np.asarray(out)
        assert out.shape == vol.shape and set(np.unique(out).tolist()) <= {0, 1, 2}, np.unique(out)
        tiled_s, _ = run_cli(["test", "--data", str(dirs["tv"]), "--livermask", str(dirs["tm"]),
                              "--weights", str(cke), "--save-path", str(root / "res_tiled"),
                              "--num-volumes", "1", "--tiled", str(TILE),
                              "--set", "model.compute_dtype", "bfloat16"])
        launches["cli_test_tiled"] = read_counts()
        windows, batches = tiled_batches(vol.shape, TILE, 8, 8)
        assert launches["cli_test_tiled"] == only(**scaled(per_batch, batches)), (
            launches["cli_test_tiled"], batches)
        tiled, _ = nifti.read(root / "res_tiled" / "test-segmentation-0.nii")
        tiled = np.asarray(tiled)
        assert tiled.shape == vol.shape and set(np.unique(tiled).tolist()) <= {0, 1, 2}, np.unique(tiled)
        _, text = run_cli(["evaluate", "--pred", str(root / "res"), "--truth", str(dirs["truth"]),
                           "--num-volumes", "1"])
        assert "mean per-case Dice" in text

        for stage, (ms, marks) in timing.items():
            arch = "2d" if stage == "2d" else "end2end"
            saves = [(round(d, 3), b) for _, d, b in marks["saves"]]
            print(f"cli train {stage}: real feed {[round(v, 1) for v in ms]} ms/step (steps 1 to "
                  f"{len(ms)}, saves taken out) against the synthetic feed's {synthetic_ms[arch]:.1f} "
                  f"ms/step (phase 5, {arch}, steps 2-4); saves (s, bytes) {saves} [{card}]")
        print(f"cli resume: restore {restore_s:.3f} s of {restore_bytes} bytes, bit-identical to the "
              f"saved state; test: {[round(s, 3) for s in seconds]} s/volume {CLI_SHAPE}, launches "
              f"{launches['cli_test']}; test --tiled {TILE}: {windows} windows in {batches} batches, "
              f"{[round(s, 3) for s in tiled_s]} s/volume, labelmap {tiled.shape} with label counts "
              f"{np.bincount(tiled.ravel(), minlength=3).tolist()} [{card}]")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def model_check(card: str) -> float:
    """The tiny fp32 scorer, card (kernels) against CPU (plain versions), in
    each scoring path: the dedup-2D default, the per-window path and the
    shared-2D mode; the tiled scorer and the host-loop window predictor;
    and the uint8 wire's labelmask at the default path's thresholds."""
    import dataclasses

    from hdenseunet_tpu_torch.core.config import InferConfig
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer, TiledVolumeScorer
    from hdenseunet_tpu_torch.infer.sliding_window import WindowPredictor
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
    from hdenseunet_tpu_torch.ops.fused_affine import affine_relu

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = init_model(HDenseUNet(preset="tiny"), SEED)
    gpu_model = copy.deepcopy(cpu_model)
    vol = np.random.default_rng(SEED).normal(0, 50, (64, 64, 28)).astype(np.float32)
    worst, probs = 0.0, None
    for mode, knobs in (("dedup-2D", {}), ("per-window", dict(dedup_2d=False)),
                        ("shared-2D", dict(shared_2d=True))):
        cfg = dataclasses.replace(InferConfig(), **knobs)
        want = DeviceVolumeScorer(cpu_model, cfg, device="cpu").score(vol, 4, 20).numpy()
        before = affine_relu.launches
        got = DeviceVolumeScorer(gpu_model, cfg, device="cuda").score(vol, 4, 20).cpu().numpy()
        assert affine_relu.launches > before, f"the card's {mode} scorer did not run K1"
        err = float(np.abs(got - want).max())
        assert err <= MODEL_TOL, (mode, err)
        worst = max(worst, err)
        probs = want if mode == "dedup-2D" else probs
        print(f"model check: tiny fp32 {mode} scorer, card (K1) vs CPU (plain) max_abs_err "
              f"{err:.3g} [{card}]")
    for mode, make in (
        ("tiled (tile 32)", lambda m, d: lambda: TiledVolumeScorer(m, InferConfig(window_batch=4), tile=32,
                                                                   device=d).score(vol).cpu().numpy()),
        ("host-loop", lambda m, d: lambda: np.stack(WindowPredictor(m, InferConfig(), device=d)
                                                    .predict_volume(vol, 4, 20), axis=-1)),
    ):
        want = make(cpu_model, "cpu")()
        before = affine_relu.launches
        got = make(gpu_model, "cuda")()
        assert affine_relu.launches > before, f"the card's {mode} scorer did not run K1"
        err = float(np.abs(got - want).max())
        assert err <= MODEL_TOL and want.max() > 0, (mode, err)
        worst = max(worst, err)
        print(f"model check: tiny fp32 {mode} scorer, card (K1) vs CPU (plain) max_abs_err "
              f"{err:.3g} [{card}]")
    # the uint8 wire: thresholds midway between neighbouring probabilities
    # more than 2 MODEL_TOL apart, so no voxel can flip between the devices
    thresholds = []
    for ch, q in ((1, 0.6), (2, 0.9)):
        v = np.unique(probs[..., ch][probs[..., 0] > 0])
        k = int(q * (len(v) - 1))
        while v[k + 1] - v[k] <= 2 * MODEL_TOL:
            k += 1
        thresholds.append(float((v[k] + v[k + 1]) / 2))
    cfg = InferConfig(wire_bits=8, thres_liver=thresholds[0], thres_tumor=thresholds[1])
    want = DeviceVolumeScorer(cpu_model, cfg, device="cpu").labelmask(vol, 4, 20)
    got = DeviceVolumeScorer(gpu_model, cfg, device="cuda").labelmask(vol, 4, 20)
    assert np.array_equal(got, want) and (got == 1).any() and (got == 3).any()
    print(f"model check: tiny uint8-wire labelmask, card vs CPU byte-identical [{card}]")
    return worst


def train_check(card: str) -> None:
    """One tiny end2end train step in float32 on the CPU (plain versions)
    and on the card (kernels), from the same seeded weights and batch, with
    dropout as the identity (the two devices' random bits differ)."""
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.data.sampler import synthetic_batches
    from hdenseunet_tpu_torch.models import layers as L
    from hdenseunet_tpu_torch.train import trainer as T

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config()
    cfg.model.preset, cfg.model.input_size, cfg.train.batch = "tiny", 32, 2
    batch = next(synthetic_batches(mode="hybrid", batch=2, input_size=32, input_cols=8, seed=SEED))
    dropout = L.dropout
    L.dropout = lambda x, rate, seed=None: x
    try:
        states, losses, deltas = [], [], []
        for device in ("cpu", "cuda"):
            st = T.create_train_state(cfg, "end2end", device=device, seed=SEED)
            before = {k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()}
            reset_counts()
            losses.append(float(T.train_step(st, batch, cfg)))
            states.append({k: v.detach().cpu() for k, v in st.model.state_dict().items()})
            deltas.append({k: states[-1][k] - before[k] for k in before})
        launches = read_counts()
    finally:
        L.dropout = dropout
    assert all(launches[name] > 0 for name in K12_NAMES + K6_NAMES), launches
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0]), losses
    worst = 0.0
    for name, d_cpu in deltas[0].items():
        if name.endswith(("moving_mean", "moving_variance")):
            torch.testing.assert_close(states[1][name], states[0][name], rtol=1e-4, atol=1e-4)
            continue
        allowed = 2 * ULP_FP32 * states[0][name].abs() + 1e-9
        excess = float(((deltas[1][name] - d_cpu).abs() - allowed).clamp_min(0).norm())
        assert excess <= TRAIN_UPDATE_RTOL * float(d_cpu.norm()), (name, excess, float(d_cpu.norm()))
        worst = max(worst, excess / float(d_cpu.norm()) if d_cpu.any() else 0.0)
    print(
        f"train check: tiny end2end fp32 step, card (kernels {launches}) vs CPU (plain): "
        f"loss {losses[1]:.7g} vs {losses[0]:.7g}, worst update error {worst:.3g} of its "
        f"tensor's update norm [{card}]"
    )


@contextlib.contextmanager
def timed_all_reduces():
    """Time every ``torch.distributed.all_reduce`` the port makes while
    open, the card synchronised before and after each (the sync adds to
    the step it times): yields the list of their seconds."""
    import torch.distributed as dist

    spans, inner = [], dist.all_reduce

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out

    dist.all_reduce = timed
    try:
        yield spans
    finally:
        dist.all_reduce = inner


def train_dp_w1(card: str, one_steps: dict) -> dict:
    """train_dp_w1: this process joins a process group of one rank over
    NCCL (a file store under build/), and phase 5's runs go through the
    'data' mesh: per stage, one step from the seeded weights held to the
    one-process step at phase 7's bars, then ``train(..., mesh=)`` for
    TRAIN_STEPS steps with phase 5's launches per step, its all-reduces
    (the loss sums and the gradient bucket; live statistics reduce only
    over several ranks) timed. The group is left at the end. Returns the
    launch counts per stage."""
    import torch.distributed as dist

    from hdenseunet_tpu_torch.core.mesh import axis_size, make_mesh
    from hdenseunet_tpu_torch.parallel import multihost

    BUILD.mkdir(parents=True, exist_ok=True)
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_w1_", dir=BUILD))
    several = multihost.initialize(
        init_method=f"file://{store}/store", world_size=1, rank=0, backend="nccl", timeout=DP_TIMEOUT,
    )
    assert not several and dist.is_initialized()
    launches = {}
    try:
        mesh = make_mesh("cuda")
        assert axis_size(mesh) == 1 and dist.get_backend() == "nccl", (mesh, dist.get_backend())
        for arch in ("end2end", "2d"):
            got = one_step(arch, mesh=mesh)
            assert got["launches"] == one_steps[arch]["launches"], (got["launches"], one_steps[arch]["launches"])
            worst = step_error(one_steps[arch], got)
            with timed_all_reduces() as spans:
                run = train_path(card, arch, mesh=mesh, label="train_dp_w1")
            launches[f"train_dp_w1_{arch}"] = run["launches"]
            print(f"train_dp_w1 {arch}: NCCL, 1 rank; step 1 against the one-process step: loss "
                  f"{got['loss']:.7g} against {one_steps[arch]['loss']:.7g}, worst update error {worst:.3g} "
                  f"of its tensor's update norm; {len(spans) // TRAIN_STEPS} all-reduces a step, "
                  f"{sum(spans) * 1e3 / TRAIN_STEPS:.3f} ms a step synchronised, "
                  f"{100 * sum(spans) * 1e3 / TRAIN_STEPS / run['ms']:.2f} % of {run['ms']:.1f} ms/step [{card}]")
            del run
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return launches


def ranks_identical(mesh, model) -> bool:
    """Every parameter and buffer of ``model`` equals rank 0's bit for bit
    (rank 0's flat copy broadcast, then compared on each rank)."""
    import torch.distributed as dist

    from hdenseunet_tpu_torch.core.mesh import axis_group

    same = True
    tensors = [*model.parameters(), *model.buffers()]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        mine = torch.cat([t.detach().reshape(-1) for t in tensors if t.dtype == dtype])
        theirs = mine.clone()
        dist.broadcast(theirs, src=0, group=axis_group(mesh))
        same = same and torch.equal(mine, theirs)
    return same


def dp_train_rank(arch: str, mesh, out_dir: Path) -> dict:
    """One rank's part of train_dp_w2 for one stage: one float32 step from
    the seeded weights on its rows of the first global batch, then DP_STEPS
    bfloat16 steps on its rows of phase 5's global batches: after step 1
    and at the end the ranks' parameters and statistics against rank 0's;
    step 2 timed, step 3 timed with its all-reduces synchronised. Rank 0
    saves the float32 step and the bfloat16 step 1 for the comparisons
    with one process."""
    from hdenseunet_tpu_torch.core.mesh import axis_rank, shard_batch
    from hdenseunet_tpu_torch.train.trainer import create_train_state, train_step

    exact = one_step(arch, mesh=mesh, dtype="float32")
    if axis_rank(mesh) == 0:
        torch.save({k: exact[k] for k in ("loss", "launches", "after")}, out_dir / f"{arch}-float32.pt")
    del exact
    cfg = train_config(arch)
    batches = [shard_batch(mesh, b) for b in global_batches(cfg, DP_STEPS)]
    st = create_train_state(cfg, arch, device="cuda")
    reset_counts()
    walls, losses, spans = [], [], []
    for i, batch in enumerate(batches):
        timing = timed_all_reduces() if i == 2 else contextlib.nullcontext([])
        with timing as found:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(train_step(st, batch, cfg, mesh)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        spans += found
        if i == 0:
            identical_1 = ranks_identical(mesh, st.model)
            if axis_rank(mesh) == 0:
                torch.save({k: v.detach().cpu() for k, v in st.model.state_dict().items()},
                           out_dir / f"{arch}-bf16.pt")
    return dict(launches=read_counts(), losses=losses, walls=walls, all_reduce=spans,
                identical=(identical_1, ranks_identical(mesh, st.model)), rows=len(batches[0]["image"]))


def serve_float32(mesh=None, labelmap: bool = True) -> dict:
    """Phase 4's model and first volume in float32, TF32 off, through
    ``VolumePredictor`` (over ``mesh`` when given): the labelmap (unless
    ``labelmap`` is False) and the scorer's probabilities, on the host."""
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    cfg = Config()
    cfg.model.compute_dtype = "float32"
    vol, ext = synthetic_case(SEED)
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    with exact_float32():
        model = init_model(HDenseUNet(preset=cfg.model.preset, device="cuda"), SEED)
        predictor = VolumePredictor(model, cfg, arch="end2end", device="cuda", mesh=mesh)
        out = dict(labelmap=predictor.segment(vol, ext)) if labelmap else {}
        out["probs"] = predictor.windows.score(vol - cfg.infer.mean, z_lo, z_hi).cpu()
    return out


def dp_serve_rank(mesh, out_dir: Path) -> dict:
    """One rank's part of serve_dp_w2: phase 4's model and first volume
    through ``VolumePredictor(mesh=)`` in bfloat16, twice (the first
    carries cuDNN's first-call cost), K1 launches and s/volume each time;
    then in float32 (:func:`serve_float32`). Rank 0 saves the probabilities
    of both for the comparison with one process's."""
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.core.mesh import axis_rank
    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    model = init_model(HDenseUNet(preset=cfg.model.preset, device="cuda"), SEED)
    predictor = VolumePredictor(model, cfg, arch="end2end", device="cuda", mesh=mesh)
    vol, ext = synthetic_case(SEED)
    seconds, k1 = [], []
    for _ in range(2):
        reset_counts()
        t0 = time.perf_counter()
        labelmap = predictor.segment(vol, ext)
        seconds.append(time.perf_counter() - t0)
        k1.append(read_counts())
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    probs = predictor.windows.score(vol - cfg.infer.mean, z_lo, z_hi).cpu()
    del predictor, model
    torch.cuda.empty_cache()
    exact = serve_float32(mesh)
    if axis_rank(mesh) == 0:
        torch.save(dict(bf16=probs, float32=exact["probs"]), out_dir / "probs.pt")
    return dict(labelmap=labelmap, labelmap32=exact["labelmap"], seconds=seconds, launches=k1)


def dp_rank(job: dict) -> None:
    """``chip_smoke.py dp-rank JOB``: one of DP_RANKS processes sharing the
    card over gloo (train_dp_w2, then serve_dp_w2); results to job['out']."""
    import torch.distributed as dist

    from hdenseunet_tpu_torch.core.mesh import make_mesh
    from hdenseunet_tpu_torch.parallel import multihost

    multihost.initialize(init_method=job["init"], world_size=job["world"], rank=job["rank"],
                         backend="gloo", timeout=DP_TIMEOUT)
    torch.cuda.set_device(0)
    mesh = make_mesh("cuda")
    out = {"train": {}}
    for arch in ("end2end", "2d"):
        out["train"][arch] = dp_train_rank(arch, mesh, Path(job["dir"]))
        torch.cuda.empty_cache()
    out["serve"] = dp_serve_rank(mesh, Path(job["dir"]))
    torch.save(out, job["out"])
    dist.destroy_process_group()


def dp_two_ranks(card: str, one_steps: dict, exact_steps: dict, serve_ref: dict) -> dict:
    """train_dp_w2 and serve_dp_w2: DP_RANKS processes (``dp-rank``) on the
    one card over gloo, each with its rows of global batch 8 (4) and its 4
    windows of each batch of 8. Two ranks on one card check the semantics,
    not scaling: they share its SMs and memory. Step 1 is held to the
    one-process step in float32 (``exact_steps``): cuDNN picks its kernels
    by shape, so in bfloat16 the ranks' 4 rows may round otherwise than 8,
    and a tensor whose gradient is a sum that cancels differs past the
    bars; the bfloat16 step 1 against ``one_steps`` is reported, not held.
    The same holds for serving, where the 2D logits enter the 3D branch
    times 250: in bfloat16 the ranks' labelmaps are held to each other's
    and their difference from phase 4's is reported; in float32 (one
    process's in ``serve_ref['float32']``) the probabilities are held to
    one process's within DP_FLOAT32_GAP and the ranks' labelmaps to each
    other's byte for byte; the labelmap's voxels unlike one process's (a
    voxel whose probability lies within the gap of a threshold may change
    its label) are reported. Everything is printed before any check. Returns rank 0's
    launch counts per path."""
    BUILD.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=BUILD))
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = spawn_ranks(root, DP_RANKS)
        print(f"dp ranks: {DP_RANKS} processes, gloo on one card (semantics, not scaling), "
              f"{time.perf_counter() - t0:.1f} s in all [{card}]")
        launches, failed = {}, []
        for arch in ("end2end", "2d"):
            runs = [out["train"][arch] for out in outs]
            for r, run in enumerate(runs):
                ar = sum(run["all_reduce"]) * 1e3
                print(f"train_dp_w2 {arch} rank {r}: {run['rows']} rows of global batch 8, bf16, {DP_STEPS} "
                      f"steps, ms/step {[round(w * 1e3, 1) for w in run['walls']]} (step 1 first-call; step "
                      f"3 with {len(run['all_reduce'])} all-reduces synchronised: {ar:.1f} ms, "
                      f"{100 * ar / (run['walls'][2] * 1e3):.1f} % of it), losses "
                      f"{[round(v, 6) for v in run['losses']]}, ranks bit-identical after step 1 and "
                      f"{DP_STEPS}: {run['identical']}, launches {run['launches']} [{card}]")
                if run["identical"] != (True, True) or run["launches"] != runs[0]["launches"]:
                    failed.append((arch, r, run["identical"], run["launches"]))
                if run["losses"] != runs[0]["losses"] or not all(np.isfinite(run["losses"])):
                    failed.append((arch, r, run["losses"]))
            exact = torch.load(root / f"{arch}-float32.pt")
            worst, bad = step_report(exact_steps[arch], dict(exact_steps[arch], **exact))
            print(f"train_dp_w2 {arch}: float32 step 1 of 2 ranks against one process's on the global batch: "
                  f"loss {exact['loss']:.7g} against {exact_steps[arch]['loss']:.7g}, worst update error "
                  f"{worst:.3g} of its tensor's update norm, past the bars: {bad[:10]} [{card}]")
            failed += bad
            bf16 = dict(one_steps[arch], after=torch.load(root / f"{arch}-bf16.pt"), loss=runs[0]["losses"][0])
            worst16, bad16 = step_report(one_steps[arch], bf16)
            print(f"train_dp_w2 {arch}: bfloat16 step 1 against one process's (reported, not held): loss "
                  f"{bf16['loss']:.7g} against {one_steps[arch]['loss']:.7g}, worst update error {worst16:.3g} "
                  f"of its tensor's update norm, {len(bad16)} tensors past phase 7's bars: "
                  f"{[(b[0], round(b[1], 3)) if isinstance(b[1], float) else b for b in bad16[:5]]} [{card}]")
            # one process's launches a step, K6's and K7's included
            per_step = {k: n // DP_STEPS for k, n in runs[0]["launches"].items()}
            want = exact_steps[arch]["launches"]
            assert all(want[k] for k in K6_NAMES + K7_NAMES), want
            if per_step != want or exact["launches"] != want:
                failed.append((arch, per_step, exact["launches"], want))
            launches[f"train_dp_w2_{arch}"] = runs[0]["launches"]
        probs = torch.load(root / "probs.pt")
        exact = serve_ref["float32"]
        gap16 = (probs["bf16"] - serve_ref["probs"]).abs()
        gap32 = float((probs["float32"] - exact["probs"]).abs().max())
        print(f"serve_dp_w2: rank 0's probabilities against one process's: bfloat16 (phase 4) max gap "
              f"{float(gap16.max()):.3g}, {int((gap16 > 0).sum())} of {gap16.numel()} values differ; "
              f"float32 max gap {gap32:.3g} (bound {DP_FLOAT32_GAP:.3g}) [{card}]")
        if gap32 > DP_FLOAT32_GAP:
            failed.append(("serve_dp_w2 float32 gap", gap32))
        for kind in ("bf16", "float32"):
            if not (bool(torch.isfinite(probs[kind]).all()) and 0.0 <= float(probs[kind].min())
                    and float(probs[kind].max()) <= 1.0 + 1e-5):
                failed.append(("serve_dp_w2 probabilities", kind))
        for r, out in enumerate(outs):
            serve = out["serve"]
            diff = int((serve["labelmap"] != serve_ref["labelmap"]).sum())
            diff32 = int((serve["labelmap32"] != exact["labelmap"]).sum())
            print(f"serve_dp_w2 rank {r}: {VOLUME_SHAPE} window_batch 8 (4 a rank), bf16 s/volume "
                  f"{[round(v, 3) for v in serve['seconds']]} (one process, phase 4: "
                  f"{[round(v, 3) for v in serve_ref['seconds']]}), K1 launches a volume "
                  f"{[c['affine_relu'] for c in serve['launches']]} (one process: {serve_ref['k1']}), "
                  f"labelmap voxels unlike one process's: {diff} in bfloat16, {diff32} in float32 [{card}]")
            if not (np.array_equal(serve["labelmap"], outs[0]["serve"]["labelmap"])
                    and np.array_equal(serve["labelmap32"], outs[0]["serve"]["labelmap32"])):
                failed.append(("serve_dp_w2 ranks differ", r))
            counts = serve["launches"][0]
            if any(c != counts for c in serve["launches"]) or not counts["affine_relu"] or any(
                    counts[k] for k in K4_NAMES + ("wce_forward", "wce_backward")) or not (
                    counts["window_accumulate"] and counts["score_finish"] == 1):
                failed.append(("serve_dp_w2", r, serve["launches"]))
        assert not failed, failed[:20]
        launches["serve_dp_w2"] = outs[0]["serve"]["launches"][0]
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def spawn_ranks(root: Path, world: int) -> list:
    """Run ``chip_smoke.py dp-rank`` in ``world`` processes meeting at a
    file store under ``root``; each rank's results come back from its
    file. Fails if a rank fails or the group outlives DP_WALL (every rank
    is then killed)."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["LOCAL_RANK"] = "0"  # every rank on the one card
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "dp-rank", json.dumps(dict(
                init=f"file://{root}/store", world=world, rank=r, out=str(root / f"rank{r}.pt"), dir=str(root)))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + DP_WALL
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"dp rank {r} exited {p.returncode}:\n{log[-6000:]}"
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(world)]


def cli_rank(counts: str, argv: list[str]) -> None:
    """``chip_smoke.py cli-rank COUNTS ARGV...`` under torchrun: the port's
    CLI (``hdenseunet_tpu_torch.cli.main``, what ``python -m
    hdenseunet_tpu_torch`` runs) with ARGV in torchrun's environment; rank 0
    writes the launch counts and the process group it joined to COUNTS."""
    import torch.distributed as dist

    from hdenseunet_tpu_torch import cli

    reset_counts()
    state = cli.main(argv)
    torch.cuda.synchronize()
    info = dict(launches=read_counts(), step=state.step, device=str(state.device),
                world=dist.get_world_size(), backend=dist.get_backend(), rank=dist.get_rank())
    if info["rank"] == 0:
        Path(counts).write_text(json.dumps(info))
    dist.destroy_process_group()


def cli_train_dp(card: str) -> dict:
    """cli_train_dp: ``torchrun --standalone --nproc_per_node 1`` (its
    module, ``torch.distributed.run``) runs ``train --arch end2end`` for 2
    steps at full width with a checkpoint (``cli-rank``: the port's
    ``cli.main`` in torchrun's environment, over NCCL); then this process,
    with no torchrun and no group, resumes the run for one step through the
    CLI. The restored state equals the saved one bit for bit. Returns the
    launch counts of both runs."""
    from hdenseunet_tpu_torch.train import checkpoint as C

    BUILD.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_dp_", dir=BUILD))
    try:
        common = ["train", "--arch", "end2end", "--batch", "8", "--checkpoint-dir", str(root / "ck"),
                  "--set", "model.compute_dtype", "bfloat16", "--set", "train.log_every_steps", "1",
                  "--set", "train.save_path", str(root / "exp")]
        counts = root / "launches.json"
        env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
             __file__, "cli-rank", str(counts), *common, "--max-steps", "2"],
            env=env, capture_output=True, text=True, timeout=DP_WALL,
        )
        seconds = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"  | {line}")
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
        child = json.loads(counts.read_text())
        # one rank: live BN takes K6
        per_step = {"affine_relu": BSR_2D + REMAT_2D, "affine_relu_backward": BSR_2D,
                    "wce_forward": 1, "wce_backward": 1, **live_per_step("end2end")}
        assert (child["world"], child["backend"], child["step"]) == (1, "nccl", 2), child
        assert child["launches"] == only(**{k: 2 * n for k, n in per_step.items()}), child["launches"]
        saved = C.load(root / "ck" / "step-2.pt")
        with cli_clock() as marks:
            state, text = run_cli([*common, "--max-steps", "1", "--resume"])
        resumed = read_counts()
        assert "resumed from step 2" in text, text
        (restore_s, _, restored), = marks["restores"]
        assert payloads_equal(restored, saved), "the restored state differs from the saved one"
        assert state.step == 3 and resumed == only(**per_step), (state.step, resumed)
        print(f"cli_train_dp: torchrun, 1 rank over NCCL ({child['device']}): 2 end2end steps and a save in "
              f"{seconds:.1f} s (the process's start included), launches {child['launches']}; resumed in one "
              f"process with no group: restore {restore_s:.3f} s, bit-identical to the save [{card}]")
        return {"cli_train_dp": child["launches"], "cli_train_dp_resume": resumed}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_path(card: str) -> dict:
    """Phase 10: ``bench_torch.main`` in this process under BENCH_ENV, its
    line checked (module docstring). Every scoring's plan and every served
    digest are noted on the way, by wrapping ``DeviceVolumeScorer._sums``
    and ``summarize``. Returns the launch counts of the serving phases
    (bench_serve) and of the train phase (bench_train)."""
    from unittest import mock

    import bench_torch
    from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    live, digests, launches = [], [], {}
    sums, summarize = DeviceVolumeScorer._sums, DeviceVolumeScorer.summarize
    measure_train = bench_torch.measure_train

    def counted_sums(self, vol_d, p):  # one call a scoring
        live.append(int(p["weights"].any(axis=1).sum()))
        return sums(self, vol_d, p)

    def kept_summarize(self, *args):
        digests.append(summarize(self, *args))
        return digests[-1]

    def counted_train(*args):  # the serving phases are over; the train phase starts
        launches["bench_serve"] = read_counts()
        reset_counts()
        try:
            return measure_train(*args)
        finally:
            launches["bench_train"] = read_counts()

    out = io.StringIO()
    t0 = time.perf_counter()
    reset_counts()
    with mock.patch.dict(os.environ, BENCH_ENV), contextlib.redirect_stdout(out), \
            mock.patch.object(DeviceVolumeScorer, "_sums", counted_sums), \
            mock.patch.object(DeviceVolumeScorer, "summarize", kept_summarize), \
            mock.patch.object(bench_torch, "measure_train", counted_train):
        status = bench_torch.main()
    seconds = time.perf_counter() - t0
    lines = [json.loads(s) for s in out.getvalue().splitlines() if s.startswith("{")]
    assert status == 0 and len(lines) == 5, (status, out.getvalue()[-3000:])
    line = lines[-1]
    assert not [k for k in line if k.endswith("_error")], line
    missing = [k for k in BENCH_KEYS if k not in line]
    for reliable, unreliable in BENCH_EITHER:
        if not all(k in line for k in unreliable):
            missing += [k for k in reliable if k not in line]
    assert not missing and line["card"] in card, (missing, line)
    assert digests and all(np.isfinite(d).all() for d in digests), digests
    if "compute_s_per_volume" in line:
        assert line["value"] >= line["compute_s_per_volume"], line
    unreliable = sorted(k for k in line if k.endswith("_unreliable"))

    serve, train = launches["bench_serve"], launches["bench_train"]
    per_batch = route_counts(HDenseUNet(preset="full", device="meta"))
    finishes = 1 + int(BENCH_ENV["BENCH_PIPELINE_VOLUMES"])  # the pipelined loop's warm-up and volumes
    assert serve["window_accumulate"] == sum(live) and serve["score_finish"] == finishes, (serve, live)
    assert serve == only(**scaled(per_batch, sum(live)), window_accumulate=sum(live),
                         score_finish=finishes), (serve, per_batch, sum(live))
    env = {k: int(v) for k, v in BENCH_ENV.items() if k.startswith("BENCH_TRAIN")}
    # the first step, the chained loops, and each endpoint's eager call and capture
    steps = (1 + env["BENCH_TRAIN_REPS"] * env["BENCH_TRAIN_STEPS"]
             + env["BENCH_TRAIN_K_SMALL"] + 1 + env["BENCH_TRAIN_K_BIG"] + 1)
    assert train == only(wce_forward=steps, wce_backward=steps, **scaled(live_per_step("2d"), steps)), (train, steps)
    print(
        f"bench: bench_torch.main under {BENCH_ENV}: exit {status}, {len(lines)} cumulative lines, "
        f"{seconds:.1f} s; {len(live)} scorings over {sum(live)} live window batches, {len(digests)} "
        f"digests finite; unreliable: {unreliable or 'none'}; launches bench_serve "
        f"{ {k: v for k, v in serve.items() if v} } ({per_batch} x {sum(live)}), bench_train "
        f"{ {k: v for k, v in train.items() if v} } ({steps} steps counted, replays not) [{card}]"
    )
    print(f"  bench line: {json.dumps(line)}")
    return launches


class Laps:
    """Prints each phase's wall seconds and the total so far."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"time: {phase} {now - self.last:.1f} s, {now - self.start:.1f} s in all")
        self.last = now


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a card")
    from hdenseunet_tpu_torch.ops import build

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; cuda {torch.version.cuda}")
    lap = Laps()
    so, seconds = build.build()
    print(f"build: {so.name} in {seconds:.1f} s")
    lap("build")

    k1 = check_k1(card)
    lap("k1")
    k1_bwd = check_k1_backward(card)
    lap("k1_backward")
    k2_fwd, k2_bwd = check_k2(card)
    lap("k2")
    k6 = check_k6(card)
    lap("k6")
    k7 = check_k7(card)
    lap("k7")
    check_back_to_back(card)
    lap("back_to_back")
    serve = serve_path(card)
    paths, calls, synthetic_ms = {"serve": serve["launches"]}, {}, {}
    lap("serve")
    paths.update(serve_dpp_path(card, serve))
    lap("serve_dpp")
    paths.update(serve_modes(card, serve))
    lap("serve_modes")
    paths["serve_host_loop"] = serve_host_loop(card, serve)
    lap("serve_host_loop")
    paths["serve_tiled"] = serve_tiled(card, serve)
    lap("serve_tiled")
    paths["mfu"] = mfu_path(card, serve)
    lap("mfu")
    paths["trace"] = trace_path(card, serve)
    lap("trace")
    k4 = check_k4(card, serve)
    lap("k4")
    k3 = check_k3(card, serve)
    paths["serve_plain_k3"] = k3["launches"]
    lap("k3")
    k5 = check_k5(card, serve)
    paths["serve_unfused"] = k5["launches"]
    lap("k5")
    paths.update(forms_serve_path(card, serve))
    lap("forms_serve")
    per_batch = serve["per_batch"]
    serve_ref = dict(labelmap=serve["labelmaps"][0], probs=serve["probs"], seconds=serve["seconds"],
                     k1=serve["launches"]["affine_relu"] // len(serve["cases"]))
    del serve
    runs = {}
    for arch in ("end2end", "2d"):
        runs[arch] = train_path(card, arch)
        paths[f"train_{arch}"], calls[f"train_{arch}"] = runs[arch]["launches"], runs[arch]["calls"]
        synthetic_ms[arch] = runs[arch]["ms"]
    paths["train_end2end_convs"] = train_convs_path(card, runs["end2end"])
    lap("train")
    paths.update(forms_train_path(card, runs["end2end"]))
    lap("forms_train")
    del runs
    paths.update(graph_path(card))
    lap("graph")
    paths.update(cli_path(card, synthetic_ms, per_batch))
    lap("cli")
    k1_bwd.update(sweep_k1_backward(card, calls["train_end2end"]["k1"], TRAIN_STEPS))
    k1_bwd["steps"] = {"train_end2end": dict(
        launches=BSR_2D, ms=k1_bwd["step_ms"], bound_ms=k1_bwd["step_bound_ms"])}
    for numbers, steps in zip((k2_fwd, k2_bwd), sweep_k2(
            card, {path: found["k2"] for path, found in calls.items()}, TRAIN_STEPS)):
        numbers.update(steps=steps, step_ms=steps["train_end2end"]["ms"],
                       step_bound_ms=steps["train_end2end"]["bound_ms"])
    lap("sweeps")
    model_check(card)
    lap("model_check")
    train_check(card)
    lap("train_check")
    paths["parity"] = parity_path(card, per_batch)
    lap("parity")
    paths.update(variants_path(card))
    lap("variants")
    one_steps = {arch: one_step(arch) for arch in ("end2end", "2d")}
    paths.update(train_dp_w1(card, one_steps))
    lap("train_dp_w1")
    exact_steps = {arch: one_step(arch, dtype="float32") for arch in ("end2end", "2d")}
    serve_ref["float32"] = k5.pop("float32")  # phase 4's model and first volume, float32, K5
    paths.update(dp_two_ranks(card, one_steps, exact_steps, serve_ref))
    lap("dp_two_ranks")
    del one_steps, exact_steps, serve_ref
    paths.update(cli_train_dp(card))
    lap("cli_train_dp")
    paths.update(bench_path(card))
    lap("bench")
    kernels = []
    for name, source, replaces, numbers in (
        ("affine_relu", "fused_affine.cu", "ops/fused_affine.py:48", k1),
        ("affine_relu_backward", "fused_affine.cu", "ops/fused_affine.py:81", k1_bwd),
        ("wce_forward", "wce.cu", "ops/wce.py:80", k2_fwd),
        ("wce_backward", "wce.cu", "ops/wce.py:129", k2_bwd),
        ("cc_label", "cc.cu", "infer/device_postprocess.py:166", k4["cc_label"]),
        ("largest_component", "cc.cu", "infer/device_postprocess.py:209", k4["largest_component"]),
        ("fill_holes", "cc.cu", "infer/device_postprocess.py:259", k4["fill_holes"]),
        ("compose_prep", "cc.cu", "infer/device_postprocess.py:313", k4["compose_prep"]),
        ("compose_finish", "cc.cu", "infer/device_postprocess.py:379", k4["compose_finish"]),
        ("window_accumulate", "score.cu", "infer/device_pipeline.py:1178", k3["numbers"]["window_accumulate"]),
        ("score_finish", "score.cu", "infer/device_pipeline.py:1195", k3["numbers"]["score_finish"]),
        # no Pallas body: the XLA fusion of the folded affine into the 1x1 convs
        ("affine_gemm", "affine_gemm.cu", "ops/fused_affine.py:95", k5["numbers"]),
        # no Pallas body: XLA fuses the live BN, Scale and ReLU
        ("bn_live_forward", "bn_live.cu", "models/layers.py:142", k6["bn_live_forward"]),
        ("bn_live_backward", "bn_live.cu", "models/layers.py:142", k6["bn_live_backward"]),
        # no Pallas body: XLA fuses the dropout's hash and scaling
        ("dropout_forward", "dropout.cu", "models/layers.py:291", k7["dropout_forward"]),
        ("dropout_backward", "dropout.cu", "models/layers.py:291", k7["dropout_backward"]),
    ):
        main_path = {"cc.cu": "serve_dpp", "score.cu": "serve", "affine_gemm.cu": "serve",
                     "bn_live.cu": "train_2d", "dropout.cu": "train_2d"}.get(source, "train_end2end")
        per = {"launches_per_volume": paths[main_path][name] // 2} if main_path.startswith("serve") else {
            "launches_per_step": paths[main_path][name] // TRAIN_STEPS}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"hdenseunet_tpu_torch/csrc/{source}",
            "replaces": f"hdenseunet_tpu/{replaces}",
            "launches": paths[main_path][name],
            **per,
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            **numbers,
            # K5's product alone is one cuDNN call; K6's and K7's, the ATen
            # chains they replaced; nothing else has one
            "library_ms": numbers.get("library_ms"),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    if sys.argv[1:2] == ["dp-rank"]:
        dp_rank(json.loads(sys.argv[2]))
    elif sys.argv[1:2] == ["cli-rank"]:
        cli_rank(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["k6"]:
        phase_main("k6", check_k6)
    elif sys.argv[1:2] == ["k7"]:
        phase_main("k7", check_k7)
    else:
        main()
