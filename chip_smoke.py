"""Drive the repro_torch paths on one NVIDIA GPU and check every kernel.

Run from the repository root:

    python3 chip_smoke.py

It builds the six CUDA kernels (gram, hat_apply, foldsolve, fold_eval,
pairdist, flash_attention) from ``src/repro_torch/csrc`` with nvcc, all at
once, and drives three paths at the paper's MEG/EEG size (787 trials,
P = 76,000 features, 10-fold CV) through the package's public entry points:

* binary: binary LDA with analytical CV, ridge CV, and a 1000-draw
  permutation test (Algorithm 1);
* multi-class: 3-class LDA by Algorithm 2 and its 1000-draw permutation
  test, against an f64 composite run, and, at P = 1,900, analytical CV
  against retraining direct LDA per fold;
* RSA: 8-condition cross-validated RDMs (pairwise accuracy and contrast
  with and without the bias adjust, confusion), the condition-mean
  Euclidean RDM, and Spearman model scoring with a 1000-draw
  condition-permutation null;

then four more on the same subject:

* multidim: a classifier per time point (``multidim.cv_grid`` over the
  301 points of 787 trials × 380 channels; every plan primal, P < N) and
  the 301 × 301 ``time_generalization``, λ from Ledoit-Wolf shrinkage at
  the post-stimulus point of largest evoked power (Eq. 18); against the
  f64 composite route, Eq. 14 with the regression bias, and chance before
  the stimulus;
* tune: ``tuning.tune_ridge`` on the default 25-point grid (MSE and error)
  and ``shrinkage.ledoit_wolf_lambda`` at P = 76,000 (their N×N Gram
  forms); the f64 curve against analytical CV on LOO folds (fold_eval at
  m = 1), the f32 curve and intensity against f64;
* update: ``fastcv.update_plan``, ``sliding_window`` and ``downdate_plan``
  on a plan of 777 trials, each step against ``prepare`` rebuilt on its
  rows, in f32 and f64;
* serve: ``repro_torch.serve.CVEngine`` on the card: the subject registered
  and warmed, one ``run_workloads`` batch of every workload kind (binary,
  ridge and 3-class CV, binary and 3-class permutation tests at T = 1,000,
  one padded batch of 1,024 each, 8-condition RSA with 2 model RDMs and a
  1,000-draw null, ``tune`` over 25 λ, a 301-point ``grid``), an
  ``update`` of 10 trials and a warm replay, each step's launches exact,
  the results against the direct ``core`` / ``rsa`` calls, and a
  ``PlanStore`` round trip with zero builds;
* http: the serve edges on the serve phase's warm engine: ``EdgeThread`` on
  127.0.0.1:0 and ``HTTPClient`` (the handle-carried kinds of the serve
  batch over the wire equal to the same batch in process bit for bit, with
  equal launch counts; a malformed entry answered per entry; an SSE stream
  at chunk 1,024 equal to the monolithic null; an append of 10 trials over
  the wire; ``/v1/metrics`` and ``/v1/trace``; ``compile_count`` flat), then
  ``python -m repro_torch.launch.serve_cv --http 0`` as a process on the
  card (cold boot with a plan store and recorded traffic, SIGTERM exit 0, a
  warm reboot with 0 plan builds), a ``--async 8`` replay with 0
  recompiles, and ``examples/torch/http_quickstart.py`` and
  ``serve_quickstart.py`` on the card;
* distributed: ``core.distributed``, ``rsa.searchlight_rdm`` and a mesh
  ``CVEngine`` through NCCL on a process group of one rank and a (1, 1)
  ``DeviceMesh`` ("data", "model"): the feature-sharded Gram and hat
  matrix, Algorithm 1 sharded over T = 1,000 permutations, ``searchlight_cv``
  and ``searchlight_rdm`` over 20 sliding 50-ms windows (787 × 3,800
  each), a mesh engine's plan, permutation test and streamed null, each
  against its local counterpart bit for bit at equal widths (across
  widths: ≥ 999 of 1,000 accuracies equal, none more than one prediction
  apart), launches exact per call; the group is destroyed before the LLM
  paths;

and two paths of the LLM substrate at gemma2-2b's full width and depth
(26 layers, d_model 2,304, 8/4 heads of 256, vocabulary 256,000, bf16,
random weights from a seed):

* lm_serve: ``launch.serve.generate`` (a 4 × 2,048-token prefill, then 64
  greedy decode steps; then 16 more steps timed and 16 under
  torch.profiler for decode's device idle share), an 8,192-token
  ``prefill_step`` (the local layers' window masks and skips), the same
  model with the plain attention swapped in at both lengths, and decode
  against the forward over 256 tokens: in bf16, and on an f32 copy of the
  weights at gemma2's window and at a 64-token window that the replay
  wraps four times (the local layers' ring buffer);
* lm_probe: ``launch.probe`` on 2 × 192 sequences of 128 tokens: the
  residual stream after each of the 13 repeats, an analytical-CV
  permutation test (K = 6, T = 1,000, f64, λ = tr(G_c)/N of each point) on
  each;

then, with gemma2-2b freed, the MoE and RG-LRU trunks at full width (bf16,
random weights from a seed), each against the same weights on attention_ref
and an f32 copy of them (the yardstick), one model on the card at a time:

* lm_moe: olmoe-1b-7b at full depth (16 layers, d_model 2,048, 16 heads of
  128, 64 experts top-8): ``launch.serve.generate`` (4 × 2,048 + 64 greedy
  steps), an 8,192-token ``prefill_step`` (two dispatch groups), both
  lengths against attention_ref, the dropped choices per layer at 4 × 2,048,
  decode against the forward over 256 tokens at the no-drop capacity factor
  E/k (the bf16 forward's routing imposed, decode's own route run beside:
  its experts may differ from the forward's in at most 2× the share of
  (token, layer) pairs where the f32 forward's do, every choice kept in
  slot 0), the f32 copy's freely routed decode over 32 tokens against its
  forward; then its probe (lm_moe_probe, 16 points);
* lm_moe_qwen3: qwen3-moe-30b-a3b at full width (32 / 4 heads of 128, 128
  experts top-8, d_ff 768, vocabulary 151,936), 16 of its 48 layers: a
  4 × 2,048 prefill against attention_ref, decode against the forward over
  64 tokens at the no-drop factor (with the same routing checks), its peak
  memory and how many more layers would fit;
* lm_hybrid: recurrentgemma-2b at full depth (26 layers, 8 of them local
  MQA attention of 10 query heads on 1 KV head of 256, window 2,048;
  RG-LRU width 2,560; vocabulary 256,000): a 4 × 2,048 ``prefill_step``
  against attention_ref, decode from an empty state against the forward over
  256 tokens in bf16 and in f32, ``launch.serve.generate``'s refusal (prefill
  returns no recurrent state); then its probe (lm_hybrid_probe, 8 points);

then the audio, vision and xLSTM families at full width and depth, the same
way (bf16, random weights from a seed, an f32 copy as the yardstick):

* lm_audio: musicgen-medium (48 layers, 24 MHA heads of 64, d_model 1,536,
  4 codebooks of 2,048, sinusoidal positions): ``launch.serve.generate``
  on 4 × 4 codebooks × 2,048 prompt tokens + 64 greedy steps, the prefill
  against attention_ref, decode against the forward over 256 tokens in
  bf16 and f32; then its probe (lm_audio_probe, 48 points, the band tokens
  tiled over the codebooks);
* lm_vision: llama-3.2-vision-11b (32 self-attention layers of 32 / 8
  heads of 128, 8 gated cross layers, d_model 4,096, 1,600 patch
  embeddings of width 1,280 from the generator), its cross gates planted
  at ``VISION_GATES`` (0 at init makes a cross layer the identity):
  ``generate`` (4 × 2,048 + 64), a timed prefill (the cross routes'
  seconds, the cross caches (4, 1,600, 8, 128) unquantized and placed),
  the prefill against attention_ref, decode against the forward over 256
  tokens from caches whose cross K/V come from a prefill, in bf16 and f32,
  peak memory; then its probe (lm_vision_probe, 8 points);
* lm_xlstm: xlstm-125m (6 mLSTM and 6 sLSTM layers, d_model 768): a 4 ×
  2,048 ``prefill_step`` (the sLSTM scans' seconds apart), the card's f32
  forward against the CPU's at 1 × 2,048, the chunkwise mLSTM at 2,048
  against one quadratic chunk at 2,000 on the shared prefix, decode from
  an empty state against the forward over 256 tokens in bf16 and f32,
  ``generate``'s refusal; then its probe (lm_xlstm_probe, 6 points);

then training (phase train):

* gemma2-2b uncut (26 layers, vocabulary 256,000, bf16 parameters, f32
  master weights and moments, remat per layer): 4 steps of
  ``train.trainer.Trainer`` on ``TokenStream(256,000, 1,024, batch 2,
  seed 0)``, checkpoints off: step 1's and the warm steps' seconds and
  tokens/s, loss, grad norm and lr per step, the peak memory, the flash
  launches per step (exactly 2 × 26: the forward and the recompute; the
  backward launches nothing); step 1's loss near ln V; step 1 again from
  the same seed with attention on attention_ref, held to the bf16
  yardstick (that run against an f32 copy); a second step on the same
  batch below 1.5× the first;
* the restart: xlstm-125m at full width, vocabulary 2,048, f32, 8 × 128
  (the example's model): 3 steps, an async checkpoint, a new Trainer
  resuming at step 3 with the data cursor (every restored tensor equal
  to the saved one), 3 more steps, against 6 uninterrupted steps (losses
  within 1e-5 relative); the checkpoint's bytes and its snapshot, write
  and restore seconds;

then the dry run and the step counter (phase dryrun):

* ``python -m repro_torch.launch.dryrun`` as two processes at once (the
  fake process group is process-global, and this process ran NCCL):
  gemma2-2b and olmoe-1b-7b at train_4k on the (16, 16) mesh (µ = 1) and
  gemma2-2b at decode_32k on the (2, 16, 16) mesh, traced on fake CPU
  tensors under fake groups of 256 / 512 ranks; per cell its per-rank
  bytes, FLOPs, collective bytes by kind, seconds and the roofline row
  with the H100 constants (``launch.roofline``). A gemma2 cell that does
  not trace fails the phase; olmoe's refusal is printed with its reason;
* ``launch.step_analysis.analyze_step`` on the card over one train step
  of phase train's shape (gemma2-2b uncut, 2 × 1,024, bf16, remat; flash
  counted as attention_ref's products): its FLOPs and dot bytes must equal
  the same step traced on fake CPU tensors in this process, integer for
  integer, and it must see every flash launch; then two warm steps timed,
  and the counted FLOPs and 6·N·D over the warm step as shares of 989
  TFLOP/s, beside the card's name and power limit, with the roofline's
  compute and memory terms of the step (the memory term with each flash
  launch at the bytes the kernel moves, and with attention_ref's f32
  bytes as counted);

and, after the build, ``python -m repro_torch.analysis`` (lint: reprolint
for the port) as a process, which must exit 0.

Each path's launch counts are reset before it and read after it; every
kernel the path should run must have launched (flash_attention exactly once
per self-attention layer in each prefill and forward of the MoE, hybrid,
audio and vision trunks, never in their decode, never for a cross layer,
never in the xLSTM trunk) (the multidim, tune and
update paths exactly as often as their calls make: 301 hat_apply and
foldsolve, one gram a tuning call, none in an update; the serve path's
warm-up, first batch, update and replay as predicted) (flash_attention exactly
once per layer in each prefill and forward, never in decode), and each
call of foldsolve and fold_eval must be one launch, its residual check and
jitter retry inside (on lm_probe, one foldsolve launch per hat_apply
launch). Every kernel
is held against its plain PyTorch version on the card (at each path's own
shapes and column blocks, at ragged shapes, at f64, bf16, m = 1 and m = 393
folds, a near-singular fold that forces the jitter retry, the one-launch
checked foldsolve and fold_eval against the plain checked solve with a
fold that fails only past its first column tile, pairdist on both its
routes (the RSA path's condition means on route S, a trial-level RDM of
787 patterns in f32, f64 and bf16 on route T, the route sweep's inputs on
each route that takes them; every one exactly symmetric with a zero
diagonal and bitwise repeatable), and flash_attention at the LM paths' shapes and strided
layout, at head widths 128 and 64 (musicgen's and llama-vision's prefill
shapes among them), a ragged length and f32 I/O), and the results are
checked: against the Cholesky composite and against f64 composite runs
(binary decision values, multi-class predictions, the RSA path's accuracy,
contrast and confusion RDMs, a probe point's decision values), against
retraining per fold (binary at P = 3,800, multi-class at P = 1,900), and
the LM's logits against the plain-attention model and its own forward.

foldsolve's and fold_eval's instantiations must not spill (ptxas's report
in the build phase), nor may any of pairdist's (both routes). flash_attention's
bf16 route, gram's f32 and bf16 routes (which pairdist's route T runs too)
and hat_apply's f32 route must run on the tensor cores: the build
phase counts the HGMMA
instructions in each built library's SASS (cuobjdump; TF32 ones in libgram,
libpairdist and libhat_apply, BF16 ones in libgram and libpairdist) and
reads ptxas's report of those instantiations, and the run fails on no HGMMA
or any spill. Their f64 routes must run on the FP64 tensor cores: DMMA in
the SASS of upper_gram_dmma_kernel (libgram and libpairdist) and
hat_apply_dmma_kernel, and no spill in any.
gram at the main shape must also hold the f32 pin against the f64 product,
be exactly symmetric and bitwise repeatable (f64: within 1e-9, symmetric
and repeatable at the main and a ragged shape); hat_apply bitwise
repeatable (f64 too, and at the x64 label vector's B = 1). The `kernels`
line times flash at the LM paths' shapes (tensor-core route) and at an
f32 I/O shape (SIMT route), gram and hat_apply at the main path's shapes
in f32 and f64 and at the probe path's (f64) shapes, foldsolve and
fold_eval there both without the check (jitter=None, the row) and as the
paths call them (on_path_ms, jitter="auto"), foldsolve's checked launch by
tile width (tile_widths), and gram's bf16_gram
build (beside torch.mm with out_dtype=float32 where torch has it), pairdist at
the RSA path's shape and the trial-level RDM in f32, f64 and bf16 (beside
squared cdist; bf16 beside that torch.mm), with the route of each, and the
route sweep behind the route rule (C = 8 … 256 at P = 76,000, f32 and
f64: device ms of each route and of cdist), with TFLOP/s on
the counted and on the issued operations for the tensor-core routes, and
every row's device-busy time (torch.profiler) beside its CUDA-event time,
for the kernel and for the library call. The f32 library calls must run
full f32 (no TF32): the env line prints the two settings and the run
fails otherwise.

Each phase prints one JSON line; the ``wall`` line gives the whole run's
seconds. The line before the last is the card's
name and power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Without a CUDA device, or without the package beside it, it fails.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SEED = 0
N_TRIALS = 787
K = 10
N_PERM = 1000
CHUNK = 250
MC_CLASSES = 3
MC_CHUNK = 64
RSA_CONDITIONS = 8
REPS = 20
# warm replays of the serve phase's batch, timed and then profiled
REPLAYS = 5
SERVE_SHAPE_NOTE = ("the serve path's launches at this shape: warm-up, first batch, "
                    "update and replay")
# pairdist's route sweep: C conditions of P features, f32 and f64, each C
# on both routes where route S takes it (C <= 128)
PD_SWEEP_C = (8, 16, 32, 64, 128, 256)
PD_SWEEP_P = 76000

# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; f32 67 TFLOP/s
# outside the tensor cores; f64 67 TFLOP/s on the tensor cores; TF32 494.7
# and bf16 989 TFLOP/s on the tensor cores. gram's and hat_apply's f32 routes
# run on the tensor cores in TF32 (three products for f32-grade results), so
# their bounds count the f32 function's operations at the TF32 peak.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12, torch.bfloat16: 989e12,
              "tf32": 494.7e12}

# Tolerances, relative to the largest magnitude of the plain result.
# f32 kernels: the reference pins its fp32 kernels at 1e-5; f64 at 1e-9.
TOL = {torch.float32: 1e-5, torch.float64: 1e-9, torch.bfloat16: 1e-5}
# f32 decision values against the composite route and against f64: two f32
# evaluations of ill-conditioned-ish solves from a 76,000-term Gram.
TOL_DVALS_F32 = 2e-3
# f32 contrast RDMs against f64: each entry is a mean of hundreds of
# decision values, each within about 1e-6 of f64 (relative to max |RDM|).
TOL_RDM_F32 = 1e-4
# Analytical CV against retraining per fold, in f64 (the paper's exactness).
TOL_EXACT = 1e-8
# The multidim phase: accuracies of the kernel route (f32) against the f64
# composite route point by point, off the samples whose f64 decision value
# lies within MD_MARGIN of max |dv| (or within the f32 route's own distance
# from f64, where that is larger) of 0; fold weights' decision values
# against Eq. 14's within TOL_FOLD_WEIGHTS of max |dv| (f32); "above
# chance" is more than 3 binomial standard deviations over 0.5.
MD_MARGIN = 1e-6
TOL_FOLD_WEIGHTS = 1e-4
# The tune phase: the f64 LOO curve against analytical CV on LOO folds (the
# reference's own pin), the f32 curve and the f32 Ledoit-Wolf intensity
# against f64; grid points of the pin.
TOL_TUNE_PIN = 1e-6
TOL_TUNE_F32 = 1e-4
TOL_LW_F32 = 1e-4
TUNE_PIN_POINTS = (0, 12, 24)
# The update phase: a plan on the first UPDATE_N0 trials, advanced by
# UPDATE_ROWS rows a step; updated plans' decision values against a rebuild
# within TOL_UPDATE of max |dv| (the reference's pin).
UPDATE_N0, UPDATE_ROWS = 777, 10
UPDATE_WARM = 5            # warm repeats of each update and rebuild, timed
TOL_UPDATE = 1e-5
# The LLM substrate at gemma2-2b's full width and depth (bf16).
LM_ARCH = "gemma2-2b"
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 64      # 64 greedy decode steps
LM_LONG = 8192                                     # q − k reaches 8,191 > the 4,096 window
LM_REPLAY = 256                                    # decode replay against the forward
LM_RING_WINDOW = 64                                # a window the 256-token replay wraps 4×
LM_IDLE_STEPS = 16                                 # decode steps timed, then profiled
# The MoE and RG-LRU trunks at full width: olmoe-1b-7b and recurrentgemma-2b at
# full depth, qwen3-moe-30b-a3b cut to QWEN_LAYERS of its 48 layers: its bf16
# weights and their f32 copy, the yardstick, take 3.5 GiB a layer, and at 16
# layers the phase peaks at 66.8 GiB reserved of the card's 79.2 (measured on
# an H100 80GB), which leaves the run's other tensors and the allocator ~12 GiB.
LM_MOE_ARCH, LM_QWEN_ARCH, LM_HYBRID_ARCH = "olmoe-1b-7b", "qwen3-moe-30b-a3b", \
    "recurrentgemma-2b"
QWEN_LAYERS = 16
QWEN_REPLAY = 64                                   # qwen3's decode replay, tokens
MOE_FREE_REPLAY = 32     # tokens of the f32 copies' freely routed MoE decode
# The xLSTM, vision and audio families uncut: musicgen-medium (4 codebooks),
# llama-3.2-vision-11b (1,600 patch embeddings of width 1,280 from the
# generator) and xlstm-125m. The cross layers' tanh gates are 0 at init, which
# makes every cross layer the identity: the phase plants VISION_GATES
# (gate_attn, gate_mlp) in each before it serves.
LM_AUDIO_ARCH, LM_VISION_ARCH, LM_XLSTM_ARCH = "musicgen-medium", "llama-3.2-vision-11b", \
    "xlstm-125m"
VISION_GATES = (0.8, -0.6)
XLSTM_QUADRATIC = 2000   # S of the one-chunk (masked-quadratic) mLSTM forward
# Training (phase train): gemma2-2b uncut (bf16 parameters, f32 master and
# moments, remat per layer) for TRAIN_STEPS Trainer steps at B × S =
# TRAIN_BATCH × TRAIN_SEQ of the token stream, checkpoints off; then the
# restart check on the example's model (xlstm-125m full width, vocabulary
# 2,048, f32) at 8 × 128: TRAIN_RESTART_AT steps, a checkpoint, a resumed
# Trainer to 2 × TRAIN_RESTART_AT, against an uninterrupted run.
TRAIN_ARCH = LM_ARCH
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 2, 1024, 3e-4
TRAIN_RESTART_AT, TRAIN_RESTART_BATCH, TRAIN_RESTART_SEQ, TRAIN_RESTART_VOCAB = 3, 8, 128, 2048
# a random model's first loss lies within this of ln V (its logits are ~0)
TRAIN_LOSS0_BAND = 1.0
# Dry run (phase dryrun): the CLI's cells, each process cut at this many
# seconds; the counter's step is phase train's, then DRYRUN_WARM timed steps
DRYRUN_CELLS = [["--arch", "gemma2-2b,olmoe-1b-7b", "--shape", "train_4k", "--mesh", "single",
                 "--microbatches", "1"],
                ["--arch", "gemma2-2b", "--shape", "decode_32k", "--mesh", "multi"]]
DRYRUN_TIMEOUT = 600
DRYRUN_WARM = 2
# the restarted xLSTM's losses against the uninterrupted run's: the embedding
# backward's atomics on the card reorder its sums
TOL_RESTART = 1e-5
# λ per point = tr(G_c)/N of that point's features (the MEG/EEG paths' rule):
# the residual stream's scale grows about 19× from the first to the last point
PROBE_PER_CLASS, PROBE_SEQ, PROBE_FOLDS = 192, 128, 6
# flash_attention against attention_ref: f32 I/O at 2e-5 of max |out| (the
# same f32 softmax summed in another order); bf16 I/O within 2 bf16 ulps of
# each element (both round an f32 result once, and ~1e-7 before rounding can
# move it by one ulp), the ulp taken at no less than 2^-8 of max |out|
# (smaller outputs come from cancellation).
TOL_ATTN_F32 = 2e-5
TOL_ATTN_BF16_ULPS = 2.0
# gemma2-2b's logits, two bf16 evaluations of one model (the flash kernel
# against attention_ref; decode against the forward): each strays from the
# same weights in f32 by E, the plain bf16 model's distance from the f32
# one, measured in the run; two such evaluations lie within 2E of each other.
# The train step's loss and grad norm (the kernel against attention_ref) are
# held to 2E alone: a random model's loss is ~ln V whatever attention
# computes, so a floor of TOL_LM_F32 × |loss| would pass a wrong kernel.
TOL_LM_YARDSTICK = 2.0
# The same comparisons on the f32 copy of the weights (the kernel against
# attention_ref; decode against the kernel's forward, at the real window and
# at one the replay wraps): the attention outputs differ by ~3e-7 of their
# scale, and 26 layers carry a bf16 ulp (4e-3) to ~1.5e-2 of max |logit|
# (measured on an H100), so ~1e-6 here; 1e-4 of max |logit|.
TOL_LM_F32 = 1e-4


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the run's seconds so far ("t")."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, reps: int = REPS, warmup: int = 3):
    """Median over ``reps`` calls of ``fn`` of the device-busy time of each
    call (:func:`device_calls`); None when fewer than half the calls were
    seen whole. The calls are not the ones ``cuda_ms`` timed: profiling adds
    host time."""
    calls = device_calls(fn, reps, warmup)
    return None if calls is None else statistics.median(b for b, _ in calls)


def device_calls(fn, reps: int = REPS, warmup: int = 3):
    """(busy ms, span ms) of each of ``reps`` calls of ``fn`` after warm-up,
    from torch.profiler. Busy: the union of the call's kernels', copies' and
    memsets' intervals (the sum of their times where they do not overlap; a
    kernel launched as a programmatic dependent starts before its
    predecessor ends and waits, and is not counted twice). Span: the
    device's time from the end of the marker before the call to the start of
    the marker after it, the call's wall time as the device saw it, idle
    gaps included. A short marker kernel (torch.cuda._sleep) runs before each
    call and after the last, and a call's events are those between two
    markers: the profiler may drop events, so calls are not told apart by
    counting. None when fewer than half the calls were seen whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.cuda._sleep(100)
            fn()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    calls = []
    for a, b in zip(marks, marks[1:]):
        total, end = 0.0, float("-inf")
        for e in events[a + 1:b]:
            total += max(0.0, e.time_range.end - max(e.time_range.start, end))
            end = max(end, e.time_range.end)
        if b > a + 1:
            span = events[b].time_range.start - events[a].time_range.end
            calls.append((total / 1e3, span / 1e3))
    if len(calls) < reps // 2:
        print(f"device_calls: {len(events)} device events, {len(marks)} markers, "
              f"{len(calls)} whole calls of {reps}", file=sys.stderr)
        return None
    return calls


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max abs error, scale = max |want|, at least 1e-30)."""
    err = float((got.double() - want.double()).abs().max())
    scale = max(float(want.double().abs().max()), 1e-30)
    return err, scale


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: Calls of foldsolve and fold_eval since the last reset_counts(), counted
#: where the paths make them (core.fastcv.cv_errors_fused is their only caller).
FOLD_CALLS = {"foldsolve": 0, "fold_eval": 0}


def count_fold_calls() -> None:
    """Count every call of fastcv's foldsolve and fold_eval in FOLD_CALLS."""
    from repro_torch.core import fastcv

    for name in FOLD_CALLS:
        def counted(*args, _fn=getattr(fastcv, name), _name=name, **kwargs):
            FOLD_CALLS[_name] += 1
            return _fn(*args, **kwargs)
        setattr(fastcv, name, counted)


def reset_counts() -> None:
    from repro_torch.kernels import _build
    _build.reset_launches()
    for name in FOLD_CALLS:
        FOLD_CALLS[name] = 0


def shape_counts() -> collections.Counter:
    """Launches per (kernel, the entry point's int arguments) since
    reset_counts()."""
    from repro_torch.kernels import _build
    return collections.Counter(_build.LAUNCH_SHAPES)


def counts() -> dict:
    """Launches per kernel since reset_counts(), and under "calls" the fold
    kernels' calls."""
    from repro_torch.kernels import _build
    return {**_build.LAUNCHES, "calls": dict(FOLD_CALLS)}


def expect_launches(path: str, launches: dict, names) -> None:
    """Every kernel in ``names`` launched, and each call of foldsolve and
    fold_eval one launch (its check and retry inside)."""
    missing = [k for k in names if launches.get(k, 0) <= 0]
    if missing:
        fail(f"kernels not launched on the {path} path: {missing}")
    off = {k: [launches[k], n] for k, n in launches["calls"].items() if launches[k] != n}
    if off:
        fail(f"the {path} path made other than one launch per call ([launches, calls]): {off}")


def near_singular_folds(gen, k: int, m: int, b: int, dtype) -> tuple:
    """(h_te, e): k folds with I − H_Te SPD, fold 1 near-singular
    (Q·diag(1, …, d)·Qᵀ, d = 1e-14 in f64 and 0 before the f32 rounding) with
    its first 64 right-hand sides off the near-null direction, so that in f64
    only its later column tiles fail the residual check."""
    a = torch.randn(k, m, m, generator=gen, device="cuda", dtype=dtype) / (3 * m ** 0.5)
    h = -(a @ a.transpose(1, 2))
    q, _ = torch.linalg.qr(torch.randn(m, m, generator=gen, device="cuda", dtype=torch.float64))
    d = torch.ones(m, device="cuda", dtype=torch.float64)
    d[-1] = 1e-14 if dtype == torch.float64 else 0.0
    h[1] = (torch.eye(m, device="cuda", dtype=torch.float64) - (q * d) @ q.T).to(dtype)
    e = torch.randn(k, m, b, generator=gen, device="cuda", dtype=torch.float64)
    null = q[:, -1]
    e[1, :, :64] -= torch.outer(null, null @ e[1, :, :64])
    return h, e.to(dtype)


def lam_rule(x: torch.Tensor) -> float:
    """λ = tr(G_c) / N, the scale of the centered Gram's diagonal."""
    xc = x - x.mean(dim=0, keepdim=True)
    return float((xc * xc).sum()) / x.shape[0]


def randperm_rows(seed: int, n: int, t: int, dev) -> torch.Tensor:
    """(t, n) permutations drawn as the port drew them before permdraw: a
    ``torch.Generator`` seeded from (seed, row) through ``SeedSequence`` and a
    ``torch.randperm`` a row. The yardstick of the permdraw row only."""
    import numpy as np

    rows = []
    for r in range(t):
        state = np.random.SeedSequence([seed, r]).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(state) & 0x7FFF_FFFF_FFFF_FFFF)
        rows.append(torch.randperm(n, generator=gen, device=dev))
    return torch.stack(rows)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bf16_ulps(got: torch.Tensor, want: torch.Tensor, floor: bool = True) -> tuple:
    """(max |got − want| in bf16 ulps of |want|, |want| at that element); with
    ``floor`` the ulp is taken at no less than 2^-8 of max |want|."""
    got, want = got.double().flatten(), want.double().flatten()
    mag = want.abs().clamp(min=float(want.abs().max()) / 256 if floor else 2.0 ** -126)
    ulps = (got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    i = int(ulps.argmax())
    return float(ulps[i]), float(want[i].abs())


def decode_replay(model, tokens, cfg, dev, vision=None) -> tuple:
    """Decode every position of ``tokens`` (1, T), or (1, K, T) over K
    codebooks, from empty caches of T slots; a vision model's cross caches
    hold the K/V of a prefill over the same tokens and ``vision``. Returns
    (logits (1, T, V) or (1, T, K, V), flash_attention launches in the
    decode steps)."""
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    n = tokens.shape[-1]
    caches = T.init_trunk_cache(cfg, 1, n, dev)
    if vision is not None:
        _, pre = M.prefill_step(model, {"tokens": tokens, "vision_embeds": vision}, cfg)
        for kind, cache, part in zip(cfg.layer_kinds, caches, pre):
            if kind == "cross":
                for name in ("k", "v"):
                    cache[name].copy_(part[name])
        del pre
    before = _build.LAUNCHES["flash_attention"]
    logits = torch.stack([M.decode_step(model, tokens[..., t:t + 1], t, caches, cfg)[0][:, 0]
                          for t in range(n)], dim=1)
    return logits, _build.LAUNCHES["flash_attention"] - before


def decode_idle_share(model, prompts, cfg) -> dict:
    """Device idle share of serve's greedy decode: LM_IDLE_STEPS steps on the
    host clock, then as many under torch.profiler for the device's busy
    time (the union of its kernel and copy intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.models import model as M

    b, s = prompts.shape
    last, pre = M.prefill_step(model, {"tokens": prompts}, cfg)
    caches = serve.place_prefill(cfg, pre, b, s + 2 * LM_IDLE_STEPS)
    del pre
    state = {"tok": last.argmax(dim=-1)[:, None], "pos": s}

    def steps():
        for _ in range(LM_IDLE_STEPS):
            logits, _ = M.decode_step(model, state["tok"], state["pos"], caches, cfg)
            state["tok"] = logits[:, -1].argmax(dim=-1)[:, None]
            state["pos"] += 1
        torch.cuda.synchronize()

    _, wall = timed(steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for e in sorted(device, key=lambda e: e.time_range.start):
        busy_us += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    out = {"batch": b, "steps": LM_IDLE_STEPS, "wall_ms_per_step": wall / LM_IDLE_STEPS * 1e3,
           "device_events": len(device)}
    if not device:
        return {**out, "idle_share": "not measured (the profiler saw no device events)"}
    busy_ms = busy_us / 1e3 / LM_IDLE_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {**out, "device_busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / out["wall_ms_per_step"],
            "top_device_ms_per_step": [[name[:100], us / 1e3 / LM_IDLE_STEPS]
                                       for name, us in top]}


def attention_pairs(s: int, window, causal: bool = True) -> int:
    """Reachable (q, k) pairs of self-attention over S positions."""
    if not causal:
        return s * s if window is None else sum(min(s, q + window) for q in range(s))
    if window is None:
        return s * (s + 1) // 2
    return sum(min(q + 1, window) for q in range(s))


def attention_tiles(s: int, window, causal: bool, route: str) -> int:
    """Key tiles the flash kernel's ``route`` visits per (b·Hq), over its
    query blocks (the kernel's loop bounds, ``key_tile_range``)."""
    from repro_torch.kernels.flash_attention.flash_attention import TILES, key_tile_range
    tile = TILES[route]
    return sum(hi - lo + 1 for lo, hi in (key_tile_range(q0, s, window, causal, tile)
                                          for q0 in range(0, s, tile[0])))


def ptxas_report(log: str) -> dict:
    """{kernel symbol: {"registers": n, "spill_bytes": stores + loads}} from
    ``nvcc -Xptxas -v`` output."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_text(lib: Path) -> str:
    """A built library's SASS (cuobjdump of the CUDA toolkit that built it)."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def sass_count(lib: Path, opcode: str) -> int:
    """Instructions named ``opcode`` in a built library's SASS."""
    return len(re.findall(rf"\b{opcode}\b", sass_text(lib)))


def sass_functions(sass: str) -> dict:
    """{kernel symbol: its SASS} from cuobjdump's listing."""
    parts = re.split(r"^\s*Function : (\S+)\s*$", sass, flags=re.M)
    return dict(zip(parts[1::2], parts[2::2]))


def bf16_mm_f32(xb: torch.Tensor) -> tuple:
    """(the library call for the bf16_gram row, a note): ``torch.mm(xb, xb.T,
    out_dtype=torch.float32)`` (bf16 in, f32 out) where this torch has it,
    else (None, why not)."""
    try:
        torch.mm(xb[:2], xb[:2].T, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as err:
        return None, f"torch.mm(..., out_dtype=torch.float32) is not available: {err}"
    return (lambda: torch.mm(xb, xb.T, out_dtype=torch.float32),
            "torch.mm(xb, xb.T, out_dtype=torch.float32)")


def launch_delta(before: dict, after: dict) -> dict:
    """Launches (and fold-kernel calls) between two ``counts()``."""
    out = {k: after[k] - before[k] for k in after if k != "calls"}
    out["calls"] = {k: after["calls"][k] - before["calls"][k] for k in after["calls"]}
    return out


def launch_sum(a: dict, b: dict) -> dict:
    out = {k: a[k] + b[k] for k in a if k != "calls"}
    out["calls"] = {k: a["calls"][k] + b["calls"][k] for k in a["calls"]}
    return out


def counted(fn):
    """(fn's result, host seconds up to a synchronize, its launches)."""
    before = counts()
    out, secs = timed(fn)
    return out, secs, launch_delta(before, counts())


def expect_exact(path: str, launches: dict, want: dict) -> None:
    """Each kernel launched exactly as often as ``want`` says (0 if absent),
    each fold-kernel call one launch."""
    got = {k: v for k, v in launches.items() if k != "calls"}
    wanted = {k: want.get(k, 0) for k in got}
    if got != wanted:
        fail(f"the {path} path's launches: want {wanted}, got {got}")
    expect_launches(path, launches, [k for k, v in want.items() if v])


def multidim_phase(ds, y, folds) -> dict:
    """The paper's multi-dimensional use (§4.2) at full width: a classifier
    per time point of the main subject (301 points of 787 trials × 380
    channels, f32, K = 10) by ``cv_grid``, their 301 × 301
    ``time_generalization``, λ from Ledoit-Wolf shrinkage at the
    post-stimulus point of largest evoked power, converted by Eq. 18. Each
    point's P = 380 < N, so every plan is primal."""
    from repro_torch.core import fastcv, multidim, shrinkage

    xs = ds.epochs.permute(2, 0, 1).contiguous()                # (301, 787, 380) f32
    t_pts, n, p = xs.shape
    post = torch.nonzero(ds.times > 0).flatten()
    power = (ds.epochs.mean(dim=0) ** 2).sum(dim=0)              # evoked power per point
    peak = int(post[power[post].argmax()])
    x_pk = xs[peak]
    lam_s = float(shrinkage.ledoit_wolf_lambda(x_pk))
    lam = float(shrinkage.shrink_to_ridge(lam_s, shrinkage.trace_scaling(x_pk)))
    reset_counts()
    accs, t_grid = timed(lambda: multidim.cv_grid(xs, y, folds, lam))
    tg, t_tg = timed(lambda: multidim.time_generalization(xs, y, folds, lam))
    launches = counts()
    expect_exact("multidim", launches, {"hat_apply": t_pts, "foldsolve": t_pts})
    if accs.shape != (t_pts,) or tg.shape != (t_pts, t_pts) or not (
            bool(((accs >= 0) & (accs <= 1)).all()) and bool(((tg >= 0) & (tg <= 1)).all())):
        fail("multidim accuracies are not shares of the expected shapes")

    te = folds.te_idx.long()
    km = te.numel()
    sign_te = torch.sign(y[te])

    def hits(dv):
        return int((torch.where(dv >= 0, 1.0, -1.0).to(dv.dtype) == sign_te.to(dv.dtype)).sum())

    # (a) each checked point's grid accuracy against the f64 composite route;
    # (b) the time-generalization diagonal against Eq. 14 with the
    # regression bias (the fold weights' convention); (c) the fold weights'
    # decision values against Eq. 14's
    rows = []
    for t in sorted(set(range(0, t_pts, 10)) | {peak}):
        x_t = xs[t]
        dv32, _ = fastcv.binary_cv(x_t, y, folds, lam)
        dv64 = fastcv.binary_dvals(fastcv.prepare(x_t.double(), folds, lam), y.double(),
                                   fused=False)
        scale = float(dv64.abs().max())
        err = float((dv32.double() - dv64).abs().max())
        ties = int((dv64.abs() <= max(MD_MARGIN * scale, err)).sum())
        ws, bs = multidim.fold_weights(x_t, y, folds, lam)
        dv_w = torch.einsum("kmp,kp->km", x_t[te], ws) + bs[:, None]
        dv_nb, _ = fastcv.binary_cv(x_t, y, folds, lam, adjust_bias=False)
        err_w = float((dv_w - dv_nb).abs().max())
        ties_nb = int((dv_nb.abs() <= err_w).sum())
        grid_hits, diag_hits = round(float(accs[t]) * km), round(float(tg[t, t]) * km)
        row = {"t": t, "time_s": float(ds.times[t]), "accuracy": float(accs[t]),
               "grid_hits": grid_hits, "route_hits": hits(dv32), "f64_hits": hits(dv64),
               "dvals_f32_vs_f64": err, "scale": scale, "near_ties": ties,
               "diag_hits": diag_hits, "eq14_hits": hits(dv_nb),
               "fold_weights_vs_eq14": err_w, "eq14_scale": float(dv_nb.abs().max()),
               "eq14_near_ties": ties_nb}
        row["ok"] = (grid_hits == row["route_hits"] and abs(grid_hits - row["f64_hits"]) <= ties
                     and abs(diag_hits - row["eq14_hits"]) <= ties_nb)
        rows.append(row)
    pk = next(r for r in rows if r["t"] == peak)
    pre = ds.times < 0
    pre_mean = float(accs[pre].double().mean())
    above = 0.5 + 3 * (0.25 / km) ** 0.5
    out = {"phase": "multidim", "T": t_pts, "N": n, "P": p, "K": folds.k, "m": folds.test_size,
           "dtype": "float32", "mode": "primal", "peak": peak,
           "peak_time_s": float(ds.times[peak]), "lam_shrink": lam_s, "lam": lam,
           "lam_rule": "ledoit_wolf_lambda at the peak, then shrink_to_ridge(., trace_scaling)",
           "peak_accuracy": float(accs[peak]), "max_accuracy": float(accs.max()),
           "pre_stimulus_mean_accuracy": pre_mean, "above_chance": above,
           "diagonal_vs_cv_grid_max_gap": float((torch.diagonal(tg) - accs).abs().max()),
           "launches": launches, "seconds": {"cv_grid": t_grid, "time_generalization": t_tg},
           "checked_points": rows,
           "fold_weights_at_peak": {"max_abs_err": pk["fold_weights_vs_eq14"],
                                    "scale": pk["eq14_scale"], "tol": TOL_FOLD_WEIGHTS},
           "fold_weights_max_rel_err": max(r["fold_weights_vs_eq14"] / r["eq14_scale"]
                                           for r in rows)}
    emit(out)
    bad = [r["t"] for r in rows if not r["ok"]]
    if bad:
        fail(f"multidim accuracies disagree with the f64 composite or Eq. 14 at points {bad}")
    if pk["fold_weights_vs_eq14"] > TOL_FOLD_WEIGHTS * pk["eq14_scale"]:
        fail("fold weights do not reproduce Eq. 14's decision values at the peak")
    if abs(pre_mean - 0.5) > 0.1 or float(accs[peak]) <= above:
        fail(f"multidim: pre-stimulus mean {pre_mean} is not chance, or the peak "
             f"{float(accs[peak])} does not decode above {above}")
    return {"launches": launches, "plan": fastcv.prepare(x_pk, folds, lam), "lam": lam}


def ref_form_f32_curve(x, y, lambdas):
    """The LOO MSE curve by the reference's f32 arithmetic: an f32
    eigendecomposition of the f32 Gram, the curve in f32 (for comparison
    only; ``tuning.loo_curve`` projects the Gram and works in f64)."""
    from repro_torch.kernels.gram.ops import centered_gram

    evals, u = torch.linalg.eigh(centered_gram(x))
    evals = evals.clamp(min=0.0)
    w = evals[None] / (evals[None] + lambdas.float()[:, None])
    y_hat = y.mean() + (w * (u.T @ y)) @ u.T
    h_diag = 1.0 / x.shape[0] + ((u * u) @ w.T).T
    return (((y - y_hat) / (1.0 - h_diag).clamp(min=1e-12)) ** 2).mean(dim=1)


def tune_phase(x, x64, y) -> dict:
    """λ tuning at the main features (787 × 76,000 f32): ``tune_ridge`` on
    the default 25-point grid for both criteria, and the Ledoit-Wolf
    intensity of X (its N×N Gram form)."""
    from repro_torch.core import folds as folds_mod, regression, shrinkage, tuning

    n = x.shape[0]
    runs, launches = {}, None
    for crit in ("mse", "error"):
        res, secs, d = counted(lambda crit=crit: tuning.tune_ridge(x, y, criterion=crit))
        expect_exact(f"tune ({crit})", d, {"gram": 1})
        runs[crit] = {"best_lambda": float(res.best_lambda), "best_score": float(res.best_score),
                      "best_index": int(torch.argmin(res.scores)), "seconds": secs,
                      "launches": d, "result": res}
        launches = d if launches is None else launch_sum(launches, d)
    lw, t_lw, d = counted(lambda: shrinkage.ledoit_wolf_lambda(x))
    expect_exact("ledoit_wolf", d, {"gram": 1})
    launches = launch_sum(launches, d)
    # (a) the f64 curve against analytical CV on LOO folds (fold_eval, m = 1);
    # (b) the f32 curve against the f64 one; (c) Ledoit-Wolf f32 against f64
    before = counts()
    lambdas = runs["mse"]["result"].lambdas
    curve64 = tuning.loo_curve(x64, y.double(), lambdas)
    loo = folds_mod.loo(n, device=x.device)
    pins = []
    for i in TUNE_PIN_POINTS:
        preds, y_te = regression.analytical_cv(x64, y.double(), loo, float(lambdas[i]))
        mse = float(((preds - y_te) ** 2).mean())
        pins.append({"index": i, "lam": float(lambdas[i]), "loo_curve": float(curve64[i]),
                     "analytical_cv": mse, "rel_err": abs(float(curve64[i]) - mse) / mse})
    check_launches = launch_delta(before, counts())
    scores32 = runs["mse"]["result"].scores
    rel_f32 = ((scores32.double() - curve64).abs() / curve64.abs())
    ref_form = ref_form_f32_curve(x, y, lambdas)
    rel_ref_form = ((ref_form.double() - curve64).abs() / curve64.abs())
    lw64 = float(shrinkage.ledoit_wolf_lambda(x64))
    out = {"phase": "tune", "N": n, "P": x.shape[1], "dtype": "float32", "grid": "tr(G_c)/N · "
           "logspace(-4, 2, 25)", "lambdas": lambdas.tolist(),
           "mse": {k: v for k, v in runs["mse"].items() if k != "result"},
           "error": {k: v for k, v in runs["error"].items() if k != "result"},
           "ledoit_wolf": {"f32": float(lw), "f64": lw64, "seconds": t_lw, "launches": d,
                           "tol": TOL_LW_F32},
           "launches": launches,
           "pin_vs_analytical_cv_loo": {"points": pins, "tol": TOL_TUNE_PIN},
           "f32_vs_f64_curve": {"max_rel_err": float(rel_f32.max()),
                                "rel_err": rel_f32.tolist(), "tol": TOL_TUNE_F32},
           "reference_f32_arithmetic_vs_f64_curve": {"max_rel_err": float(rel_ref_form.max()),
                                                     "rel_err": rel_ref_form.tolist()},
           "check_launches": check_launches}
    emit(out)
    for crit in ("mse", "error"):
        sc = runs[crit]["result"].scores
        if sc.shape != (25,) or not bool(torch.isfinite(sc).all()):
            fail(f"tune_ridge ({crit}) scores are not 25 finite values")
    if any(pn["rel_err"] > TOL_TUNE_PIN for pn in pins):
        fail("the f64 LOO curve does not equal analytical CV on LOO folds")
    if float(rel_f32.max()) > TOL_TUNE_F32:
        fail("the f32 LOO curve strays from the f64 curve")
    if not (0.0 <= float(lw) <= 1.0) or abs(float(lw) - lw64) > TOL_LW_F32:
        fail("the f32 Ledoit-Wolf intensity strays from f64 or leaves [0, 1]")
    return {"launches": launches, "check_launches": check_launches}


def update_phase(x, x64, y, lam, x_more, y_more) -> dict:
    """Incremental plans at the main size: a plan on the first 777 trials
    (kfold(777, 10): m = 77, 7 train-only rows), ``update_plan`` appending
    trials 777–786 (one a fold), ``sliding_window`` dropping rows 0–9 and
    appending ``x_more`` (10 further trials), ``downdate_plan`` dropping one
    test row a fold; after each step the plan against ``prepare`` rebuilt on
    the step's rows, in f32 and in f64, and both calls' seconds: the first
    call's and the median of UPDATE_WARM warm ones (the warm calls are not
    in the launch counts). λ = tr(G_c)/N of the main features."""
    from repro_torch.core import fastcv, folds as folds_mod

    dev = x.device
    path = check = None
    steps = []
    for xd in (x, x64):
        dt = xd.dtype
        yd, y_more_d, x_more_d = y.to(dt), y_more.to(dt), x_more.to(dt)
        rows, labels = xd[:UPDATE_N0], yd[:UPDATE_N0]
        plan = fastcv.prepare(rows, folds_mod.kfold(UPDATE_N0, K, seed=SEED, device=dev), lam)
        moves = (
            ("update_plan", lambda p, r: fastcv.update_plan(
                p, xd[UPDATE_N0:UPDATE_N0 + UPDATE_ROWS], torch.arange(K), x=r, lam=lam),
             lambda r, lb, p: (torch.cat([r, xd[UPDATE_N0:UPDATE_N0 + UPDATE_ROWS]]),
                               torch.cat([lb, yd[UPDATE_N0:UPDATE_N0 + UPDATE_ROWS]]))),
            ("sliding_window", lambda p, r: fastcv.sliding_window(
                p, x_more_d, torch.arange(UPDATE_ROWS), x=r, lam=lam),
             lambda r, lb, p: (torch.cat([r[UPDATE_ROWS:], x_more_d]),
                               torch.cat([lb[UPDATE_ROWS:], y_more_d]))),
            ("downdate_plan", lambda p, r: fastcv.downdate_plan(
                p, p.te_idx[:, 0], x=r, lam=lam), None),
        )
        for name, move, new_rows in moves:
            if new_rows is None:
                drop = plan.te_idx[:, 0].long()
                keep = torch.ones(rows.shape[0], dtype=torch.bool, device=dev)
                keep[drop] = False
                nxt = (rows[keep], labels[keep])
            else:
                nxt = new_rows(rows, labels, plan)
            upd, t_upd, d_upd = counted(lambda: move(plan, rows))
            dv_upd, _, d_dv = counted(lambda: fastcv.binary_dvals(upd, nxt[1]))
            rebuilt, t_reb, d_reb = counted(lambda: fastcv.prepare(
                nxt[0], folds_mod.Folds.with_indices(upd.te_idx, upd.tr_idx), lam))
            dv_reb, _, d_dv2 = counted(lambda: fastcv.binary_dvals(rebuilt, nxt[1]))
            # the same two calls again, warm: the first ones pay first-call costs
            warm_upd = statistics.median(timed(lambda: move(plan, rows))[1]
                                         for _ in range(UPDATE_WARM))
            warm_reb = statistics.median(timed(lambda: fastcv.prepare(
                nxt[0], folds_mod.Folds.with_indices(upd.te_idx, upd.tr_idx), lam))[1]
                for _ in range(UPDATE_WARM))
            expect_exact(f"update ({name}, {dt})", d_upd, {})
            d_path, d_check = launch_sum(d_upd, d_dv), launch_sum(d_reb, d_dv2)
            path = d_path if path is None else launch_sum(path, d_path)
            check = d_check if check is None else launch_sum(check, d_check)
            err, scale = rel_err(dv_upd, dv_reb)
            step = {"step": name, "dtype": str(dt).removeprefix("torch."), "N": int(nxt[0].shape[0]),
                    "m": int(upd.te_idx.shape[1]), "seconds_update": t_upd,
                    "seconds_rebuild": t_reb, "warm_median_seconds_update": warm_upd,
                    "warm_median_seconds_rebuild": warm_reb,
                    "max_abs_dH": float((upd.h - rebuilt.h).abs().max()),
                    "max_abs_dchol_ih": float((upd.chol_ih - rebuilt.chol_ih).abs().max()),
                    "max_abs_dh_tr_te": float((upd.h_tr_te - rebuilt.h_tr_te).abs().max()),
                    "dvals": {"max_abs_err": err, "scale": scale, "tol": TOL_UPDATE}}
            step["ok"] = (upd.h.dtype == dt and upd.h.shape == rebuilt.h.shape
                          and torch.equal(upd.te_idx, rebuilt.te_idx)
                          and bool(torch.isfinite(dv_upd).all()) and err <= TOL_UPDATE * scale)
            steps.append(step)
            plan, (rows, labels) = upd, nxt
            del rebuilt
    emit({"phase": "update", "lam": lam, "lam_rule": "tr(G_c)/N", "N0": UPDATE_N0,
          "rows_a_step": UPDATE_ROWS, "new_rows": "trials 787-796 of a 797-trial simulation "
          "of the same seed", "steps": steps, "launches": path, "check_launches": check})
    bad = [(s_["step"], s_["dtype"]) for s_ in steps if not s_["ok"]]
    if bad:
        fail(f"updated plans disagree with their rebuilds: {bad}")
    expect_exact("update", path, {"hat_apply": 6, "foldsolve": 6})
    return {"launches": path, "check_launches": check}


def serve_phase(ds, x, y, folds, lam, grid_lam, x_more) -> dict:
    """The serving core (``repro_torch.serve``) at the paper's size: a
    ``CVEngine`` on the card, the main subject (787 × 76,000 f32, K = 10,
    λ = tr(G_c)/N) registered once and warmed for every bucket of the
    traffic (binary, ridge, 3-class, permutation; then RSA with 8
    conditions, contrast dissimilarity and 2 model RDMs), then one
    ``run_workloads`` batch of one workload of each kind — binary, ridge
    and 3-class CV, binary and 3-class permutation tests (T = 1,000: one
    padded batch of 1,024), an 8-condition RSA scored against 2 model RDMs
    with a 1,000-draw null, ``tune`` on the default 25 λ, and a 301-point
    ``grid`` of the multidim path's features — an ``update`` appending 10
    trials, and the same batch again, warm. The class and condition labels
    are the subject's binary label y (trial t mod 2) split by ⌊t/2⌋ (3
    classes: y = 0, and y = 1 by ⌊t/2⌋ mod 2; 8 conditions:
    4y + ⌊t/2⌋ mod 4), so part of their structure decodes. Each step's launches are counted;
    the first batch and the replay must launch each kernel as predicted.
    Results are held against the direct ``core`` / ``rsa`` calls on the
    engine's plan, the permutation nulls against ``core.permutation`` of
    the same seed (at one chunk of 1,024, the engine's width: bit for bit),
    and a ``PlanStore`` round trip warm-boots a second engine with zero
    builds and bit-identical decision values. The four kernels of the path
    are held against their plain versions at the bucket-padded shapes."""
    import dataclasses as dc
    import tempfile

    from repro_torch.core import fastcv, metrics, multiclass, multidim, permutation, tuning
    from repro_torch.kernels.fold_eval.ops import fold_eval
    from repro_torch.kernels.fold_eval.ref import fold_eval_ref
    from repro_torch.kernels.foldsolve.ops import foldsolve
    from repro_torch.kernels.foldsolve.ref import foldsolve_ref
    from repro_torch.kernels.gram.ops import gram
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.hat_apply.ops import hat_errors
    from repro_torch.kernels.hat_apply.ref import hat_apply_ref
    from repro_torch.rsa import compare as rsa_compare
    from repro_torch.rsa import rdm as rsa_rdm
    from repro_torch.serve import (CVEngine, DatasetSpec, EngineConfig, PlanStore, Workload,
                                   run_workloads)

    dev = x.device
    n, p = x.shape
    idx = torch.arange(n, device=dev)
    y01 = ds.y.to(dev)
    yc3 = torch.where(y01 == 0, 0, 1 + (idx // 2) % 2).long()     # y = trial mod 2
    y8 = (4 * y01 + (idx // 2) % 4).long()
    c8 = RSA_CONDITIONS
    models = torch.stack([rsa_rdm.ring_rdm(c8, device=dev),
                          (torch.arange(c8, device=dev)[:, None] // 4
                           != torch.arange(c8, device=dev)[None, :] // 4).double()
                          ]).to(x.dtype)                                # (2, 8, 8) f32
    xs = ds.epochs.permute(2, 0, 1).contiguous()                       # (301, 787, 380) f32

    engine = CVEngine(EngineConfig(device="cuda"))
    compiles0 = engine.compile_count()
    reset_counts()
    handle, t_register = timed(lambda: engine.register(x, folds, lam))
    warm_tasks = ("binary", "ridge", "multiclass", "permutation")

    def warm():
        # warmup's num_classes serves both its multiclass and its RSA tasks;
        # this traffic has 3 classes and 8 conditions, so two calls
        a = engine.warmup(handle, tasks=warm_tasks, num_classes=MC_CLASSES, pin=True)
        b = engine.warmup(handle, tasks=("rsa",), num_classes=c8, num_model_rdms=2,
                          dissimilarity="contrast", pin=True)
        return a, b

    (w_a, w_b), t_warm = timed(warm)
    launches_warm, shapes_warm = counts(), shape_counts()
    plans_after_warm = engine.plans_built
    batch = [
        ("binary_cv", Workload(kind="cv", dataset=handle, y=y)),
        ("ridge_cv", Workload(kind="cv", dataset=handle, y=y, estimator="ridge")),
        ("multiclass_cv", Workload(kind="cv", dataset=handle, y=yc3, estimator="multiclass",
                                   num_classes=MC_CLASSES)),
        ("binary_permutation", Workload(kind="permutation", dataset=handle, y=y,
                                        n_perm=N_PERM, seed=SEED)),
        ("multiclass_permutation", Workload(kind="permutation", dataset=handle, y=yc3,
                                            estimator="multiclass", num_classes=MC_CLASSES,
                                            n_perm=N_PERM, seed=SEED)),
        ("rsa", Workload(kind="rsa", dataset=handle, y=y8, num_classes=c8,
                         dissimilarity="contrast", model_rdms=models, n_perm=N_PERM,
                         seed=SEED)),
        ("tune", Workload(kind="tune", x=x, y=y)),
        ("grid", Workload(kind="grid", dataset=DatasetSpec(None, folds, grid_lam), xs=xs, y=y)),
    ]
    names = [k for k, _ in batch]
    work = [w for _, w in batch]
    compiles_before = engine.compile_count()

    def per_kind(responses):
        return {k: sum(r.timings.values()) for k, r in zip(names, responses)}

    engine.enable_tracing()
    reset_counts()
    first, t_first = timed(lambda: run_workloads(engine, work))
    launches_first, shapes_first = counts(), shape_counts()
    cold = per_kind(first)
    reset_counts()
    (upd,), t_update = timed(lambda: run_workloads(
        engine, [Workload(kind="update", dataset=handle, x=x_more)]))
    launches_update, shapes_update = counts(), shape_counts()
    reset_counts()
    replay, t_replay_traced = timed(lambda: run_workloads(engine, work))
    launches_replay, shapes_replay = counts(), shape_counts()
    serve_shapes = shapes_warm + shapes_first + shapes_update + shapes_replay
    warm_kind = per_kind(replay)
    engine.disable_tracing()
    replays = [timed(lambda: run_workloads(engine, work)) for _ in range(REPLAYS)]
    replay2 = replays[0][0]
    t_replays = [t for _, t in replays]
    t_replay = statistics.median(t_replays)
    # where a warm batch's time goes: the device-busy ms of each profiled
    # replay (torch.profiler, union of its device intervals) against the same
    # replay's span on the device, and the host seconds of the permutation
    # draws alone (each permutation test and the RSA null draw 1,024 rows,
    # one permdraw launch)
    profiled = device_calls(lambda: run_workloads(engine, work), reps=REPLAYS, warmup=0)
    _, t_draws = timed(lambda: permutation.permutation_indices(SEED, n, 1024, device=dev))
    _, t_draws8 = timed(lambda: permutation.permutation_indices(SEED, c8, 1024, device=dev))
    compiles_after = engine.compile_count()
    stats = engine.stats()

    # -- the results against the direct core / rsa calls on the same plan ------
    _, plan = engine.resolve(handle)
    r = dict(zip(names, first))
    direct = {
        "binary_cv": fastcv.binary_dvals(plan, y),
        "ridge_cv": fastcv.cv_errors(dc.replace(plan, h_tr_te=None), y)[0],
        "rsa": rsa_rdm.pair_dissimilarities(
            plan, rsa_rdm.pair_contrast_columns(y8, c8, plan.h.dtype), dissimilarity="contrast"),
    }
    got = {"binary_cv": r["binary_cv"].values, "ridge_cv": r["ridge_cv"].values,
           "rsa": r["rsa"].pair_values}
    value_checks = {}
    for k in direct:
        err, scale = rel_err(got[k], direct[k])
        value_checks[k] = {"max_abs_err": err, "scale": scale, "tol": TOL[torch.float32],
                           "ok": err <= TOL[torch.float32] * scale}
    mc_direct = multiclass.batch_predict(plan, yc3[None, :], MC_CLASSES)[0]
    value_checks["multiclass_cv"] = {"mismatches": int((r["multiclass_cv"].values
                                                         != mc_direct).sum()),
                                     "ok": torch.equal(r["multiclass_cv"].values, mc_direct)}
    # model scoring and its null on the engine's own RDM (ranks of two RDMs
    # within the f32 pin of each other may still order differently)
    emp = r["rsa"].rdm
    value_checks["rsa_rdm"] = {"equals_pair_values": torch.equal(
        emp, rsa_rdm.rdm_from_pair_values(r["rsa"].pair_values, c8))}
    value_checks["rsa_rdm"]["ok"] = value_checks["rsa_rdm"]["equals_pair_values"]
    sc_direct = rsa_compare.compare_rdms(emp, models, "spearman")
    null_direct = rsa_compare.permutation_null(
        emp, models, permutation.permutation_indices(SEED, c8, N_PERM, device=dev), "spearman")
    for k, a, b in (("rsa_scores", r["rsa"].model_scores, sc_direct),
                    ("rsa_null", r["rsa"].null, null_direct)):
        err, scale = rel_err(a, b)
        value_checks[k] = {"max_abs_err": err, "scale": scale, "tol": TOL[torch.float32],
                           "ok": err <= TOL[torch.float32] * scale and a.shape == b.shape}
    tune_direct = tuning.tune_ridge(x, y)
    err, scale = rel_err(r["tune"].result.scores, tune_direct.scores)
    value_checks["tune"] = {"max_abs_err": err, "scale": scale, "tol": TOL[torch.float32],
                            "ok": err <= TOL[torch.float32] * scale}
    grid_direct = multidim.cv_grid(xs, y, folds, grid_lam)
    value_checks["grid"] = {"ok": torch.equal(r["grid"].accuracies, grid_direct),
                            "differ": int((r["grid"].accuracies != grid_direct).sum())}
    # the nulls: core.permutation on the same seed, one chunk of the bucket
    # width (1,024 draws; the engine draws the same prefix-stable rows)
    t_gen = 1024
    core_bin = permutation.analytical_permutation_binary(x, y, folds, lam, t_gen, SEED,
                                                         chunk=t_gen)
    core_mc = permutation.analytical_permutation_multiclass(x, yc3, folds, MC_CLASSES, lam,
                                                            t_gen, SEED, chunk=t_gen)
    for k, core in (("binary_permutation", core_bin), ("multiclass_permutation", core_mc)):
        resp = r[k]
        p_core = permutation.p_value(core.observed, core.null[:N_PERM])
        value_checks[k] = {
            "null_equal": torch.equal(resp.null, core.null[:N_PERM]),
            "observed_equal": torch.equal(resp.observed, core.observed),
            "p": float(resp.p), "p_core": float(p_core), "observed": float(resp.observed)}
        value_checks[k]["ok"] = (value_checks[k]["null_equal"]
                                 and value_checks[k]["observed_equal"]
                                 and float(resp.p) == float(p_core))
    same_replay = all(
        torch.equal(getattr(a, f), getattr(b, f))
        for a, b in zip(first, replay2)
        for f in ("values", "null", "rdm", "accuracies") if getattr(a, f, None) is not None)

    # -- the kernels at the serve path's shapes against their plain versions ---
    te = plan.te_idx
    h_te = plan.h[te[:, :, None], te[:, None, :]]
    perms = permutation.permutation_indices(SEED, n, t_gen, device=dev)
    y_null = y[perms].T.contiguous()                                    # (787, 1024)
    y1h = multiclass.onehot(yc3[perms], MC_CLASSES, dtype=x.dtype)      # (1024, 787, 3)
    y_mc = y1h.permute(1, 0, 2).reshape(n, t_gen * MC_CLASSES).contiguous()   # (787, 3072)
    cols8 = rsa_rdm.pair_contrast_columns(y8, c8, x.dtype)
    y_rsa = torch.cat([cols8, cols8.new_zeros(n, 32 - cols8.shape[1])], 1)    # (787, 32)
    y1 = y[:, None].contiguous()
    xc = x - x.mean(dim=0, keepdim=True)
    k_te, m_te = te.shape
    shapes = {}
    kernel_checks = []
    for tag, yy in (("binary null B=1024", y_null), ("3-class null block B=3072", y_mc),
                    ("RSA contrasts B=32 (28 padded)", y_rsa)):
        e = hat_errors(plan.h, yy)
        err_h = rel_err(e, hat_apply_ref(plan.h, yy))
        e_te = e[te]
        err_f = rel_err(foldsolve(h_te, e_te, jitter=None), foldsolve_ref(h_te, e_te))
        kernel_checks += [{"kernel": "hat_apply", "case": f"serve {tag}", "max_abs_err": err_h[0],
                           "scale": err_h[1], "ok": err_h[0] <= TOL[torch.float32] * err_h[1]},
                          {"kernel": "foldsolve", "case": f"serve {tag}", "max_abs_err": err_f[0],
                           "scale": err_f[1], "ok": err_f[0] <= TOL[torch.float32] * err_f[1]}]
        # the serve path's launches at this shape (warm-up, first batch,
        # update, replay), from the per-shape counts
        b_ = yy.shape[1]
        shapes[tag] = {"y": yy, "e_te": e_te, "hat_apply_err": err_h[0],
                       "foldsolve_err": err_f[0], "launches": {
                           "hat_apply": sum(v for (kn, a), v in serve_shapes.items()
                                            if kn == "hat_apply" and a[:2] == (n, b_)),
                           "foldsolve": sum(v for (kn, a), v in serve_shapes.items()
                                            if kn == "foldsolve"
                                            and a[:3] == (k_te, m_te, b_))}}
    err_g = rel_err(gram(xc), gram_ref(xc))
    err_e = rel_err(fold_eval(plan.h[te], h_te, y1, y1[te], jitter=None),
                    fold_eval_ref(plan.h[te], h_te, y1, y1[te])[0])
    kernel_checks += [
        {"kernel": "gram", "case": f"serve: plan build and tune X ({n}, {p}) f32",
         "max_abs_err": err_g[0], "scale": err_g[1],
         "ok": err_g[0] <= TOL[torch.float32] * err_g[1]},
        {"kernel": "fold_eval", "case": "serve: the ridge group, bucket 1",
         "max_abs_err": err_e[0], "scale": err_e[1],
         "ok": err_e[0] <= TOL[torch.float32] * err_e[1]}]

    # -- the store tier: save, then a second engine on the store ---------------
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_store-", dir=root) as store_dir:
        store = PlanStore(store_dir, device=dev)
        _, t_save = timed(lambda: store.save(handle.key, plan))
        engine2 = CVEngine(EngineConfig(device="cuda", plan_store=store_dir))
        handle2 = engine2.register(x, folds, lam)
        (warm_boot,), t_load = timed(lambda: run_workloads(
            engine2, [Workload(kind="cv", dataset=handle2, y=y)]))
        store_check = {"plans_built": engine2.plans_built,
                       "store_hits": engine2.stats()["store_hits"],
                       "bit_equal": torch.equal(warm_boot.values, r["binary_cv"].values),
                       "entry_bytes": store.total_bytes()}
        del engine2
    _, t_rebuild = timed(lambda: fastcv.prepare(x, folds, lam))
    store_check.update(seconds={"save": t_save, "load_and_eval": t_load, "rebuild": t_rebuild})
    store_check["ok"] = (store_check["plans_built"] == 0 and store_check["store_hits"] == 1
                         and store_check["bit_equal"])

    # draws: one permdraw launch for each permutation test and RSA null, and
    # in warm-up one for each bucket of each warm-up call that draws
    want_batch = {"gram": 1, "hat_apply": 308, "foldsolve": 308, "fold_eval": 1, "permdraw": 3}
    want_replay = {"gram": 1, "hat_apply": 307, "foldsolve": 307, "fold_eval": 1, "permdraw": 3}
    want_warm = {"gram": 1, "hat_apply": 57, "foldsolve": 57, "fold_eval": 11,
                 "permdraw": len(w_a["buckets"]) + len(w_b["buckets"])}
    strip = lambda d: {k: v for k, v in d.items() if k != "calls"}
    out = {"phase": "serve", "N": n, "P": p, "K": folds.k, "m": folds.test_size,
           "dtype": "float32", "lam": lam, "grid_lam": grid_lam, "workloads": names,
           "n_perm": N_PERM, "perm_bucket": t_gen, "rsa_conditions": c8, "model_rdms": 2,
           "seconds": {"register": t_register, "warmup": t_warm, "first_batch": t_first,
                       "update": t_update, "replay_traced": t_replay_traced,
                       "replay": t_replay},
           "seconds_per_kind": {"cold": cold, "warm": warm_kind},
           "replay_seconds": t_replays,
           "warm_workloads_per_s": len(work) / t_replay,
           "profiled_replays_ms": (None if profiled is None
                                   else [{"busy": b, "span": w} for b, w in profiled]),
           "replay_device_busy_ms": (None if profiled is None
                                     else statistics.median(b for b, _ in profiled)),
           "replay_device_idle_share": (None if profiled is None
                                        else statistics.median(1.0 - b / w
                                                               for b, w in profiled)),
           "draw_seconds": {"1024 x 787": t_draws, "1024 x 8": t_draws8},
           "launches": {"warmup": launches_warm, "first_batch": launches_first,
                        "update": launches_update, "replay": launches_replay},
           "predicted_launches": {"warmup": want_warm, "first_batch": want_batch,
                                  "update": {}, "replay": want_replay},
           "compile_count": {"engine_start": compiles0, "after_warmup": compiles_before,
                             "after_traffic": compiles_after,
                             "warmup_summaries": [w_a["compiles"], w_b["compiles"]]},
           "plans_built": {"after_warmup": plans_after_warm, "end": stats["plans_built"]},
           "plans_updated": stats["plans_updated"], "update_version": upd.version,
           "update_n": upd.handle.n, "replay_equals_first": same_replay,
           "launches_by_shape": {tag: sh["launches"] for tag, sh in shapes.items()},
           "checks": value_checks, "kernel_checks": kernel_checks, "store": store_check,
           "accuracy": float(r["binary_cv"].score), "multiclass_accuracy":
               float(r["multiclass_cv"].score),
           "perm_p": {"binary": float(r["binary_permutation"].p),
                      "multiclass": float(r["multiclass_permutation"].p)},
           "rsa_scores": r["rsa"].model_scores.tolist(), "rsa_p": r["rsa"].p.tolist(),
           "cache": {k: stats[k] for k in ("hits", "misses", "pinned", "bytes_in_use")}}
    emit(out)
    print(f"serve: register {t_register:.4f} s, warm-up {t_warm:.4f} s, first batch "
          f"{t_first:.4f} s, replay {t_replay:.4f} s ({len(work) / t_replay:.2f} workloads/s); "
          f"store save {t_save:.4f} s, load {t_load:.4f} s, rebuild {t_rebuild:.4f} s; "
          f"launches first batch {strip(launches_first)}, replay {strip(launches_replay)}",
          flush=True)
    if stats["plans_built"] != 1 or plans_after_warm != 1 or stats["plans_updated"] != 1:
        fail(f"serve: plans_built {stats['plans_built']} (want 1), plans_updated "
             f"{stats['plans_updated']} (want 1)")
    if compiles_after != compiles_before:
        fail(f"serve: compile_count moved from {compiles_before} to {compiles_after} "
             "over warmed traffic")
    bad = [k for k, v in value_checks.items() if not v["ok"]]
    if bad:
        fail(f"serve: results disagree with the direct calls: {bad}")
    bad = [c["case"] for c in kernel_checks if not c["ok"]]
    if bad:
        fail(f"serve: kernels disagree with their plain versions at {bad}")
    if not store_check["ok"]:
        fail(f"serve: the store round trip failed: {store_check}")
    if not same_replay:
        fail("serve: the untraced replay differs from the first batch")
    unlaunched = [(tag, k) for tag, sh in shapes.items() for k, v in sh["launches"].items()
                  if v <= 0]
    if unlaunched:
        fail(f"serve: no launch at the bucket-padded shapes {unlaunched}")
    expect_exact("serve warm-up", launches_warm, want_warm)
    expect_exact("serve first batch", launches_first, want_batch)
    expect_exact("serve update", launches_update, {})
    expect_exact("serve replay", launches_replay, want_replay)
    for resp in first:
        for f in ("values", "null", "rdm", "accuracies", "score"):
            v = getattr(resp, f, None)
            if v is not None and not bool(torch.isfinite(v.double()).all()):
                fail(f"serve: non-finite {f} in a {type(resp).__name__}")
    launches = launch_sum(launch_sum(launch_sum(launches_warm, launches_first),
                                     launches_update), launches_replay)
    return {"launches": launches, "first_batch": launches_first, "shapes": shapes,
            "plan": plan, "h_te": h_te, "engine": engine, "handle": handle,
            "batch": dict(batch), "first": r, "update": upd}


# the http phase: the serve edges over a socket and the serve_cv entry point
HTTP_KINDS = ("binary_cv", "ridge_cv", "multiclass_cv", "binary_permutation",
              "multiclass_permutation", "rsa")
HTTP_CHUNK = 1024
HTTP_TIMED = 5
# across bucket widths on the card (hat_apply's split count follows B), f32
# decision values agree to 1e-4 of scale end to end
TOL_SERVE_EDGE = 1e-4
BOOT_TIMEOUT = 240          # seconds to a serve_cv subprocess's "listening" line
EXIT_TIMEOUT = 120          # seconds from SIGTERM to its exit
REPLAY_TIMEOUT = 300        # the async replay run of serve_cv
EXAMPLE_TIMEOUT = 180       # each example


class _Proc:
    """A subprocess whose merged output is read on a thread (so a wait for a
    line can time out) and that is killed if still running at close()."""

    def __init__(self, cmd, cwd, env):
        import queue
        import threading
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True, bufsize=1)
        self.lines: list = []
        self._q: "queue.Queue" = queue.Queue()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            self._q.put(line)
        self._q.put(None)

    def wait_for(self, pattern: str, timeout: float):
        """(match, seconds since start) of the first line matching ``pattern``."""
        import queue
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._q.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                return None, None
            if line is None:
                return None, None
            m = re.search(pattern, line)
            if m:
                return m, time.perf_counter() - self.t0

    def finish(self, timeout: float):
        """Exit code (None on timeout) after the process ends."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        self._reader.join(timeout=10)
        return rc

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def tail(self, n: int = 12) -> str:
        return "".join(self.lines[-n:])


def http_phase(srv, y, x_more, y_more) -> dict:
    """The serve edges (``repro_torch.serve.http``) on the serve phase's warm
    engine and handle (787 × 76,000 f32, K = 10), then the
    ``repro_torch.launch.serve_cv`` entry point as a process on the card.

    In process, over a socket: ``EdgeThread`` on 127.0.0.1:0 and
    ``HTTPClient``. The handle-carried kinds of the serve batch (binary,
    ridge and 3-class CV, both T = 1,000 permutation tests, the 8-condition
    RSA with its model null) go over the wire as one batch and in process as
    the same batch: every decoded response equals its in-process one bit for
    bit, and the two runs launch the same kernels as often; a malformed
    entry in the batch answers a structured 400 while its siblings are
    served; an SSE stream of the binary test at ``stream_chunk`` 1,024
    concatenates to the monolithic null bit for bit; an append of 10 trials
    over the wire yields the handle the in-process update yields, and a CV on
    it agrees with the in-process CV; ``/v1/metrics`` parses and
    ``/v1/trace`` names only ``STAGES``. Over the wire traffic
    ``compile_count`` stays flat and no plan is built (the append is a rank-k
    update). Then ``serve_cv --http 0 --data eeg --n 787`` boots cold with a
    plan store and records its traffic, serves a CV and a permutation test
    over HTTP, and shuts down on SIGTERM (exit 0); a second boot from the
    store and the recorded traffic builds 0 plans; a replay run with
    ``--async 8`` reports 0 recompiles; and ``examples/torch/http_quickstart``
    and ``serve_quickstart`` run on the card."""
    import os
    import signal
    import tempfile

    from repro_torch.serve import EdgeThread, HTTPClient, Workload, run_workloads, stream_workload
    from repro_torch.serve.http import assert_responses_equal, response_from_dict, response_to_dict
    from repro_torch.serve.obs import METRICS
    from repro_torch.serve.trace import STAGES

    engine, handle, upd = srv["engine"], srv["handle"], srv["update"]
    dicts = [srv["batch"][k].to_dict() for k in HTTP_KINDS]
    fresh = lambda: [Workload.from_dict(d) for d in dicts]          # the wire's own inputs
    total = None

    def seg(fn):
        """(fn's result, host seconds up to a synchronize, its launches); the
        launches add to the phase's total."""
        nonlocal total
        reset_counts()
        out, secs = timed(fn)
        c = counts()
        total = c if total is None else launch_sum(total, c)
        return out, secs, c

    def equal(got, want):
        try:
            for g, w in zip(got, want, strict=True):
                assert_responses_equal(g, w)
            return True
        except AssertionError as e:
            print(f"http: responses differ: {str(e)[:400]}", flush=True)
            return False

    # -- in process first: every launch shape the wire traffic will need -----
    w_cv1 = lambda h: Workload(kind="cv", dataset=h, y=torch.cat([y, y_more]))
    ref, _, l_inproc = seg(lambda: run_workloads(engine, fresh()))
    inproc_events, _, l_inproc_stream = seg(lambda: list(stream_workload(
        engine, fresh()[3], chunk=HTTP_CHUNK)))
    (cv_v1,), _, _ = seg(lambda: run_workloads(engine, [w_cv1(upd.handle)]))
    in_times = [seg(lambda: run_workloads(engine, fresh()))[1] for _ in range(HTTP_TIMED)]
    # the codec alone, host clock: the batch's responses to JSON and back
    # (response_to_dict copies each array to the host), and the request body
    body, t_encode = timed(lambda: json.dumps({"results": [
        {"ok": True, "response": response_to_dict(r)} for r in ref]}))
    _, t_decode = timed(lambda: [response_from_dict(e["response"])
                                 for e in json.loads(body)["results"]])
    request_body = json.dumps({"workloads": dicts})
    codec = {"encode_s": t_encode, "decode_s": t_decode, "response_mib": len(body) / 2 ** 20,
             "request_mib": len(request_body) / 2 ** 20}
    # what differs across bucket widths on the card: the binary null at
    # chunk 64 (bucket 64) against the monolithic bucket 1,024, and the
    # binary CV column alone (bucket 1) against inside a batch of 5 (bucket 8)
    ev64, _, _ = seg(lambda: list(stream_workload(engine, fresh()[3], chunk=64)))
    null64 = torch.cat([e.payload for e in ev64 if e.kind == "null"])
    ys = torch.stack([y] + [torch.roll(y, s_) for s_ in (1, 2, 3, 5)], 1)
    (cv5,), _, _ = seg(lambda: run_workloads(engine, [Workload(kind="cv", dataset=handle,
                                                               y=ys)]))
    err_cv, scale_cv = rel_err(cv5.values[..., 0], ref[0].values)
    across = {"null_chunk64_vs_1024": {"differ": int((null64 != ref[3].null).sum()),
                                       "max_abs_err": float((null64 - ref[3].null).abs().max())},
              "cv_bucket8_vs_1": {"bit_equal": torch.equal(cv5.values[..., 0], ref[0].values),
                                  "max_abs_err": err_cv, "scale": scale_cv,
                                  "tol": TOL_SERVE_EDGE}}
    compiles0, built0, updated0 = engine.compile_count(), engine.plans_built, engine.plans_updated

    checks = {}
    with EdgeThread(engine, stream_chunk=HTTP_CHUNK) as edge, HTTPClient(edge.url) as hc:
        checks["healthz"] = hc.healthz() == {"status": "ok"}
        listed = [d["handle"].key for d in hc.datasets()]
        checks["handle_listed"] = handle.key in listed and upd.handle.key in listed
        # the batch over the wire, with one malformed entry beside it
        bad = dict(dicts[0], y={"__array__": [2.0] * handle.n, "dtype": "float64"})
        out, t_wire_bad, l_wire = seg(lambda: hc._request(
            "POST", "/v1/workloads", {"workloads": dicts + [bad]}))
        entries = out["results"]
        checks["malformed_entry"] = (not entries[-1]["ok"]
                                     and entries[-1]["error"]["status"] == 400
                                     and entries[-1]["error"]["type"] == "validation")
        wire = [HTTPClient._entry(e, raise_errors=True) for e in entries[:-1]]
        checks["wire_equals_in_process"] = equal(wire, ref)
        checks["wire_launches_equal"] = l_wire == l_inproc
        wire_times = []
        for _ in range(HTTP_TIMED):
            ws = fresh()
            got, secs, _ = seg(lambda: hc.gather(ws))
            wire_times.append(secs)
            checks["wire_equals_in_process"] &= equal(got, ref)
        # SSE: the binary permutation test at stream_chunk 1,024
        events, marks = [], []

        def stream():
            t0 = time.perf_counter()
            for ev in hc.stream(fresh()[3]):
                events.append(ev)
                marks.append(time.perf_counter() - t0)

        _, t_stream, l_wire_stream = seg(stream)
        t_first = next(t for ev, t in zip(events, marks) if ev.kind == "null")
        chunks = [ev.payload for ev in events if ev.kind == "null"]
        mono = ref[3].null.cpu()
        checks["sse_equals_monolithic"] = (
            [ev.kind for ev in events] == [ev.kind for ev in inproc_events]
            and torch.equal(torch.cat(chunks), mono)
            and torch.equal(events[-1].payload.null, mono)
            and torch.equal(torch.cat([ev.payload for ev in inproc_events
                                       if ev.kind == "null"]).cpu(), mono))
        checks["sse_launches_equal"] = l_wire_stream == l_inproc_stream
        # an append of 10 trials over the wire, then a CV on its handle
        body_mb = len(json.dumps({"x": {"__array__": x_more.cpu().tolist(),
                                        "dtype": "float32"}})) / 2 ** 20
        h_new, t_append, l_append = seg(lambda: hc.append(handle, x_more))
        (cv_wire,), _, _ = seg(lambda: hc.gather([w_cv1(h_new)]))
        err, scale = rel_err(cv_wire.values, cv_v1.values.cpu())
        checks["append_handle"] = (h_new.key == upd.handle.key
                                   and h_new.n == handle.n + x_more.shape[0])
        checks["append_cv"] = err <= TOL_UPDATE * scale
        # the exposition routes
        text = hc.metrics_text()
        samples = [ln.rsplit(" ", 1) for ln in text.splitlines() if ln and not ln.startswith("#")]
        names = {s[0].split("{")[0] for s in samples}
        base = {re.sub(r"_(bucket|sum|count)$", "", nm) if nm not in METRICS else nm
                for nm in names}
        checks["metrics_parse"] = (bool(samples) and all(_is_float(v) for _, v in samples)
                                   and base <= set(METRICS))
        engine.enable_tracing()
        seg(lambda: hc.gather(fresh()[:1]))
        traced = hc.trace(8)
        engine.disable_tracing()
        span_names = set()

        def walk(spans):
            for sp in spans:
                span_names.add(sp["name"])
                walk(sp.get("children", []))

        for tr in traced["traces"]:
            walk(tr["spans"])
        checks["trace_stages"] = bool(span_names) and span_names <= set(STAGES)
        edge_stats = hc.stats()["edge"]
    compiles1, built1, updated1 = engine.compile_count(), engine.plans_built, engine.plans_updated
    checks["compile_count_flat"] = compiles1 == compiles0
    checks["across_buckets_within_f32"] = (
        across["cv_bucket8_vs_1"]["max_abs_err"] <= TOL_SERVE_EDGE * scale_cv)
    checks["no_plan_built"] = built1 == built0 and updated1 == updated0 + 1
    for resp in ref:
        for f in ("values", "null", "rdm", "score", "p"):
            v = getattr(resp, f, None)
            if v is not None and not bool(torch.isfinite(v.double()).all()):
                checks["finite"] = False
    checks.setdefault("finite", True)

    # -- the entry point: python -m repro_torch.launch.serve_cv ---------------
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    cli = [sys.executable, "-m", "repro_torch.launch.serve_cv", "--data", "eeg",
           "--n", str(N_TRIALS)]
    n_eeg = N_TRIALS
    y_eeg = torch.where(torch.arange(n_eeg) % 2 == 0, -1.0, 1.0).double()
    eeg_batch = lambda h: [Workload(kind="cv", dataset=h, y=y_eeg),
                           Workload(kind="permutation", dataset=h, y=y_eeg, n_perm=N_PERM,
                                    seed=SEED)]
    boots, procs = {}, []

    def boot(tag, extra):
        proc = _Proc(cli + ["--http", "0"] + extra, root, env)
        procs.append(proc)
        m, secs = proc.wait_for(r"listening on (http://\S+)", BOOT_TIMEOUT)
        if m is None:
            proc.close()
            fail(f"http: serve_cv ({tag}) printed no listening line within {BOOT_TIMEOUT} s:\n"
                 f"{proc.tail()}")
        client = HTTPClient(m.group(1))
        stats0 = client.stats()["engine"]
        h = next(d["handle"] for d in client.datasets() if d["handle"].n == n_eeg)
        out, t_batch = timed(lambda: client.gather(eeg_batch(h)))
        stats1 = client.stats()["engine"]
        client.close()
        proc.proc.send_signal(signal.SIGTERM)
        rc = proc.finish(EXIT_TIMEOUT)
        shut = any("http edge shut down" in ln for ln in proc.lines)
        boots[tag] = {"to_listening_s": secs, "batch_s": t_batch, "rc": rc,
                      "shutdown_line": shut,
                      "plans_built": {"after_warmup": stats0["plans_built"],
                                      "after_batch": stats1["plans_built"]},
                      "store_hits": stats1["store_hits"],
                      "accuracy": float(out[0].score), "p": float(out[1].p)}
        if rc != 0 or not shut:
            fail(f"http: serve_cv ({tag}) did not shut down cleanly on SIGTERM (rc {rc}):\n"
                 f"{proc.tail()}")

    examples = {}
    try:
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_store-", dir=root) as tmp:
            store, traffic = os.path.join(tmp, "plans"), os.path.join(tmp, "traffic.json")
            boot("cold", ["--warmup", "--pin", "--plan-store", store, "--save-plans",
                          "--record-traffic", traffic])
            boot("warm", ["--plan-store", store, "--warmup-from", traffic])
        replay = _Proc(cli + ["--warmup", "--pin", "--async", "8"], root, env)
        procs.append(replay)
        rc = replay.finish(REPLAY_TIMEOUT)
        text = "".join(replay.lines)
        rec = {k: [int(v) for v in re.findall(rf"recompiles on {k} replay: (\d+)", text)]
               for k in ("warm", "async")}
        boots["async_replay"] = {"rc": rc, "recompiles": rec,
                                 "seconds": time.perf_counter() - replay.t0}
        if rc != 0 or rec != {"warm": [0], "async": [0]}:
            fail(f"http: serve_cv --async 8 (rc {rc}) recompiles {rec}:\n{replay.tail()}")
        for name in ("http_quickstart", "serve_quickstart"):
            ex = _Proc([sys.executable, str(root / "examples" / "torch" / f"{name}.py")], root,
                       env)
            procs.append(ex)
            rc = ex.finish(EXAMPLE_TIMEOUT)
            examples[name] = {"rc": rc, "seconds": time.perf_counter() - ex.t0}
            if rc != 0:
                fail(f"http: examples/torch/{name}.py exited {rc}:\n{ex.tail()}")
    finally:
        for proc in procs:
            proc.close()

    out = {"phase": "http", "N": handle.n, "P": handle.p, "K": engine.dataset_record(
               handle).folds.k, "workloads": list(HTTP_KINDS), "n_perm": N_PERM,
           "stream_chunk": HTTP_CHUNK, "checks": checks,
           "launches": {"in_process": l_inproc, "wire": l_wire,
                        "in_process_stream": l_inproc_stream, "wire_stream": l_wire_stream,
                        "append": l_append},
           "seconds": {"wire_batch": wire_times, "wire_batch_median": statistics.median(
                           wire_times), "in_process_batch": in_times,
                       "in_process_batch_median": statistics.median(in_times),
                       "wire_batch_with_malformed": t_wire_bad,
                       "sse_first_chunk": t_first, "sse_whole": t_stream,
                       "append": t_append},
           "codec": codec, "across_buckets": across, "append_body_mib": body_mb, "append_cv": {"max_abs_err": err, "scale": scale,
                                                     "tol": TOL_UPDATE},
           "compile_count": {"before_wire": compiles0, "after_wire": compiles1},
           "plans_built": {"before_wire": built0, "after_wire": built1},
           "plans_updated": {"before_wire": updated0, "after_wire": updated1},
           "edge": edge_stats, "trace_span_names": sorted(span_names),
           "serve_cv": boots, "examples": examples,
           "warm_boot_vs_cold": boots["warm"]["to_listening_s"] / boots["cold"]["to_listening_s"]}
    emit(out)
    print(f"http: wire batch median {statistics.median(wire_times):.4f} s against in-process "
          f"{statistics.median(in_times):.4f} s (codec: encode {t_encode:.4f} s, decode "
          f"{t_decode:.4f} s); SSE first chunk {t_first:.4f} s, whole "
          f"{t_stream:.4f} s; serve_cv to listening cold {boots['cold']['to_listening_s']:.2f} "
          f"s, warm {boots['warm']['to_listening_s']:.2f} s; launches wire "
          f"{ {k: v for k, v in l_wire.items() if k != 'calls'} } = in process",
          flush=True)
    bad_checks = [k for k, v in checks.items() if not v]
    if bad_checks:
        fail(f"http: checks failed: {bad_checks} (launches in process {l_inproc}, wire "
             f"{l_wire}; compile_count {compiles0} -> {compiles1}; plans_built {built0} -> "
             f"{built1}, plans_updated {updated0} -> {updated1})")
    if boots["warm"]["plans_built"] != {"after_warmup": 0, "after_batch": 0}:
        fail(f"http: the warm reboot built plans: {boots['warm']}")
    expect_launches("http", total, ["hat_apply", "foldsolve", "fold_eval"])
    return {"launches": total}


# the distributed phase: core.distributed, rsa.searchlight_rdm and a mesh
# engine over NCCL at world size 1 (the card's one GPU)
DIST_WINDOWS = 20              # searchlight problems: 50-ms windows of the subject
DIST_STREAM_CHUNK = 250        # the mesh engine's streamed null (bucket 256)


def distributed_phase(ds, x, y, folds, lam) -> dict:
    """``repro_torch.core.distributed``, ``rsa.searchlight_rdm`` and a mesh
    ``CVEngine`` on the card, through NCCL: a process group of one rank (a
    ``FileStore`` under the checkout, ``init_process_group("nccl")``) and a
    (1, 1) ``DeviceMesh`` of dims ("data", "model"), the mesh one GPU can
    hold (NCCL refuses two ranks on one device). On the main subject: the
    feature-sharded Gram and hat matrix against ``centered_gram`` and
    ``hat_matrix_dual`` (bit for bit); Algorithm 1 sharded over the
    permutations (T = 1,000) against ``core.permutation`` at one chunk of
    1,000; ``searchlight_cv`` and ``searchlight_rdm`` (8 conditions) over 20
    sliding 50-ms windows (10 consecutive 5-ms windows × 380 channels; the
    features are window-major) against ``binary_cv`` / ``rdm_binary``
    window by window; a mesh engine's plan against a local engine's, its
    T = 1,000 permutation test against ``sharded_null_from_plan`` called
    directly and against the local engine's, and its null streamed at
    chunk 1,024 (one chunk) against its monolithic null and at chunk 250
    (bucket 256) against the local engine's stream at chunk 250. Each of
    those is bit for bit; where widths differ (the mesh engine against the
    local one, the 256-wide stream against the 1,024-wide null: hat_apply's
    split count follows B) ≥ 999 of 1,000 accuracies must be equal and none
    more than one prediction apart. Launches are exact per call; the
    kernels are held against their plain versions at the path's new
    shapes. The group is destroyed at the end, so later phases run as
    before; if NCCL does not start or a check fails, the run fails."""
    import datetime
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed as D
    from repro_torch.core import fastcv, metrics, permutation
    from repro_torch.kernels.foldsolve.ops import foldsolve
    from repro_torch.kernels.foldsolve.ref import foldsolve_ref
    from repro_torch.kernels.gram.ops import centered_gram, gram
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.hat_apply.ops import hat_errors
    from repro_torch.kernels.hat_apply.ref import hat_apply_ref
    from repro_torch.rsa import rdm as rsa_rdm
    from repro_torch.serve import CVEngine, EngineConfig, Workload, bucket_size, stream_workload

    dev = x.device
    n, p = x.shape
    root = Path(__file__).resolve().parent
    store_dir = tempfile.TemporaryDirectory(prefix=".chip_smoke_store-pg-", dir=root)
    torch.cuda.set_device(dev)   # the communicator's device, before the mesh
    try:
        dist.init_process_group("nccl", init_method=f"file://{store_dir.name}/store", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=120))
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    except (RuntimeError, ValueError) as err:
        fail(f"distributed: NCCL did not start: {err}")
    backend = dist.get_backend()
    if backend != "nccl" or mesh.device_type != "cuda":
        fail(f"distributed: the group runs {backend} on {mesh.device_type}, not nccl on cuda")
    # each window: 10 consecutive 5-ms windows x 380 channels, 3,800 features
    wp = p // DIST_WINDOWS
    lam_w = lam * wp / p     # the windows' mean tr(G_c)/N (traces add over features)
    xs = torch.stack([x[:, q * wp:(q + 1) * wp] for q in range(DIST_WINDOWS)])
    idx = torch.arange(n, device=dev)
    y8 = (4 * ds.y.to(dev) + (idx // 2) % 4).long()                       # 8 conditions
    c8 = RSA_CONDITIONS
    steps, secs, checks = {}, {}, {}
    by_shape = collections.Counter()

    def step(name, fn, want):
        before = shape_counts()
        out, secs[name], steps[name] = counted(fn)
        by_shape.update(shape_counts() - before)
        expect_exact(f"distributed {name}", steps[name], want)
        return out

    # -- core.distributed against the local calls ------------------------------
    g = step("distributed_gram", lambda: D.distributed_gram(x, mesh), {"gram": 1})
    checks["gram_equals_centered_gram"] = torch.equal(g, centered_gram(x))
    h = step("distributed_hat_matrix", lambda: D.distributed_hat_matrix(x, lam, mesh),
             {"gram": 1})
    checks["hat_equals_hat_matrix_dual"] = torch.equal(
        h, fastcv.hat_matrix_dual(x, lam, gram=centered_gram(x)))
    perm = step("distributed_permutation_binary", lambda: D.distributed_permutation_binary(
        x, y, folds, lam, N_PERM, SEED, mesh), {"gram": 1, "hat_apply": 2, "foldsolve": 2,
                                                "permdraw": 1})
    want = permutation.analytical_permutation_binary(x, y, folds, lam, N_PERM, SEED,
                                                     chunk=N_PERM)
    checks["permutation_equals_core"] = (torch.equal(perm.observed, want.observed)
                                         and torch.equal(perm.null, want.null)
                                         and torch.equal(perm.p, want.p))
    per_window = {"gram": DIST_WINDOWS, "hat_apply": DIST_WINDOWS, "foldsolve": DIST_WINDOWS}
    acc = step("searchlight_cv", lambda: D.searchlight_cv(xs, y, folds, lam_w, mesh),
               per_window)
    want_acc = []
    for xq in xs:
        dv, y_te = fastcv.binary_cv(xq, y, folds, lam_w)
        hits = torch.where(dv >= 0, 1.0, -1.0).to(dv.dtype) == torch.sign(y_te)
        want_acc.append(metrics.share(hits.sum(), hits.numel()))
    checks["searchlight_equals_binary_cv"] = torch.equal(acc, torch.stack(want_acc))
    rdms = step("searchlight_rdm", lambda: rsa_rdm.searchlight_rdm(
        xs, y8, folds, lam_w, mesh, num_classes=c8), per_window)
    checks["searchlight_rdm_equals_rdm_binary"] = torch.equal(rdms, torch.stack(
        [rsa_rdm.rdm_binary(xq, y8, folds, c8, lam_w) for xq in xs]))

    # -- a mesh engine against a local one --------------------------------------
    engine = CVEngine(EngineConfig(device="cuda", mesh=mesh))
    handle = engine.register(x, folds, lam)
    _, plan = step("engine_plan", lambda: engine.resolve(handle), {"gram": 1})
    local = CVEngine(EngineConfig(device="cuda"))
    _, plan_l = local.plan(x, folds, lam)
    checks["engine_h_equals_local"] = torch.equal(plan.h, plan_l.h)
    res = step("engine_permutation_binary", lambda: engine.permutation_binary(
        plan, y, N_PERM, SEED), {"hat_apply": 2, "foldsolve": 2, "permdraw": 1})
    t_gen = bucket_size(N_PERM, engine.config.buckets)
    direct = D.sharded_null_from_plan(plan, y, permutation.permutation_indices(
        SEED, n, t_gen, device=dev), mesh)[:N_PERM]
    checks["engine_null_equals_sharded_null"] = torch.equal(res.null, direct)
    res_l = local.permutation_binary(plan_l, y, N_PERM, SEED)
    m_te = folds.k * folds.test_size
    vs_local = {"equal": int((res.null == res_l.null).sum()), "of": N_PERM,
                "max_abs_diff": float((res.null - res_l.null).abs().max()),
                "one_prediction": 1.0 / m_te, "observed_equal": torch.equal(res.observed,
                                                                            res_l.observed)}
    checks["engine_null_near_local"] = (vs_local["equal"] >= N_PERM - 1
                                        and vs_local["max_abs_diff"] <= 1.0 / m_te + 1e-7
                                        and vs_local["observed_equal"])
    # the null streamed at chunk 250 (bucket 256) and at chunk 1,024 (one
    # chunk, the monolithic width); bits follow the width (hat_apply's split
    # count follows B), so the 256-wide chunks are held bit for bit to the
    # local engine's stream at the same chunk, and to the monolithic null by
    # the rule of the engines above
    w = Workload(kind="permutation", dataset=handle, y=y, n_perm=N_PERM, seed=SEED)
    events = step("stream_workload", lambda: list(stream_workload(
        engine, w, chunk=DIST_STREAM_CHUNK)), {"hat_apply": 5, "foldsolve": 5, "permdraw": 1})
    events_1024 = step("stream_workload_1024", lambda: list(stream_workload(
        engine, w, chunk=t_gen)), {"hat_apply": 2, "foldsolve": 2, "permdraw": 1})
    nulls = lambda evs: torch.cat([e.payload for e in evs if e.kind == "null"])
    streamed = nulls(events)
    local_stream = nulls(stream_workload(local, Workload(
        kind="permutation", dataset=local.register(x, folds, lam), y=y, n_perm=N_PERM,
        seed=SEED), chunk=DIST_STREAM_CHUNK))
    vs_mono = {"equal": int((streamed == res.null).sum()), "of": N_PERM,
               "max_abs_diff": float((streamed - res.null).abs().max())}
    stream_diag = {"chunk_250_vs_monolithic": vs_mono,
                   "chunk_250_vs_local_chunk_250_bit_equal": torch.equal(streamed, local_stream),
                   "chunk_1024_vs_monolithic_bit_equal": torch.equal(nulls(events_1024),
                                                                     res.null)}
    checks["stream_250_equals_local_stream_250"] = stream_diag[
        "chunk_250_vs_local_chunk_250_bit_equal"]
    checks["stream_250_near_monolithic"] = (
        torch.equal(events[-1].payload.null, streamed) and vs_mono["equal"] >= N_PERM - 1
        and vs_mono["max_abs_diff"] <= 1.0 / m_te + 1e-7)
    checks["stream_1024_equals_monolithic"] = (
        stream_diag["chunk_1024_vs_monolithic_bit_equal"]
        and torch.equal(events_1024[-1].payload.null, res.null))

    # -- the kernels at this path's new shapes against their plain versions ----
    # (launches: the path's at the shape; a window's Gram, centered as the
    # path centers it; the 1,000-wide null of distributed_permutation_binary
    # at one shard and the stream's 256-wide chunks)
    te = plan.te_idx
    k_te, m_te_ = te.shape
    h_te = plan.h[te[:, :, None], te[:, None, :]]
    perms = permutation.permutation_indices(SEED, n, N_PERM, device=dev)
    xw = xs[0] - xs[0].mean(dim=0, keepdim=True)
    err = rel_err(gram(xw), gram_ref(xw))
    kernel_checks = [{"kernel": "gram", "case": f"a window X ({n}, {wp}) f32",
                      "max_abs_err": err[0], "scale": err[1]}]
    shapes = {"gram": [{"x": xw, "max_abs_err": err[0], "launches": sum(
        v for (kn, a), v in by_shape.items() if kn == "gram" and a[:2] == (n, wp))}],
        "hat_apply": [], "foldsolve": []}
    for b_ in (N_PERM, 256):
        yy = y[perms[:b_]].T.contiguous()
        e = hat_errors(plan.h, yy)
        err_h = rel_err(e, hat_apply_ref(plan.h, yy))
        e_te = e[te]
        err_f = rel_err(foldsolve(h_te, e_te, jitter=None), foldsolve_ref(h_te, e_te))
        kernel_checks += [{"kernel": "hat_apply", "case": f"null B={b_}", "max_abs_err": err_h[0],
                           "scale": err_h[1]},
                          {"kernel": "foldsolve", "case": f"null B={b_}", "max_abs_err": err_f[0],
                           "scale": err_f[1]}]
        shapes["hat_apply"].append({"y": yy, "max_abs_err": err_h[0], "launches": sum(
            v for (kn, a), v in by_shape.items() if kn == "hat_apply" and a[:2] == (n, b_))})
        shapes["foldsolve"].append({"e_te": e_te, "max_abs_err": err_f[0], "launches": sum(
            v for (kn, a), v in by_shape.items()
            if kn == "foldsolve" and a[:3] == (k_te, m_te_, b_))})
    for c in kernel_checks:
        c["ok"] = c["max_abs_err"] <= TOL[torch.float32] * c["scale"]

    dist.destroy_process_group()
    store_dir.cleanup()
    launches = {}
    for v in steps.values():
        launches = v if not launches else launch_sum(launches, v)
    strip = lambda d: {k: v for k, v in d.items() if k != "calls"}
    emit({"phase": "distributed", "backend": backend, "world_size": 1,
          "mesh": {"shape": list(mesh.shape), "dims": list(mesh.mesh_dim_names)},
          "N": n, "P": p, "K": folds.k, "lam": lam, "windows": DIST_WINDOWS,
          "window_P": wp, "window_lam": lam_w, "conditions": c8, "n_perm": N_PERM,
          "stream_chunk": DIST_STREAM_CHUNK, "seconds": secs,
          "launches": {k: strip(v) for k, v in steps.items()}, "checks": checks,
          "engine_vs_local": vs_local, "stream": stream_diag, "kernel_checks": kernel_checks,
          "launches_by_shape": {k: [r["launches"] for r in v] for k, v in shapes.items()},
          "searchlight_accuracy": acc.tolist(), "perm_observed": float(perm.observed),
          "perm_p": float(perm.p)})
    print(f"distributed: NCCL at world size 1; seconds "
          f"{ {k: round(v, 4) for k, v in secs.items()} }; launches {strip(launches)}; "
          f"mesh engine against local: {vs_local['equal']} of {N_PERM} equal", flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"distributed: checks failed: {bad} (engine against local: {vs_local}; "
             f"streams: {stream_diag})")
    bad = [c["case"] for c in kernel_checks if not c["ok"]]
    if bad:
        fail(f"distributed: kernels disagree with their plain versions at {bad}")
    for name, val in (("searchlight accuracies", acc), ("RDMs", rdms), ("null", perm.null)):
        if not bool(torch.isfinite(val).all()):
            fail(f"distributed: non-finite {name}")
    if acc.shape != (DIST_WINDOWS,) or rdms.shape != (DIST_WINDOWS, c8, c8):
        fail(f"distributed: shapes {tuple(acc.shape)}, {tuple(rdms.shape)}")
    unlaunched = [k for k, v in shapes.items() for r in v if r["launches"] <= 0]
    if unlaunched:
        fail(f"distributed: no launch at the path's shapes of {unlaunched}")
    return {"launches": launches, "seconds": secs, "plan": plan, "h_te": h_te,
            "shapes": shapes}


def _is_float(text: str) -> bool:
    try:
        float(text)
        return True
    except ValueError:
        return False


def lm_serve_phase(dev):
    """gemma2-2b at full width and depth: serve (prefill + greedy decode), a
    long prefill, the flash kernel against attention_ref in the same model,
    and decode against the forward."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import layers
    from repro_torch.models import model as M

    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model, t_init = timed(lambda: M.init_params(cfg, generator=gen, device=dev))
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    long_prompt = torch.randint(0, cfg.vocab_size, (1, LM_LONG), generator=gen, device=dev)

    # 1. the serving path: prefill, then 64 greedy decode steps
    reset_counts()
    (ids, st), t_serve = timed(lambda: serve.generate(model, prompts, LM_DECODE + 1, cfg))
    launches = counts()
    idle = decode_idle_share(model, prompts, cfg)
    # 2. an 8,192-token prefill: the local layers mask by window and skip tiles
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    (last_long, caches_long), t_long = timed(
        lambda: M.prefill_step(model, {"tokens": long_prompt}, cfg))
    launches_long = dict(_build.LAUNCHES)
    peak_long = torch.cuda.max_memory_allocated()
    del caches_long
    # 3. the same weights on attention_ref, at both lengths, and the yardstick:
    # the same weights in f32 (plain attention), also run on the kernel
    flash = {"short": M.prefill_step(model, {"tokens": prompts}, cfg)[0], "long": last_long}
    replay = long_prompt[:, :LM_REPLAY]
    full, _, _ = M.forward(model, replay, cfg)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = M.Model(cfg32, dev)
    for p32, p in zip(model32.parameters(), model.parameters(), strict=True):
        p32.copy_(p)
    flash32 = {"short": M.prefill_step(model32, {"tokens": prompts}, cfg32)[0],
               "long": M.prefill_step(model32, {"tokens": long_prompt}, cfg32)[0]}
    layers_flash = layers.flash_attention
    layers.flash_attention = attention_ref
    plain = {"short": M.prefill_step(model, {"tokens": prompts}, cfg)[0],
             "long": M.prefill_step(model, {"tokens": long_prompt}, cfg)[0]}
    plain32 = {"short": M.prefill_step(model32, {"tokens": prompts}, cfg32)[0],
               "long": M.prefill_step(model32, {"tokens": long_prompt}, cfg32)[0],
               "replay": M.forward(model32, replay, cfg32)[0]}
    layers.flash_attention = layers_flash
    vs_ref = {}
    for key, name in (("short", f"{LM_BATCH}x{LM_PROMPT}"), ("long", f"1x{LM_LONG}")):
        err, scale = rel_err(flash[key], plain[key])
        yard = rel_err(plain[key], plain32[key])[0]
        err32, scale32 = rel_err(flash32[key], plain32[key])
        tol = max(TOL_LM_YARDSTICK * yard, TOL_LM_F32 * scale)
        vs_ref[name] = {"max_abs_err": err, "scale": scale, "plain_vs_f32": yard,
                        "flash_vs_f32": rel_err(flash[key], plain32[key])[0], "tol": tol,
                        "f32_flash_vs_f32_plain": err32, "f32_scale": scale32,
                        "f32_tol": TOL_LM_F32 * scale32,
                        "ok": (err <= tol and err32 <= TOL_LM_F32 * scale32
                               and bool(torch.isfinite(flash[key]).all()))}
    del flash, flash32, plain
    # 4. the port's decode against its own forward, 256 tokens: bf16 against
    # the yardstick; f32 at 1e-4, at gemma2's window and at one the replay
    # wraps (the local layers' ring buffer)
    dec, decode_flash = decode_replay(model, replay, cfg, dev)
    e_dec, s_dec = rel_err(dec, full)
    yard_dec = rel_err(full, plain32["replay"])[0]
    tol_dec = max(TOL_LM_YARDSTICK * yard_dec, TOL_LM_F32 * s_dec)
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    del full, dec, plain32
    dec_f32 = {}
    for name, c32 in (("f32", cfg32),
                      (f"f32 window {LM_RING_WINDOW}",
                       dataclasses.replace(cfg32, local_window=LM_RING_WINDOW))):
        full32 = M.forward(model32, replay, c32)[0]
        dec32, flash_n = decode_replay(model32, replay, c32, dev)
        e32, s32 = rel_err(dec32, full32)
        decode_flash += flash_n
        dec_f32[name] = {"window": c32.local_window, "max_abs_err": e32, "scale": s32,
                         "tol": TOL_LM_F32 * s32,
                         "argmax_agreement": float((dec32.argmax(-1) == full32.argmax(-1))
                                                   .float().mean()),
                         "ok": e32 <= TOL_LM_F32 * s32 and bool(torch.isfinite(dec32).all())}
        del full32, dec32
    del model32

    out = {"phase": "lm_serve", "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "params": M.count_params(model), "seconds_init": t_init,
           "serve": {"batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": LM_DECODE,
                     "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                     "decode_tokens_per_s": st["tokens_per_s"],
                     "cache_mib": st["cache_bytes"] / 2**20, "seconds": t_serve,
                     "first_ids": ids.flatten()[:16].tolist(), "launches": launches},
           "long_prefill": {"tokens": LM_LONG, "seconds": t_long, "launches": launches_long,
                            "peak_memory_gib": peak_long / 2**30,
                            "logits_gib": LM_LONG * cfg.vocab_size * 4 / 2**30},
           "vs_attention_ref": vs_ref,
           "decode_vs_forward": {"tokens": LM_REPLAY, "max_abs_err": e_dec, "scale": s_dec,
                                 "forward_vs_f32": yard_dec, "tol": tol_dec,
                                 "argmax_agreement": agree, "flash_launches": decode_flash,
                                 **dec_f32},
           "decode_idle": idle}
    emit(out)
    n = cfg.num_layers
    if launches["flash_attention"] != n or launches_long["flash_attention"] != n:
        fail(f"flash_attention launches per prefill: {launches['flash_attention']} and "
             f"{launches_long['flash_attention']}, want {n} (and none in decode)")
    if decode_flash:
        fail(f"decode launched flash_attention {decode_flash} times")
    if ids.shape != (LM_BATCH, LM_DECODE + 1) or not bool(((ids >= 0) &
                                                           (ids < cfg.vocab_size)).all()):
        fail("generated ids out of shape or range")
    bad = [name for name, v in vs_ref.items() if not v["ok"]]
    if bad:
        fail(f"last-position logits disagree with the attention_ref model at {bad}")
    if e_dec > tol_dec:
        fail("decode disagrees with the forward")
    bad = [name for name, v in dec_f32.items() if not v["ok"]]
    if bad:
        fail(f"f32 decode disagrees with the f32 forward at {bad}")
    return model, cfg, launches


def attention_layers(cfg, n_layers=None) -> int:
    """Layers among the first ``n_layers`` (default: all) that run the flash
    kernel in a prefill or forward."""
    kinds = cfg.layer_kinds[:n_layers] if n_layers is not None else cfg.layer_kinds
    return sum(kind in ("attn", "local") for kind in kinds)


def lm_probe_phase(model, cfg, dev, phase="lm_probe"):
    """launch.probe at full width: a point of the residual stream per repeat
    of the layer pattern (gemma2-2b 13, olmoe 16, recurrentgemma 8,
    musicgen 48, llama-vision 8, xlstm 6), an analytical-CV permutation test
    on each (f64). The band tokens are tiled over an audio model's
    codebooks; a vision model gets patch embeddings from the generator."""
    from repro_torch.core import fastcv, folds as folds_mod
    from repro_torch.launch import probe

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    band, y = probe.band_tokens(cfg, PROBE_PER_CLASS, PROBE_SEQ, gen)
    tokens, vision = probe.probe_inputs(cfg, band, gen)
    n = tokens.shape[0]
    folds = folds_mod.kfold(n, PROBE_FOLDS, seed=SEED, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    feats, t_feats = timed(lambda: probe.layerwise_hidden_states(model, tokens, cfg,
                                                                 vision_embeds=vision))
    peak = torch.cuda.max_memory_allocated()
    del vision
    lams = [lam_rule(f.double()) for f in feats]
    results, t_probe = timed(lambda: probe.probe_points(feats, y, folds, lams, N_PERM))
    launches = counts()
    # point 0 on the kernel route against the f64 composite route
    plan = fastcv.prepare(feats[0].double(), folds, lams[0])
    dv_k = fastcv.binary_dvals(plan, y, fused=True)
    dv_c = fastcv.binary_dvals(plan, y, fused=False)
    e_dv, s_dv = rel_err(dv_k, dv_c)
    emit({"phase": phase, "arch": cfg.name, "N": n, "seq": PROBE_SEQ,
          "points": feats.shape[0], "P": feats.shape[2], "dtype": "float64", "K": PROBE_FOLDS,
          "lam": lams, "n_perm": N_PERM,
          "accuracy": [float(r.observed) for r in results],
          "p_value": [float(r.p) for r in results],
          "null_mean": [float(r.null.mean()) for r in results],
          "kernel_vs_composite_point0": {"max_abs_err": e_dv, "scale": s_dv,
                                         "tol": TOL[torch.float64]},
          "hidden_states_peak_memory_gib": peak / 2**30,
          "seconds": {"hidden_states": t_feats, "probes": t_probe}, "launches": launches})
    points = cfg.num_layers // len(cfg.layer_pattern)
    if feats.shape != (points, n, cfg.d_model):
        fail(f"{phase}: probe features of shape {tuple(feats.shape)}")
    if not bool(torch.isfinite(feats).all()):
        fail(f"{phase}: non-finite probe features")
    for r in results:
        if r.null.shape != (N_PERM,) or not bool(torch.isfinite(r.null).all()) \
                or not 0.0 < float(r.p) <= 1.0:
            fail(f"{phase}: probe permutation results out of shape or range")
    want_flash = attention_layers(cfg, points * len(cfg.layer_pattern))
    if launches["flash_attention"] != want_flash:
        fail(f"{phase}: the probe forward launched flash_attention "
             f"{launches['flash_attention']} times, want {want_flash}")
    expect_launches(phase, launches, ("gram", "hat_apply", "foldsolve"))
    if launches["foldsolve"] != launches["hat_apply"]:
        fail(f"{phase}: {launches['foldsolve']} foldsolve launches for "
             f"{launches['hat_apply']} hat_apply launches, want one each per permutation chunk")
    if e_dv > TOL[torch.float64] * s_dv:
        fail(f"{phase}: probe decision values disagree with the f64 composite route")
    return launches


def f32_twin(model, cfg, dev, dtype="float32"):
    """An f32 copy of ``model``'s weights (the yardstick's model), or a copy
    in ``dtype``."""
    from repro_torch.models import model as M

    cfg32 = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    model32 = M.Model(cfg32, dev)
    for p32, p in zip(model32.parameters(), model.parameters(), strict=True):
        p32.copy_(p)
    return model32, cfg32


def on_attention_ref(fn):
    """``fn()`` with the models' attention on attention_ref instead of the
    flash kernel."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers

    kernel = layers.flash_attention
    layers.flash_attention = attention_ref
    try:
        return fn()
    finally:
        layers.flash_attention = kernel


class Routing:
    """moe.route's discrete decisions (experts, slots, kept choices) recorded
    in one run and imposed on the runs compared with it. With random weights
    a router's top-k choices and the capacity drops that follow from them
    flip under any perturbation (a bf16 rounding, another summation order):
    a flip is a discontinuity that no tolerance bounds, and it hides what the
    comparison is there to see. Imposed, each run routes every token alike
    and computes its own gates from its own router probabilities; its own
    route still runs beside, and what it would have picked is kept
    (``imposed`` yields the list) for ``flips``."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.models import moe

        route = moe.route

        def record(p, x, c):
            out = route(p, x, c)
            self.calls.append(out[1:4])
            return out

        moe.route = record
        try:
            yield
        finally:
            moe.route = route

    @contextlib.contextmanager
    def imposed(self, decode_layers=None):
        """Impose the recorded calls in order; with ``decode_layers`` (L) the
        record is one forward over T tokens and the run T decode steps: call j
        takes layer j % L's choices of token j // L, each kept in slot 0.
        Yields a list that gains, per call, the run's own (expert, slot, kept)
        and the imposed expert."""
        from repro_torch.models import moe

        route, count, own = moe.route, [0], []

        def impose(p, x, c):
            j = count[0]
            count[0] += 1
            if decode_layers is None:
                expert, slot, kept = self.calls[j]
            else:
                t = j // decode_layers
                expert = self.calls[j % decode_layers][0][:, t:t + 1]
                slot, kept = torch.zeros_like(expert), torch.ones_like(expert, dtype=torch.bool)
            own.append((*route(p, x, c)[1:4], expert))
            gates = torch.softmax(x.float() @ p.router, dim=-1).gather(-1, expert)
            # the aux loss of an imposed run is not compared: zero
            return (gates / gates.sum(dim=-1, keepdim=True), expert, slot, kept,
                    torch.zeros((), device=x.device))

        moe.route = impose
        try:
            yield own
        finally:
            moe.route = route


def flips(own) -> tuple:
    """(token-layer pairs, pairs whose own top-k expert set differs from the
    imposed one) over ``Routing.imposed``'s list."""
    pairs = flipped = 0
    for expert, _, _, want in own:
        d = (expert.sort(dim=-1).values != want.sort(dim=-1).values).any(dim=-1)
        pairs, flipped = pairs + d.numel(), flipped + int(d.sum())
    return pairs, flipped


def routed(pin, fn, own=None, **kw):
    """``fn()`` with ``pin``'s routing imposed (no pin: as it comes); the run's
    own picks extend ``own``."""
    if pin is None:
        return fn()
    with pin.imposed(**kw) as picks:
        out = fn()
    if own is not None:
        own.extend(picks)
    return out


def versus_attention_ref(model, cfg, model32, cfg32, batches: dict) -> dict:
    """Last-position logits of each prefill batch ({"tokens"}, with
    "vision_embeds" for a vision model) on the flash kernel against the
    same weights on attention_ref, within TOL_LM_YARDSTICK × the plain bf16
    model's distance from the plain f32 one (as lm_serve holds gemma2-2b);
    the f32 copy on the kernel against attention_ref at TOL_LM_F32. An MoE
    trunk's four runs take the bf16 kernel run's routing (``Routing``)."""
    from repro_torch.models import model as M

    out = {}
    for name, batch in batches.items():
        pin = Routing() if cfg.moe_experts else None
        if pin is None:
            flash = M.prefill_step(model, batch, cfg)[0]
        else:
            with pin.recording():
                flash = M.prefill_step(model, batch, cfg)[0]
        runs = {"flash32": lambda: M.prefill_step(model32, batch, cfg32)[0],
                "plain": lambda: on_attention_ref(
                    lambda: M.prefill_step(model, batch, cfg)[0]),
                "plain32": lambda: on_attention_ref(
                    lambda: M.prefill_step(model32, batch, cfg32)[0])}
        got = {k: routed(pin, fn) for k, fn in runs.items()}
        err, scale = rel_err(flash, got["plain"])
        yard = rel_err(got["plain"], got["plain32"])[0]
        err32, scale32 = rel_err(got["flash32"], got["plain32"])
        tol = max(TOL_LM_YARDSTICK * yard, TOL_LM_F32 * scale)
        out[name] = {"max_abs_err": err, "scale": scale, "plain_vs_f32": yard,
                     "flash_vs_f32": rel_err(flash, got["plain32"])[0], "tol": tol,
                     "f32_flash_vs_f32_plain": err32, "f32_scale": scale32,
                     "f32_tol": TOL_LM_F32 * scale32,
                     "argmax_agreement": float((flash.argmax(-1) == got["plain"].argmax(-1))
                                               .float().mean()),
                     "ok": (err <= tol and err32 <= TOL_LM_F32 * scale32
                            and bool(torch.isfinite(flash).all()))}
        if pin is not None:
            out[name]["routing"] = "imposed from the bf16 kernel run"
            out[name]["dropped_choices_per_layer"] = [int((~kept).sum())
                                                      for _, _, kept in pin.calls]
        del flash, got
    return out


def decode_versus_forward(model, cfg, model32, cfg32, tokens, dev, f32: bool,
                          vision=None) -> dict:
    """Decode every position of ``tokens`` (1, T) (or (1, K, T); a vision
    model's cross caches from a prefill with ``vision``, see
    ``decode_replay``) from empty caches against the
    model's own forward: bf16 within TOL_LM_YARDSTICK × the forward's
    distance from the f32 copy's forward on attention_ref; with ``f32`` also
    the f32 copy's decode against its forward at TOL_LM_F32. An MoE trunk's
    runs take the bf16 forward's routing (``Routing``); decode's own route
    runs beside, and its picks must differ from the forward's in no more
    than TOL_LM_YARDSTICK × the share of (token, layer) pairs where the f32
    forward's own picks differ, with every choice kept in slot 0 (capacity
    at S = 1); then ``moe_free_decode``."""
    from repro_torch.models import model as M

    pin = Routing() if cfg.moe_experts else None
    vis = {"vision_embeds": vision}
    if pin is None:
        full = M.forward(model, tokens, cfg, **vis)[0]
    else:
        with pin.recording():
            full = M.forward(model, tokens, cfg, **vis)[0]
    steps = {"decode_layers": cfg.num_layers} if pin is not None else {}
    own32, own_dec = [], []
    ref32 = routed(pin, lambda: on_attention_ref(
        lambda: M.forward(model32, tokens, cfg32, **vis)[0]), own=own32)
    (dec, flash_n), secs = timed(lambda: routed(
        pin, lambda: decode_replay(model, tokens, cfg, dev, vision), own=own_dec, **steps))
    err, scale = rel_err(dec, full)
    yard = rel_err(full, ref32)[0]
    tol = max(TOL_LM_YARDSTICK * yard, TOL_LM_F32 * scale)
    out = {"tokens": tokens.shape[-1], "max_abs_err": err, "scale": scale,
           "forward_vs_f32": yard, "tol": tol, "seconds": secs,
           "tokens_per_s": tokens.shape[-1] / secs,
           "argmax_agreement": float((dec.argmax(-1) == full.argmax(-1)).float().mean()),
           "ok": err <= tol and bool(torch.isfinite(dec).all())}
    if pin is not None:
        pairs, flipped = flips(own_dec)
        pairs32, flipped32 = flips(own32)
        share_tol = max(TOL_LM_YARDSTICK * flipped32 / pairs32, 1 / pairs)
        slot0 = all(not bool(slot.any()) and bool(kept.all()) for _, slot, kept, _ in own_dec)
        out["routing"] = "imposed from the bf16 forward"
        out["decode_own_routing"] = {
            "pairs": pairs, "flipped": flipped, "share": flipped / pairs,
            "f32_forward_flipped": flipped32, "f32_forward_share": flipped32 / pairs32,
            "tol_share": share_tol, "all_kept_in_slot_0": slot0,
            "ok": flipped / pairs <= share_tol and slot0}
        out["ok"] = out["ok"] and out["decode_own_routing"]["ok"]
    del full, ref32, dec
    if f32:
        full32 = routed(pin, lambda: M.forward(model32, tokens, cfg32, **vis)[0])
        dec32, n32 = routed(pin, lambda: decode_replay(model32, tokens, cfg32, dev, vision),
                            **steps)
        e32, s32 = rel_err(dec32, full32)
        flash_n += n32
        out["f32"] = {"max_abs_err": e32, "scale": s32, "tol": TOL_LM_F32 * s32,
                      "argmax_agreement": float((dec32.argmax(-1) == full32.argmax(-1))
                                                .float().mean()),
                      "ok": e32 <= TOL_LM_F32 * s32 and bool(torch.isfinite(dec32).all())}
        out["ok"] = out["ok"] and out["f32"]["ok"]
        del full32, dec32
    if pin is not None:
        out["f32_free"], n32 = moe_free_decode(model32, cfg32, tokens[:, :MOE_FREE_REPLAY], dev)
        flash_n += n32
        out["ok"] = out["ok"] and out["f32_free"]["ok"]
    out["flash_launches"] = flash_n
    return out


def moe_free_decode(model32, cfg32, tokens, dev) -> tuple:
    """The f32 copy's decode over ``tokens`` (1, T) with its own routing (top-k,
    the S = 1 capacity, slots, kept mask, gates) against its forward, both
    routed freely: logits within TOL_LM_F32 at every token before the first
    one whose experts differ from the forward's at some layer (an f32 near
    tie; all T tokens without one), and at least half the tokens compared.
    Returns (the comparison, flash launches)."""
    from repro_torch.models import model as M

    fwd, dec = Routing(), Routing()
    with fwd.recording():
        full = M.forward(model32, tokens, cfg32)[0]
    with dec.recording():
        out, n = decode_replay(model32, tokens, cfg32, dev)
    n_layers, flipped, slot0 = cfg32.num_layers, [], True
    for j, (expert, slot, kept) in enumerate(dec.calls):
        t, layer = divmod(j, n_layers)
        want = fwd.calls[layer][0][:, t:t + 1]
        if not torch.equal(expert.sort(dim=-1).values, want.sort(dim=-1).values):
            flipped.append(t)
        slot0 = slot0 and not bool(slot.any()) and bool(kept.all())
    first = min(flipped, default=tokens.shape[1])
    err, scale = rel_err(out[:, :first], full[:, :first]) if first else (float("nan"), 0.0)
    return {"tokens": tokens.shape[1], "pairs": len(dec.calls), "flipped": len(flipped),
            "tokens_compared": first, "max_abs_err": err, "scale": scale,
            "tol": TOL_LM_F32 * scale, "all_kept_in_slot_0": slot0,
            "ok": (2 * first >= tokens.shape[1] and err <= TOL_LM_F32 * scale and slot0
                   and bool(torch.isfinite(out).all()))}, n


def no_drop(cfg):
    """``cfg`` at the MoE capacity factor E/k: capacity S, no choice dropped,
    so decode (which never drops) equals the forward."""
    return dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)


def lm_moe_phase(dev):
    """olmoe-1b-7b at full width and depth: serve.generate (4 × 2,048 + 64
    greedy steps), an 8,192-token prefill (two dispatch groups of 4,096), both
    against attention_ref and the f32 yardstick, the dropped choices per
    layer, decode against the forward at the no-drop factor; then its probe."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config(LM_MOE_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model, t_init = timed(lambda: M.init_params(cfg, generator=gen, device=dev))
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    long_prompt = torch.randint(0, cfg.vocab_size, (1, LM_LONG), generator=gen, device=dev)
    n_attn = attention_layers(cfg)

    reset_counts()
    (ids, st), t_serve = timed(lambda: serve.generate(model, prompts, LM_DECODE + 1, cfg))
    launches = counts()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    (last_long, caches_long), t_long = timed(
        lambda: M.prefill_step(model, {"tokens": long_prompt}, cfg))
    launches_long = dict(_build.LAUNCHES)
    peak_long = torch.cuda.max_memory_allocated()
    del caches_long, last_long
    model32, cfg32 = f32_twin(model, cfg, dev)
    vs_ref = versus_attention_ref(model, cfg, model32, cfg32,
                                  {f"{LM_BATCH}x{LM_PROMPT}": {"tokens": prompts},
                                   f"1x{LM_LONG}": {"tokens": long_prompt}})
    drops = vs_ref[f"{LM_BATCH}x{LM_PROMPT}"]["dropped_choices_per_layer"]
    dec = decode_versus_forward(model, no_drop(cfg), model32, no_drop(cfg32),
                                long_prompt[:, :LM_REPLAY], dev, f32=False)
    del model32
    e, k = cfg.moe_experts, cfg.moe_top_k
    emit({"phase": "lm_moe", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "head_dim": cfg.head_dim, "experts": e, "top_k": k, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "dtype": cfg.dtype, "params": M.count_params(model),
          "seconds_init": t_init,
          "serve": {"batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": LM_DECODE,
                    "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                    "decode_tokens_per_s": st["tokens_per_s"],
                    "cache_mib": st["cache_bytes"] / 2**20, "seconds": t_serve,
                    "first_ids": ids.flatten()[:16].tolist(), "launches": launches},
          "long_prefill": {"tokens": LM_LONG, "dispatch_groups": LM_LONG // 4096,
                           "seconds": t_long, "launches": launches_long,
                           "peak_memory_gib": peak_long / 2**30},
          "dropped_choices_per_layer": {
              "tokens": f"{LM_BATCH}x{LM_PROMPT}", "capacity_factor": cfg.moe_capacity_factor,
              "capacity": int(LM_PROMPT * k * cfg.moe_capacity_factor / e),
              "choices_per_layer": LM_BATCH * LM_PROMPT * k, "dropped": drops},
          "vs_attention_ref": vs_ref,
          "decode_vs_forward": {"capacity_factor": e / k, **dec}})
    if launches["flash_attention"] != n_attn or launches_long["flash_attention"] != n_attn:
        fail(f"lm_moe: flash_attention launches per prefill {launches['flash_attention']} and "
             f"{launches_long['flash_attention']}, want {n_attn} (and none in decode)")
    if dec["flash_launches"]:
        fail(f"lm_moe: decode launched flash_attention {dec['flash_launches']} times")
    if ids.shape != (LM_BATCH, LM_DECODE + 1) or not bool(((ids >= 0) &
                                                           (ids < cfg.vocab_size)).all()):
        fail("lm_moe: generated ids out of shape or range")
    if len(drops) != cfg.num_layers:
        fail(f"lm_moe: {len(drops)} MoE dispatches counted in one prefill, want "
             f"{cfg.num_layers}")
    bad = [name for name, v in vs_ref.items() if not v["ok"]]
    if bad:
        fail(f"lm_moe: last-position logits disagree with the attention_ref model at {bad}")
    if not dec["ok"]:
        fail("lm_moe: decode disagrees with the forward at the no-drop factor")
    launches_probe = lm_probe_phase(model, cfg, dev, phase="lm_moe_probe")
    return launches, launches_probe


def lm_qwen_phase(dev):
    """qwen3-moe-30b-a3b at full width (32 / 4 heads of 128, 128 experts top-8,
    d_ff 768, vocabulary 151,936), cut to QWEN_LAYERS layers: one 4 × 2,048
    prefill against attention_ref and the f32 yardstick, decode against the
    forward over QWEN_REPLAY tokens at the no-drop factor."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(LM_QWEN_ARCH), num_layers=QWEN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    model, t_init = timed(lambda: M.init_params(cfg, generator=gen, device=dev))
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    replay = torch.randint(0, cfg.vocab_size, (1, QWEN_REPLAY), generator=gen, device=dev)
    n_attn = attention_layers(cfg)
    reset_counts()
    (_, caches), t_prefill = timed(lambda: M.prefill_step(model, {"tokens": prompts}, cfg))
    launches = counts()
    del caches
    model32, cfg32 = f32_twin(model, cfg, dev)
    vs_ref = versus_attention_ref(model, cfg, model32, cfg32,
                                  {f"{LM_BATCH}x{LM_PROMPT}": {"tokens": prompts}})
    drops = vs_ref[f"{LM_BATCH}x{LM_PROMPT}"]["dropped_choices_per_layer"]
    dec = decode_versus_forward(model, no_drop(cfg), model32, no_drop(cfg32), replay, dev,
                                f32=False)
    # what one more layer would add: its bf16 and f32 weights and the f32
    # copy's prefill K/V
    layer_bytes = sum(q.numel() * q.element_size() for m in (model, model32)
                      for q in m.blocks.layers[0].parameters()) + \
        2 * LM_BATCH * LM_PROMPT * cfg.num_kv_heads * cfg.head_dim * 4
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    total = torch.cuda.mem_get_info()[1]
    del model32
    e, k = cfg.moe_experts, cfg.moe_top_k
    emit({"phase": "lm_moe_qwen3", "arch": cfg.name,
          "memory": {"peak_allocated_gib": peak / 2**30, "peak_reserved_gib": reserved / 2**30,
                     "card_gib": total / 2**30, "gib_per_layer": layer_bytes / 2**30,
                     "more_layers_that_fit": int((total - reserved) // layer_bytes)},
          "layers": [cfg.num_layers, get_config(LM_QWEN_ARCH).num_layers],
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "head_dim": cfg.head_dim, "experts": e, "top_k": k, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "dtype": cfg.dtype, "params": M.count_params(model),
          "seconds_init": t_init,
          "prefill": {"tokens": f"{LM_BATCH}x{LM_PROMPT}", "seconds": t_prefill,
                      "launches": launches},
          "dropped_choices_per_layer": {
              "capacity": int(LM_PROMPT * k * cfg.moe_capacity_factor / e),
              "choices_per_layer": LM_BATCH * LM_PROMPT * k, "dropped": drops},
          "vs_attention_ref": vs_ref,
          "decode_vs_forward": {"capacity_factor": e / k, **dec}})
    if launches["flash_attention"] != n_attn or dec["flash_launches"]:
        fail(f"lm_moe_qwen3: flash_attention launches {launches['flash_attention']} per "
             f"prefill (want {n_attn}), {dec['flash_launches']} in decode (want 0)")
    bad = [name for name, v in vs_ref.items() if not v["ok"]]
    if bad or not dec["ok"]:
        fail(f"lm_moe_qwen3: disagrees with the attention_ref model at {bad} or decode "
             f"with the forward (ok={dec['ok']})")
    return launches


def lm_hybrid_phase(dev):
    """recurrentgemma-2b at full width and depth (26 layers: 18 RG-LRU, 8
    local MQA attention): a 4 × 2,048 prefill_step against attention_ref and
    the f32 yardstick, decode from an empty state against the forward over
    256 tokens in bf16 and in f32, serve.generate's refusal; then its
    probe."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config(LM_HYBRID_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    model, t_init = timed(lambda: M.init_params(cfg, generator=gen, device=dev))
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    replay = torch.randint(0, cfg.vocab_size, (1, LM_REPLAY), generator=gen, device=dev)
    n_attn = attention_layers(cfg)
    reset_counts()
    (_, caches), t_prefill = timed(lambda: M.prefill_step(model, {"tokens": prompts}, cfg))
    launches = counts()
    states = sum(c is None for c in caches)
    del caches
    try:
        serve.generate(model, prompts[:, :16], 4, cfg)
        refusal = None
    except ValueError as err:
        refusal = str(err)
    model32, cfg32 = f32_twin(model, cfg, dev)
    vs_ref = versus_attention_ref(model, cfg, model32, cfg32,
                                  {f"{LM_BATCH}x{LM_PROMPT}": {"tokens": prompts}})
    dec = decode_versus_forward(model, cfg, model32, cfg32, replay, dev, f32=True)
    del model32
    emit({"phase": "lm_hybrid", "arch": cfg.name, "layers": cfg.num_layers,
          "kinds": {k: cfg.layer_kinds.count(k) for k in sorted(set(cfg.layer_kinds))},
          "d_model": cfg.d_model, "rnn_width": cfg.rnn_width,
          "heads": [cfg.num_heads, cfg.num_kv_heads], "head_dim": cfg.head_dim,
          "window": cfg.local_window, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "params": M.count_params(model), "seconds_init": t_init,
          "prefill": {"tokens": f"{LM_BATCH}x{LM_PROMPT}", "seconds": t_prefill,
                      "launches": launches, "layers_without_state": states},
          "generate_refusal": refusal, "vs_attention_ref": vs_ref,
          "decode_vs_forward": dec})
    if launches["flash_attention"] != n_attn or dec["flash_launches"]:
        fail(f"lm_hybrid: flash_attention launches {launches['flash_attention']} per prefill "
             f"(want {n_attn}), {dec['flash_launches']} in decode (want 0)")
    if refusal is None or "no recurrent state" not in refusal:
        fail(f"lm_hybrid: serve.generate did not refuse the prefill-state gap: {refusal!r}")
    bad = [name for name, v in vs_ref.items() if not v["ok"]]
    if bad:
        fail(f"lm_hybrid: last-position logits disagree with the attention_ref model at {bad}")
    if not dec["ok"]:
        fail("lm_hybrid: decode from an empty state disagrees with the forward")
    launches_probe = lm_probe_phase(model, cfg, dev, phase="lm_hybrid_probe")
    return launches, launches_probe


@contextlib.contextmanager
def clocked(module, name: str, seconds: list):
    """``module.name`` wrapped so that each call's seconds (synchronized on
    both sides) are appended to ``seconds``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        out, secs = timed(lambda: fn(*args, **kwargs))
        seconds.append(secs)
        return out

    setattr(module, name, wrapper)
    try:
        yield seconds
    finally:
        setattr(module, name, fn)


def lm_audio_phase(dev):
    """musicgen-medium at full width and depth (48 layers, 24 MHA heads of 64,
    d_model 1,536, 4 codebooks of 2,048, layernorm, gelu, sinusoidal
    positions): serve.generate on 4 × 4 codebooks × 2,048 prompt tokens + 64
    greedy steps, the prefill against attention_ref and the f32 yardstick,
    decode against the forward over 256 tokens in bf16 and f32; then its
    probe."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config(LM_AUDIO_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    model, t_init = timed(lambda: M.init_params(cfg, generator=gen, device=dev))
    k = cfg.num_codebooks
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, k, LM_PROMPT), generator=gen,
                            device=dev)
    replay = torch.randint(0, cfg.vocab_size, (1, k, LM_REPLAY), generator=gen, device=dev)
    n_attn = attention_layers(cfg)
    reset_counts()
    (ids, st), t_serve = timed(lambda: serve.generate(model, prompts, LM_DECODE + 1, cfg))
    launches = counts()
    model32, cfg32 = f32_twin(model, cfg, dev)
    name = f"{LM_BATCH}x{k}x{LM_PROMPT}"
    vs_ref = versus_attention_ref(model, cfg, model32, cfg32, {name: {"tokens": prompts}})
    dec = decode_versus_forward(model, cfg, model32, cfg32, replay, dev, f32=True)
    del model32
    emit({"phase": "lm_audio", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "head_dim": cfg.head_dim, "codebooks": k, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "params": M.count_params(model), "seconds_init": t_init,
          "serve": {"batch": LM_BATCH, "codebooks": k, "prompt": LM_PROMPT,
                    "decode_steps": LM_DECODE, "prefill_s": st["prefill_s"],
                    "decode_s": st["decode_s"], "decode_tokens_per_s": st["tokens_per_s"],
                    "cache_mib": st["cache_bytes"] / 2**20, "seconds": t_serve,
                    "first_ids": ids[0, :, :4].tolist(), "launches": launches},
          "vs_attention_ref": vs_ref, "decode_vs_forward": dec})
    if launches["flash_attention"] != n_attn or dec["flash_launches"]:
        fail(f"lm_audio: flash_attention launches {launches['flash_attention']} in generate "
             f"(want {n_attn}, all in its prefill), {dec['flash_launches']} in decode (want 0)")
    if ids.shape != (LM_BATCH, k, LM_DECODE + 1) or not bool(((ids >= 0) &
                                                              (ids < cfg.vocab_size)).all()):
        fail(f"lm_audio: generated ids of shape {tuple(ids.shape)} or out of range")
    if not vs_ref[name]["ok"]:
        fail("lm_audio: last-position logits disagree with the attention_ref model")
    if not dec["ok"]:
        fail("lm_audio: decode disagrees with the forward")
    launches_probe = lm_probe_phase(model, cfg, dev, phase="lm_audio_probe")
    return launches, launches_probe


def lm_vision_phase(dev):
    """llama-3.2-vision-11b at full width and depth (32 self-attention layers,
    GQA 32 / 8 heads of 128, 8 gated cross layers; d_model 4,096, d_ff
    14,336, vocabulary 128,256; 1,600 patch embeddings of width 1,280), the
    gates planted non-zero: serve.generate (4 × 2,048 + 64 greedy steps), a
    timed prefill_step (the cross route's seconds apart, the cross caches'
    shape), the prefill against attention_ref and the f32 yardstick, decode
    against the forward over 256 tokens from caches whose cross K/V come
    from the prefill, in bf16 and f32; then its probe."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import layers
    from repro_torch.models import model as M

    cfg = get_config(LM_VISION_ARCH)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    model, t_init = timed(lambda: M.init_params(cfg, generator=gen, device=dev))
    cross = [blk for blk in model.blocks.layers if blk.kind == "cross"]
    for blk in cross:                 # planted: at 0 every cross layer is the identity
        blk.gate_attn.fill_(VISION_GATES[0])
        blk.gate_mlp.fill_(VISION_GATES[1])
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    vision = torch.randn((LM_BATCH, cfg.vision_tokens, cfg.vision_dim), generator=gen,
                         device=dev)
    replay = torch.randint(0, cfg.vocab_size, (1, LM_REPLAY), generator=gen, device=dev)
    vision_replay = torch.randn((1, cfg.vision_tokens, cfg.vision_dim), generator=gen,
                                device=dev)
    n_attn = attention_layers(cfg)
    batch = {"tokens": prompts, "vision_embeds": vision}
    reset_counts()
    (ids, st), t_serve = timed(lambda: serve.generate(model, prompts, LM_DECODE + 1, cfg,
                                                      vision_embeds=vision))
    launches = counts()
    reset_counts()
    with clocked(layers, "cross_attention", []) as cross_s:
        (_, pre), t_prefill = timed(lambda: M.prefill_step(model, batch, cfg))
    launches_prefill = counts()
    placed = serve.place_prefill(cfg, pre, LM_BATCH, LM_PROMPT + LM_DECODE + 1)
    cross_caches = sorted({(tuple(c["k"].shape), str(c["k"].dtype), tuple(sorted(c)))
                           for kind, c in zip(cfg.layer_kinds, placed) if kind == "cross"})
    cross_placed = all(torch.equal(c["k"], p["k"]) and torch.equal(c["v"], p["v"])
                       for kind, c, p in zip(cfg.layer_kinds, placed, pre) if kind == "cross")
    del pre, placed
    model32, cfg32 = f32_twin(model, cfg, dev)
    name = f"{LM_BATCH}x{LM_PROMPT}"
    vs_ref = versus_attention_ref(model, cfg, model32, cfg32, {name: batch})
    dec = decode_versus_forward(model, cfg, model32, cfg32, replay, dev, f32=True,
                                vision=vision_replay)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    del model32
    want_cache = [((LM_BATCH, cfg.vision_tokens, cfg.num_kv_heads, cfg.head_dim),
                   str(getattr(torch, cfg.dtype)), ("k", "v"))]
    emit({"phase": "lm_vision", "arch": cfg.name, "layers": cfg.num_layers,
          "kinds": {k: cfg.layer_kinds.count(k) for k in sorted(set(cfg.layer_kinds))},
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
          "vision": [cfg.vision_tokens, cfg.vision_dim], "gates": VISION_GATES,
          "dtype": cfg.dtype, "params": M.count_params(model), "seconds_init": t_init,
          "memory": {"peak_allocated_gib": peak / 2**30, "peak_reserved_gib": reserved / 2**30,
                     "card_gib": torch.cuda.mem_get_info()[1] / 2**30},
          "serve": {"batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": LM_DECODE,
                    "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                    "decode_tokens_per_s": st["tokens_per_s"],
                    "cache_mib": st["cache_bytes"] / 2**20, "seconds": t_serve,
                    "first_ids": ids.flatten()[:16].tolist(), "launches": launches},
          "prefill": {"tokens": name, "seconds": t_prefill, "launches": launches_prefill,
                      "cross_attention_s": sum(cross_s), "cross_calls": len(cross_s),
                      "cross_caches": cross_caches, "cross_placed": cross_placed},
          "vs_attention_ref": vs_ref, "decode_vs_forward": dec})
    if launches["flash_attention"] != n_attn or launches_prefill["flash_attention"] != n_attn \
            or dec["flash_launches"]:
        fail(f"lm_vision: flash_attention launches {launches['flash_attention']} in generate and "
             f"{launches_prefill['flash_attention']} per prefill (want {n_attn}: the self-"
             f"attention layers), {dec['flash_launches']} in decode (want 0)")
    if len(cross_s) != len(cross) or cross_caches != want_cache or not cross_placed:
        fail(f"lm_vision: {len(cross_s)} cross routes per prefill (want {len(cross)}), cross "
             f"caches {cross_caches} (want {want_cache} unquantized), placed {cross_placed}")
    if ids.shape != (LM_BATCH, LM_DECODE + 1) or not bool(((ids >= 0) &
                                                           (ids < cfg.vocab_size)).all()):
        fail("lm_vision: generated ids out of shape or range")
    if not vs_ref[name]["ok"]:
        fail("lm_vision: last-position logits disagree with the attention_ref model")
    if not dec["ok"]:
        fail("lm_vision: decode from the prefill's cross caches disagrees with the forward")
    launches_probe = lm_probe_phase(model, cfg, dev, phase="lm_vision_probe")
    return launches, launches_probe


def lm_xlstm_phase(dev):
    """xlstm-125m at full width and depth (12 layers, 6 mLSTM and 6 sLSTM, 4
    heads; d_model 768; vocabulary 50,304; tied embeddings): a 4 × 2,048
    prefill_step (8 mLSTM chunks of 256; the sLSTM scan's seconds apart),
    the card's f32 forward against the same weights' f32 forward on the CPU
    at 1 × 2,048, the chunkwise forward at 2,048 against the one-chunk
    (masked-quadratic) forward at 2,000 on their shared prefix, decode from
    an empty state against the forward over 256 tokens in bf16 and f32,
    serve.generate's refusal; then its probe."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import xlstm

    cfg = get_config(LM_XLSTM_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    model, t_init = timed(lambda: M.init_params(cfg, generator=gen, device=dev))
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    replay = torch.randint(0, cfg.vocab_size, (1, LM_REPLAY), generator=gen, device=dev)
    reset_counts()
    with clocked(xlstm, "slstm_scan", []) as scan_s:
        (_, caches), t_prefill = timed(lambda: M.prefill_step(model, {"tokens": prompts}, cfg))
    launches = counts()
    states = sum(c is None for c in caches)
    del caches
    try:
        serve.generate(model, prompts[:, :16], 4, cfg)
        refusal = None
    except ValueError as err:
        refusal = str(err)
    model32, cfg32 = f32_twin(model, cfg, dev)
    # the card's f32 forward against the CPU's, the same f32 weights
    one = prompts[:1]
    card32, t_card32 = timed(lambda: M.forward(model32, one, cfg32)[0])
    model_cpu = M.Model(cfg32, "cpu")
    for pc, p in zip(model_cpu.parameters(), model32.parameters(), strict=True):
        pc.copy_(p)
    t0 = time.perf_counter()
    cpu32 = M.forward(model_cpu, one.cpu(), cfg32)[0]
    t_cpu32 = time.perf_counter() - t0
    del model_cpu
    e_cpu, s_cpu = rel_err(card32.cpu(), cpu32)
    # chunkwise (8 chunks of 256) against one masked-quadratic chunk
    quad = M.forward(model32, one[:, :XLSTM_QUADRATIC], cfg32)[0]
    e_q, s_q = rel_err(card32[:, :XLSTM_QUADRATIC], quad)
    # not a gate: each f32 forward's own distance from the same weights in
    # f64 on the card (the trunk's mLSTM layers amplify f32 rounding ~30×)
    model64, cfg64 = f32_twin(model, cfg, dev, "float64")
    f64 = M.forward(model64, one, cfg64)[0]
    f64_dist = {"card_f32": rel_err(card32, f64)[0], "cpu_f32": rel_err(cpu32, f64.cpu())[0],
                "quadratic_f32": rel_err(quad, f64[:, :XLSTM_QUADRATIC])[0],
                "scale": rel_err(f64, f64)[1]}
    del model64, f64, card32, cpu32, quad
    dec = decode_versus_forward(model, cfg, model32, cfg32, replay, dev, f32=True)
    del model32
    emit({"phase": "lm_xlstm", "arch": cfg.name, "layers": cfg.num_layers,
          "kinds": {k: cfg.layer_kinds.count(k) for k in sorted(set(cfg.layer_kinds))},
          "d_model": cfg.d_model, "heads": cfg.num_heads, "vocab": cfg.vocab_size,
          "dtype": cfg.dtype, "params": M.count_params(model), "seconds_init": t_init,
          "prefill": {"tokens": f"{LM_BATCH}x{LM_PROMPT}", "mlstm_chunks": LM_PROMPT //
                      xlstm.MLSTM_CHUNK, "seconds": t_prefill,
                      "slstm_scan_s": sum(scan_s), "slstm_scans": len(scan_s),
                      "launches": launches, "layers_without_state": states},
          "f32_card_vs_cpu": {"tokens": f"1x{LM_PROMPT}", "max_abs_err": e_cpu, "scale": s_cpu,
                              "tol": TOL_LM_F32 * s_cpu, "card_s": t_card32, "cpu_s": t_cpu32},
          "chunkwise_vs_quadratic": {"tokens": [LM_PROMPT, XLSTM_QUADRATIC],
                                     "max_abs_err": e_q, "scale": s_q, "tol": TOL_LM_F32 * s_q},
          "f32_vs_f64": f64_dist,
          "generate_refusal": refusal, "decode_vs_forward": dec})
    if launches["flash_attention"] or dec["flash_launches"]:
        fail(f"lm_xlstm: flash_attention launched ({launches['flash_attention']} in prefill, "
             f"{dec['flash_launches']} in decode) in a trunk without attention")
    if states != cfg.num_layers or len(scan_s) != cfg.layer_kinds.count("slstm"):
        fail(f"lm_xlstm: {states} layers without prefill state, {len(scan_s)} sLSTM scans")
    if refusal is None or "no recurrent state" not in refusal:
        fail(f"lm_xlstm: serve.generate did not refuse the prefill-state gap: {refusal!r}")
    if e_cpu > TOL_LM_F32 * s_cpu:
        fail("lm_xlstm: the card's f32 forward disagrees with the CPU's")
    if e_q > TOL_LM_F32 * s_q:
        fail("lm_xlstm: the chunkwise mLSTM disagrees with one quadratic chunk")
    if not dec["ok"]:
        fail("lm_xlstm: decode from an empty state disagrees with the forward")
    launches_probe = lm_probe_phase(model, cfg, dev, phase="lm_xlstm_probe")
    return launches, launches_probe


def _train_state(trainer) -> list:
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import steps

    return ckpt.flatten({"params": steps.trainable(trainer.params),
                          "opt_state": trainer.opt_state})


def _grad_norm(grads: dict) -> float:
    return float(torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads.values())))


def train_phase(dev) -> dict:
    """Training on the card. (a) gemma2-2b uncut, bf16, remat: TRAIN_STEPS
    steps of the Trainer on the token stream (checkpoints off), each step's
    seconds, tokens/s, loss, grad norm, lr and flash launches, the peak
    memory; then, from the same seed, step 1's loss and grad norm on
    attention_ref, and on an f32 copy (the yardstick: the kernel's run is
    held to TOL_LM_YARDSTICK × the plain run's distance from it, no floor),
    and two steps on one batch. The kernel at this step's shape is held
    against attention_ref elementwise in ``main``'s ``attn_cases``. (b) The example's xlstm-125m (full width, vocabulary 2,048, f32)
    restarted from a checkpoint against an uninterrupted run."""
    import shutil

    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import steps
    from repro_torch.train.trainer import Trainer, TrainerConfig

    root = Path(__file__).resolve().parent
    cfg = get_config(TRAIN_ARCH)
    opt = O.AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    scfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH, seed=SEED)
    tokens = TRAIN_BATCH * TRAIN_SEQ

    # (a) the Trainer: every launch of its run counted, and per step
    torch.cuda.reset_peak_memory_stats()
    off_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt-", dir=root)   # stays empty
    trainer, t_init = timed(lambda: Trainer(cfg, opt, TrainerConfig(
        total_steps=TRAIN_STEPS, log_every=1, checkpoint_every=10 ** 9,
        checkpoint_dir=off_dir), TokenStream(scfg, device=dev), seed=SEED))
    inner, per_step = trainer._step_fn, []

    def step_counted(*args, **kwargs):
        before = dict(_build.LAUNCHES)
        out = inner(*args, **kwargs)
        per_step.append({k: _build.LAUNCHES[k] - before[k] for k in before})
        return out

    trainer._step_fn = step_counted
    reset_counts()
    summary = trainer.run()
    launches = counts()
    peak = {"allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
    log = summary["log"]
    n_params = M.count_params(trainer.params)
    del trainer, inner
    shutil.rmtree(off_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # step 1 again from the same seed: on attention_ref, and an f32 copy on
    # attention_ref (the yardstick), then two steps on one batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = M.init_params(cfg, generator=gen, device=dev).requires_grad_(True)
    batch = TokenStream(scfg, device=dev).next_batch()
    loss_ref, _, grads = on_attention_ref(lambda: steps.loss_and_grads(model, batch, cfg))
    gn_ref = _grad_norm(grads)
    del grads
    model32, cfg32 = f32_twin(model, cfg, dev)
    model32.requires_grad_(True)
    loss32, _, grads = on_attention_ref(lambda: steps.loss_and_grads(model32, batch, cfg32))
    gn32 = _grad_norm(grads)
    del grads, model32
    torch.cuda.empty_cache()
    state = O.init_opt_state(steps.trainable(model), opt)
    step = steps.make_train_step(cfg, opt)
    same = [{k: float(v) for k, v in step(model, state, batch).items()} for _ in range(2)]
    del model, state
    torch.cuda.empty_cache()

    loss1, gn1 = log[0]["loss"], log[0]["grad_norm"]
    yard = {"loss": abs(float(loss_ref) - float(loss32)), "grad_norm": abs(gn_ref - gn32)}
    tol = {k: TOL_LM_YARDSTICK * v for k, v in yard.items()}
    vs_ref = {"loss": {"flash": loss1, "attention_ref": float(loss_ref), "f32": float(loss32),
                       "err": abs(loss1 - float(loss_ref)), "plain_vs_f32": yard["loss"],
                       "tol": tol["loss"]},
              "grad_norm": {"flash": gn1, "attention_ref": gn_ref, "f32": gn32,
                            "err": abs(gn1 - gn_ref), "plain_vs_f32": yard["grad_norm"],
                            "tol": tol["grad_norm"]}}
    warm = [e["sec"] for e in log[1:]]
    gemma = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
             "vocab": cfg.vocab_size, "params": n_params, "dtype": cfg.dtype,
             "param_dtype": cfg.param_dtype, "remat": cfg.remat, "batch": TRAIN_BATCH,
             "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "lr_peak": TRAIN_LR,
             "seconds_init": t_init, "wall_s": summary["wall_s"],
             "step1_s": log[0]["sec"], "step1_tokens_per_s": tokens / log[0]["sec"],
             "warm_s": warm, "warm_tokens_per_s": tokens / statistics.median(warm),
             "loss": [e["loss"] for e in log], "grad_norm": [e["grad_norm"] for e in log],
             "lr": [e["lr"] for e in log], "ln_vocab": math.log(cfg.vocab_size),
             "skipped": summary["skipped"], "peak_memory": peak,
             "flash_per_step": [d["flash_attention"] for d in per_step],
             "launches_per_step": per_step, "launches": launches,
             "same_batch": {"loss": [m["loss"] for m in same],
                            "grad_norm": [m["grad_norm"] for m in same]},
             "vs_attention_ref": vs_ref}

    # (b) restart on the card: the example's model
    xcfg = dataclasses.replace(get_config("xlstm-125m"), vocab_size=TRAIN_RESTART_VOCAB,
                               dtype="float32", param_dtype="float32")
    xopt = O.AdamWConfig(lr_peak=3e-3, warmup_steps=20, total_steps=2 * TRAIN_RESTART_AT)
    xscfg = TokenStreamConfig(vocab_size=xcfg.vocab_size, seq_len=TRAIN_RESTART_SEQ,
                              global_batch=TRAIN_RESTART_BATCH, seed=SEED)
    ck_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt-", dir=root)

    def xtrainer(total, every, directory):
        return Trainer(xcfg, xopt, TrainerConfig(total_steps=total, log_every=1,
                                                 checkpoint_every=every,
                                                 checkpoint_dir=directory),
                       TokenStream(xscfg, device=dev), seed=SEED)

    try:
        with clocked(ckpt, "_write", []) as write_s, clocked(ckpt, "save_async", []) as snap_s:
            first = xtrainer(TRAIN_RESTART_AT, TRAIN_RESTART_AT, ck_dir)
            r_first = first.run()
        saved = [(n, t.clone()) for n, t in _train_state(first)]
        step_dir = Path(ck_dir) / f"step_{TRAIN_RESTART_AT:08d}"
        ck_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        del first
        with clocked(ckpt, "restore", []) as restore_s:
            resumed = xtrainer(2 * TRAIN_RESTART_AT, TRAIN_RESTART_AT, ck_dir)
        start, cursor = resumed.start_step, resumed.stream.step
        restored_equal = all(torch.equal(t, want) for (_, t), (_, want)
                             in zip(_train_state(resumed), saved, strict=True))
        r_resumed = resumed.run()
        del resumed, saved
        whole = xtrainer(2 * TRAIN_RESTART_AT, 10 ** 9, str(Path(ck_dir) / "whole"))
        r_whole = whole.run()
        del whole
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    got = [e["loss"] for e in r_first["log"] + r_resumed["log"]]
    want = [e["loss"] for e in r_whole["log"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want, strict=True))
    restart = {"arch": xcfg.name, "vocab": xcfg.vocab_size, "batch": TRAIN_RESTART_BATCH,
               "seq": TRAIN_RESTART_SEQ, "restart_at": TRAIN_RESTART_AT,
               "start_step": start, "data_cursor": cursor, "restored_equal": restored_equal,
               "checkpoint_bytes": ck_bytes, "snapshot_s": snap_s, "write_s": write_s,
               "restore_s": restore_s, "losses": got, "uninterrupted": want,
               "max_rel_diff": rel, "tol": TOL_RESTART}
    emit({"phase": "train", "card": nvidia_smi(), "gemma2": gemma, "restart": restart})

    n = cfg.num_layers
    if not all(math.isfinite(x) for x in gemma["loss"] + gemma["grad_norm"]) or summary["skipped"]:
        fail(f"train: non-finite losses or grad norms {gemma['loss']} {gemma['grad_norm']}")
    if abs(loss1 - math.log(cfg.vocab_size)) > TRAIN_LOSS0_BAND:
        fail(f"train: step 1's loss {loss1} is not near ln V = {math.log(cfg.vocab_size)}")
    if not same[1]["loss"] < 1.5 * same[0]["loss"]:
        fail(f"train: the same batch's second loss {same[1]['loss']} is not below 1.5x the "
             f"first {same[0]['loss']}")
    for i, d in enumerate(per_step):
        expect_exact(f"train step {i + 1}", {**d, "calls": {}}, {"flash_attention": 2 * n})
    expect_exact("train", launches, {"flash_attention": 2 * n * TRAIN_STEPS})
    bad = [k for k, v in vs_ref.items() if not v["err"] <= v["tol"]]
    if bad:
        fail(f"train: step 1's {bad} disagree with attention_ref beyond the bf16 yardstick")
    if start != TRAIN_RESTART_AT or cursor != TRAIN_RESTART_AT or not restored_equal:
        fail(f"train: the resumed Trainer started at {start} (cursor {cursor}), restored "
             f"tensors equal: {restored_equal}")
    if not rel <= TOL_RESTART:
        fail(f"train: the resumed losses differ from the uninterrupted run's by {rel}")
    return launches


def dryrun_phase(dev) -> dict:
    """(a) The dry run's cells in two processes at once, each with its
    roofline row; (b) the step counter on the card against a fake CPU
    trace of the same step, and the step's share of bf16 peak."""
    import shutil

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.launch import roofline
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as O
    from repro_torch.train import steps

    root = Path(__file__).resolve().parent
    out_dir = Path(tempfile.mkdtemp(prefix=".chip_smoke_dryrun-", dir=root))
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                               "--out", str(out_dir)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for args in DRYRUN_CELLS]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=DRYRUN_TIMEOUT)[0])
        records = [json.loads(f.read_text()) for f in sorted(out_dir.glob("*.json"))]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    cells = []
    for rec in records:
        cell = {k: rec.get(k) for k in ("arch", "shape", "mesh", "num_chips", "ok", "profile",
                                        "microbatches", "build_s", "trace_s", "error")}
        if rec.get("ok"):
            cell.update(memory=rec["memory"], flops=rec["loop_aware"]["flops"],
                        dot_hbm_bytes=rec["loop_aware"]["dot_hbm_bytes"],
                        collective_bytes=rec["loop_aware"]["collective_bytes"],
                        collective_counts=rec["loop_aware"]["collective_counts"],
                        roofline=roofline.roofline_row(rec))
        cells.append(cell)
    sweep_s = time.perf_counter() - t0

    # (b) one train step of phase train's shape, counted on the card and on
    # fake CPU tensors
    cfg = get_config(TRAIN_ARCH)
    opt = O.AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    scfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH, seed=SEED)
    with FakeTensorMode():
        fmodel = M.Model(cfg, "cpu").requires_grad_(True)
        fstate = O.init_opt_state(steps.trainable(fmodel), opt)
        ftok = torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32)
        fake, fake_s = timed(lambda: analyze_step(steps.make_train_step(cfg, opt), fmodel, fstate,
                                                  {"tokens": ftok, "labels": ftok}))
    del fmodel, fstate
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model, state = steps.init_train_state(cfg, opt, generator=gen, device=dev)
    step = steps.make_train_step(cfg, opt)
    stream = TokenStream(scfg, device=dev)
    reset_counts()
    card, card_s = timed(lambda: analyze_step(step, model, state, stream.next_batch()))
    launches = counts()
    warm = []
    for _ in range(DRYRUN_WARM):
        batch = stream.next_batch()
        torch.cuda.synchronize()
        t = time.perf_counter()
        float(step(model, state, batch)["loss"])
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    del model, state, batch
    torch.cuda.empty_cache()
    warm_s = statistics.median(warm)
    n = roofline.param_count(cfg)
    six_nd = 6 * n * TRAIN_BATCH * TRAIN_SEQ
    opt_bytes = (3 * 2 * 4 + 4 + 2) * n
    keys = ("flops", "dot_hbm_bytes", "collective_total_bytes")
    # the roofline's memory term takes each flash launch at the bytes the
    # kernel moves (bf16 q, k, v, out once each), not attention_ref's f32
    # operands and S x S products, which the count keeps for its equality
    flash = card["flash"]
    kernel_bytes = card["dot_hbm_bytes"] - flash["ref_bytes"] + flash["kernel_bytes"]
    t_compute = card["flops"] / roofline.PEAK_FLOPS
    t_memory = (kernel_bytes + opt_bytes) / roofline.HBM_BW
    counter = {"card": {k: card[k] for k in keys}, "fake_cpu": {k: fake[k] for k in keys},
               "card_s": card_s, "fake_cpu_s": fake_s, "flash_launches": launches,
               "counter_flash": flash, "warm_step_s": warm, "params_meta": n, "six_nd": six_nd,
               "counted_share_of_bf16_peak": card["flops"] / warm_s / roofline.PEAK_FLOPS,
               "six_nd_share_of_bf16_peak": six_nd / warm_s / roofline.PEAK_FLOPS,
               "roofline": {"t_compute_s": t_compute, "t_memory_s": t_memory,
                            "t_memory_attention_ref_bytes_s":
                                (card["dot_hbm_bytes"] + opt_bytes) / roofline.HBM_BW,
                            "dot_bytes_flash_as_kernel": kernel_bytes,
                            "opt_traffic_bytes": opt_bytes,
                            "warm_step_over_bound": warm_s / max(t_compute, t_memory)},
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "peak_flops": roofline.PEAK_FLOPS}
    emit({"phase": "dryrun", "card": nvidia_smi(), "sweep_s": sweep_s, "cells": cells,
          "counter": counter})

    by = {(c["arch"], c["shape"], c["mesh"]): c for c in cells}
    for key in (("gemma2-2b", "train_4k", "16x16"), ("gemma2-2b", "decode_32k", "2x16x16")):
        if key not in by or not by[key]["ok"]:
            fail(f"dryrun: {key} did not trace: {by.get(key, {}).get('error')}\n"
                 f"{''.join(logs)[-3000:]}")
    if ("olmoe-1b-7b", "train_4k", "16x16") not in by:
        fail("dryrun: the olmoe-1b-7b cell wrote no record")
    if counter["card"] != counter["fake_cpu"]:
        fail(f"dryrun: the card's count {counter['card']} is not the fake CPU trace's "
             f"{counter['fake_cpu']}")
    expect_exact("dryrun counted step", {**launches, "calls": {}},
                 {"flash_attention": 2 * cfg.num_layers})
    if flash["launches"] != launches.get("flash_attention"):
        fail(f"dryrun: the counter saw {flash['launches']} flash launches, the kernel's "
             f"count is {launches.get('flash_attention')}")
    return launches


def lint_phase() -> None:
    """``python -m repro_torch.analysis`` (reprolint for the port) over the
    port's tree, as a process on this machine's Python."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    proc, secs = timed(lambda: subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json"], cwd=root, env=env,
        capture_output=True, text=True, timeout=300))
    try:
        count = json.loads(proc.stdout)["count"]
    except (ValueError, KeyError):
        count = None
    emit({"phase": "lint", "python": sys.version.split()[0], "returncode": proc.returncode,
          "findings": count, "seconds": secs})
    if proc.returncode != 0:
        fail(f"lint: python -m repro_torch.analysis exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    from repro_torch.core import fastcv, folds as folds_mod, lda, metrics
    from repro_torch.core import multiclass, permutation, regression
    from repro_torch.data import eeg
    from repro_torch.kernels import _build
    from repro_torch.kernels.fold_eval.fold_eval import fold_eval_cuda
    from repro_torch.kernels.fold_eval.ops import fold_eval
    from repro_torch.kernels.fold_eval.ref import fold_eval_checked_ref, fold_eval_ref
    from repro_torch.kernels.foldsolve.foldsolve import foldsolve_cuda
    from repro_torch.kernels.foldsolve.ops import (fold_jitter,
                                                   fold_residual_bad, foldsolve)
    from repro_torch.kernels.foldsolve.ref import foldsolve_checked_ref, foldsolve_ref
    from repro_torch.kernels.gram.gram import gram_cuda
    from repro_torch.kernels.gram.ops import centered_gram_plain, gram
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.hat_apply.ops import hat_errors
    from repro_torch.kernels.hat_apply.ref import hat_apply_ref
    from repro_torch.kernels.flash_attention.flash_attention import ROUTES
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.pairdist.ops import pairwise_sq_dists
    from repro_torch.kernels.pairdist.pairdist import S_MAX_C as PD_S_MAX_C
    from repro_torch.kernels.pairdist.pairdist import pairdist_cuda, pairdist_route
    from repro_torch.kernels.pairdist.ref import pairwise_sq_dists_ref
    from repro_torch.kernels.permdraw.ops import permdraw
    from repro_torch.kernels.permdraw.ref import permdraw_ref
    from repro_torch.rsa import compare as rsa_compare
    from repro_torch.rsa import rdm as rsa_rdm

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    count_fold_calls()

    # -- 1. environment ------------------------------------------------------
    # the library yardsticks (torch.mm, addmm) must run full f32 cuBLAS, not TF32
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    f32_precision = torch.get_float32_matmul_precision()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "matmul_allow_tf32": matmul_tf32, "float32_matmul_precision": f32_precision})
    if matmul_tf32 or f32_precision != "highest":
        fail(f"f32 matmuls are not full f32 (allow_tf32={matmul_tf32}, "
             f"precision={f32_precision!r}): the library times would be TF32")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln] if log.is_file() else []
    # flash_attention's bf16 route must run on the tensor cores (HGMMA in its
    # SASS) with no register spills at any head width
    flash_lib = paths["flash_attention"]
    hgmma = sass_count(flash_lib, "HGMMA")
    flash_tc = {int(re.search(r"ILi(\d+)E", k).group(1)): v for k, v in
                ptxas_report(flash_lib.with_suffix(".log").read_text()).items()
                if "flash_tc_kernel" in k}
    # gram's f32 and bf16 routes and hat_apply's f32 route run on the tensor
    # cores: TF32 (and, for gram's bf16 input, BF16) HGMMA in their SASS, and
    # no spill in those instantiations
    # (pairdist's many-pattern route runs gram's passes: the same checks)
    tc_libs, dmma_libs = {}, {}
    for name, kernel, dmma_kernel in (("gram", "upper_gram_tc_kernel", "upper_gram_dmma_kernel"),
                                      ("hat_apply", "hat_apply_tc_kernel",
                                       "hat_apply_dmma_kernel"),
                                      ("pairdist", "upper_gram_tc_kernel",
                                       "upper_gram_dmma_kernel")):
        lib = paths[name]
        sass = sass_text(lib)
        report = ptxas_report(lib.with_suffix(".log").read_text())
        tc_libs[name] = {
            "hgmma_tf32": len(re.findall(r"\bHGMMA\.\S*TF32", sass)),
            "hgmma_bf16": len(re.findall(r"\bHGMMA\.\S*BF16", sass)),
            "ptxas": {k: v for k, v in report.items() if kernel in k}}
        # the f64 route runs on the FP64 tensor cores: DMMA in its kernel's
        # SASS, and no spill
        dmma_libs[name] = {
            "dmma": sum(len(re.findall(r"\bDMMA\b", body))
                        for fn, body in sass_functions(sass).items() if dmma_kernel in fn),
            "ptxas": {k: v for k, v in report.items() if dmma_kernel in k}}
    # foldsolve and fold_eval: f32 and f64, each on the register route and on
    # the shared/global-memory route; none may spill
    fold_ptxas = {name: {k: v for k, v in ptxas_report(
        paths[name].with_suffix(".log").read_text()).items() if f"{name}_kernel" in k}
        for name in ("foldsolve", "fold_eval")}
    # pairdist: every instantiation of both routes (route S's two passes,
    # route T's first passes and its distance reduce); none may spill
    pairdist_ptxas = ptxas_report(paths["pairdist"].with_suffix(".log").read_text())
    emit({"phase": "build", "seconds": build_s, "hash": _build.source_hash(),
          "ptxas": ptxas, "flash_hgmma": hgmma, "flash_tensor_core_ptxas": flash_tc,
          "tensor_core_routes": tc_libs, "fp64_tensor_core_routes": dmma_libs,
          "fold_kernels_ptxas": fold_ptxas, "pairdist_ptxas": pairdist_ptxas})
    pd_kinds = {kind: sum(kind in k for k in pairdist_ptxas) for kind in (
        "pairdist_rows_kernel", "pairdist_rows_reduce_kernel", "DistanceOut",
        "upper_gram_tc_kernel", "upper_gram_dmma_kernel")}
    if pd_kinds != {"pairdist_rows_kernel": 3, "pairdist_rows_reduce_kernel": 2,
                    "DistanceOut": 2, "upper_gram_tc_kernel": 2,
                    "upper_gram_dmma_kernel": 1} or any(
            v.get("spill_bytes", 1) for v in pairdist_ptxas.values()):
        fail(f"pairdist's instantiations: want both routes' kernels (route S: f32/f64/bf16 "
             f"and 2 reduces; route T: 2 tensor-core, 1 DMMA, 2 distance reduces) with 0 "
             f"spill bytes, got {pd_kinds}, ptxas says {pairdist_ptxas}")
    for name, report in fold_ptxas.items():
        if len(report) != 4 or any(v.get("spill_bytes", 1) for v in report.values()):
            fail(f"{name}'s instantiations: want 4 (f32/f64 × register/memory route) with 0 "
                 f"spill bytes, ptxas says {report}")
    if hgmma == 0:
        fail("libflash_attention.so holds no HGMMA instruction: the bf16 route is not on the "
             "tensor cores")
    if sorted(flash_tc) != [64, 128, 256] or any(v.get("spill_bytes", 1) for v in
                                                  flash_tc.values()):
        fail(f"flash_attention's bf16 instantiations: want D = 64, 128, 256 with 0 spill "
             f"bytes, ptxas says {flash_tc}")
    for name, info in tc_libs.items():
        gram_like = name in ("gram", "pairdist")   # an f32 and a bf16 instantiation
        if info["hgmma_tf32"] == 0 or (gram_like and info["hgmma_bf16"] == 0):
            fail(f"lib{name}.so lacks the tensor-core products of its f32/bf16 routes: {info}")
        want = 2 if gram_like else 1
        if len(info["ptxas"]) != want or any(v.get("spill_bytes", 1) for v in
                                             info["ptxas"].values()):
            fail(f"{name}'s tensor-core instantiations: want {want} with 0 spill bytes, "
                 f"ptxas says {info['ptxas']}")
    for name, info in dmma_libs.items():
        if info["dmma"] == 0 or len(info["ptxas"]) != 1 or any(
                v.get("spill_bytes", 1) for v in info["ptxas"].values()):
            fail(f"lib{name}.so's f64 route: want DMMA in its kernel's SASS and 0 spill bytes, "
                 f"got {info}")

    # reprolint for the port, on this machine's Python
    lint_phase()

    # -- 4. the main path at the paper's MEG/EEG size --------------------------
    ds, t_sim = timed(lambda: eeg.simulate_subject(SEED, n_trials=N_TRIALS, device=dev))
    x = eeg.windowed_features(ds, 5.0)                           # (787, 76000) f32
    y = (1 - 2 * ds.y).to(x.dtype)                               # ±1 labels
    n, p = x.shape
    if (n, p) != (787, 76000):
        fail(f"unexpected feature shape {(n, p)}")
    folds = folds_mod.kfold(n, K, seed=SEED, device=dev)
    lam = lam_rule(x)

    reset_counts()
    (dvals, y_te), t_cv = timed(lambda: fastcv.binary_cv(x, y, folds, lam))
    (preds, r_te), t_ridge = timed(lambda: regression.analytical_cv(x, y, folds, lam))
    perm, t_perm = timed(lambda: permutation.analytical_permutation_binary(
        x, y, folds, lam, N_PERM, SEED, chunk=CHUNK))
    launches = counts()
    acc = float(metrics.binary_accuracy(dvals, y_te))
    auc = float(metrics.auc(dvals, y_te))
    emit({"phase": "main", "N": n, "P": p, "K": K, "m": folds.test_size, "dtype": "float32",
          "lam": lam, "lam_rule": "tr(G_c)/N", "accuracy": acc, "auc": auc,
          "ridge_r2": float(metrics.r2(preds, r_te)),
          "perm_observed": float(perm.observed), "p_value": float(perm.p),
          "n_perm": N_PERM, "chunk": CHUNK, "launches": launches,
          "seconds": {"simulate": t_sim, "binary_cv": t_cv, "ridge_cv": t_ridge,
                      "permutation": t_perm}})
    expect_launches("binary", launches, ("gram", "hat_apply", "foldsolve", "fold_eval"))
    for name, val in (("dvals", dvals), ("preds", preds), ("null", perm.null)):
        if not bool(torch.isfinite(val).all()):
            fail(f"non-finite {name} on the main path")
    if dvals.shape != (K, folds.test_size) or perm.null.shape != (N_PERM,):
        fail("main path outputs have unexpected shapes")

    # the kernel route against the Cholesky composite (plain Gram too), and
    # against the same path in f64
    plan_plain = fastcv.prepare(x, folds, lam, gram=centered_gram_plain(x))
    dv_plain = fastcv.binary_dvals(plan_plain, y, fused=False)
    x64 = x.double()
    dv64, _ = fastcv.binary_cv(x64, y.double(), folds, lam)
    plan64_plain = fastcv.prepare(x64, folds, lam, gram=centered_gram_plain(x64))
    dv64_plain = fastcv.binary_dvals(plan64_plain, y.double(), fused=False)
    e_comp, s_comp = rel_err(dvals, dv_plain)
    e_f64, s_f64 = rel_err(dvals, dv64)
    e_64c, s_64c = rel_err(dv64, dv64_plain)
    # the examples' λ = 1.0, tiny next to a Gram diagonal of about P: I − H_Te
    # is badly conditioned in f32; count the folds the jitter retry re-solves
    lam_small = 1.0
    plan_small = fastcv.prepare(x, folds, lam_small)
    h_te_small = plan_small.h[plan_small.te_idx[:, :, None], plan_small.te_idx[:, None, :]]
    e_small = hat_errors(plan_small.h, y)[plan_small.te_idx][..., None]
    raw_small = foldsolve(h_te_small, e_small, jitter=None)
    bad_small = int(fold_residual_bad(h_te_small, raw_small, e_small).sum())
    # the one launch (check and retry inside) against the plain checked route
    one_small, flags_small = foldsolve_cuda(h_te_small, e_small, check=True)
    e_one, s_one = rel_err(one_small, foldsolve_checked_ref(h_te_small, e_small))
    dv_small = fastcv.binary_dvals(plan_small, y, fused=True)
    emit({"phase": "main_checks",
          "dvals_vs_composite": {"max_abs_err": e_comp, "scale": s_comp, "tol": TOL_DVALS_F32},
          "dvals_vs_f64": {"max_abs_err": e_f64, "scale": s_f64, "tol": TOL_DVALS_F32},
          "f64_vs_f64_composite": {"max_abs_err": e_64c, "scale": s_64c,
                                   "tol": TOL[torch.float64]},
          "accuracy_f64": float(metrics.binary_accuracy(dv64, y_te.double())),
          "small_lam": {"lam": lam_small, "bad_folds_before_retry": bad_small,
                        "kernel_resolved_folds": int(flags_small.sum()),
                        "one_launch_vs_plain_checked": {"max_abs_err": e_one, "scale": s_one,
                                                        "tol": TOL[torch.float32]},
                        "finite_after_retry": bool(torch.isfinite(dv_small).all())}})
    if e_comp > TOL_DVALS_F32 * s_comp or e_f64 > TOL_DVALS_F32 * s_f64:
        fail("f32 decision values disagree with the composite or the f64 run")
    if e_64c > TOL[torch.float64] * s_64c:
        fail("f64 kernel route disagrees with the f64 composite")
    if not bool(torch.isfinite(dv_small).all()):
        fail("small-λ decision values are not finite after the jitter retry")
    if e_one > TOL[torch.float32] * s_one or not bool(torch.isfinite(one_small).all()):
        fail("small-λ: the one-launch checked foldsolve disagrees with the plain checked route")

    # analytical CV == retraining per fold, at the paper's P = 3,800 (f64)
    x38 = eeg.windowed_features(ds, 100.0).double()
    lam38 = lam_rule(x38)
    (dv_an, _), t_an = timed(lambda: fastcv.binary_cv(x38, y.double(), folds, lam38,
                                                      adjust_bias=False))
    (dv_st, _), t_st = timed(lambda: lda.standard_cv_binary(x38, y.double(), folds,
                                                            lam38, form="regression"))
    e_ex, s_ex = rel_err(dv_an, dv_st)
    emit({"phase": "exactness", "P": x38.shape[1], "dtype": "float64", "lam": lam38,
          "max_abs_err": e_ex, "scale": s_ex, "tol": TOL_EXACT,
          "seconds": {"analytical": t_an, "retrain": t_st}})
    if e_ex > TOL_EXACT * s_ex:
        fail("analytical CV does not equal retraining at P = 3,800")

    # a small input against the CPU (the plain versions): the same answers
    xs, ys = x[:120, :500].contiguous(), y[:120]
    fs_gpu = folds_mod.kfold(120, 6, seed=1, device=dev)
    fs_cpu = folds_mod.kfold(120, 6, seed=1, device="cpu")
    lam_s = lam_rule(xs)
    small_gpu = fastcv.binary_cv(xs.double(), ys.double(), fs_gpu, lam_s)[0].cpu()
    small_cpu = fastcv.binary_cv(xs.double().cpu(), ys.double().cpu(), fs_cpu, lam_s)[0]
    e_cpu, s_cpu = rel_err(small_gpu, small_cpu)
    emit({"phase": "cpu_agreement", "N": 120, "P": 500, "dtype": "float64",
          "max_abs_err": e_cpu, "scale": s_cpu, "tol": TOL[torch.float64]})
    if e_cpu > TOL[torch.float64] * s_cpu:
        fail("CUDA and CPU results disagree on a small input")

    # -- 5. multi-class LDA (Algorithm 2) and its permutation test --------------
    ds3 = eeg.simulate_subject(SEED, n_trials=N_TRIALS, num_classes=MC_CLASSES, device=dev)
    x3, y3 = eeg.windowed_features(ds3, 5.0), ds3.y               # (787, 76000) f32
    folds3 = folds_mod.kfold(n, K, seed=SEED, device=dev)
    lam3 = lam_rule(x3)
    reset_counts()
    (pred3, y3_te), t_mc = timed(lambda: multiclass.analytical_cv_multiclass(
        x3, y3, folds3, MC_CLASSES, lam3))
    perm3, t_mperm = timed(lambda: permutation.analytical_permutation_multiclass(
        x3, y3, folds3, MC_CLASSES, lam3, N_PERM, SEED, chunk=MC_CHUNK))
    launches_mc = counts()
    expect_launches("multi-class", launches_mc, ("gram", "hat_apply", "foldsolve"))
    # the distances behind the predictions, on the kernel route (f32) and on
    # the f64 composite route; near-ties of the argmin may fall either way
    plan3 = fastcv.prepare(x3, folds3, lam3)
    d2_32, a2_32 = multiclass._batch_distances(plan3, y3[None], MC_CLASSES)
    x3_64 = x3.double()
    plan3_64 = fastcv.prepare(x3_64, folds3, lam3)
    pred3_64, _ = multiclass.analytical_cv_multiclass(x3_64, y3, folds3, MC_CLASSES, lam3,
                                                      plan=plan3_64, fused=False)
    d2_64, _ = multiclass._batch_distances(plan3_64, y3[None], MC_CLASSES, fused=False)
    del x3_64, plan3_64
    s64 = d2_64[0].sort(dim=-1).values
    decisive = (s64[..., 1] - s64[..., 0]) > TOL_DVALS_F32 * s64[..., -1]
    differ = pred3 != pred3_64
    mc = {"phase": "multiclass", "N": n, "P": x3.shape[1], "C": MC_CLASSES, "K": K,
          "dtype": "float32", "lam": lam3, "lam_rule": "tr(G_c)/N",
          "accuracy": float(metrics.multiclass_accuracy(pred3, y3_te)),
          "accuracy_f64": float(metrics.multiclass_accuracy(pred3_64, y3_te)),
          "perm_observed": float(perm3.observed), "p_value": float(perm3.p),
          "n_perm": N_PERM, "chunk": MC_CHUNK, "launches": launches_mc,
          "max_alpha2": float(a2_32.max()), "alpha2_clip": 1.0 - multiclass._EPS,
          "alpha2_clip_in_f32": float(torch.tensor(1.0 - multiclass._EPS,
                                                   dtype=torch.float32)),
          "vs_f64_composite": {"differ": int(differ.sum()),
                               "differ_decisive": int((differ & decisive).sum()),
                               "near_ties": int((~decisive).sum()),
                               "margin_tol": TOL_DVALS_F32},
          "seconds": {"analytical_cv": t_mc, "permutation": t_mperm}}
    emit(mc)
    for name, val in (("distances", d2_32), ("alpha2", a2_32), ("null", perm3.null)):
        if not bool(torch.isfinite(val).all()):
            fail(f"non-finite {name} on the multi-class path")
    if not torch.equal(d2_32[0].argmin(dim=-1), pred3):
        fail("multi-class predictions are not the argmin of their distances")
    if pred3.shape != (K, folds3.test_size) or perm3.null.shape != (N_PERM,):
        fail("multi-class outputs have unexpected shapes")
    if mc["vs_f64_composite"]["differ_decisive"]:
        fail("multi-class f32 predictions differ from f64 beyond the near-ties")
    del x3

    # analytical multi-class CV == retraining direct LDA, P = 1,900 (f64)
    x19 = eeg.windowed_features(ds3, 200.0).double()
    lam19 = lam_rule(x19)
    (p_an, yte_an), t_an19 = timed(lambda: multiclass.analytical_cv_multiclass(
        x19, y3, folds3, MC_CLASSES, lam19))
    (p_st, yte_st), t_st19 = timed(lambda: multiclass.standard_cv_multiclass(
        x19, y3, folds3, MC_CLASSES, lam19))
    emit({"phase": "multiclass_exactness", "P": x19.shape[1], "dtype": "float64",
          "lam": lam19, "predictions": int(p_an.numel()),
          "mismatches": int((p_an != p_st).sum()),
          "accuracy": float(metrics.multiclass_accuracy(p_an, yte_an)),
          "seconds": {"analytical": t_an19, "retrain": t_st19}})
    if not (torch.equal(p_an, p_st) and torch.equal(yte_an, yte_st)):
        fail("analytical multi-class CV does not equal retraining at P = 1,900")
    del ds3, x19

    # -- 6. RSA: cross-validated RDMs, pattern RDMs, model comparison ----------
    ds8 = eeg.simulate_subject(SEED, n_trials=N_TRIALS, num_classes=RSA_CONDITIONS,
                               device=dev)
    x8, y8 = eeg.windowed_features(ds8, 5.0), ds8.y               # (787, 76000) f32
    del ds8
    c8 = RSA_CONDITIONS
    folds8 = folds_mod.stratified_kfold(y8, K, seed=SEED, device=dev)
    lam8 = lam_rule(x8)

    def rsa_path():
        plan8 = fastcv.prepare(x8, folds8, lam8)
        rdms = {
            "accuracy": rsa_rdm.rdm_binary(x8, y8, folds8, c8, plan=plan8),
            "contrast": rsa_rdm.rdm_binary(x8, y8, folds8, c8, plan=plan8,
                                           dissimilarity="contrast"),
            "contrast_no_bias_adjust": rsa_rdm.rdm_from_pair_values(
                rsa_rdm.pair_dissimilarities(
                    plan8, rsa_rdm.pair_contrast_columns(y8, c8, plan8.h.dtype),
                    dissimilarity="contrast", adjust_bias=False), c8),
            "confusion": rsa_rdm.rdm_multiclass(plan8, y8, c8),
        }
        means = rsa_rdm.condition_means(x8, y8, c8)
        rdms["euclidean"] = rsa_rdm.euclidean_rdm(means)
        rdms["ring"] = rsa_rdm.ring_rdm(c8, device=dev)
        models = torch.stack([rdms["ring"], rdms["euclidean"].double()])
        emp = rdms["contrast"].double()
        scores = rsa_compare.compare_rdms(emp, models, "spearman")
        perms8 = permutation.permutation_indices(SEED, c8, N_PERM, device=dev)
        null8 = rsa_compare.permutation_null(emp, models, perms8, "spearman")
        return plan8, rdms, means, scores, null8

    reset_counts()
    (plan8, rdms, means8, scores8, null8), t_rsa = timed(rsa_path)
    launches_rsa = counts()
    expect_launches("RSA", launches_rsa,
                    ("gram", "hat_apply", "foldsolve", "fold_eval", "pairdist"))
    p8 = [float(permutation.p_value(scores8[i], null8[i])) for i in range(len(scores8))]
    off = ~torch.eye(c8, dtype=torch.bool, device=dev)
    emit({"phase": "rsa", "N": n, "P": x8.shape[1], "conditions": c8, "pairs": c8 * (c8 - 1) // 2,
          "K": K, "m": folds8.test_size, "dtype": "float32", "lam": lam8,
          "mean_offdiagonal": {k: float(r[off].double().mean()) for k, r in rdms.items()},
          "empirical": "contrast", "models": ["ring", "euclidean"], "method": "spearman",
          "scores": scores8.tolist(), "p_values": p8, "n_perm": N_PERM,
          "launches": launches_rsa, "seconds": t_rsa})
    for name, r in rdms.items():
        if r.shape != (c8, c8) or not bool(torch.isfinite(r).all()):
            fail(f"RSA {name} RDM is not a finite ({c8}, {c8}) matrix")
        if not torch.equal(r, r.T) or bool(torch.diagonal(r).any()):
            fail(f"RSA {name} RDM is not symmetric with a zero diagonal")
    if null8.shape != (2, N_PERM) or not bool(torch.isfinite(null8).all()):
        fail("RSA permutation null is not finite of shape (2, T)")

    # the RDMs' values against an f64 composite run on a plain Gram
    x8_64 = x8.double()
    plan8_64 = fastcv.prepare(x8_64, folds8, lam8, gram=centered_gram_plain(x8_64))
    del x8_64
    cols8_64 = rsa_rdm.pair_contrast_columns(y8, c8, torch.float64)

    def pair_rdm_64(**kw):
        return rsa_rdm.rdm_from_pair_values(
            rsa_rdm.pair_dissimilarities(plan8_64, cols8_64, fused=False, **kw), c8)

    rsa_checks = {}
    for name, kw in (("contrast", {}), ("contrast_no_bias_adjust", {"adjust_bias": False})):
        err, scale = rel_err(rdms[name], pair_rdm_64(dissimilarity="contrast", **kw))
        rsa_checks[name] = {"max_abs_err": err, "scale": scale, "tol": TOL_RDM_F32,
                            "ok": err <= TOL_RDM_F32 * scale}
    # pairwise accuracy: a test sample whose f64 bias-adjusted decision value
    # lies within the margin of 0 may flip, moving its pair's share by
    # 1/count; the f32 share itself rounds by < 1e-6
    y_dot_te, y_dot_tr = fastcv.cv_errors(plan8_64, cols8_64, fused=False)
    tr_lab, te_lab = cols8_64[plan8_64.tr_idx], cols8_64[plan8_64.te_idx]

    def train_mean(mask):
        mask = mask.double()
        return (y_dot_tr * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)

    dv8_64 = y_dot_te - 0.5 * (train_mean(tr_lab > 0) + train_mean(tr_lab < 0))[:, None, :]
    in_pair = te_lab != 0
    ties8 = in_pair & (dv8_64.abs() <= TOL_DVALS_F32 * float(dv8_64[in_pair].abs().max()))
    slack = ties8.sum(dim=(0, 1)) / in_pair.sum(dim=(0, 1))          # (B,) pairs
    iu = torch.triu_indices(c8, c8, 1, device=dev)                   # the same order
    acc_err = (rdms["accuracy"].double() - pair_rdm_64(dissimilarity="accuracy"))[iu[0], iu[1]]
    rsa_checks["accuracy"] = {"max_abs_err": float(acc_err.abs().max()),
                              "near_ties": int(ties8.sum()), "margin_tol": TOL_DVALS_F32,
                              "ok": bool((acc_err.abs() <= slack + 1e-6).all())}
    # confusion: the f32 kernel route's predictions equal the f64 composite's
    # off the near-ties of the centroid distances, and give the RDM
    d2_8, _ = multiclass._batch_distances(plan8, y8[None], c8)
    d2_8_64, _ = multiclass._batch_distances(plan8_64, y8[None], c8, fused=False)
    pred8, pred8_64 = d2_8[0].argmin(dim=-1), d2_8_64[0].argmin(dim=-1)
    s8 = d2_8_64[0].sort(dim=-1).values
    decisive8 = (s8[..., 1] - s8[..., 0]) > TOL_DVALS_F32 * s8[..., -1]
    y8_te = y8[plan8.te_idx]
    rsa_checks["confusion"] = {
        "differ": int((pred8 != pred8_64).sum()),
        "differ_decisive": int(((pred8 != pred8_64) & decisive8).sum()),
        "near_ties": int((~decisive8).sum()), "margin_tol": TOL_DVALS_F32,
        "equal_to_f64": torch.equal(rdms["confusion"],
                                    rsa_rdm.rdm_from_confusion(pred8_64, y8_te, c8)),
        "ok": (torch.equal(rdms["confusion"], rsa_rdm.rdm_from_confusion(pred8, y8_te, c8))
               and torch.equal(pred8[decisive8], pred8_64[decisive8]))}
    del plan8_64, cols8_64, y_dot_te, y_dot_tr, tr_lab, te_lab, dv8_64
    emit({"phase": "rsa_checks", "vs_f64_composite": rsa_checks})
    bad_rdms = [k for k, v in rsa_checks.items() if not v["ok"]]
    if bad_rdms:
        fail(f"RSA RDMs disagree with the f64 composite run: {bad_rdms}")

    # -- 6b. multi-dimensional analyses, λ tuning, incremental plans ----------
    md = multidim_phase(ds, y, folds)
    tune = tune_phase(x, x64, y)
    ds_more = eeg.simulate_subject(SEED, n_trials=N_TRIALS + UPDATE_ROWS, device=dev)
    x_more = eeg.windowed_features(ds_more, 5.0)[N_TRIALS:].contiguous()
    y_more = (1 - 2 * ds_more.y[N_TRIALS:]).to(x.dtype)
    del ds_more
    upd = update_phase(x, x64, y, lam, x_more, y_more)
    srv = serve_phase(ds, x, y, folds, lam, md["lam"], x_more)
    htp = http_phase(srv, y, x_more, y_more)
    dst = distributed_phase(ds, x, y, folds, lam)
    del x_more
    for k in ("engine", "handle", "batch", "first", "update"):
        srv.pop(k)

    # -- 7. the LLM substrate: serving and layer probes at gemma2-2b width -----
    lm_model, lm_cfg, launches_serve = lm_serve_phase(dev)
    launches_probe = lm_probe_phase(lm_model, lm_cfg, dev)
    del lm_model
    torch.cuda.empty_cache()
    # the MoE and RG-LRU trunks, one model at a time
    launches_moe, launches_moe_probe = lm_moe_phase(dev)
    torch.cuda.empty_cache()
    launches_qwen = lm_qwen_phase(dev)
    torch.cuda.empty_cache()
    launches_hybrid, launches_hybrid_probe = lm_hybrid_phase(dev)
    torch.cuda.empty_cache()
    # the audio, vision and xLSTM families, one model at a time
    launches_audio, launches_audio_probe = lm_audio_phase(dev)
    torch.cuda.empty_cache()
    launches_vision, launches_vision_probe = lm_vision_phase(dev)
    torch.cuda.empty_cache()
    launches_xlstm, launches_xlstm_probe = lm_xlstm_phase(dev)
    torch.cuda.empty_cache()
    # training: gemma2-2b uncut through the Trainer, and a restart
    launches_train = train_phase(dev)
    torch.cuda.empty_cache()
    # the dry run's cells, and the step counter on the card
    dryrun_phase(dev)
    torch.cuda.empty_cache()

    # -- 3. every kernel against its plain version on the card -----------------
    plan = fastcv.prepare(x, folds, lam)
    te = plan.te_idx
    h_te = plan.h[te[:, :, None], te[:, None, :]]
    yp = y[permutation.permutation_indices(SEED, n, CHUNK, device=dev)].T.contiguous()
    e_te = hat_errors(plan.h, yp)[te]
    xc = x - x.mean(dim=0, keepdim=True)
    y1 = y[:, None].contiguous()
    y1_te = y1[te]
    h_rows = plan.h[te]
    eye_m = torch.eye(folds.test_size, device=dev)

    checks = []

    def check(kernel, case, got, want, tol, exact=None):
        """Kernel ``got`` against plain ``want``; with ``exact`` (an f64
        product of the same inputs) also each one's own error."""
        err, scale = rel_err(got, want)
        ok = err <= tol * scale and bool(torch.isfinite(got).all())
        row = {"kernel": kernel, "case": case, "max_abs_err": err,
               "scale": scale, "tol": tol, "ok": ok}
        if exact is not None:
            row["kernel_vs_f64"] = rel_err(got, exact)[0]
            row["plain_vs_f64"] = rel_err(want, exact)[0]
        checks.append(row)
        return err

    f32, f64 = torch.float32, torch.float64
    # main-path shapes: these four also give the kernels line
    xc64 = xc.double()
    g_exact = gram_ref(xc64)
    g_main, e_main = gram(xc), hat_errors(plan.h, yp)
    main_err = {
        "gram": check("gram", "main (787, 76000) f32", g_main, gram_ref(xc), TOL[f32],
                      g_exact),
        "hat_apply": check("hat_apply", "main (787, 787)x(787, 250) f32",
                           e_main, hat_apply_ref(plan.h, yp), TOL[f32]),
        "foldsolve": check("foldsolve", "main K=10 m=78 B=250 f32",
                           foldsolve(h_te, e_te, jitter=None), foldsolve_ref(h_te, e_te),
                           TOL[f32]),
        "fold_eval": check("fold_eval", "main K=10 m=78 N=787 B=1 f32",
                           fold_eval(h_rows, h_te, y1, y1_te, jitter=None),
                           fold_eval_ref(h_rows, h_te, y1, y1_te)[0], TOL[f32]),
    }
    # the tensor-core routes at the main shapes: gram within the f32 pin of
    # the f64 product too, exactly symmetric; both bitwise repeatable (fixed
    # sum orders, no atomics)
    g_row = checks[0]
    g_row["kernel_vs_f64_ok"] = g_row["kernel_vs_f64"] <= TOL[f32] * rel_err(g_exact, g_exact)[1]
    g_row["symmetric"] = torch.equal(g_main, g_main.T)
    g_row["repeatable"] = torch.equal(g_main, gram(xc))
    g_row["ok"] = g_row["ok"] and g_row["kernel_vs_f64_ok"] and g_row["symmetric"] \
        and g_row["repeatable"]
    checks[1]["repeatable"] = torch.equal(e_main, hat_errors(plan.h, yp))
    checks[1]["ok"] = checks[1]["ok"] and checks[1]["repeatable"]
    del e_main
    # ragged shapes (no dimension a multiple of a tile) and f64
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def held_exact(row, got, again, symmetric=False):
        """The f64 tensor-core routes: bitwise repeatable (fixed sum orders,
        no atomics); G exactly symmetric."""
        row["repeatable"] = torch.equal(got, again)
        if symmetric:
            row["symmetric"] = torch.equal(got, got.T)
        row["ok"] = row["ok"] and row["repeatable"] and row.get("symmetric", True)

    for dt in (f32, f64):
        xr = torch.randn(130, 1037, generator=gen, device=dev, dtype=dt)
        g_r = gram(xr)
        check("gram", f"ragged (130, 1037) {dt}", g_r, gram_ref(xr), TOL[dt])
        if dt == f64:
            held_exact(checks[-1], g_r, gram(xr), symmetric=True)
        hr = torch.randn(131, 131, generator=gen, device=dev, dtype=dt) / 131
        yr = torch.randn(131, 70, generator=gen, device=dev, dtype=dt)
        check("hat_apply", f"ragged N=131 B=70 {dt}", hat_errors(hr, yr),
              hat_apply_ref(hr, yr), TOL[dt])
        a = torch.randn(3, 17, 17, generator=gen, device=dev, dtype=dt) / 17
        htr = -(a @ a.transpose(1, 2))
        er = torch.randn(3, 17, 70, generator=gen, device=dev, dtype=dt)
        check("foldsolve", f"ragged K=3 m=17 B=70 {dt}", foldsolve(htr, er, jitter=None),
              foldsolve_ref(htr, er), TOL[dt])
        hrows = torch.randn(3, 17, 131, generator=gen, device=dev, dtype=dt) / 131
        yte = torch.randn(3, 17, 70, generator=gen, device=dev, dtype=dt)
        check("fold_eval", f"ragged K=3 m=17 N=131 B=70 {dt}",
              fold_eval(hrows, htr, yr, yte, jitter=None),
              fold_eval_ref(hrows, htr, yr, yte)[0], TOL[dt])
    # the f64 routes at the main size: gram of the centered f64 design;
    # hat_apply on an f64 copy of the main plan's H, a permutation chunk and
    # the x64 binary_cv label vector (B = 1)
    x64c = x64 - x64.mean(dim=0, keepdim=True)
    g64 = gram(x64c)
    h64, yp64 = plan.h.double(), yp.double()
    e64 = hat_errors(h64, yp64)
    main64_err = {
        "gram": check("gram", "main (787, 76000) f64", g64, gram_ref(x64c), TOL[f64]),
        "hat_apply": check("hat_apply", "main (787, 787)x(787, 250) f64", e64,
                           hat_apply_ref(h64, yp64), TOL[f64])}
    held_exact(checks[-2], g64, gram(x64c), symmetric=True)
    held_exact(checks[-1], e64, hat_errors(h64, yp64))
    y64 = y.double()
    check("hat_apply", "x64 labels N=787 B=1 f64", hat_errors(h64, y64),
          hat_apply_ref(h64, y64[:, None])[:, 0], TOL[f64])
    del xc64, g_exact, g64, e64
    xb_main = xc.to(torch.bfloat16)
    bf16_gram_err = check("gram", "bf16_gram (787, 76000)", gram(xc, precision="bf16_gram"),
                          gram_ref(xb_main), TOL[torch.bfloat16], gram_ref(xb_main.double()))
    # foldsolve at m = 1 (leave-one-out) and m = 393 (K = 2: global scratch)
    for kk, fs in (("m=1 (LOO, K=787)", folds_mod.loo(n, device=dev)),
                   ("m=393 (K=2)", folds_mod.kfold(n, 2, seed=SEED, device=dev))):
        t_ = fs.te_idx
        hb = plan.h[t_[:, :, None], t_[:, None, :]]
        eb = hat_errors(plan.h, yp[:, :64].contiguous())[t_]
        check("foldsolve", f"{kk} B=64 f32", foldsolve(hb, eb, jitter=None),
              foldsolve_ref(hb, eb), TOL[f32])
        check("fold_eval", f"{kk} B=64 f32",
              fold_eval(plan.h[t_], hb, yp[:, :64].contiguous(),
                        yp[:, :64].contiguous()[t_], jitter=None),
              fold_eval_ref(plan.h[t_], hb, yp[:, :64].contiguous(),
                            yp[:, :64].contiguous()[t_])[0], TOL[f32])
    # the multidim, tune and update paths' new shapes: hat_apply on the peak
    # point's primal H (P = 380 < N: not symmetrised, from a matmul) with one
    # label column, foldsolve on that plan's fold blocks, and fold_eval at
    # the LOO shape of the tune phase's pin, in f32 and f64
    h_md, te_md = md["plan"].h, md["plan"].te_idx
    hb_md = h_md[te_md[:, :, None], te_md[:, None, :]]
    e_md = hat_errors(h_md, y1)
    new_err = {
        "hat_apply": check("hat_apply", f"multidim primal H ({n}, {n}) Y ({n}, 1) f32", e_md,
                           hat_apply_ref(h_md, y1), TOL[f32]),
        "foldsolve": check("foldsolve", f"multidim primal K={K} m={te_md.shape[1]} B=1 f32",
                           foldsolve(hb_md, e_md[te_md], jitter=None),
                           foldsolve_ref(hb_md, e_md[te_md]), TOL[f32])}
    loo_te = folds_mod.loo(n, device=dev).te_idx
    loo_in = {}
    for dt, hh in ((f32, plan.h), (f64, plan.h.double())):
        yy = y1.to(dt)
        hb = hh[loo_te[:, :, None], loo_te[:, None, :]]
        loo_in[dt] = (hh[loo_te], hb, yy, yy[loo_te])
        new_err[("fold_eval", dt)] = check(
            "fold_eval", f"tune LOO K={n} m=1 N={n} B=1 {dt}",
            fold_eval(*loo_in[dt], jitter=None), fold_eval_ref(*loo_in[dt])[0], TOL[dt])
    # near-singular folds: the retry must engage and match the shifted solve
    q, _ = torch.linalg.qr(torch.randn(12, 12, generator=gen, device=dev, dtype=f64))
    d = torch.ones(12, device=dev, dtype=f64)
    d[-1] = 1e-14
    hs = (torch.eye(12, device=dev, dtype=f64) - (q * d) @ q.T).expand(3, 12, 12).contiguous()
    es = torch.randn(3, 12, 4, generator=gen, device=dev, dtype=f64)
    raw = foldsolve(hs, es, jitter=None)
    bad = fold_residual_bad(hs, raw, es)
    got = foldsolve(hs, es)
    eye12 = torch.eye(12, device=dev, dtype=f64)
    want = torch.linalg.solve(eye12 - hs + fold_jitter(hs)[:, None, None] * eye12, es)
    check("foldsolve", "near-singular jitter retry f64", got, want, 1e-8)
    hr_rows = torch.randn(3, 12, 40, generator=gen, device=dev, dtype=f64) / 40
    yr40 = torch.randn(40, 4, generator=gen, device=dev, dtype=f64)
    yr_te = torch.randn(3, 12, 4, generator=gen, device=dev, dtype=f64)
    e_fe = yr_te - hr_rows @ yr40
    want_fe = torch.linalg.solve(eye12 - hs + fold_jitter(hs)[:, None, None] * eye12, e_fe)
    check("fold_eval", "near-singular jitter retry f64",
          fold_eval(hr_rows, hs, yr40, yr_te), want_fe, 1e-8)
    if not bool(bad.all()):
        fail("near-singular case did not trip the residual check (vacuous)")
    # the one-launch check and retry at the main shape: fold 1 near-singular,
    # failing (in f64) only past its first 64-column tile; the kernel's flags
    # name it alone, it is re-solved whole, and the healthy folds keep the
    # raw solve bit for bit; fold_eval on the same folds (ê = these columns)
    for dt in (f32, f64):
        hm, em = near_singular_folds(gen, K, folds.test_size, CHUNK, dt)
        want_flags = [i == 1 for i in range(K)]
        raw = foldsolve(hm, em, jitter=None)
        got, flags = foldsolve_cuda(hm, em, check=True)
        check("foldsolve", f"checked: fold 1 near-singular, K={K} m={folds.test_size} "
              f"B={CHUNK} {dt}", got, foldsolve_checked_ref(hm, em), TOL[dt])
        hrm = torch.randn(K, folds.test_size, n, generator=gen, device=dev, dtype=dt) / n
        ym = torch.randn(n, CHUNK, generator=gen, device=dev, dtype=dt)
        ytm = (em + hrm @ ym).contiguous()
        raw_fe = fold_eval_cuda(hrm, hm, ym, ytm, check=False)[0]
        got_fe, _, flags_fe = fold_eval_cuda(hrm, hm, ym, ytm, check=True)
        check("fold_eval", f"checked: fold 1 near-singular, K={K} m={folds.test_size} N={n} "
              f"B={CHUNK} {dt}", got_fe, fold_eval_checked_ref(hrm, hm, ym, ytm), TOL[dt])
        for row, g, r, fl in ((checks[-2], got, raw, flags), (checks[-1], got_fe, raw_fe,
                                                              flags_fe)):
            healthy = ~fl
            row.update(bad_folds=fl.nonzero().flatten().tolist(),
                       healthy_equal_raw=torch.equal(g[healthy], r[healthy]),
                       resolved_whole=not torch.equal(g[1, :, :64], r[1, :, :64]))
            row["ok"] = (row["ok"] and fl.tolist() == want_flags and row["healthy_equal_raw"]
                         and row["resolved_whole"])
    # the multi-class and RSA paths' own plans and column blocks: the CV's
    # (N, 3) indicators, a permutation chunk's (N, 64·3) and the last
    # chunk's (N, 40·3); the 28 contrast columns and the confusion RDM's
    # (N, 8) indicators

    def indicators(yb, c):
        return multiclass.onehot(yb, c, dtype=f32).permute(1, 0, 2).reshape(n, -1).contiguous()

    perms3 = permutation.permutation_indices(SEED, n, N_PERM, device=dev)
    last3 = N_PERM - (N_PERM - 1) // MC_CHUNK * MC_CHUNK
    cols8 = rsa_rdm.pair_contrast_columns(y8, c8, f32)
    for case, pl, yb in (
            ("multi-class CV", plan3, indicators(y3[None], MC_CLASSES)),
            (f"multi-class chunk of {MC_CHUNK}", plan3,
             indicators(y3[perms3[:MC_CHUNK]], MC_CLASSES)),
            (f"multi-class last chunk of {last3}", plan3,
             indicators(y3[perms3[-last3:]], MC_CLASSES)),
            ("rsa contrasts", plan8, cols8),
            ("rsa confusion", plan8, indicators(y8[None], c8))):
        t_ = pl.te_idx
        hb = pl.h[t_[:, :, None], t_[:, None, :]]
        eb = hat_errors(pl.h, yb)
        shape = f"K={t_.shape[0]} m={t_.shape[1]} B={yb.shape[1]} f32"
        check("hat_apply", f"{case} N={n} B={yb.shape[1]} f32", eb,
              hat_apply_ref(pl.h, yb), TOL[f32])
        check("foldsolve", f"{case} {shape}", foldsolve(hb, eb[t_], jitter=None),
              foldsolve_ref(hb, eb[t_]), TOL[f32])
        if case == "rsa contrasts":       # the same columns without train blocks
            check("fold_eval", f"{case} {shape} N={n}",
                  fold_eval(pl.h[t_], hb, yb, yb[t_], jitter=None),
                  fold_eval_ref(pl.h[t_], hb, yb, yb[t_])[0], TOL[f32])
    del plan3, perms3
    # pairdist: the RSA path's condition means (route S), a trial-level RDM
    # of all 787 patterns (route T: f32, f64, bf16), ragged shapes, and the
    # route sweep's inputs on both routes; every one exactly symmetric with
    # a zero diagonal, and bitwise repeatable

    def check_pd(case, u, route=None, exact=False):
        def call():   # the public entry point where the rule picks the route
            return pairwise_sq_dists(u) if route is None else pairdist_cuda(u, route=route)

        got = call()
        want = pairwise_sq_dists_ref(u)
        acc_t = want.dtype
        err = check("pairdist", f"{case} {u.dtype}", got, want, TOL[u.dtype],
                    pairwise_sq_dists_ref(u.double()) if exact else None)
        row = checks[-1]
        row["kernel_route"] = route or pairdist_route(*u.shape, u.dtype)
        row["symmetric"] = torch.equal(got, got.T)
        row["zero_diagonal"] = not bool(torch.diagonal(got).any())
        row["repeatable"] = torch.equal(got, call())
        row["ok"] = (row["ok"] and got.dtype == acc_t and row["symmetric"]
                     and row["zero_diagonal"] and row["repeatable"])
        return err

    main_err["pairdist"] = check_pd(f"rsa path ({c8}, {p})", means8, exact=True)
    pd_err = {(c8, "float32"): main_err["pairdist"]}
    x8_64, x8b = x8.double(), x8.to(torch.bfloat16)
    for u_ in (x8, x8_64, x8b):
        pd_err[(n, str(u_.dtype).removeprefix("torch."))] = check_pd(
            f"trial ({n}, {p})", u_, exact=u_.dtype == torch.bfloat16)
    for dt in (f32, f64):
        for cc, pp in ((5, 30), (33, 500), (130, 1037)):
            check_pd(f"ragged ({cc}, {pp})", torch.randn(cc, pp, generator=gen, device=dev,
                                                         dtype=dt))
    sweep_inputs = {}
    for dt in (f32, f64):
        for cc in PD_SWEEP_C:
            u_ = torch.randn(cc, PD_SWEEP_P, generator=gen, device=dev, dtype=dt)
            sweep_inputs[(cc, dt)] = u_
            for route in ("S", "T") if cc <= PD_S_MAX_C else ("T",):
                check_pd(f"sweep ({cc}, {PD_SWEEP_P}) route {route}", u_, route=route)
    # flash_attention: the LM paths' own shapes and layout (gemma2-2b's serve
    # prefill of 4 × 2,048, its local and global layers at 8,192 tokens, the
    # probe's 384 × 128; olmoe's, qwen3-moe's and recurrentgemma's prefills of
    # 4 × 2,048, olmoe's 8,192-token prefill, olmoe's and recurrentgemma's
    # probes at 384 × 128; q/k/v as (B, H, S, D) views of (B, S, H, D) memory,
    # as attention_full passes them; the train step's 2 × 1,024 at gemma2's
    # local and global layers), starcoder2's and minicpm's head widths,
    # a ragged length, f32 I/O, and the inputs of the cuda-marked test
    # test_flash_attention_kernel[200-None-None-64-bf16] (a seed-0 generator)
    bf16 = torch.bfloat16
    attn_cases = [
        ("lm_serve prefill", 1, LM_BATCH, 8, 4, LM_PROMPT, 256, bf16, 4096, 50.0),
        ("lm_serve local", 1, 1, 8, 4, LM_LONG, 256, bf16, 4096, 50.0),
        ("lm_serve global", 1, 1, 8, 4, LM_LONG, 256, bf16, None, 50.0),
        ("lm_probe", 1, 2 * PROBE_PER_CLASS, 8, 4, PROBE_SEQ, 256, bf16, 4096, 50.0),
        ("starcoder2 D=128", 0, 1, 24, 2, 2048, 128, bf16, None, None),
        ("minicpm D=64", 0, 1, 36, 36, 2048, 64, bf16, None, None),
        ("ragged S=1000", 0, 2, 8, 4, 1000, 256, bf16, 100, 50.0),
        ("f32 I/O", 0, 1, 8, 4, 2048, 256, f32, 512, 50.0),
        ("f32 I/O ragged D=64", 0, 2, 6, 2, 777, 64, f32, None, 20.0),
        ("cuda test inputs", 0, 2, 8, 4, 200, 64, bf16, None, None),
        ("lm_moe prefill", 1, LM_BATCH, 16, 16, LM_PROMPT, 128, bf16, None, None),
        ("lm_moe_qwen3 prefill", 1, LM_BATCH, 32, 4, LM_PROMPT, 128, bf16, None, None),
        ("lm_hybrid prefill", 1, LM_BATCH, 10, 1, LM_PROMPT, 256, bf16, 2048, None),
        ("lm_moe long", 1, 1, 16, 16, LM_LONG, 128, bf16, None, None),
        ("lm_moe_probe", 1, 2 * PROBE_PER_CLASS, 16, 16, PROBE_SEQ, 128, bf16, None, None),
        ("lm_hybrid_probe", 1, 2 * PROBE_PER_CLASS, 10, 1, PROBE_SEQ, 256, bf16, 2048, None),
        ("lm_audio prefill", 1, LM_BATCH, 24, 24, LM_PROMPT, 64, bf16, None, None),
        ("lm_vision prefill", 1, LM_BATCH, 32, 8, LM_PROMPT, 128, bf16, None, None),
        ("train local", 1, TRAIN_BATCH, 8, 4, TRAIN_SEQ, 256, bf16, 4096, 50.0),
        ("train global", 1, TRAIN_BATCH, 8, 4, TRAIN_SEQ, 256, bf16, None, 50.0),
    ]
    attn_inputs = {}
    for case, strided, b_, hq, hkv, s_, d_, dt, win, cap in attn_cases:
        g = gen
        if case == "cuda test inputs":
            g = torch.Generator(device=dev)
            g.manual_seed(0)
        if strided:
            qa, ka, va = (torch.randn(b_, s_, h, d_, generator=g, device=dev).to(dt)
                          .transpose(1, 2) for h in (hq, hkv, hkv))
        else:
            qa = torch.randn(b_, hq, s_, d_, generator=g, device=dev).to(dt)
            ka, va = (torch.randn(b_, hkv, s_, d_, generator=g, device=dev).to(dt)
                      for _ in range(2))
        kw = dict(scale=d_ ** -0.5, window=win, softcap=cap)
        got, want = flash_attention(qa, ka, va, **kw), attention_ref(qa, ka, va, **kw)
        err, scale = rel_err(got, want)
        row = {"kernel": "flash_attention", "case": f"{case} B={b_} Hq={hq} Hkv={hkv} S={s_} "
               f"D={d_} window={win} softcap={cap} {dt}",
               "layout": "(B, S, H, D) viewed as (B, H, S, D)" if strided else "(B, H, S, D)",
               "max_abs_err": err, "scale": scale}
        if dt == bf16:
            ulps, _ = bf16_ulps(got, want)
            own, at = bf16_ulps(got, want, floor=False)
            row.update(max_ulps=ulps, tol_ulps=TOL_ATTN_BF16_ULPS, max_ulps_unfloored=own,
                       want_at_max_unfloored=at,
                       ok=ulps <= TOL_ATTN_BF16_ULPS and bool(torch.isfinite(got).all()))
        else:
            row.update(tol=TOL_ATTN_F32, ok=err <= TOL_ATTN_F32 * scale
                       and bool(torch.isfinite(got).all()))
        checks.append(row)
        if case.startswith(("lm_", "train")) or case == "f32 I/O":
            attn_inputs[case] = (qa, ka, va, kw, err)
        del got, want
    emit({"phase": "kernel_checks", "checks": checks})
    failed = [c for c in checks if not c["ok"]]
    if failed:
        fail(f"kernel checks failed: {failed}")

    # -- timings at the main path's shapes ---------------------------------------
    f4 = 4
    kk_, m_ = K, folds.test_size
    b_ = CHUNK
    eye_b = eye_m.expand(kk_, m_, m_)
    rows = [
        {"name": "gram", "source": "src/repro_torch/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram/gram.py:47",
         "kernel": lambda: gram(xc), "plain": lambda: gram_ref(xc),
         "library": lambda: torch.mm(xc, xc.T),
         "bytes": (n * p + n * n) * f4, "flops": n * (n + 1) * p, "dtype": "tf32",
         "issued": 3 * n * (n + 1) * p, "shape": f"X ({n}, {p}) f32"},
        {"name": "hat_apply", "source": "src/repro_torch/csrc/hat_apply.cu",
         "replaces": "src/repro/kernels/hat_apply/hat_apply.py:48",
         "kernel": lambda: hat_errors(plan.h, yp), "plain": lambda: hat_apply_ref(plan.h, yp),
         "library": lambda: torch.addmm(yp, plan.h, yp, alpha=-1.0),
         "bytes": (n * n + 2 * n * b_) * f4, "flops": 2 * n * n * b_, "dtype": "tf32",
         "issued": 3 * 2 * n * n * b_, "shape": f"H ({n}, {n}), Y ({n}, {b_}) f32"},
        {"name": "foldsolve", "source": "src/repro_torch/csrc/foldsolve.cu",
         "replaces": "src/repro/kernels/foldsolve/foldsolve.py:71",
         "kernel": lambda: foldsolve(h_te, e_te, jitter=None),
         "on_path": lambda: foldsolve(h_te, e_te),
         "plain": lambda: foldsolve_ref(h_te, e_te),
         "library": lambda: torch.linalg.solve(eye_b - h_te, e_te),
         "bytes": (kk_ * m_ * m_ + 2 * kk_ * m_ * b_) * f4,
         "flops": kk_ * (2 * m_ ** 3 / 3 + 2 * m_ * m_ * b_),
         "shape": f"h_te ({kk_}, {m_}, {m_}), e ({kk_}, {m_}, {b_}) f32"},
        {"name": "fold_eval", "source": "src/repro_torch/csrc/fold_eval.cu",
         "replaces": "src/repro/kernels/fold_eval/fold_eval.py:59",
         "kernel": lambda: fold_eval(h_rows, h_te, y1, y1_te, jitter=None),
         "on_path": lambda: fold_eval(h_rows, h_te, y1, y1_te),
         "plain": lambda: fold_eval_ref(h_rows, h_te, y1, y1_te),
         "library": lambda: torch.linalg.solve(eye_b - h_te, y1_te - torch.bmm(
             h_rows, y1.expand(kk_, n, 1))),
         "bytes": (kk_ * m_ * n + kk_ * m_ * m_ + n + 3 * kk_ * m_) * f4,
         "flops": 2 * kk_ * m_ * n + kk_ * (2 * m_ ** 3 / 3 + 2 * m_ * m_),
         "shape": f"h_rows ({kk_}, {m_}, {n}), y ({n}, 1) f32"},
    ]
    by_path = {"binary": launches, "multiclass": launches_mc, "rsa": launches_rsa,
               "multidim": md["launches"], "tune": tune["launches"], "update": upd["launches"],
               "serve": srv["launches"], "http": htp["launches"],
               "distributed": dst["launches"], "lm_serve": launches_serve,
               "lm_probe": launches_probe, "lm_moe": launches_moe,
               "lm_moe_probe": launches_moe_probe, "lm_moe_qwen3": launches_qwen,
               "lm_hybrid": launches_hybrid, "lm_hybrid_probe": launches_hybrid_probe,
               "lm_audio": launches_audio, "lm_audio_probe": launches_audio_probe,
               "lm_vision": launches_vision, "lm_vision_probe": launches_vision_probe,
               "train": launches_train,
               "lm_xlstm": launches_xlstm, "lm_xlstm_probe": launches_xlstm_probe}
    # the new paths' shapes (launches: the path that runs the shape; the
    # fold_eval LOO rows run only in the tune phase's f64 check)
    km_, mm_ = te_md.shape
    eye_md = torch.eye(mm_, device=dev).expand(km_, mm_, mm_)
    new_rows = {"hat_apply": [{
        "kernel": lambda: hat_errors(h_md, y1), "plain": lambda: hat_apply_ref(h_md, y1),
        "library": lambda: torch.addmm(y1, h_md, y1, alpha=-1.0),
        "bytes": (n * n + 2 * n) * f4, "flops": 2 * n * n, "dtype": "tf32",
        "shape": f"multidim: primal H ({n}, {n}), Y ({n}, 1) f32",
        "max_abs_err": new_err["hat_apply"], "launches": md["launches"]["hat_apply"],
        "tol": TOL[f32]}],
        "foldsolve": [{
            "kernel": lambda: foldsolve(hb_md, e_md[te_md], jitter=None),
            "on_path": lambda: foldsolve(hb_md, e_md[te_md]),
            "plain": lambda: foldsolve_ref(hb_md, e_md[te_md]),
            "library": lambda: torch.linalg.solve(eye_md - hb_md, e_md[te_md]),
            "bytes": (km_ * mm_ * mm_ + 2 * km_ * mm_) * f4,
            "flops": km_ * (2 * mm_ ** 3 / 3 + 2 * mm_ * mm_),
            "shape": f"multidim: primal h_te ({km_}, {mm_}, {mm_}), e ({km_}, {mm_}, 1) f32",
            "max_abs_err": new_err["foldsolve"], "launches": md["launches"]["foldsolve"],
            "tol": TOL[f32]}],
        "fold_eval": [{
            "kernel": lambda a=loo_in[dt]: fold_eval(*a, jitter=None),
            "on_path": lambda a=loo_in[dt]: fold_eval(*a),
            "plain": lambda a=loo_in[dt]: fold_eval_ref(*a),
            "library": lambda a=loo_in[dt], dt=dt: torch.linalg.solve(
                torch.eye(1, device=dev, dtype=dt).expand(n, 1, 1) - a[1],
                a[3] - torch.bmm(a[0], a[2].expand(n, n, 1))),
            "bytes": (n * n + n + n + 3 * n) * (4 if dt == f32 else 8),
            "flops": 2 * n * n + n * (2 / 3 + 2), "dtype": dt,
            "shape": f"tune LOO: h_rows ({n}, 1, {n}), y ({n}, 1) "
                     f"{str(dt).removeprefix('torch.')}",
            "max_abs_err": new_err[("fold_eval", dt)],
            "launches": tune["check_launches"]["fold_eval"] if dt == f64 else 0,
            "launches_note": "the tune phase's check (analytical_cv on LOO folds, f64)",
            "tol": TOL[dt]} for dt in (f32, f64)]}
    # the serve path's bucket-padded shapes on the engine's plan: the binary
    # null (B = 1,024 in one launch), the 3-class null's indicator block
    # (1,024 · 3 columns) and the RSA contrasts (28 padded to 32); launches:
    # the serve path's count at the shape
    h_sv, hb_sv = srv["plan"].h, srv["h_te"]
    te_sv = srv["plan"].te_idx
    ks_, ms_ = te_sv.shape
    eye_sv = torch.eye(ms_, device=dev).expand(ks_, ms_, ms_)
    for tag, sh in srv["shapes"].items():
        ysv, esv = sh["y"], sh["e_te"]
        bsv = ysv.shape[1]
        new_rows["hat_apply"].append({
            "kernel": lambda ysv=ysv: hat_errors(h_sv, ysv),
            "plain": lambda ysv=ysv: hat_apply_ref(h_sv, ysv),
            "library": lambda ysv=ysv: torch.addmm(ysv, h_sv, ysv, alpha=-1.0),
            "bytes": (n * n + 2 * n * bsv) * f4, "flops": 2 * n * n * bsv, "dtype": "tf32",
            "shape": f"serve {tag}: H ({n}, {n}), Y ({n}, {bsv}) f32",
            "max_abs_err": sh["hat_apply_err"], "launches": sh["launches"]["hat_apply"],
            "launches_note": SERVE_SHAPE_NOTE, "tol": TOL[f32]})
        new_rows["foldsolve"].append({
            "kernel": lambda esv=esv: foldsolve(hb_sv, esv, jitter=None),
            "on_path": lambda esv=esv: foldsolve(hb_sv, esv),
            "plain": lambda esv=esv: foldsolve_ref(hb_sv, esv),
            "library": lambda esv=esv: torch.linalg.solve(eye_sv - hb_sv, esv),
            "bytes": (ks_ * ms_ * ms_ + 2 * ks_ * ms_ * bsv) * f4,
            "flops": ks_ * (2 * ms_ ** 3 / 3 + 2 * ms_ * ms_ * bsv),
            "shape": f"serve {tag}: h_te ({ks_}, {ms_}, {ms_}), e ({ks_}, {ms_}, {bsv}) f32",
            "max_abs_err": sh["foldsolve_err"], "launches": sh["launches"]["foldsolve"],
            "launches_note": SERVE_SHAPE_NOTE, "tol": TOL[f32]})

    # the distributed path's new shapes: a searchlight window's Gram, and
    # hat_apply / foldsolve at the 1,000-wide null of one shard and the
    # stream's 256-wide chunks (launches: the path's at the shape)
    h_ds, hb_ds = dst["plan"].h, dst["h_te"]
    kd_, md_ = dst["plan"].te_idx.shape
    eye_ds = torch.eye(md_, device=dev).expand(kd_, md_, md_)
    note_ds = "the distributed path's launches at this shape"
    for sh in dst["shapes"]["gram"]:
        xw, pw = sh["x"], sh["x"].shape[1]
        new_rows.setdefault("gram", []).append({
            "kernel": lambda xw=xw: gram(xw), "plain": lambda xw=xw: gram_ref(xw),
            "library": lambda xw=xw: torch.mm(xw, xw.T),
            "bytes": (n * pw + n * n) * f4, "flops": n * (n + 1) * pw, "dtype": "tf32",
            "issued": 3 * n * (n + 1) * pw, "shape": f"distributed: a window X ({n}, {pw}) f32",
            "max_abs_err": sh["max_abs_err"], "launches": sh["launches"],
            "launches_note": note_ds, "tol": TOL[f32]})
    for sh_h, sh_f in zip(dst["shapes"]["hat_apply"], dst["shapes"]["foldsolve"]):
        yd, ed = sh_h["y"], sh_f["e_te"]
        bd = yd.shape[1]
        new_rows["hat_apply"].append({
            "kernel": lambda yd=yd: hat_errors(h_ds, yd),
            "plain": lambda yd=yd: hat_apply_ref(h_ds, yd),
            "library": lambda yd=yd: torch.addmm(yd, h_ds, yd, alpha=-1.0),
            "bytes": (n * n + 2 * n * bd) * f4, "flops": 2 * n * n * bd, "dtype": "tf32",
            "shape": f"distributed: H ({n}, {n}), Y ({n}, {bd}) f32",
            "max_abs_err": sh_h["max_abs_err"], "launches": sh_h["launches"],
            "launches_note": note_ds, "tol": TOL[f32]})
        new_rows["foldsolve"].append({
            "kernel": lambda ed=ed: foldsolve(hb_ds, ed, jitter=None),
            "on_path": lambda ed=ed: foldsolve(hb_ds, ed),
            "plain": lambda ed=ed: foldsolve_ref(hb_ds, ed),
            "library": lambda ed=ed: torch.linalg.solve(eye_ds - hb_ds, ed),
            "bytes": (kd_ * md_ * md_ + 2 * kd_ * md_ * bd) * f4,
            "flops": kd_ * (2 * md_ ** 3 / 3 + 2 * md_ * md_ * bd),
            "shape": f"distributed: h_te ({kd_}, {md_}, {md_}), e ({kd_}, {md_}, {bd}) f32",
            "max_abs_err": sh_f["max_abs_err"], "launches": sh_f["launches"],
            "launches_note": note_ds, "tol": TOL[f32]})

    # the lm_probe path's own f64 shapes: 384 sequences of d_model 2,304
    # features, K = 6 folds of 64, permutation chunks of 64 labels (random
    # features of that size, their plan, a chunk of ±1 labels)
    nq, bq = 2 * PROBE_PER_CLASS, min(N_PERM, 64)
    xq = torch.randn(nq, lm_cfg.d_model, generator=gen, device=dev, dtype=f64)
    xqc = xq - xq.mean(dim=0, keepdim=True)
    planq = fastcv.prepare(xq, folds_mod.kfold(nq, PROBE_FOLDS, seed=SEED, device=dev),
                           lam_rule(xq))
    yq = torch.where(torch.rand(nq, bq, generator=gen, device=dev) < 0.5, 1.0, -1.0).to(f64)
    teq = planq.te_idx
    hq_te = planq.h[teq[:, :, None], teq[:, None, :]]
    eq_te = hat_errors(planq.h, yq)[teq]
    kq, mq = teq.shape
    eye_q = torch.eye(mq, device=dev, dtype=f64).expand(kq, mq, mq)
    f8 = 8
    probe_rows = {
        "gram": {"kernel": lambda: gram(xqc), "plain": lambda: gram_ref(xqc),
                 "library": lambda: torch.mm(xqc, xqc.T),
                 "bytes": (nq * xq.shape[1] + nq * nq) * f8, "flops": nq * (nq + 1) * xq.shape[1],
                 "dtype": f64, "shape": f"lm_probe: X ({nq}, {xq.shape[1]}) f64"},
        "hat_apply": {"kernel": lambda: hat_errors(planq.h, yq),
                      "plain": lambda: hat_apply_ref(planq.h, yq),
                      "library": lambda: torch.addmm(yq, planq.h, yq, alpha=-1.0),
                      "bytes": (nq * nq + 2 * nq * bq) * f8, "flops": 2 * nq * nq * bq,
                      "dtype": f64, "shape": f"lm_probe: H ({nq}, {nq}), Y ({nq}, {bq}) f64"},
        "foldsolve": {"kernel": lambda: foldsolve(hq_te, eq_te, jitter=None),
                      "on_path": lambda: foldsolve(hq_te, eq_te),
                      "plain": lambda: foldsolve_ref(hq_te, eq_te),
                      "library": lambda: torch.linalg.solve(eye_q - hq_te, eq_te),
                      "bytes": (kq * mq * mq + 2 * kq * mq * bq) * f8,
                      "flops": kq * (2 * mq ** 3 / 3 + 2 * mq * mq * bq), "dtype": f64,
                      "shape": f"lm_probe: h_te ({kq}, {mq}, {mq}), e ({kq}, {mq}, {bq}) f64"},
    }
    for name, r in probe_rows.items():
        r["launches"] = launches_probe[name]
        r["max_abs_err"] = rel_err(r["kernel"](), r["plain"]())[0]
    # the f64 routes at the main size (the x64 binary_cv's gram, and
    # hat_apply at a permutation chunk's width)
    main64_rows = {
        "gram": {"kernel": lambda: gram(x64c), "plain": lambda: gram_ref(x64c),
                 "library": lambda: torch.mm(x64c, x64c.T),
                 "bytes": (n * p + n * n) * f8, "flops": n * (n + 1) * p, "dtype": f64,
                 "shape": f"X ({n}, {p}) f64"},
        "hat_apply": {"kernel": lambda: hat_errors(h64, yp64),
                      "plain": lambda: hat_apply_ref(h64, yp64),
                      "library": lambda: torch.addmm(yp64, h64, yp64, alpha=-1.0),
                      "bytes": (n * n + 2 * n * b_) * f8, "flops": 2 * n * n * b_, "dtype": f64,
                      "shape": f"H ({n}, {n}), Y ({n}, {b_}) f64"},
    }

    def timing(r):
        b_ms, b_by = bound(r["bytes"], r["flops"], r.get("dtype", torch.float32))
        k_ms = cuda_ms(r["kernel"])
        lib = r["library"]
        out = {"ms": k_ms, "kernel_ms": k_ms, "device_ms": device_ms(r["kernel"]),
               "plain_ms": cuda_ms(r["plain"]), "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": cuda_ms(lib) if lib else None,
               "library_device_ms": device_ms(lib) if lib else None, "shape": r["shape"]}
        if "on_path" in r:  # the call the paths make: jitter="auto", check and retry inside
            out["on_path_ms"] = cuda_ms(r["on_path"])
            out["on_path_device_ms"] = device_ms(r["on_path"])
        if "issued" in r:   # the tensor-core routes: TFLOP/s counted and issued
            out["tflops_counted"] = r["flops"] / k_ms / 1e9
            out["tflops_issued"] = r["issued"] / k_ms / 1e9
        return out

    kernels = []
    for r in rows:
        main_t = timing(r)
        entry = {
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "launches_by_path": {k: v[r["name"]] for k, v in by_path.items()},
            "max_abs_err": main_err[r["name"]], "tol": TOL[f32], **main_t}
        if r["name"] in probe_rows:
            pr = probe_rows[r["name"]]
            entry["shapes"] = [{**main_t, "max_abs_err": main_err[r["name"]]},
                               {**timing(pr), "max_abs_err": pr["max_abs_err"],
                                "launches": pr["launches"], "tol": TOL[f64]}]
        if r["name"] in main64_rows:
            entry["shapes"].append({**timing(main64_rows[r["name"]]),
                                    "max_abs_err": main64_err[r["name"]], "tol": TOL[f64]})
        if r["name"] in new_rows:
            entry.setdefault("shapes", [{**main_t, "max_abs_err": main_err[r["name"]]}])
            entry["shapes"] += [{**timing(nr), **{k: nr[k] for k in (
                "max_abs_err", "launches", "tol", "launches_note") if k in nr}}
                for nr in new_rows[r["name"]]]
        if r["name"] == "foldsolve":   # the checked launch by tile width, B in one block last
            entry["tile_widths"] = [
                {"shape": shape, "bb": bb, "blocks": K_ * min(-(-b_w // bb), 8),
                 "ms": cuda_ms(fn), "device_ms": device_ms(fn)}
                for shape, K_, b_w, hh, ee in (("main f32", kk_, b_, h_te, e_te),
                                               ("lm_probe f64", kq, bq, hq_te, eq_te))
                for bb in sorted({16, 32, 64, b_w})
                for fn in (lambda hh=hh, ee=ee, bb=bb: foldsolve_cuda(hh, ee, check=True,
                                                                      block=bb),)]
        if r["name"] == "gram":   # the bf16_gram build: bf16 products, f32 out
            bf16_lib, bf16_note = bf16_mm_f32(xb_main)
            entry["shapes"].append({**timing({
                "kernel": lambda: gram_cuda(xb_main), "plain": lambda: gram_ref(xb_main),
                "library": bf16_lib, "bytes": n * p * 2 + n * n * f4,
                "flops": n * (n + 1) * p, "dtype": torch.bfloat16, "issued": n * (n + 1) * p,
                "shape": f"bf16_gram: X ({n}, {p}) bf16 in, f32 out"}),
                "max_abs_err": bf16_gram_err, "tol": TOL[torch.bfloat16],
                "library_note": bf16_note})
        kernels.append(entry)
    # pairdist: the RSA path's shape (its launches; route S) and a
    # trial-level RDM in f32, f64 and bf16 (route T), each with the route
    # the rule gave it; then the route sweep behind the rule, device ms
    def cdist_sq(u):
        return lambda: torch.cdist(u, u, compute_mode="use_mm_for_euclid_dist").square()

    shapes = []
    xb8_lib, xb8_note = bf16_mm_f32(x8b)
    for u in (means8, x8, x8_64, x8b):
        cu, pu = u.shape
        dname = str(u.dtype).removeprefix("torch.")
        route = pairdist_route(cu, pu, u.dtype)
        # bounds: route T's f32 runs 3×TF32 on the tensor cores, as gram's
        # row counts it; f64 on DMMA (the f64 peak); bf16 at the bf16 peak
        peak = {"float32": "tf32" if route == "T" else f32, "float64": f64,
                "bfloat16": torch.bfloat16}[dname]
        row = {**timing({
            "kernel": lambda u=u: pairwise_sq_dists(u),
            "plain": lambda u=u: pairwise_sq_dists_ref(u),
            "library": xb8_lib if u.dtype == torch.bfloat16 else cdist_sq(u),
            "bytes": cu * pu * u.element_size() + cu * cu * (8 if u.dtype == f64 else f4),
            "flops": cu * (cu + 1) * pu, "dtype": peak,
            "shape": f"U ({cu}, {pu}) {dname}" + (" in, f32 out" if dname == "bfloat16"
                                                 else "")}),
            "max_abs_err": pd_err[(cu, dname)], "tol": TOL[u.dtype], "kernel_route": route}
        if u.dtype == torch.bfloat16:
            row["library_note"] = (f"{xb8_note}: the Gram product alone (bf16 in, f32 out), "
                                   "no distance epilogue")
        elif u.dtype == f64:
            row["library_note"] = "torch.cdist in f64, squared"
        shapes.append(row)
    route_sweep = []
    for (cc, dt), u in sweep_inputs.items():
        rs = {"c": cc, "p": PD_SWEEP_P, "dtype": str(dt).removeprefix("torch."),
              "rule": pairdist_route(cc, PD_SWEEP_P, dt)}
        for route in ("S", "T") if cc <= PD_S_MAX_C else ("T",):
            rs[f"{route}_device_ms"] = device_ms(lambda u=u, route=route: pairdist_cuda(
                u, route=route))
        rs["cdist_device_ms"] = device_ms(cdist_sq(u))
        route_sweep.append(rs)
    del sweep_inputs, x8_64, x8b
    kernels.append({
        "name": "pairdist", "route": "cuda", "source": "src/repro_torch/csrc/pairdist.cu",
        "replaces": "src/repro/kernels/pairdist/pairdist.py:55",
        "launches": launches_rsa["pairdist"],
        "launches_by_path": {k: v["pairdist"] for k, v in by_path.items()},
        "tol": TOL[f32], **shapes[0], "shapes": shapes, "route_sweep": route_sweep})
    # permdraw: the serve path's draw of a permutation test, T = 1,000 at its
    # bucket of 1,024 rows of N trials; bytes: the int64 rows written once;
    # the per-row randperm loop it replaced as the yardstick
    pd_key = (0x9E3779B9, 0x7F4A7C15)
    pd_t, pd_n = 1024, n
    pd_equal = torch.equal(permdraw(pd_key, pd_t, pd_n, device=dev),
                           permdraw_ref(pd_key, pd_t, pd_n, device=dev))
    kernels.append({
        "name": "permdraw", "route": "cuda", "source": "src/repro_torch/csrc/permdraw.cu",
        "replaces": "no TPU kernel: src/repro/core/permutation.py (jax.random.permutation)",
        "launches": srv["launches"]["permdraw"],
        "launches_by_path": {k: v["permdraw"] for k, v in by_path.items()},
        "equals_plain": pd_equal, **timing({
            "kernel": lambda: permdraw(pd_key, pd_t, pd_n, device=dev),
            "plain": lambda: permdraw_ref(pd_key, pd_t, pd_n, device=dev),
            "library": lambda: randperm_rows(SEED, pd_n, pd_t, dev),
            "bytes": pd_t * pd_n * 8, "flops": 0,
            "shape": f"(T, N) = ({pd_t}, {pd_n}) int64"}),
        "library_note": "a seeded torch.Generator and torch.randperm a row (the former draw)"})
    if not pd_equal:
        fail("permdraw: the kernel's rows differ from the plain version's")
    # flash_attention: gemma2-2b's global layer at 8,192 tokens (the row),
    # its local layer and the probe's shape; SDPA as the library yardstick,
    # timed with K/V expanded to Hq heads beforehand, the boolean
    # causal+window mask (is_causal for a global layer) and NO softcap
    # (SDPA has none)
    def sdpa_call(qa, ka, va, kw):
        group = qa.shape[1] // ka.shape[1]
        ke, ve = (t.repeat_interleave(group, dim=1) for t in (ka, va))
        s_ = qa.shape[2]
        if kw["window"] is None:
            return lambda: F.scaled_dot_product_attention(qa, ke, ve, is_causal=True,
                                                          scale=kw["scale"])
        idx = torch.arange(s_, device=dev)
        diff = idx[:, None] - idx[None, :]
        mask = (diff >= 0) & (diff < kw["window"])
        return lambda: F.scaled_dot_product_attention(qa, ke, ve, attn_mask=mask,
                                                      scale=kw["scale"])

    # each timed shape with its kernel route: bf16 on the tensor cores, f32 on
    # the SIMT cores; TFLOP/s on the counted operations (4·D·pairs·B·Hq, the
    # bound's) and on those the route issues (6·D·pairs·B·Hq with P split in
    # two on the tensor cores)
    attn_shapes = []
    for case in ("lm_serve global", "lm_serve local", "lm_serve prefill", "lm_probe",
                 "f32 I/O", "lm_moe prefill", "lm_moe_qwen3 prefill", "lm_hybrid prefill",
                 "lm_moe long", "lm_moe_probe", "lm_hybrid_probe", "lm_audio prefill",
                 "lm_vision prefill", "train global"):
        qa, ka, va, kw, err = attn_inputs[case]
        b_, hq, s_, d_ = qa.shape
        pairs = attention_pairs(s_, kw["window"])
        route = ROUTES[qa.dtype]
        counted = 4 * d_ * pairs * b_ * hq
        issued = (6 if route == "tensor_core" else 4) * d_ * pairs * b_ * hq
        layout = ("views of (B, S, H, D)" if case.startswith(("lm_", "train"))
                  else "contiguous")
        row = {**timing({
            "kernel": lambda qa=qa, ka=ka, va=va, kw=kw: flash_attention(qa, ka, va, **kw),
            "plain": lambda qa=qa, ka=ka, va=va, kw=kw: attention_ref(qa, ka, va, **kw),
            "library": sdpa_call(qa, ka, va, kw),
            "bytes": qa.element_size() * (2 * b_ * hq * s_ * d_ + 2 * b_ * ka.shape[1] * s_ * d_),
            "flops": counted, "dtype": qa.dtype,
            "shape": f"{case}: q ({b_}, {hq}, {s_}, {d_}), k/v ({b_}, {ka.shape[1]}, {s_}, "
                     f"{d_}) {str(qa.dtype).removeprefix('torch.')} {layout}, window "
                     f"{kw['window']}, softcap {kw['softcap']}"}),
            "max_abs_err": err, "kernel_route": route, "pairs": pairs,
            "tiles_visited": attention_tiles(s_, kw["window"], True, route) * b_ * hq,
            "library_note": "SDPA without the softcap" if kw["softcap"] is not None else
            "SDPA, the same function (no softcap; K/V expanded to the Hq heads before timing)"}
        row["tflops_counted"] = counted / row["ms"] / 1e9
        row["tflops_issued"] = issued / row["ms"] / 1e9
        attn_shapes.append(row)
    # the skips at work: the same 8,192-token inputs with every tile visited
    qa, ka, va, kw, _ = attn_inputs["lm_serve global"]
    full_ms = cuda_ms(lambda: flash_attention(qa, ka, va, scale=kw["scale"], causal=False,
                                              softcap=kw["softcap"]))
    skips = {"non_causal_ms": full_ms,
             "non_causal_tiles": attention_tiles(LM_LONG, None, False, "tensor_core") * 8,
             "global_ms": attn_shapes[0]["ms"], "global_tiles": attn_shapes[0]["tiles_visited"],
             "local_ms": attn_shapes[1]["ms"], "local_tiles": attn_shapes[1]["tiles_visited"]}
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:90",
        "launches": launches_serve["flash_attention"],
        "launches_by_path": {k: v["flash_attention"] for k, v in by_path.items()},
        "tol_ulps": TOL_ATTN_BF16_ULPS, **attn_shapes[0], "shapes": attn_shapes,
        "skips": skips, "hgmma": hgmma, "tensor_core_ptxas": flash_tc})
    emit({"kernels": kernels, "card": smi})
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start, "card": smi})

    print(f"nvidia-smi: {smi}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
