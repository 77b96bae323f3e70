"""Drive the repro_torch paths on one NVIDIA GPU and check every kernel.

Run from the repository root:

    python3 chip_smoke.py

It builds the five CUDA kernels (gram, hat_apply, foldsolve, fold_eval,
pairdist) from ``src/repro_torch/csrc`` with nvcc, all at once, and drives
three paths at the paper's MEG/EEG size (787 trials, P = 76,000 features,
10-fold CV) through the package's public entry points:

* binary: binary LDA with analytical CV, ridge CV, and a 1000-draw
  permutation test (Algorithm 1);
* multi-class: 3-class LDA by Algorithm 2 and its 1000-draw permutation
  test, against an f64 composite run, and, at P = 1,900, analytical CV
  against retraining direct LDA per fold;
* RSA: 8-condition cross-validated RDMs (pairwise accuracy and contrast
  with and without the bias adjust, confusion), the condition-mean
  Euclidean RDM, and Spearman model scoring with a 1000-draw
  condition-permutation null.

Each path's launch counts are reset before it and read after it; every
kernel the path should run must have launched. Every kernel is held
against its plain PyTorch version on the card (at each path's own shapes
and column blocks, at ragged shapes, at f64, bf16, m = 1 and m = 393
folds, a near-singular fold that forces the jitter retry, and a
trial-level RDM of 787 patterns), and the results are checked: against
the Cholesky composite and against f64 composite runs (binary decision
values, multi-class predictions, the RSA path's accuracy, contrast and
confusion RDMs), and against retraining per fold (binary at P = 3,800,
multi-class at P = 1,900).

Each phase prints one JSON line. The line before the last is the card's
name and power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Without a CUDA device, or without the package beside it, it fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

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

# H100 SXM peaks (NVIDIA data sheet): memory 3.35 TB/s; outside the tensor
# cores f32 67 TFLOP/s and f64 34 TFLOP/s; bf16 tensor cores 989 TFLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12}

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


def emit(obj) -> None:
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


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max abs error, scale = max |want|, at least 1e-30)."""
    err = float((got.double() - want.double()).abs().max())
    scale = max(float(want.double().abs().max()), 1e-30)
    return err, scale


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expect_launches(path: str, launches: dict, names) -> None:
    missing = [k for k in names if launches.get(k, 0) <= 0]
    if missing:
        fail(f"kernels not launched on the {path} path: {missing}")


def lam_rule(x: torch.Tensor) -> float:
    """λ = tr(G_c) / N, the scale of the centered Gram's diagonal."""
    xc = x - x.mean(dim=0, keepdim=True)
    return float((xc * xc).sum()) / x.shape[0]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    from repro_torch.core import fastcv, folds as folds_mod, lda, metrics
    from repro_torch.core import multiclass, permutation, regression
    from repro_torch.data import eeg
    from repro_torch.kernels import _build
    from repro_torch.kernels.fold_eval.ops import fold_eval
    from repro_torch.kernels.fold_eval.ref import fold_eval_ref
    from repro_torch.kernels.foldsolve.ops import (fold_jitter,
                                                   fold_residual_bad, foldsolve)
    from repro_torch.kernels.foldsolve.ref import foldsolve_ref
    from repro_torch.kernels.gram.ops import centered_gram_plain, gram
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.hat_apply.ops import hat_errors
    from repro_torch.kernels.hat_apply.ref import hat_apply_ref
    from repro_torch.kernels.pairdist.ops import pairwise_sq_dists
    from repro_torch.kernels.pairdist.ref import pairwise_sq_dists_ref
    from repro_torch.rsa import compare as rsa_compare
    from repro_torch.rsa import rdm as rsa_rdm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()

    # -- 1. environment ------------------------------------------------------
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln] if log.is_file() else []
    emit({"phase": "build", "seconds": build_s, "hash": _build.source_hash(),
          "ptxas": ptxas})

    # -- 4. the main path at the paper's MEG/EEG size --------------------------
    ds, t_sim = timed(lambda: eeg.simulate_subject(SEED, n_trials=N_TRIALS, device=dev))
    x = eeg.windowed_features(ds, 5.0)                           # (787, 76000) f32
    y = (1 - 2 * ds.y).to(x.dtype)                               # ±1 labels
    n, p = x.shape
    if (n, p) != (787, 76000):
        fail(f"unexpected feature shape {(n, p)}")
    folds = folds_mod.kfold(n, K, seed=SEED, device=dev)
    lam = lam_rule(x)

    _build.reset_launches()
    (dvals, y_te), t_cv = timed(lambda: fastcv.binary_cv(x, y, folds, lam))
    (preds, r_te), t_ridge = timed(lambda: regression.analytical_cv(x, y, folds, lam))
    perm, t_perm = timed(lambda: permutation.analytical_permutation_binary(
        x, y, folds, lam, N_PERM, SEED, chunk=CHUNK))
    launches = dict(_build.LAUNCHES)
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
    dv_small = fastcv.binary_dvals(plan_small, y, fused=True)
    emit({"phase": "main_checks",
          "dvals_vs_composite": {"max_abs_err": e_comp, "scale": s_comp, "tol": TOL_DVALS_F32},
          "dvals_vs_f64": {"max_abs_err": e_f64, "scale": s_f64, "tol": TOL_DVALS_F32},
          "f64_vs_f64_composite": {"max_abs_err": e_64c, "scale": s_64c,
                                   "tol": TOL[torch.float64]},
          "accuracy_f64": float(metrics.binary_accuracy(dv64, y_te.double())),
          "small_lam": {"lam": lam_small, "bad_folds_before_retry": bad_small,
                        "finite_after_retry": bool(torch.isfinite(dv_small).all())}})
    if e_comp > TOL_DVALS_F32 * s_comp or e_f64 > TOL_DVALS_F32 * s_f64:
        fail("f32 decision values disagree with the composite or the f64 run")
    if e_64c > TOL[torch.float64] * s_64c:
        fail("f64 kernel route disagrees with the f64 composite")
    if not bool(torch.isfinite(dv_small).all()):
        fail("small-λ decision values are not finite after the jitter retry")

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
    _build.reset_launches()
    (pred3, y3_te), t_mc = timed(lambda: multiclass.analytical_cv_multiclass(
        x3, y3, folds3, MC_CLASSES, lam3))
    perm3, t_mperm = timed(lambda: permutation.analytical_permutation_multiclass(
        x3, y3, folds3, MC_CLASSES, lam3, N_PERM, SEED, chunk=MC_CHUNK))
    launches_mc = dict(_build.LAUNCHES)
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

    _build.reset_launches()
    (plan8, rdms, means8, scores8, null8), t_rsa = timed(rsa_path)
    launches_rsa = dict(_build.LAUNCHES)
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
    main_err = {
        "gram": check("gram", "main (787, 76000) f32", gram(xc), gram_ref(xc), TOL[f32],
                      g_exact),
        "hat_apply": check("hat_apply", "main (787, 787)x(787, 250) f32",
                           hat_errors(plan.h, yp), hat_apply_ref(plan.h, yp), TOL[f32]),
        "foldsolve": check("foldsolve", "main K=10 m=78 B=250 f32",
                           foldsolve(h_te, e_te, jitter=None), foldsolve_ref(h_te, e_te),
                           TOL[f32]),
        "fold_eval": check("fold_eval", "main K=10 m=78 N=787 B=1 f32",
                           fold_eval(h_rows, h_te, y1, y1_te, jitter=None),
                           fold_eval_ref(h_rows, h_te, y1, y1_te)[0], TOL[f32]),
    }
    # ragged shapes (no dimension a multiple of a tile) and f64
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for dt in (f32, f64):
        xr = torch.randn(130, 1037, generator=gen, device=dev, dtype=dt)
        check("gram", f"ragged (130, 1037) {dt}", gram(xr), gram_ref(xr), TOL[dt])
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
    x64c = x64 - x64.mean(dim=0, keepdim=True)
    check("gram", "main (787, 76000) f64", gram(x64c), gram_ref(x64c), TOL[f64])
    del x64c, xc64, g_exact
    xb = xc.to(torch.bfloat16)
    check("gram", "bf16_gram (787, 76000)", gram(xc, precision="bf16_gram"),
          gram_ref(xb), TOL[torch.bfloat16], gram_ref(xb.double()))
    del xb
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
    # pairdist: the RSA path's condition means, a trial-level RDM of all 787
    # patterns (f32, f64, bf16), and ragged shapes
    main_err["pairdist"] = check("pairdist", f"rsa path ({c8}, {p}) f32",
                                 pairwise_sq_dists(means8), pairwise_sq_dists_ref(means8),
                                 TOL[f32], pairwise_sq_dists_ref(means8.double()))
    pd_err = {(c8, "f32"): main_err["pairdist"]}
    pd_err[(n, "f32")] = check("pairdist", f"trial ({n}, {p}) f32", pairwise_sq_dists(x8),
                               pairwise_sq_dists_ref(x8), TOL[f32])
    x8_64 = x8.double()
    check("pairdist", f"trial ({n}, {p}) f64", pairwise_sq_dists(x8_64),
          pairwise_sq_dists_ref(x8_64), TOL[f64])
    x8b = x8.to(torch.bfloat16)
    check("pairdist", f"trial ({n}, {p}) bf16", pairwise_sq_dists(x8b),
          pairwise_sq_dists_ref(x8b), TOL[torch.bfloat16], pairwise_sq_dists_ref(x8b.double()))
    del x8_64, x8b
    for dt in (f32, f64):
        for cc, pp in ((5, 30), (33, 500), (130, 1037)):
            ur = torch.randn(cc, pp, generator=gen, device=dev, dtype=dt)
            check("pairdist", f"ragged ({cc}, {pp}) {dt}", pairwise_sq_dists(ur),
                  pairwise_sq_dists_ref(ur), TOL[dt])
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
         "bytes": (n * p + n * n) * f4, "flops": n * (n + 1) * p,
         "shape": f"X ({n}, {p}) f32"},
        {"name": "hat_apply", "source": "src/repro_torch/csrc/hat_apply.cu",
         "replaces": "src/repro/kernels/hat_apply/hat_apply.py:48",
         "kernel": lambda: hat_errors(plan.h, yp), "plain": lambda: hat_apply_ref(plan.h, yp),
         "library": lambda: torch.addmm(yp, plan.h, yp, alpha=-1.0),
         "bytes": (n * n + 2 * n * b_) * f4, "flops": 2 * n * n * b_,
         "shape": f"H ({n}, {n}), Y ({n}, {b_}) f32"},
        {"name": "foldsolve", "source": "src/repro_torch/csrc/foldsolve.cu",
         "replaces": "src/repro/kernels/foldsolve/foldsolve.py:71",
         "kernel": lambda: foldsolve(h_te, e_te, jitter=None),
         "plain": lambda: foldsolve_ref(h_te, e_te),
         "library": lambda: torch.linalg.solve(eye_b - h_te, e_te),
         "bytes": (kk_ * m_ * m_ + 2 * kk_ * m_ * b_) * f4,
         "flops": kk_ * (2 * m_ ** 3 / 3 + 2 * m_ * m_ * b_),
         "shape": f"h_te ({kk_}, {m_}, {m_}), e ({kk_}, {m_}, {b_}) f32"},
        {"name": "fold_eval", "source": "src/repro_torch/csrc/fold_eval.cu",
         "replaces": "src/repro/kernels/fold_eval/fold_eval.py:59",
         "kernel": lambda: fold_eval(h_rows, h_te, y1, y1_te, jitter=None),
         "plain": lambda: fold_eval_ref(h_rows, h_te, y1, y1_te),
         "library": lambda: torch.linalg.solve(eye_b - h_te, y1_te - torch.bmm(
             h_rows, y1.expand(kk_, n, 1))),
         "bytes": (kk_ * m_ * n + kk_ * m_ * m_ + n + 3 * kk_ * m_) * f4,
         "flops": 2 * kk_ * m_ * n + kk_ * (2 * m_ ** 3 / 3 + 2 * m_ * m_),
         "shape": f"h_rows ({kk_}, {m_}, {n}), y ({n}, 1) f32"},
    ]
    by_path = {"binary": launches, "multiclass": launches_mc, "rsa": launches_rsa}

    def timing(r):
        b_ms, b_by = bound(r["bytes"], r["flops"], torch.float32)
        k_ms = cuda_ms(r["kernel"])
        return {"ms": k_ms, "kernel_ms": k_ms, "plain_ms": cuda_ms(r["plain"]),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(r["library"]),
                "shape": r["shape"]}

    kernels = []
    for r in rows:
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "launches_by_path": {k: v[r["name"]] for k, v in by_path.items()},
            "max_abs_err": main_err[r["name"]], "tol": TOL[f32], **timing(r)})
    # pairdist: the RSA path's shape (its launches) and a trial-level RDM
    shapes = []
    for u in (means8, x8):
        cu, pu = u.shape
        shapes.append({**timing({
            "kernel": lambda u=u: pairwise_sq_dists(u),
            "plain": lambda u=u: pairwise_sq_dists_ref(u),
            "library": lambda u=u: torch.cdist(
                u, u, compute_mode="use_mm_for_euclid_dist").square(),
            "bytes": (cu * pu + cu * cu) * f4, "flops": cu * (cu + 1) * pu,
            "shape": f"U ({cu}, {pu}) f32"}), "max_abs_err": pd_err[(cu, "f32")]})
    kernels.append({
        "name": "pairdist", "route": "cuda", "source": "src/repro_torch/csrc/pairdist.cu",
        "replaces": "src/repro/kernels/pairdist/pairdist.py:55",
        "launches": launches_rsa["pairdist"],
        "launches_by_path": {k: v["pairdist"] for k, v in by_path.items()},
        "tol": TOL[f32], **shapes[0], "shapes": shapes})
    emit({"kernels": kernels, "card": smi})

    print(f"nvidia-smi: {smi}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
