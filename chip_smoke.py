"""Drive the repro_torch main path on one NVIDIA GPU and check every kernel.

Run from the repository root:

    python3 chip_smoke.py

It builds the four CUDA kernels (gram, hat_apply, foldsolve, fold_eval)
from ``src/repro_torch/csrc`` with nvcc, drives the paper's workload at the
MEG/EEG size through the package's public entry points — binary LDA with
analytical 10-fold CV at P = 76,000 features, ridge CV, and a 1000-draw
permutation test — checks that every kernel launched on that run, holds
each kernel against its plain PyTorch version on the card (at the main
path's shapes, at ragged shapes, at f64, bf16 Gram, m = 1 and m = 393
folds, and a near-singular fold that forces the jitter retry), and checks
the results: against the Cholesky composite, against an f64 run, and,
at P = 3,800, analytical CV against retraining per fold.

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
    from repro_torch.core import permutation, regression
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
    xc = x - x.mean(dim=0, keepdim=True)
    lam = float((xc * xc).sum()) / n                             # tr(G_c) / N
    del xc

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
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
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
    lam38 = float(((x38 - x38.mean(dim=0)) ** 2).sum()) / n       # tr(G_c) / N
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
    lam_s = float(((xs - xs.mean(0)) ** 2).sum()) / 120
    small_gpu = fastcv.binary_cv(xs.double(), ys.double(), fs_gpu, lam_s)[0].cpu()
    small_cpu = fastcv.binary_cv(xs.double().cpu(), ys.double().cpu(), fs_cpu, lam_s)[0]
    e_cpu, s_cpu = rel_err(small_gpu, small_cpu)
    emit({"phase": "cpu_agreement", "N": 120, "P": 500, "dtype": "float64",
          "max_abs_err": e_cpu, "scale": s_cpu, "tol": TOL[torch.float64]})
    if e_cpu > TOL[torch.float64] * s_cpu:
        fail("CUDA and CPU results disagree on a small input")

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
    kernels = []
    for r in rows:
        b_ms, b_by = bound(r["bytes"], r["flops"], torch.float32)
        k_ms = cuda_ms(r["kernel"])
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "max_abs_err": main_err[r["name"]], "tol": TOL[f32],
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": cuda_ms(r["plain"]),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(r["library"]),
            "shape": r["shape"]})
    emit({"kernels": kernels, "card": smi})

    print(f"nvidia-smi: {smi}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
