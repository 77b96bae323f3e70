"""Time gram, hat_apply, foldsolve, fold_eval and pairdist of two checkouts
on one NVIDIA GPU, in turns.

Run from the repository root, with another checkout unpacked beside it
(for example a parent commit: ``git archive <commit> | tar -x -C
.archive/parent``):

    python3 chip_compare.py .archive/parent

Each side runs in its own process (both packages are named
``repro_torch``), in the order other, this, this, other, on the same
inputs made from a seed: gram at the main path's X (787, 76,000) in f32
and f64 and at the lm_probe path's X (384, 2,304) in f64; hat_apply at
H (787, 787), Y (787, 250) in f32 and f64 and at the lm_probe path's
H (384, 384), Y (384, 64) in f64; each beside ``torch.mm`` or
``torch.addmm`` in the same dtype (f32 at full f32, no TF32); foldsolve at
the main path's h_te (10, 78, 78), E (10, 78, 250) in f32 and the
lm_probe path's (6, 64, 64), (6, 64, 64) in f64, and fold_eval at the
main path's h_rows (10, 78, 787), y (787, 1) in f32 and at (6, 64, 384),
(384, 64) in f64, each with jitter=None and as the paths call them
(jitter="auto", the residual check and retry), beside batched
``torch.linalg.solve`` (after a ``bmm`` for fold_eval); pairdist at the
RSA path's U (8, 76,000) f32 and at a trial-level U (787, 76,000) in f32
and f64, beside squared ``torch.cdist`` in the same dtype. gram's rows
carry a digest of the result's bytes, so two sides that compute it bit for
bit alike show the same digest. Each row
is the CUDA-event time of the Python call (median of 20 after 3
warm-ups, host launch path included), its device-busy time
(torch.profiler), as ``chip_smoke.py`` times the ``kernels`` line, and
each launched kernel's mean device µs per call. Prints one JSON line per
run and, last, the card's name and power limit. Needs a CUDA device;
builds each side's kernels with nvcc at first use.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def kernel_us(fn, reps: int = 10) -> dict:
    """Mean device µs per call of each kernel ``fn`` launches (torch.profiler,
    after 3 warm-ups). A programmatic dependent kernel starts before its
    predecessor ends and waits, so its time includes that wait."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:48]: e.self_device_time_total / reps for e in prof.key_averages()
            if e.self_device_time_total > 0}


def side(src: str) -> dict:
    """Time one checkout's kernels (run in a process of its own)."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs   # timing helpers only; puts ROOT/src on the path
    sys.path.insert(0, str(Path(src).resolve() / "src"))
    from repro_torch.kernels.fold_eval.ops import fold_eval
    from repro_torch.kernels.foldsolve.ops import foldsolve
    from repro_torch.kernels.gram.ops import gram
    from repro_torch.kernels.hat_apply.ops import hat_errors
    from repro_torch.kernels.pairdist.ops import pairwise_sq_dists
    import repro_torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    out = {"package": str(Path(repro_torch.__file__).parent.parent.parent)}
    for dt, (n, p), (nh, b) in ((torch.float32, (787, 76000), (787, 250)),
                                (torch.float64, (384, 2304), (384, 64)),
                                (torch.float64, (787, 76000), (787, 250))):
        x = torch.randn(n, p, generator=gen, device="cuda", dtype=dt)
        xc = x - x.mean(dim=0, keepdim=True)
        del x
        h = torch.randn(nh, nh, generator=gen, device="cuda", dtype=dt) / nh
        y = torch.randn(nh, b, generator=gen, device="cuda", dtype=dt)
        name = str(dt).removeprefix("torch.")
        for row, fn in ((f"gram {name} ({n}, {p})", lambda: gram(xc)),
                        (f"torch.mm {name} ({n}, {p})", lambda: torch.mm(xc, xc.T)),
                        (f"hat_apply {name} ({nh}, {nh})x({nh}, {b})", lambda: hat_errors(h, y)),
                        (f"torch.addmm {name} ({nh}, {nh})x({nh}, {b})",
                         lambda: torch.addmm(y, h, y, alpha=-1.0))):
            out[row] = {"ms": cs.cuda_ms(fn), "device_ms": cs.device_ms(fn),
                        "kernel_us": kernel_us(fn)}
            if row.startswith("gram"):   # the same bits on both sides, or not
                out[row]["digest"] = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
        del xc, h, y
    for dt, c, p in ((torch.float32, 8, 76000), (torch.float32, 787, 76000),
                     (torch.float64, 787, 76000)):
        u = torch.randn(c, p, generator=gen, device="cuda", dtype=dt)
        name = str(dt).removeprefix("torch.")
        for row, fn in ((f"pairdist {name} ({c}, {p})", lambda: pairwise_sq_dists(u)),
                        (f"cdist {name} ({c}, {p})", lambda: torch.cdist(
                            u, u, compute_mode="use_mm_for_euclid_dist").square())):
            out[row] = {"ms": cs.cuda_ms(fn), "device_ms": cs.device_ms(fn),
                        "kernel_us": kernel_us(fn)}
        del u
    for dt, k, m, b, n, bf in ((torch.float32, 10, 78, 250, 787, 1),
                               (torch.float64, 6, 64, 64, 384, 64)):
        a = torch.randn(k, m, m, generator=gen, device="cuda", dtype=dt) / (3 * m ** 0.5)
        h_te = -(a @ a.transpose(1, 2))         # I − H_Te SPD
        e = torch.randn(k, m, b, generator=gen, device="cuda", dtype=dt)
        h_rows = torch.randn(k, m, n, generator=gen, device="cuda", dtype=dt) / n
        y = torch.randn(n, bf, generator=gen, device="cuda", dtype=dt)
        y_te = torch.randn(k, m, bf, generator=gen, device="cuda", dtype=dt)
        eye = torch.eye(m, device="cuda", dtype=dt).expand(k, m, m)
        name = str(dt).removeprefix("torch.")
        fs, fe = f"({k}, {m}, {m})x{b}", f"({k}, {m}, {n})x({n}, {bf})"
        for row, fn in ((f"foldsolve jitter=None {name} {fs}",
                         lambda: foldsolve(h_te, e, jitter=None)),
                        (f"foldsolve jitter=auto {name} {fs}", lambda: foldsolve(h_te, e)),
                        (f"linalg.solve {name} {fs}", lambda: torch.linalg.solve(eye - h_te, e)),
                        (f"fold_eval jitter=None {name} {fe}",
                         lambda: fold_eval(h_rows, h_te, y, y_te, jitter=None)),
                        (f"fold_eval jitter=auto {name} {fe}",
                         lambda: fold_eval(h_rows, h_te, y, y_te)),
                        (f"bmm + linalg.solve {name} {fe}",
                         lambda: torch.linalg.solve(eye - h_te, y_te - torch.bmm(
                             h_rows, y.expand(k, n, bf))))):
            out[row] = {"ms": cs.cuda_ms(fn), "device_ms": cs.device_ms(fn),
                        "kernel_us": kernel_us(fn)}
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--side":
        print(json.dumps(side(sys.argv[2])), flush=True)
        return
    if len(sys.argv) != 2:
        raise SystemExit("usage: python3 chip_compare.py OTHER_CHECKOUT")
    other = sys.argv[1]
    for src in (other, str(ROOT), str(ROOT), other):
        run = subprocess.run([sys.executable, __file__, "--side", src], capture_output=True,
                             text=True)
        if run.returncode != 0:
            raise SystemExit(f"chip_compare: the side {src} failed:\n{run.stderr[-3000:]}")
        print(run.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)


if __name__ == "__main__":
    main()
