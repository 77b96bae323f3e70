"""Time gram and hat_apply of two checkouts on one NVIDIA GPU, in turns.

Run from the repository root, with another checkout unpacked beside it
(for example a parent commit: ``git archive <commit> | tar -x -C
.archive/parent``):

    python3 chip_compare.py .archive/parent

Each side runs in its own process (both packages are named
``repro_torch``), in the order other, this, this, other, on the same
inputs made from a seed: gram at the main path's X (787, 76,000) f32 and
hat_apply at H (787, 787), Y (787, 250) f32, beside ``torch.mm`` and
``torch.addmm`` at full f32. Each row is the CUDA-event time of the
Python call (median of 20 after 3 warm-ups, host launch path included)
and its device-busy time (torch.profiler), as ``chip_smoke.py`` times the
``kernels`` line. Prints one JSON line per run and, last, the card's name
and power limit. Needs a CUDA device; builds each side's kernels with
nvcc at first use.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def side(src: str) -> dict:
    """Time one checkout's kernels (run in a process of its own)."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs   # timing helpers only; puts ROOT/src on the path
    sys.path.insert(0, str(Path(src).resolve() / "src"))
    from repro_torch.kernels.gram.ops import gram
    from repro_torch.kernels.hat_apply.ops import hat_errors
    import repro_torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    x = torch.randn(787, 76000, generator=gen, device="cuda")
    xc = x - x.mean(dim=0, keepdim=True)
    h = torch.randn(787, 787, generator=gen, device="cuda") / 787
    y = torch.randn(787, 250, generator=gen, device="cuda")
    out = {"package": str(Path(repro_torch.__file__).parent.parent.parent)}
    for name, fn in (("gram", lambda: gram(xc)), ("torch.mm", lambda: torch.mm(xc, xc.T)),
                     ("hat_apply", lambda: hat_errors(h, y)),
                     ("torch.addmm", lambda: torch.addmm(y, h, y, alpha=-1.0))):
        out[name] = {"ms": cs.cuda_ms(fn), "device_ms": cs.device_ms(fn)}
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
