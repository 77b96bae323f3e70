"""Roofline analysis from the dry-run records, with H100 constants.

The port of the reference's ``launch/roofline.py``. Per (arch × shape) on
one mesh:

  compute term    = FLOPs_per_rank / peak_FLOP/s
  memory term     = dot_HBM_bytes_per_rank / HBM_bw   (+ optimizer traffic)
  collective term = collective_bytes_per_rank / link_bw

All three in seconds per step; the largest names the bottleneck. FLOPs and
bytes are the step counter's (``launch.step_analysis``), read from the
records' ``loop_aware`` key, which ``launch.dryrun`` writes in the
reference's layout (so the reference's records read here too).

MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill, decode), N the parameters of
``Model(cfg, "meta")`` (for MoE, the active share: the experts' tensors
count k/E of their size). The ratio MODEL_FLOPS / (FLOPs × ranks) shows
how much counted compute is "useful" (remat and attention push it below
1, compute replicated over a mesh axis further).

Hardware constants (NVIDIA H100 SXM5 data sheet): 989 TFLOP/s dense bf16
tensor-core peak, 3.35 TB/s HBM3, and NVLink 4 at 450 GB/s per direction
per GPU (18 links, 900 GB/s total both ways).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import shapes as shp
from repro_torch.configs.base import get_config

PEAK_FLOPS = 989e12        # bf16 dense, H100 SXM5
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 450e9            # bytes/s per direction per GPU, NVLink 4 (18 links)

__all__ = ["roofline_row", "build_table", "main", "param_count", "PEAK_FLOPS", "HBM_BW",
           "LINK_BW"]


def param_count(cfg, *, active: bool = False) -> int:
    """Parameters of ``Model(cfg, "meta")``; with ``active`` the MoE experts'
    tensors count top_k / experts of their size (the parameters one token
    touches)."""
    from repro_torch.models.model import Model

    total = 0
    for name, p in Model(cfg, "meta").named_parameters():
        n = p.numel()
        if active and cfg.moe_experts and ".moe.w_" in name:
            n = n * cfg.moe_top_k // cfg.moe_experts
        total += n
    return total


def _model_flops(cfg, shape) -> float:
    n = param_count(cfg, active=bool(cfg.moe_experts))
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n * tokens


def _opt_traffic_per_chip(cfg, num_chips) -> float:
    """AdamW: read+write master/mu/nu (f32) + read grads + write params."""
    return (3 * 2 * 4 + 4 + 2) * param_count(cfg) / num_chips


def roofline_row(rec: dict) -> dict:
    cfg = get_config(rec["arch"])
    shape = shp.get_shape(rec["shape"])
    chips = rec["num_chips"]
    la = rec["loop_aware"]
    flops = la["flops"]                       # per rank
    mem_bytes = la["dot_hbm_bytes"]
    if shape.kind == "train":
        mem_bytes += _opt_traffic_per_chip(cfg, chips)
    coll_bytes = la["collective_total_bytes"]

    t_compute = flops / PEAK_FLOPS
    t_memory = mem_bytes / HBM_BW
    t_coll = coll_bytes / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    model_fl = _model_flops(cfg, shape)
    useful = model_fl / max(flops * chips, 1.0)
    # roofline fraction: useful work at peak vs the time the dominant
    # term needs — how close the step is to the hardware's best case
    t_ideal = model_fl / chips / PEAK_FLOPS
    frac = t_ideal / bound if bound > 0 else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "flops_per_chip": flops, "mem_bytes_per_chip": mem_bytes,
        "coll_bytes_per_chip": coll_bytes,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": model_fl, "useful_ratio": useful,
        "roofline_fraction": frac,
        "temp_bytes": (rec.get("memory") or {}).get("temp_bytes"),
    }


_SUGGEST = {
    "compute": "reduce recompute (remat policy) or replicated compute over the model axis",
    "memory": "fuse/elide HBM round-trips; larger microbatch amortises weight reads",
    "collective": "reshard to cut all-gathers (SP/ZeRO tuning) or overlap collectives with compute",
}


def build_table(dryrun_dir: Path, mesh: str = "16x16") -> tuple[str, list]:
    rows = []
    for f in sorted(dryrun_dir.glob(f"*__{mesh}.json")):
        rec = json.loads(f.read_text())
        if rec.get("ok") and "loop_aware" in rec:
            rows.append(roofline_row(rec))
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | useful | roofline frac | next move |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['model_flops']:.2e} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_fraction']:.2%} | "
            f"{_SUGGEST[r['dominant']]} |")
    return "\n".join(lines), rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", required=True, help="the dry run's --out directory")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--out", default=None,
                    help="directory for roofline_<mesh>.md / .json (default: print only)")
    args = ap.parse_args(argv)
    table, rows = build_table(Path(args.dryrun_dir), args.mesh)
    if args.out is not None:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"roofline_{args.mesh}.md").write_text(table + "\n")
        (out / f"roofline_{args.mesh}.json").write_text(json.dumps(rows, indent=2))
    print(table)


if __name__ == "__main__":
    main()
