"""Multi-pod dry run: trace every (arch × shape × mesh) cell on the host.

The port of the reference's ``launch/dryrun.py``. The reference lowers and
compiles each cell's step for 512 placeholder host devices; here each cell
runs its step once, eagerly, on fake tensors under a fake process group of
256 or 512 ranks (``torch.testing``'s ``FakeStore``, backend ``"fake"``),
as rank 0 of the production mesh. Nothing is allocated and no collective
moves data. This is a host tool: the mesh is a ``cpu`` mesh, so attention
runs through its plain version (``attention_ref``), as it does on the
CPU; the card's path is not touched.

For every cell this driver:
  1. builds the parameters, optimizer state, batch and caches as fake CPU
     tensors (``FakeTensorMode``), laid out as DTensors with placements
     from ``launch.sharding``'s rules,
  2. runs the cell's step from ``train.steps`` once under the step counter
     (``launch.step_analysis``), which counts what rank 0 executes,
  3. records per-rank argument bytes (exact, from the placements), the
     counter's FLOPs, dot bytes and collective bytes by kind, and the
     seconds the trace took into ``<out>/<cell>.json``, in the
     reference's record layout (``loop_aware`` holds the counts, which
     ``launch.roofline`` reads).

A cell that cannot be traced (an op DTensor has no sharding strategy for,
an uneven view) is recorded with ``ok: false`` and its error. The fake
group is a CPU group, which has no all-to-all: DTensor issues an
all-gather where a cuda mesh would issue an all-to-all.

Usage (no default output directory: ``--out`` is required; give each run
a fresh one, since ``launch.roofline`` reads every record in its
``--dryrun-dir``):
  out=$(mktemp -d)
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out "$out"
  PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun-dir "$out"
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate

from repro_torch.configs import shapes as shp
from repro_torch.configs.base import ArchConfig, get_config, list_archs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import MeshShape, make_production_mesh, production_shape
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as O
from repro_torch.train import steps

__all__ = ["run_cell", "input_specs", "main"]


# ----------------------------------------------------------- the group --

def _fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks, this process rank 0.
    Replaces a fake group of another size; refuses a real one."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is running; the dry "
                               "run needs its own fake group (run it in another process)")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


# ------------------------------------------------------------- layouts --

def _dp_axes(mesh, rules: sh.Rules) -> tuple:
    rule = rules.logical.get("batch") or ("pod", "data")
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    return tuple(a for a in axes if a in MeshShape.of(mesh).axis_names)


def _activation_like_spec(shape, batch_sizes, mesh, rules: sh.Rules) -> tuple:
    """Cache/state placements: batch dim -> DP axes; the largest remaining
    model-divisible dim -> "model" (memory-first layout for decode caches)."""
    sizes = MeshShape.of(mesh).shape
    dp = _dp_axes(mesh, rules)
    dp_size = math.prod(sizes[a] for a in dp)
    m = sizes.get("model", 1)
    spec = [()] * len(shape)
    for i, s in enumerate(shape):
        if s in batch_sizes and s % dp_size == 0:
            spec[i] = dp
            break
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if not spec[i] and s % m == 0 and s > best_size and s >= m:
            best, best_size = i, s
    if best is not None and m > 1:
        spec[best] = ("model",)
    return sh._placements(spec, mesh)


def _local_bytes(t) -> int:
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.numel() * local.element_size()


def _distribute(t: torch.Tensor, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


def _distributed_model(cfg: ArchConfig, mesh, rules: sh.Rules, requires_grad: bool,
                       model: Optional[M.Model] = None) -> M.Model:
    """``model`` (default ``Model(cfg)`` on the CPU) with every parameter a
    DTensor of its placements, each rank keeping its shard of the tensor it
    holds (no data moves)."""
    model = M.Model(cfg, "cpu") if model is None else model
    named = dict(model.named_parameters())
    placements = sh.param_placements({n: tuple(p.shape) for n, p in named.items()}, mesh,
                                     rules, cfg)
    for name, p in named.items():
        prefix, _, leaf = name.rpartition(".")
        owner = model.get_submodule(prefix) if prefix else model
        new = torch.nn.Parameter(_distribute(p.detach(), mesh, placements[name]),
                                 requires_grad=requires_grad)
        if isinstance(owner, torch.nn.ParameterDict):
            owner[leaf] = new
        else:
            setattr(owner, leaf, new)
    return model


def _opt_state(model: M.Model, mesh, rules: sh.Rules, opt_cfg: O.AdamWConfig) -> O.OptState:
    """ZeRO-1 optimizer state: f32 master and moments with
    ``opt_state_spec`` placements, a replicated step."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    placements = sh.opt_state_placements(shapes, mesh, rules)

    def tree():
        return {n: _distribute(torch.empty(s, dtype=torch.float32), mesh, placements[n])
                for n, s in shapes.items()}

    replicated = [Replicate()] * len(MeshShape.of(mesh).axis_names)
    return O.OptState(step=_distribute(torch.zeros((), dtype=torch.int32), mesh, replicated),
                      master=tree(), mu=tree(), nu=tree(),
                      err=tree() if opt_cfg.compress_grads else None)


def input_specs(cfg: ArchConfig, shape: shp.Shape, mesh, rules: sh.Rules,
                microbatches: int = 1, accum_dtype=None):
    """Fake DTensor stand-ins for one cell (call under ``FakeTensorMode``).
    Returns (step_fn, args dict, {part: per-rank bytes})."""
    sizes = MeshShape.of(mesh).shape
    dp = _dp_axes(mesh, rules)
    b, s = shape.global_batch, shape.seq_len
    # drop axes from the right until the global batch divides evenly
    while dp and b % math.prod(sizes[a] for a in dp) != 0:
        dp = dp[:-1]

    def batch_tensor(shape_, dtype):
        return _distribute(torch.zeros(shape_, dtype=dtype), mesh,
                           sh._placements([dp] + [()] * (len(shape_) - 1), mesh))

    def batch_specs(seq):
        tok = (b, cfg.num_codebooks, seq) if cfg.num_codebooks else (b, seq)
        specs = {"tokens": batch_tensor(tok, torch.int32),
                 "labels": batch_tensor(tok, torch.int32)}
        if cfg.vision_tokens:
            specs["vision_embeds"] = batch_tensor((b, cfg.vision_tokens, cfg.vision_dim),
                                                  torch.float32)
        return specs

    model = _distributed_model(cfg, mesh, rules, requires_grad=shape.kind == "train")
    nbytes = {"param_bytes": sum(_local_bytes(p) for p in model.parameters())}

    if shape.kind == "train":
        opt_cfg = O.AdamWConfig()
        opt_state = _opt_state(model, mesh, rules, opt_cfg)
        fn = steps.make_train_step(cfg, opt_cfg, microbatches=microbatches,
                                   accum_dtype=accum_dtype or torch.float32)
        batch = batch_specs(s)
        nbytes["opt_state_bytes"] = sum(
            _local_bytes(t) for t in [opt_state.step] + [
                x for part in (opt_state.master, opt_state.mu, opt_state.nu,
                               opt_state.err or {}) for x in part.values()])
        nbytes["batch_bytes"] = sum(_local_bytes(t) for t in batch.values())
        return fn, dict(params=model, opt_state=opt_state, batch=batch), nbytes

    if shape.kind == "prefill":
        fn = steps.make_prefill_step(cfg, microbatches=microbatches)
        batch = batch_specs(s)
        batch.pop("labels")
        nbytes["batch_bytes"] = sum(_local_bytes(t) for t in batch.values())
        return fn, dict(params=model, batch=batch), nbytes

    # decode: one new token against a cache of seq_len
    caches = [{k: _distribute(v, mesh, _activation_like_spec(v.shape, {b}, mesh, rules))
               for k, v in layer.items()}
              for layer in T.init_trunk_cache(cfg, b, s, "cpu")]
    tok_shape = (b, cfg.num_codebooks, 1) if cfg.num_codebooks else (b, 1)
    tokens = batch_tensor(tok_shape, torch.int32)
    fn = steps.make_decode_step(cfg)
    nbytes["batch_bytes"] = _local_bytes(tokens)
    nbytes["cache_bytes"] = sum(_local_bytes(t) for layer in caches for t in layer.values())
    return fn, dict(params=model, tokens=tokens, pos=s - 1, caches=caches), nbytes


# ---------------------------------------------------------------- cell --

#: Why ``memory.temp_bytes`` is null. torch's private MemTracker runs over
#: the fake trace, but its peaks are no memory a rank could hold (the full
#: gemma2-2b train_4k cell: 1.23e12 B a rank, growing with tokens × vocabulary),
#: and no test holds it to a hand count.
TEMP_BYTES_NOTE = ("not recorded: MemTracker over fake DTensors gives peaks no rank could "
                   "hold, and no hand count checks it")


def run_cell(arch: Union[str, ArchConfig], shape: Union[str, shp.Shape], multi_pod: bool,
             out_dir: Optional[Path] = None, *, profile: str = "tp",
             gathered_embed: bool = False, tag: str = "", microbatches: int = 1,
             kv_quant: bool = False, accum_dtype=None) -> dict:
    """Trace one cell and return its record (written to ``out_dir`` when
    given). ``arch`` is a name or a config (e.g. a smoke config), ``shape``
    a name of ``configs.shapes.SHAPES`` or a :class:`~repro_torch.configs.shapes.Shape`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = shp.get_shape(shape) if isinstance(shape, str) else shape
    if kv_quant and shape.kind in ("prefill", "decode"):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if cfg.moe_experts and shape.kind != "train":
        # inference capacity factor 1.0 (standard serving practice)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=1.0)
    mshape = production_shape(multi_pod=multi_pod)
    mesh_name = "x".join(map(str, mshape.sizes))
    rules = sh.rules_for(profile, gathered_embed=gathered_embed)
    arch_name = arch if isinstance(arch, str) else cfg.name
    cell_id = f"{arch_name}__{shape.name}__{mesh_name}" + (f"__{tag}" if tag else "")
    result = {"arch": arch_name, "shape": shape.name, "mesh": mesh_name,
              "profile": profile, "gathered_embed": gathered_embed, "tag": tag,
              "microbatches": microbatches, "kv_quant": kv_quant,
              "kind": shape.kind, "seq_len": shape.seq_len,
              "global_batch": shape.global_batch, "num_chips": mshape.size,
              "rules": rules.as_dict()}
    t0 = time.time()
    try:
        _fake_group(mshape.size)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        with FakeTensorMode():
            fn, args, nbytes = input_specs(cfg, shape, mesh, rules, microbatches=microbatches,
                                           accum_dtype=accum_dtype)
            t_build = time.time() - t0
            with sh.axis_ctx(mesh, rules):
                counts = analyze_step(fn, **args, mesh=mesh)
        t_trace = time.time() - t0 - t_build
        counts.pop("output")
        counts.pop("flash")                   # no launch: the fake trace takes attention_ref
        coll = {"bytes": counts["collective_bytes"], "counts": counts["collective_counts"],
                "total_bytes": counts["collective_total_bytes"]}
        result.update({
            "ok": True,
            "build_s": round(t_build, 2),
            "trace_s": round(t_trace, 2),
            "memory": dict(nbytes, argument_bytes=sum(nbytes.values()),
                           temp_bytes=None, temp_bytes_note=TEMP_BYTES_NOTE),
            "collectives": coll,
            "loop_aware": counts,
        })
        print(f"[dryrun] OK   {cell_id}  build={t_build:.1f}s trace={t_trace:.1f}s "
              f"flops={counts['flops']:.3e} coll={counts['collective_total_bytes']:.3e}B")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        result.update({"ok": False, "error": f"{type(e).__name__}: {str(e)[:2000]}",
                       "traceback": traceback.format_exc()[-2000:],
                       "seconds": round(time.time() - t0, 2)})
        print(f"[dryrun] FAIL {cell_id}: {type(e).__name__}: {str(e)[:300]}")
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{cell_id}.json").write_text(json.dumps(result, indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=(
        "Trace every (arch x shape x mesh) cell on fake CPU tensors under a fake process "
        "group of 256 / 512 ranks (a host tool: attention takes its plain version)."))
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", required=True,
                    help="directory for the cell records: a fresh one outside the "
                    "checkout (the roofline reads every record in it)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--profile", default="tp", choices=["tp", "dp", "dp16", "fsdp"])
    ap.add_argument("--gathered-embed", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="gradient-accumulation steps for train cells")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV caches for prefill/decode cells")
    args = ap.parse_args(argv)

    # the reference's per-arch memory plans: µ-chunks stay >= the DP size
    train_mu = {"internlm2-20b": 16, "qwen3-moe-30b-a3b": 16}
    train_accum = {"internlm2-20b": torch.bfloat16, "qwen3-moe-30b-a3b": torch.bfloat16}
    prefill_mu = {"olmoe-1b-7b": 2, "qwen3-moe-30b-a3b": 2}

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cfg = get_config(arch)
        shape_names = (shp.cells_for(cfg) if args.shape == "all"
                       else args.shape.split(","))
        for shape_name in shape_names:
            if shape_name not in shp.cells_for(cfg):
                print(f"[dryrun] SKIP {arch}×{shape_name} (documented skip)")
                n_skip += 1
                continue
            for multi in meshes:
                mshape = production_shape(multi_pod=multi)
                mesh_name = "x".join(map(str, mshape.sizes))
                suffix = f"__{args.tag}" if args.tag else ""
                f = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
                if args.skip_existing and f.exists() and json.loads(f.read_text()).get("ok"):
                    n_ok += 1
                    continue
                shape = shp.get_shape(shape_name)
                dpn = math.prod(n for a, n in mshape.shape.items() if a in ("pod", "data"))
                if shape.kind == "train":
                    mb = min(train_mu.get(arch, args.microbatches),
                             max(shape.global_batch // dpn, 1))
                elif shape.kind == "prefill":
                    mb = min(prefill_mu.get(arch, 1), max(shape.global_batch // dpn, 1))
                else:
                    mb = 1
                r = run_cell(arch, shape_name, multi, out_dir, profile=args.profile,
                             gathered_embed=args.gathered_embed, tag=args.tag,
                             microbatches=mb, kv_quant=args.kv_quant,
                             accum_dtype=train_accum.get(arch) if shape.kind == "train"
                             else None)
                n_ok += int(r["ok"])
                n_fail += int(not r["ok"])
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
