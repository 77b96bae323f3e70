"""repro_torch.launch.dryrun on the smoke configurations.

A smoke-config sweep: every dense architecture's train, prefill and decode
cells on the single-pod mesh (gemma2-2b on the multi-pod mesh too), built
from reduced ``Shape`` objects passed to ``run_cell`` (the CLI keeps the
reference's shapes), traced on fake tensors under fake groups of 256 and
512 ranks. The groups are process-global, so the sweep runs in one
subprocess (the module's problem) and hands its records back as JSON.

Every cell traces, and each record's per-rank parameter and optimizer
bytes equal the sum of the reference's local shard sizes: its
``param_sharding_tree`` and ``opt_state_spec`` specs on an
``AbstractMesh`` applied to its own parameter tree. No name of these
configs has a mesh axis on a repeat axis (``tests/test_torch_sharding.py``
lists them), so no tensor is set aside.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import base as ref_base
from repro.launch import sharding as ref_sh
from repro.models import model as ref_model

_SRC = str(Path(__file__).resolve().parents[1] / "src")
# f32 logits under a mesh against none, over the largest |logit|: only the
# order of the sums over ranks differs
TOL_MESHED = 1e-5
DENSE = ["gemma2-2b", "internlm2-20b", "minicpm-2b", "starcoder2-3b"]
CELLS = [(a, kind, False) for a in DENSE for kind in ("train", "prefill", "decode")] + \
    [("gemma2-2b", kind, True) for kind in ("train", "prefill", "decode")]

_SWEEP = r"""
import json, sys
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import Shape
from repro_torch.launch.dryrun import run_cell

shapes = {"train": Shape("train_smoke", 32, 64, "train"),
          "prefill": Shape("prefill_smoke", 32, 32, "prefill"),
          "decode": Shape("decode_smoke", 64, 32, "decode")}
for arch, kind, multi in json.loads(sys.argv[1]):
    rec = run_cell(get_config(arch, smoke=True), shapes[kind], multi, microbatches=2
                   if kind == "train" else 1)
    rec["arch_name"] = arch
    print("RECORD " + json.dumps(rec), flush=True)
rec = run_cell(get_config("gemma2-2b", smoke=True), shapes["train"], False, microbatches=2,
               gathered_embed=True)
print("GATHERED " + json.dumps(rec), flush=True)
"""


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [_SRC, os.environ.get("PYTHONPATH")])))
    run = subprocess.run([sys.executable, "-c", _SWEEP, json.dumps(CELLS)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    recs = [json.loads(line[7:]) for line in run.stdout.splitlines()
            if line.startswith("RECORD ")]
    assert len(recs) == len(CELLS)
    out = {(r["arch_name"], r["kind"], r["num_chips"] == 512): r for r in recs}
    (line,) = [line for line in run.stdout.splitlines() if line.startswith("GATHERED ")]
    out["gathered"] = json.loads(line[9:])
    return out


def _local_bytes(spec, shape, itemsize, mesh) -> int:
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        n *= size // math.prod(mesh.shape[a] for a in axes)
    return n * itemsize


def _reference_bytes(arch, multi):
    """(param bytes, optimizer-state bytes) one reference device holds."""
    assert dict(ref_sh.LOGICAL_RULES)["heads"] == "model" and not ref_sh.FSDP   # "tp"
    cfg = ref_base.get_config(arch, smoke=True)
    mesh = AbstractMesh((2, 16, 16) if multi else (16, 16),
                        ("pod", "data", "model") if multi else ("data", "model"))
    tree = jax.eval_shape(lambda: ref_model.init_params(jax.random.PRNGKey(0), cfg))
    specs = jax.tree.leaves(ref_sh.param_sharding_tree(tree, mesh),
                            is_leaf=lambda x: hasattr(x, "spec"))
    leaves, _ = ref_sh._flatten_with_paths(tree)
    params = sum(_local_bytes(s.spec, leaf.shape, np.dtype(leaf.dtype).itemsize, mesh)
                 for s, (_, leaf) in zip(specs, leaves))
    opt = 4                                                   # the int32 step
    for path, leaf in leaves:
        spec = ref_sh.opt_state_spec(path, len(leaf.shape), leaf.shape, mesh)
        opt += 3 * _local_bytes(spec, leaf.shape, 4, mesh)   # f32 master, mu, nu
    return params, opt


@pytest.mark.parametrize("arch,kind,multi", CELLS)
def test_every_dense_smoke_cell_traces(records, arch, kind, multi):
    rec = records[(arch, kind, multi)]
    assert rec["ok"], rec.get("error")
    la = rec["loop_aware"]
    assert set(la) == {"flops", "dot_hbm_bytes", "collective_bytes", "collective_counts",
                       "collective_total_bytes"}
    assert la["flops"] > 0 and la["dot_hbm_bytes"] > 0
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    mem = rec["memory"]
    assert mem["argument_bytes"] == sum(v for k, v in mem.items()
                                        if k.endswith("_bytes") and k not in
                                        ("argument_bytes", "temp_bytes"))
    # no temp figure that cannot be trusted: null, with the reason
    assert mem["temp_bytes"] is None and mem["temp_bytes_note"].startswith("not recorded")
    params, opt = _reference_bytes(arch, multi)
    assert mem["param_bytes"] == params
    if kind == "train":
        assert mem["opt_state_bytes"] == opt
        assert la["collective_total_bytes"] > 0       # ZeRO-1 and the data-parallel reduce


def test_gathered_embed_gathers_the_table(records):
    """--gathered-embed replicates the vocab-sharded table before the lookup:
    the same FLOPs, more all-gathered bytes, its rules recorded."""
    plain, gathered = records[("gemma2-2b", "train", False)], records["gathered"]
    assert gathered["ok"] and gathered["rules"]["gathered_embed"]
    assert gathered["loop_aware"]["flops"] == plain["loop_aware"]["flops"]
    assert gathered["loop_aware"]["collective_bytes"]["all-gather"] > \
        plain["loop_aware"]["collective_bytes"]["all-gather"]


def test_cli_has_no_default_output_directory():
    from repro_torch.launch import dryrun

    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "gemma2-2b"])


# ------------------------------------------- the layouts compute the same --

_MESHED = r"""
import json, sys, tempfile
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, path, arch):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun, sharding as sh
    from repro_torch.models import model as M

    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_config(arch, smoke=True)
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
    vis = (torch.randn((4, cfg.vision_tokens, cfg.vision_dim), generator=gen)
           if cfg.vision_tokens else None)
    with torch.no_grad():
        want = M.forward(model, tokens, cfg, vision_embeds=vis)[0]
        rules = sh.rules_for("tp")
        meshed = dryrun._distributed_model(cfg, mesh, rules, False, model)
        heads = meshed.blocks.layers[0].attn.wq.placements
        batch = sh._placements([("data",), ()], mesh)
        put = lambda t: dryrun._distribute(t, mesh, batch if t.ndim == 2 else
                                           sh._placements([("data",), (), ()], mesh))
        with sh.axis_ctx(mesh, rules), implicit_replication():
            got = M.forward(meshed, put(tokens), cfg,
                            vision_embeds=None if vis is None else put(vis))[0]
        got = got.full_tensor()
    if rank == 0:
        err = ((got - want).abs().max() / want.abs().max()).item()
        print("RESULT " + json.dumps({"err": err, "wq": [str(p) for p in heads]}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    with tempfile.NamedTemporaryFile() as f:
        mp.spawn(run, args=(f.name, sys.argv[1]), nprocs=4)
"""


@pytest.mark.parametrize("arch", ["gemma2-2b", "llama-3.2-vision-11b"])
def test_forward_under_a_mesh_equals_the_forward_without_one(tmp_path, arch):
    """The smoke model's logits on a (2, 2) ("data", "model") mesh of four
    gloo ranks, its parameters laid out by the dry run's placements (wq's
    heads split over "model"), equal its logits without a mesh: the heads
    layout of full attention (K/V repeated to Hq, each rank on its own
    heads) and the cross layers' route compute the same function. f32;
    only the order of the sums over ranks differs."""
    script = tmp_path / "meshed.py"
    script.write_text(_MESHED)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [_SRC, os.environ.get("PYTHONPATH")])))
    run = subprocess.run([sys.executable, str(script), arch], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    (line,) = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")]
    res = json.loads(line[7:])
    assert res["wq"] == ["R", "S(1)"]                         # the heads split on "model"
    assert res["err"] <= TOL_MESHED, res
