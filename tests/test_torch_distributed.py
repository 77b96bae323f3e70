"""repro_torch.core.distributed, rsa.searchlight_rdm and the engine's mesh
options on the CPU, against the reference's core.distributed.

Two parts, on f64 inputs made from a seed with numpy:

* In process: a world-size-1 gloo group (a ``FileStore`` under a
  temporary directory) and a (1, 1) ``DeviceMesh`` of dims ("data",
  "model"), held against the reference on ``jax.make_mesh((1, 1), ...)``
  at the reference's own tolerances: Gram and hat matrix 1e-8, sharded
  nulls 1e-10, searchlight accuracies 1e-12, searchlight RDMs rtol 1e-9,
  the mesh engine's nulls 1e-12 against the reference's local engine. The
  reference's sharded null runs on its unsharded plan (its closure over a
  sharded plan fails in jax 0.9), which is the path the port copies.
* Four ranks: ``python tests/test_torch_distributed.py --worker OUT``
  starts four gloo ranks of this file (``--rank``) on a 2 × 2 mesh; each
  writes its results to ``OUT/rank<r>.npz``. The test holds the ranks
  against each other (bit for bit) and against the reference's
  single-device results. The script side imports no jax.

Every group has a 60 s timeout and the subprocess one of 300 s, so a
collective that one rank enters alone fails instead of hanging.
"""

import argparse
import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core import distributed as D
from repro_torch.core import fastcv, folds
from repro_torch.core import permutation as perm_lib
from repro_torch.kernels.gram.ops import centered_gram
from repro_torch.rsa import rdm_binary, searchlight_rdm
from repro_torch.serve import (CVEngine, DatasetSpec, EngineConfig, EngineServer, Workload,
                               stream_workload)

if __name__ != "__main__":   # the pytest side; the ranks of the script import no jax
    import jax
    import jax.numpy as jnp

    from repro import rsa as ref_rsa
    from repro.core import distributed as ref_dist
    from repro.core import folds as ref_folds
    from repro.core import permutation as ref_perm
    from repro.serve import CVEngine as RefEngine
    from repro.serve import EngineConfig as RefConfig

N, P, K, LAM, C = 48, 110, 4, 1.0, 4
T, Q, PQ = 16, 4, 24          # permutations; searchlight problems of PQ features
SEED = 3
RANKS = 4
TIMEOUT = datetime.timedelta(seconds=60)
TOL_GRAM = 1e-8
TOL_NULL = 1e-10
TOL_SEARCHLIGHT = 1e-12
RTOL_RDM = 1e-9
TOL_ENGINE = 1e-12


def make_inputs() -> dict:
    """The shared problem: numpy only, from a seed."""
    rng = np.random.default_rng(0)
    yc = np.arange(N) % C
    y = np.where(yc % 2 == 0, 1.0, -1.0)
    x = rng.normal(size=(N, P))
    x[:, :6] += 0.8 * y[:, None]
    xs = rng.normal(size=(Q, N, PQ))
    xs[:, :, :3] += 0.6 * (yc[None, :, None] - 1.5)
    perms = np.stack([rng.permutation(N) for _ in range(T)])
    return {"x": x, "y": y, "yc": yc, "xs": xs, "perms": perms}


def port_side(d: dict) -> dict:
    f = folds.kfold(N, K, seed=1, device="cpu")
    return {"x": torch.tensor(d["x"]), "y": torch.tensor(d["y"]),
            "yc": torch.tensor(d["yc"]), "xs": torch.tensor(d["xs"]),
            "perms": torch.tensor(d["perms"]), "folds": f}


def _near(got, want, atol=0.0, rtol=0.0):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# The script: four gloo ranks on a 2 x 2 mesh
# ---------------------------------------------------------------------------


def rank_main(rank: int, world: int, init: str, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        p = port_side(make_inputs())
        x, y, f, perms = p["x"], p["y"], p["folds"], p["perms"]
        res = {"gram": D.distributed_gram(x, mesh),
               "gram_raw": D.distributed_gram(x, mesh, center=False),
               "hat": D.distributed_hat_matrix(x, LAM, mesh)}
        plan = fastcv.prepare(x, f, LAM, mode="dual", gram=res["gram"])
        res["null"] = D.sharded_null_from_plan(plan, y, perms, mesh)
        res["null_4"] = D.sharded_null_from_plan(plan, y, perms, mesh,
                                                 perm_axes=("data", "model"))
        r = D.distributed_permutation_binary(x, y, f, LAM, T - 1, SEED, mesh)
        res["perm_observed"], res["perm_null"] = r.observed, r.null
        res["searchlight"] = D.searchlight_cv(p["xs"], y, f, LAM, mesh)
        res["searchlight_4"] = D.searchlight_cv(p["xs"], y, f, LAM, mesh,
                                                problem_axes=("data", "model"))
        res["rdm"] = searchlight_rdm(p["xs"], p["yc"], f, LAM, mesh, num_classes=C)
        engine = CVEngine(EngineConfig(device="cpu", mesh=mesh))
        _, eplan = engine.plan(x, f, LAM)
        res["engine_h"] = eplan.h
        res["engine_null"] = engine.null_binary(eplan, y, perms[:T - 1])
        res["engine_perm_null"] = engine.permutation_binary(eplan, y, 20, 4).null
        # counts that do not divide raise before any collective, on every rank
        for name, call in (("odd_t", lambda: D.sharded_null_from_plan(plan, y, perms[:T - 1],
                                                                      mesh)),
                           ("odd_q", lambda: D.searchlight_cv(p["xs"][:3], y, f, LAM, mesh))):
            try:
                call()
                res[f"{name}_raises"] = torch.tensor(0)
            except ValueError:
                res[f"{name}_raises"] = torch.tensor(1)
        np.savez(out / f"rank{rank}.npz", **{k: v.numpy() for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def worker_main(out: Path) -> int:
    """Start RANKS processes of this file on one FileStore; 0 if all end well."""
    out.mkdir(parents=True, exist_ok=True)
    init = f"file://{out / 'store'}"
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world",
                               str(RANKS), "--init", init, str(out)]) for r in range(RANKS)]
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=240))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print("rank exit codes:", codes, flush=True)
    return 0 if all(c == 0 for c in codes) else 1


# ---------------------------------------------------------------------------
# Fixtures: the world-size-1 group and both packages' inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=TIMEOUT)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def data():
    d = make_inputs()
    port = port_side(d)
    f = port["folds"]
    ref_f = ref_folds.Folds.with_indices(jnp.asarray(f.te_idx.numpy()),
                                         jnp.asarray(f.tr_idx.numpy()))
    ref = {"x": jnp.asarray(d["x"]), "y": jnp.asarray(d["y"]), "yc": jnp.asarray(d["yc"]),
           "xs": jnp.asarray(d["xs"]), "perms": jnp.asarray(d["perms"]), "folds": ref_f,
           "mesh": jax.make_mesh((1, 1), ("data", "model"))}
    return port, ref


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four-rank script, started before the reference compiles so that
    the two overlap: (its process, its output directory)."""
    out = tmp_path_factory.mktemp("ranks")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [e for e in os.environ.get("PYTHONPATH", "").split(os.pathsep) if e]))
    proc = subprocess.Popen([sys.executable, __file__, "--worker", str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref_results(four_ranks, data):
    """The reference's single-device results the ranks are held against.
    Its local engine gives the plan (``fastcv.prepare``, unsharded), the
    observed metric and the local nulls; each ``core.distributed`` call
    compiles a shard_map, so each runs once here."""
    _, r = data
    mesh = r["mesh"]
    local = RefEngine(RefConfig())
    _, plan = local.plan(r["x"], r["folds"], LAM)
    return {
        "local": local, "plan": plan,
        "gram": ref_dist.distributed_gram(r["x"], mesh),
        "gram_raw": ref_dist.distributed_gram(r["x"], mesh, center=False),
        "hat": ref_dist.distributed_hat_matrix(r["x"], LAM, mesh),
        "null": ref_dist.sharded_null_from_plan(plan, r["y"], r["perms"], mesh),
        "perm_observed": local.observed_binary(plan, r["y"]),
        "searchlight": ref_dist.searchlight_cv(r["xs"], r["y"], r["folds"], LAM, mesh,
                                               problem_axes=("data",)),
        "rdm": ref_rsa.searchlight_rdm(r["xs"], r["yc"], r["folds"], LAM, mesh,
                                       num_classes=C, problem_axes=("data",)),
        "engine_h": plan.h,
        "engine_null": local.null_binary(plan, r["y"], r["perms"][:T - 1]),
    }


# ---------------------------------------------------------------------------
# In process, world size 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("center", [True, False], ids=["centered", "raw"])
def test_distributed_gram_matches_reference(mesh, data, ref_results, center):
    p, _ = data
    g = D.distributed_gram(p["x"], mesh, center=center)
    _near(g, ref_results["gram" if center else "gram_raw"], atol=TOL_GRAM)
    if center:   # a feature axis of size 1: the local kernel route, bit for bit
        assert torch.equal(g, centered_gram(p["x"]))


def test_distributed_hat_matrix_matches_reference(mesh, data, ref_results):
    p, _ = data
    _near(D.distributed_hat_matrix(p["x"], LAM, mesh), ref_results["hat"], atol=TOL_GRAM)


@pytest.mark.parametrize("metric,adjust_bias", [("accuracy", True), ("accuracy", False),
                                                ("auc", True)])
def test_sharded_null_matches_reference(mesh, data, ref_results, metric, adjust_bias):
    """On the reference's perms: its ``sharded_null_from_plan`` (unsharded
    plan) for the default options, its local engine's null (the same
    function of the plan) for the others."""
    p, r = data
    if (metric, adjust_bias) == ("accuracy", True):
        want = ref_results["null"]
    else:
        want = ref_results["local"].null_binary(ref_results["plan"], r["y"], r["perms"],
                                                metric=metric, adjust_bias=adjust_bias)
    plan = fastcv.prepare(p["x"], p["folds"], LAM, mode="dual",
                          gram=D.distributed_gram(p["x"], mesh))
    got = D.sharded_null_from_plan(plan, p["y"], p["perms"], mesh, metric=metric,
                                   adjust_bias=adjust_bias)
    assert got.shape == (T,) and str(got.dtype) == f"torch.{np.asarray(want).dtype}"
    _near(got, want, atol=TOL_NULL)


def test_distributed_permutation_binary(mesh, data, ref_results):
    """Observed against the reference; the null against the port's
    single-process Algorithm 1 on the same seed's draws (jax.random's
    draws differ from the port's)."""
    p, _ = data
    got = D.distributed_permutation_binary(p["x"], p["y"], p["folds"], LAM, T, SEED, mesh)
    want = perm_lib.analytical_permutation_binary(p["x"], p["y"], p["folds"], LAM, T, SEED,
                                                  chunk=T)
    _near(got.observed, ref_results["perm_observed"], atol=TOL_NULL)
    assert torch.equal(got.null, want.null) and torch.equal(got.p, want.p)


def test_searchlight_cv_matches_reference(mesh, data, ref_results):
    p, _ = data
    got = D.searchlight_cv(p["xs"], p["y"], p["folds"], LAM, mesh, problem_axes=("data",))
    assert got.shape == (Q,) and str(got.dtype) == f"torch.{ref_results['searchlight'].dtype}"
    _near(got, ref_results["searchlight"], atol=TOL_SEARCHLIGHT)


def test_searchlight_rdm_matches_reference(mesh, data, ref_results):
    p, _ = data
    got = searchlight_rdm(p["xs"], p["yc"], p["folds"], LAM, mesh, num_classes=C)
    assert got.shape == (Q, C, C)
    _near(got, ref_results["rdm"], atol=RTOL_RDM, rtol=RTOL_RDM)


@pytest.mark.parametrize("dissimilarity,adjust_bias", [("contrast", True),
                                                       ("accuracy", False)])
def test_searchlight_rdm_is_rdm_binary_per_problem(mesh, data, dissimilarity, adjust_bias):
    p, _ = data
    got = searchlight_rdm(p["xs"], p["yc"], p["folds"], LAM, mesh, num_classes=C,
                          dissimilarity=dissimilarity, adjust_bias=adjust_bias)
    want = torch.stack([rdm_binary(x, p["yc"], p["folds"], C, LAM, dissimilarity=dissimilarity,
                                   adjust_bias=adjust_bias) for x in p["xs"]])
    assert torch.equal(got, want)


def test_sharded_problems_stacks_tuple_outputs(mesh, data):
    p, _ = data
    fn = lambda x: (x.sum(), x.mean(dim=0))
    got = D.sharded_problems(fn, p["xs"], mesh)
    assert isinstance(got, tuple) and len(got) == 2
    assert torch.equal(got[0], p["xs"].sum(dim=(1, 2)))
    assert torch.equal(got[1], torch.stack([x.mean(dim=0) for x in p["xs"]]))


@pytest.mark.parametrize("adjust_bias", [True, False])
def test_mesh_engine_matches_reference_local_engine(mesh, data, ref_results, adjust_bias):
    p, r = data
    engine = CVEngine(EngineConfig(device="cpu", mesh=mesh))
    _, plan = engine.plan(p["x"], p["folds"], LAM)
    _near(plan.h, ref_results["engine_h"], atol=TOL_GRAM)
    perms = ref_perm.permutation_indices(jax.random.PRNGKey(11), N, 10)
    want = ref_results["local"].null_binary(ref_results["plan"], r["y"], perms,
                                            adjust_bias=adjust_bias)
    got = engine.null_binary(plan, p["y"], torch.tensor(np.asarray(perms)),
                             adjust_bias=adjust_bias)
    _near(got, want, atol=TOL_ENGINE)


def test_mesh_engine_streams_sharded_null_chunks(mesh, data, monkeypatch):
    """Streamed permutation chunks route through sharded_null_from_plan on
    a mesh engine, with the draws of the monolithic and local paths."""
    calls = {"n": 0}
    real = D.sharded_null_from_plan

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(D, "sharded_null_from_plan", counting)
    p, _ = data
    engine = CVEngine(EngineConfig(device="cpu", mesh=mesh))
    spec = DatasetSpec(p["x"], p["folds"], LAM)
    w = Workload(kind="permutation", dataset=spec, y=p["y"], n_perm=20, seed=4)
    events = list(stream_workload(engine, w, chunk=8))
    assert calls["n"] >= 3
    final = events[-1].payload
    streamed = torch.cat([ev.payload for ev in events if ev.kind == "null"])
    assert torch.equal(streamed, final.null)
    _, plan = engine.resolve(spec)
    mono = engine.permutation_binary(plan, p["y"], 20, 4)
    _near(final.null, mono.null.numpy(), atol=TOL_ENGINE)
    local = CVEngine(EngineConfig(device="cpu"))
    _, lplan = local.plan(p["x"], p["folds"], LAM)
    _near(final.null, local.permutation_binary(lplan, p["y"], 20, 4).null.numpy(),
          atol=TOL_ENGINE)


def test_mesh_engine_behind_the_thread_server(mesh, data):
    """An edge carries a mesh engine at world size 1: the worker thread's
    collectives give what the engine gives in the caller's thread."""
    p, _ = data
    engine = CVEngine(EngineConfig(device="cpu", mesh=mesh))
    handle = engine.register(p["x"], p["folds"], LAM)
    w = Workload(kind="permutation", dataset=handle, y=p["y"], n_perm=12, seed=5)
    with EngineServer(engine) as srv:
        got = srv.submit(w).result(timeout=60)
    _, plan = engine.resolve(handle)
    assert torch.equal(got.null, engine.permutation_binary(plan, p["y"], 12, 5).null)


def _config_errors(mesh):
    return {
        "bf16_gram": lambda: EngineConfig(device="cpu", mesh=mesh, precision="bf16_gram"),
        "unknown_perm_axis": lambda: EngineConfig(device="cpu", mesh=mesh, perm_axes=("pod",)),
        "unknown_feature_axis": lambda: EngineConfig(device="cpu", mesh=mesh,
                                                     feature_axis="pod"),
        "engine_device": lambda: CVEngine(EngineConfig(device="meta", mesh=mesh)),
    }


@pytest.mark.parametrize("case", list(_config_errors(None)))
def test_engine_config_errors(mesh, case):
    with pytest.raises(ValueError):
        _config_errors(mesh)[case]()


@pytest.mark.parametrize("case", ["unknown_axis", "tensor_device", "dtype"])
def test_distributed_gram_errors(mesh, data, case):
    x = data[0]["x"]
    call, err = {
        "unknown_axis": (lambda: D.distributed_gram(x, mesh, feature_axis="pod"), ValueError),
        "tensor_device": (lambda: D.distributed_gram(x.to("meta"), mesh), ValueError),
        "dtype": (lambda: D.distributed_gram(x.to(torch.bfloat16), mesh), TypeError),
    }[case]
    with pytest.raises(err):
        call()


# ---------------------------------------------------------------------------
# Four ranks on a 2 x 2 mesh, as a subprocess
# ---------------------------------------------------------------------------


@pytest.mark.timeout(360)
def test_four_ranks_on_a_2x2_mesh(four_ranks, data, ref_results):
    proc, out = four_ranks
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-8000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]
    for key in ranks[0]:
        for r in range(1, RANKS):
            assert np.array_equal(ranks[r][key], ranks[0][key]), (key, r)
    got = ranks[0]
    assert got["odd_t_raises"] == 1 and got["odd_q_raises"] == 1
    want = {k: np.asarray(v) for k, v in ref_results.items()}
    for key in ("gram", "gram_raw", "hat", "engine_h"):
        _near(got[key], want[key], atol=TOL_GRAM)
    for key in ("null", "null_4"):
        _near(got[key], want["null"], atol=TOL_NULL)
    for key in ("searchlight", "searchlight_4"):
        _near(got[key], want["searchlight"], atol=TOL_SEARCHLIGHT)
    _near(got["rdm"], want["rdm"], atol=RTOL_RDM, rtol=RTOL_RDM)
    _near(got["perm_observed"], want["perm_observed"], atol=TOL_NULL)
    _near(got["engine_null"], want["engine_null"], atol=TOL_ENGINE)
    # the port's own draws: the single-process Algorithm 1 and local engine
    p, _ = data
    single = perm_lib.analytical_permutation_binary(p["x"], p["y"], p["folds"], LAM, T - 1,
                                                    SEED, chunk=T)
    _near(got["perm_null"], single.null.numpy(), atol=TOL_NULL)
    local = CVEngine(EngineConfig(device="cpu"))
    _, lplan = local.plan(p["x"], p["folds"], LAM)
    _near(got["engine_perm_null"], local.permutation_binary(lplan, p["y"], 20, 4).null.numpy(),
          atol=TOL_ENGINE)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", type=Path)
    ap.add_argument("--worker", type=Path, help="start the ranks; write OUT/rank<r>.npz")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int, default=RANKS)
    ap.add_argument("--init", help="the process group's init_method (file://...)")
    args = ap.parse_args()
    if args.worker is not None:
        sys.exit(worker_main(args.worker))
    rank_main(args.rank, args.world, args.init, args.out)
