"""repro_torch.launch.step_analysis against the reference's analyze_hlo.

The five programs of tests/test_hlo_analysis.py run eagerly under the
port's counter and compiled under the reference's parser, and the counts
agree at that file's tolerances (rel 0.01 for one matmul, 0.05 for the
loops; the grad of a loop between 2.5 and 5 forward passes on both sides).
A gemma2 smoke train step counts within 5 % of the reference's analysis
of its compiled smoke step.

Per rank: a two-layer Megatron MLP (column- then row-parallel, an
all-reduce after each layer) on a fake 16-rank mesh is held to its hand
counts: FLOPs, dot bytes and all-reduce bytes. The fake group is
process-global, so that problem runs in one subprocess. Its second run of
the same program counts what its first counted: DTensor's metadata
inference, which runs only the first time, is not counted.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as H
from repro_torch.launch import step_analysis as SA

_SRC = str(Path(__file__).resolve().parents[1] / "src")


def _ref(fn, *args):
    return H.analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


def _port(fn, *args):
    return SA.analyze_step(fn, *args)


def test_plain_matmul_flops():
    want = 2 * 256 * 512 * 128
    ref = _ref(lambda x, y: x @ y, jnp.zeros((256, 512)), jnp.zeros((512, 128)))
    got = _port(lambda x, y: x @ y, torch.zeros(256, 512), torch.zeros(512, 128))
    assert got["flops"] == want
    assert got["flops"] == pytest.approx(ref["flops"], rel=0.01)
    assert got["dot_hbm_bytes"] == 4 * (256 * 512 + 512 * 128 + 256 * 128)
    assert got["collective_total_bytes"] == 0


def _repeat(c, n):
    for _ in range(n):
        c = c @ c
    return c


def test_loop_counts_every_iteration():
    def scanned(x):
        return jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=17)[0]

    ref = _ref(scanned, jnp.zeros((128, 128)))
    got = _port(lambda x: _repeat(x, 17), torch.zeros(128, 128))
    assert got["flops"] == 17 * 2 * 128 ** 3
    assert got["flops"] == pytest.approx(ref["flops"], rel=0.05)


def test_loop_matches_the_reference_unrolled():
    def unrolled(x):
        for _ in range(9):
            x = x @ x
        return x

    ref = _ref(unrolled, jnp.zeros((64, 64)))
    got = _port(lambda x: _repeat(x, 9), torch.zeros(64, 64))
    assert got["flops"] == pytest.approx(ref["flops"], rel=0.05)


def test_nested_loops():
    def outer(x):
        inner = lambda c: jax.lax.scan(lambda c, _: (c @ c, None), c, None, length=4)[0]
        return jax.lax.scan(lambda c, _: (inner(c), None), x, None, length=5)[0]

    ref = _ref(outer, jnp.zeros((32, 32)))
    got = _port(lambda x: _repeat(_repeat(_repeat(_repeat(_repeat(x, 4), 4), 4), 4), 4),
                torch.zeros(32, 32))
    assert got["flops"] == 20 * 2 * 32 ** 3
    assert got["flops"] == pytest.approx(ref["flops"], rel=0.05)


def test_grad_of_a_loop_counts_forward_and_backward():
    fwd = 8 * 2 * 64 ** 3

    def loss(w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jnp.sum(jax.lax.scan(body, jnp.zeros((64, 64)), None, length=8)[0])

    ref = _ref(jax.grad(loss), jnp.zeros((64, 64)))

    def grad(w):
        c = torch.zeros(64, 64)
        for _ in range(8):
            c = torch.tanh(c @ w)
        return torch.autograd.grad(c.sum(), [w])[0]

    got = _port(grad, torch.zeros(64, 64, requires_grad=True))
    for res in (ref, got):
        assert 2.5 * fwd <= res["flops"] <= 5 * fwd, res["flops"]
    assert got["flops"] == pytest.approx(ref["flops"], rel=0.05)


def test_gemma2_smoke_train_step_counts_as_the_reference():
    from repro.configs.base import get_config as ref_config
    from repro.models import model as ref_model
    from repro.optim import optimizer as ref_opt
    from repro.train import steps as ref_steps
    from repro_torch.configs.base import get_config
    from repro_torch.optim import optimizer as O
    from repro_torch.train import steps

    b, s = 2, 16
    rcfg = ref_config("gemma2-2b", smoke=True)
    params = ref_model.init_params(jax.random.PRNGKey(0), rcfg)
    ropt = ref_opt.AdamWConfig()
    state = ref_opt.init_opt_state(params, ropt)
    tok = jnp.zeros((b, s), jnp.int32)
    fn = ref_steps.make_train_step(rcfg, ropt)
    ref = H.analyze_hlo(jax.jit(fn).lower(params, state, {"tokens": tok, "labels": tok})
                        .compile().as_text())

    cfg = get_config("gemma2-2b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    model, opt_state = steps.init_train_state(cfg, O.AdamWConfig(), generator=gen, device="cpu")
    ttok = torch.zeros((b, s), dtype=torch.int32)
    got = SA.analyze_step(steps.make_train_step(cfg, O.AdamWConfig()), model, opt_state,
                          {"tokens": ttok, "labels": ttok})
    assert got["flops"] == pytest.approx(ref["flops"], rel=0.05), (got["flops"], ref["flops"])


def _ref_launch(q, k, v, **kw):
    """attention_ref in the kernel's place, carrying no graph, as the
    kernel's output carries none."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    with torch.no_grad():
        return attention_ref(q, k, v, **kw)


def test_flash_launches_count_as_the_plain_version(monkeypatch):
    """A launch of the flash operator (its kernel stood in for on the CPU)
    counts as attention_ref's two products, and its forward and backward
    count as autograd through attention_ref: the backward's recompute of
    the forward is not counted. ``flash`` keeps the launch, the f32 bytes
    it added and the bytes the kernel moves."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    monkeypatch.setattr(ops, "_kernel", _ref_launch)
    q0, k0 = torch.zeros(2, 4, 24, 8), torch.zeros(2, 2, 24, 8)
    kw = dict(scale=0.3, causal=True, window=5, softcap=None)

    def fwd_bwd(attend):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, k0))
        out = attend(q, k, v)
        return torch.autograd.grad(out, (q, k, v), torch.ones_like(out))

    fwd = SA.analyze_step(lambda: attention_ref(q0, k0, k0, **kw))
    plain = SA.analyze_step(fwd_bwd, lambda q, k, v: attention_ref(q, k, v, **kw))
    got = SA.analyze_step(fwd_bwd, lambda q, k, v: ops.flash_attention_op(q, k, v, *kw.values()))
    assert fwd["flops"] == 2 * 2 * (2 * 4 * 24 * 24 * 8)
    assert fwd["flash"] == plain["flash"] == {"launches": 0, "ref_bytes": 0, "kernel_bytes": 0}
    assert (got["flops"], got["dot_hbm_bytes"]) == (plain["flops"], plain["dot_hbm_bytes"])
    assert got["flash"] == {"launches": 1, "ref_bytes": fwd["dot_hbm_bytes"],
                            "kernel_bytes": 4 * (2 * (2 * 2 * 24 * 8) + 2 * (2 * 4 * 24 * 8))}


def test_step_through_the_flash_operator_counts_as_the_plain_step(monkeypatch):
    """The gemma2 smoke train step (remat on) with every attention through
    the flash operator counts what it counts through attention_ref, with
    two launches a layer (the forward and remat's recompute)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import layers
    from repro_torch.optim import optimizer as O
    from repro_torch.train import steps

    cfg = get_config("gemma2-2b", smoke=True)
    tok = torch.zeros((2, 16), dtype=torch.int32)

    def count():
        gen = torch.Generator().manual_seed(0)
        model, state = steps.init_train_state(cfg, O.AdamWConfig(), generator=gen, device="cpu")
        return SA.analyze_step(steps.make_train_step(cfg, O.AdamWConfig()), model, state,
                               {"tokens": tok, "labels": tok})

    plain = count()
    monkeypatch.setattr(ops, "_kernel", _ref_launch)
    monkeypatch.setattr(layers, "flash_attention",
                        lambda q, k, v, **kw: ops.flash_attention_op(q, k, v, *kw.values()))
    got = count()
    assert cfg.remat and got["flash"]["launches"] == 2 * cfg.num_layers
    for key in ("flops", "dot_hbm_bytes", "collective_total_bytes"):
        assert got[key] == plain[key], key


_MEGATRON = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor, Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.step_analysis import analyze_step

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
T, D, F = 64, 128, 512
with FakeTensorMode():
    put = lambda shape, pl: distribute_tensor(torch.zeros(shape), mesh, [pl], src_data_rank=None)
    x = put((T, D), Replicate())
    layers = [(put((D, F), Shard(1)), put((F, D), Shard(0))) for _ in range(2)]

    def mlp(x):
        for w1, w2 in layers:
            x = (torch.relu(x @ w1) @ w2).redistribute(mesh, [Replicate()])
        return x

    out = [{k: v for k, v in analyze_step(mlp, x, mesh=mesh).items() if k != "output"}
           for _ in range(2)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def megatron():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [_SRC, os.environ.get("PYTHONPATH")])))
    run = subprocess.run([sys.executable, "-c", _MEGATRON], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_megatron_mlp_per_rank_hand_counts(megatron):
    t, d, f, n = 64, 128, 512, 16
    first, second = megatron
    # per layer: (T, D) @ (D, F/n) and (T, F/n) @ (F/n, D), f32
    assert first["flops"] == 2 * (2 * t * d * (f // n) + 2 * t * (f // n) * d)
    assert first["dot_hbm_bytes"] == 2 * 4 * ((t * d + d * f // n + t * f // n)
                                             + (t * f // n + f // n * d + t * d))
    # one all-reduce of the (T, D) f32 partial sums per layer
    assert first["collective_counts"]["all-reduce"] == 2
    assert first["collective_bytes"]["all-reduce"] == 2 * t * d * 4
    assert first["collective_total_bytes"] == 2 * t * d * 4
    assert second == first                       # metadata inference is not counted
