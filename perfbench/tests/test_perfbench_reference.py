"""The plain reference against the program's plain route at small sizes,
in float64: retraining fold by fold equals the analytical route."""

from __future__ import annotations

import pytest
import torch

import perfbench_testkit as kit
from harness import compare
from harness.data import Subject, kfold, subseed, trace_lambda
from reference.cv import FoldRidge, hits, to_tf32, uniform_permutations

CFG = {"n_trials": 60, "n_channels": 8, "fs_hz": 20.0, "t_min_s": -0.5, "t_max_s": 1.0,
       "num_classes": 3, "snr": 0.5, "positive_classes": [0, 1], "folds": 5}


def _subject(layout: str, seed: int = 2**31 + 3) -> Subject:
    return Subject({**CFG, "layout": layout}, seed, 0, torch.device("cpu"))


def _folds(s):
    from repro_torch.core.folds import Folds
    return Folds(s.te, s.tr, CFG["n_trials"])


@pytest.mark.parametrize("layout,point", [("spatiotemporal", None), ("timepoints", 17)])
def test_decision_values_and_classes_equal_the_programs(layout, point):
    from repro_torch.core import fastcv, multiclass

    s = _subject(layout)
    x = (s.x if point is None else s.x[point]).double()
    dvals, _ = fastcv.binary_cv(x, s.y.double(), _folds(s), s.lam)
    pred, _ = multiclass.analytical_cv_multiclass(x, s.classes, _folds(s), 3, s.lam)
    ridge = FoldRidge(x, s.te, s.tr, s.lam)
    assert ridge.dual == (point is None)
    assert compare.dval_error(dvals, ridge.binary_dvals(s.y[:, None])[..., 0]) < 1e-10
    assert compare.class_gap(pred, ridge.multiclass_distances(s.classes, 3)) == 0.0


def test_grid_hits_equal_the_programs_grid():
    from repro_torch.core import multidim

    s = _subject("timepoints")
    xs = s.x.double()
    acc = multidim.cv_grid(xs, s.y.double(), _folds(s), s.lam)
    y = s.y[:, None]
    dvals = torch.cat([FoldRidge(x, s.te, s.tr, s.lam).binary_dvals(y) for x in xs], dim=-1)
    y_te = y[s.te.long()].expand_as(dvals)
    tested = s.te.numel()
    assert torch.equal(compare.hits_of(acc, tested), hits(dvals, y_te))
    assert compare.hit_gap(compare.hits_of(acc, tested), dvals, y_te) == 0.0


def test_null_hits_equal_the_engines_null_for_its_own_draws():
    from repro_torch.core.permutation import permutation_indices
    from repro_torch.serve import CVEngine, EngineConfig

    s = _subject("spatiotemporal")
    x = s.x.double()
    engine = CVEngine(EngineConfig(device="cpu"))
    _, plan = engine.plan(x, _folds(s), s.lam)
    seed, t = subseed(7, 3, 1), 50
    res = engine.permutation_binary(plan, s.y.double(), t, seed)
    perms = permutation_indices(seed, CFG["n_trials"], t, device="cpu")
    labels = torch.cat([s.y[None], s.y[perms]]).T
    dvals = FoldRidge(x, s.te, s.tr, s.lam).binary_dvals(labels)
    tested = s.te.numel()
    prog = compare.hits_of(torch.cat([res.observed.reshape(1), res.null]), tested)
    assert torch.equal(prog, hits(dvals, labels[s.te.long()]))
    assert compare.hit_gap(prog, dvals, labels[s.te.long()]) == 0.0


def test_hit_gap_is_the_least_margin_that_explains_a_count():
    # one fold of four trials, two label vectors; RMS of each column is 1
    dvals = torch.tensor([[[1.0, -1.2], [-1.2, 0.2], [0.2, 1.0], [-1.0, 1.0]]], dtype=torch.float64)
    y = torch.tensor([[[1.0, 1.0], [1.0, 1.0], [1.0, 1.0], [-1.0, 1.0]]])
    scale = dvals.pow(2).mean(dim=(0, 1)).sqrt()
    assert hits(dvals, y).tolist() == [3, 3]
    assert compare.hit_gap(torch.tensor([3.0, 3.0]), dvals, y) == 0.0
    # one hit fewer in column 0: the nearest right trial (0.2) had to turn
    gap = compare.hit_gap(torch.tensor([2.0, 3.0]), dvals, y)
    assert gap == pytest.approx(0.2 / float(scale[0]))
    # one hit more in column 1: the only wrong trial (-1.2) had to turn
    gap = compare.hit_gap(torch.tensor([3.0, 4.0]), dvals, y)
    assert gap == pytest.approx(1.2 / float(scale[1]))
    # two more than any trial can give
    assert compare.hit_gap(torch.tensor([3.0, 5.0]), dvals, y) == float("inf")


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10_000, dtype=torch.float32)
    r = to_tf32(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert torch.equal(to_tf32(r), r)


def test_inputs_are_the_seeds_and_only_the_seeds():
    a, b = _subject("spatiotemporal", 11), _subject("spatiotemporal", 11)
    c = _subject("spatiotemporal", 12)
    assert torch.equal(a.x, b.x) and torch.equal(a.te, b.te) and a.lam == b.lam
    assert not torch.equal(a.x, c.x)
    assert a.x.shape == (60, 8 * 20) and a.lam == pytest.approx(trace_lambda(a.x))
    te, tr = kfold(60, 5, 3)
    assert te.shape == (5, 12) and tr.shape == (5, 48)
    for i in range(5):
        assert sorted(set(te[i]) | set(tr[i])) == list(range(60))
    # a large seed, beyond 32 bits, is taken whole
    assert subseed(2**33 + 5, 1) != subseed(5, 1)
    assert kit.tiny_run("st76k.cohort", seed=2**40).seed == 2**40


def test_ks_distance_is_scaled_and_reads_nothing_between_equal_samples():
    a = torch.tensor([3.0, 1.0, 2.0, 2.0])
    assert compare.ks_distance(a, a.flip(0)) == 0.0
    # disjoint samples of 4 and 4: distance 1, scaled by sqrt(16 / 8)
    assert compare.ks_distance(a, a + 10) == pytest.approx(2.0 ** 0.5)
    # one of four values moved past the other sample: 1/4 at most
    b = torch.tensor([3.0, 1.0, 2.0, 9.0])
    assert compare.ks_distance(a, b) == pytest.approx(0.25 * 2.0 ** 0.5)


def test_position_chi2_reads_uniform_rows_small_and_biased_rows_large():
    rows = uniform_permutations(5, 400, 50, "cpu")
    assert sorted(rows[0].tolist()) == list(range(50))
    assert torch.equal(rows, uniform_permutations(5, 400, 50, "cpu"))
    assert compare.position_chi2(rows) < 4.0
    rotated = torch.stack([rows[0].roll(k) for k in range(400)])
    assert compare.position_chi2(rotated) > 20.0
    half = rows.clone()
    half[:, 25:] = torch.arange(25, 50)
    assert compare.position_chi2(half) > 20.0
