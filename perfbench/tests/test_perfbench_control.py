"""What ``correct`` catches, at a size a test holds, on the CPU.

The control (the reference in float32 with TF32-rounded products, put in
the program's place on the same requests) fails a number of each cell,
under the cell's own limits; each biased draw fails a number of the
permutation cell; and a run whose timed path is broken underneath — an
answer altered where it is produced, half of a batch left out with the
mean of the rest in its place, a draw that is not uniform — comes out not
correct.
The chip runs the control at the cells' own size (``perfbench/control.py``).
"""

from __future__ import annotations

import pytest
import torch

import perfbench_testkit as kit
from harness import bench

#: a size at which the control's errors show in every cell: more channels
#: and trials than the drivers' smoke size
CONTROL_CONFIG = {"n_trials": 200, "n_channels": 24, "fs_hz": 20.0, "folds": 5}


@pytest.mark.parametrize("cell", kit.CELLS)
def test_the_control_fails_and_the_program_passes(cell):
    run = kit.tiny_run(cell, seconds=0.5)
    run.config.update(CONTROL_CONFIG)
    driver = bench.load_module("drivers", run.cell["driver"])
    out = kit.control_module().readings(run, driver, control=True)
    limits = run.cell["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control"][k] > v for k, v in limits.items()), out


def test_each_biased_draw_fails_a_number_of_the_permutation_cell():
    run = kit.tiny_run("st76k.perm1000", seconds=0.5)
    run.config.update(CONTROL_CONFIG)
    driver = bench.load_module("drivers", run.cell["driver"])
    out = kit.control_module().readings(run, driver, control=True)
    limits = run.cell["limits"]
    assert set(out["faults"]) == set(driver.DRAW_FAULTS)
    for fault, numbers in out["faults"].items():
        assert any(numbers[k] > limits.get(k, 0.0) for k in numbers), (fault, numbers)


def _altered(fn, alter):
    def wrapped(*args, **kw):
        return alter(fn(*args, **kw))
    return wrapped


def _first_plus(delta):
    def alter(t):
        t = t.clone()
        t.view(-1)[0] += delta
        return t
    return alter


def _pair_first(alter):
    return lambda pair: (alter(pair[0]), pair[1])


def _half_then_mean(fn, dim_of_batch):
    """``fn`` over the first half of its batch; the mean of that half
    stands in for the rest."""
    def wrapped(*args, **kw):
        args = list(args)
        batch = args[dim_of_batch]
        half = fn(*args[:dim_of_batch], batch[: (batch.shape[0] + 1) // 2],
                  *args[dim_of_batch + 1:], **kw)
        rest = half.to(torch.float64).mean().to(half.dtype).expand(batch.shape[0] - half.shape[0])
        return torch.cat([half, rest])
    return wrapped


def _faults():
    from repro_torch.core import fastcv, multiclass, multidim, permutation
    from repro_torch.serve import engine as serve_engine

    CVEngine = serve_engine.CVEngine
    return {
        "st76k.cohort": {
            "decision value altered": (fastcv, "binary_cv",
                                       lambda f: _altered(f, _pair_first(_first_plus(1.0)))),
            "class altered": (multiclass, "analytical_cv_multiclass",
                              lambda f: _altered(f, _pair_first(_next_class))),
        },
        "st76k.perm1000": {
            "null value altered": (permutation, "_fold_metric_binary",
                                   lambda f: _altered(f, _first_plus(0.25))),
            "half the draws, their mean for the rest": (
                CVEngine, "null_binary", lambda f: _half_null(f)),
            "draws rotated": (permutation, "permutation_indices", lambda f: _rotated_draws(f)),
            "draws near the identity": (permutation, "permutation_indices",
                                        lambda f: _near_identity_draws(f)),
        },
        "tp380.grid": {
            "point accuracy altered": (multidim, "cv_grid",
                                       lambda f: _altered(f, _first_plus(0.25))),
            "half the points, their mean for the rest": (
                multidim, "cv_grid", lambda f: _half_then_mean(f, 0)),
        },
        "st76k.fresh": {
            "decision value altered": (fastcv, "binary_dvals",
                                       lambda f: _altered(f, _first_plus(1.0))),
            "class altered": (multiclass, "batch_predict",
                              lambda f: _altered(f, _next_class)),
        },
    }


def _next_class(pred):
    pred = pred.clone()
    pred.view(-1)[0] = (pred.view(-1)[0] + 1) % 3
    return pred


def _half_null(null_binary):
    def wrapped(self, plan, y, perms, **kw):
        b = perms.shape[0]
        half = null_binary(self, plan, y, perms[: (b + 1) // 2], **kw)
        rest = half.to(torch.float64).mean().to(half.dtype).expand(b - half.shape[0])
        return torch.cat([half, rest])
    return wrapped


def _rotated_draws(permutation_indices):
    """Every row the first row rotated: each row a permutation, none
    repeated while T < N, but not a uniform draw."""
    def wrapped(seed, n, n_perm, *, device=None):
        first = permutation_indices(seed, n, 1, device=device)[0]
        return torch.stack([first.roll(k) for k in range(n_perm)])
    return wrapped


def _near_identity_draws(permutation_indices):
    """Every row the identity with two entries of a uniform row swapped in."""
    def wrapped(seed, n, n_perm, *, device=None):
        rows = permutation_indices(seed, n, n_perm, device=device)
        out = torch.arange(n, device=rows.device).repeat(n_perm, 1)
        a, b = rows[:, :1], rows[:, 1:2]
        out.scatter_(1, a, b)
        out.scatter_(1, b, a)
        return out
    return wrapped


def _fault_cases():
    return [(cell, name) for cell in kit.CELLS for name in _FAULT_NAMES[cell]]


_FAULT_NAMES = {
    "st76k.cohort": ("decision value altered", "class altered"),
    "st76k.perm1000": ("null value altered", "half the draws, their mean for the rest",
                       "draws rotated", "draws near the identity"),
    "tp380.grid": ("point accuracy altered", "half the points, their mean for the rest"),
    "st76k.fresh": ("decision value altered", "class altered"),
}


@pytest.mark.parametrize("cell,fault", _fault_cases())
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    owner, attr, breaker = _faults()[cell][fault]
    monkeypatch.setattr(owner, attr, breaker(getattr(owner, attr)))
    res = kit.execute(kit.tiny_run(cell))
    assert res["correct"] is False, res["check"]
