"""The permutation driver's check sample: a uniform sample of the window's
answers, drawn from the run's seed as the answers come, so the window holds
the program's outputs of the sampled requests alone."""

from __future__ import annotations

import collections

import pytest

import perfbench_testkit  # noqa: F401 - puts the harness on the path
from harness import bench


@pytest.fixture(scope="module")
def reservoir():
    return bench.load_module("drivers", "aio_clients")._Reservoir


@pytest.mark.parametrize("offered", [3, 12, 40])
def test_keeps_at_most_its_size_and_only_what_was_offered(reservoir, offered):
    kept, r = [], reservoir(12, 7)
    for item in range(offered):
        r.offer(kept, item)
    assert len(kept) == min(offered, 12)
    assert len(set(kept)) == len(kept) and set(kept) <= set(range(offered))
    assert r.offered == offered


def test_same_seed_same_sample_other_seed_other_sample(reservoir):
    def sample(seed):
        kept, r = [], reservoir(12, seed)
        for item in range(500):
            r.offer(kept, item)
        return sorted(kept)

    assert sample(3) == sample(3)
    assert sample(3) != sample(4)


def test_every_answer_is_equally_likely_to_be_checked(reservoir):
    """Over 6,000 seeds, each of 10 answers is kept in about 3 of 10."""
    counts = collections.Counter()
    for seed in range(6000):
        kept, r = [], reservoir(3, seed)
        for item in range(10):
            r.offer(kept, item)
        counts.update(kept)
    # expected 1,800 each; sd ~ 35.5
    assert all(abs(counts[i] - 1800) < 6 * 36 for i in range(10))
