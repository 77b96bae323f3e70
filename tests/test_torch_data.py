"""repro_torch data generators on the CPU.

The port draws with torch generators, so its streams differ from the
reference's jax.random ones: the generators are held to shapes and
statistics, and the feature constructions to the reference on the
reference's own dataset.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data import eeg as ref_eeg
from repro_torch.data import eeg, synthetic


def test_make_classification_shape_and_separation():
    x, y = synthetic.make_classification(0, 60, 20, num_classes=3, class_sep=3.0, device="cpu")
    assert x.shape == (60, 20) and x.dtype == torch.float64
    assert y.dtype == torch.int32 and torch.equal(y, torch.arange(60, dtype=torch.int32) % 3)
    means = torch.stack([x[y == c].mean(0) for c in range(3)])
    assert float(torch.cdist(means, means).max()) > 2.0
    again, _ = synthetic.make_classification(0, 60, 20, num_classes=3, class_sep=3.0,
                                             device="cpu")
    assert torch.equal(x, again)


def test_make_regression_recovers_intercept():
    x, y = synthetic.make_regression(1, 400, 5, noise=0.01, dtype=torch.float32, device="cpu")
    assert x.shape == (400, 5) and y.shape == (400,) and y.dtype == torch.float32
    beta = torch.linalg.lstsq(torch.cat([x, torch.ones(400, 1)], 1), y[:, None]).solution
    assert abs(float(beta[-1, 0]) - 0.5) < 0.01


@pytest.mark.parametrize("make", [
    lambda: synthetic.make_classification(0, 4, 3),
    lambda: synthetic.make_regression(0, 4, 3),
    lambda: eeg.simulate_subject(0, n_trials=2),
], ids=["classification", "regression", "eeg"])
def test_generators_need_cuda_by_default(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_simulate_subject_shape_and_timing():
    ds = eeg.simulate_subject(0, n_trials=6, device="cpu")
    assert ds.epochs.shape == (6, 380, 301) and ds.epochs.dtype == torch.float32
    assert ds.times[100] == 0.0                         # onset exactly at 0
    assert int((ds.times > 0).sum()) == 200
    # baseline-corrected: the pre-stimulus mean is 0 on every channel
    pre = ds.epochs[:, :, ds.times < 0].mean(dim=2)
    assert float(pre.abs().max()) < 1e-5
    assert torch.equal(ds.y, torch.tensor([0, 1, 0, 1, 0, 1], dtype=torch.int32))


@pytest.mark.parametrize("window_ms,p", [(100.0, 3800), (200.0, 1900), (5.0, 76000)])
def test_windowed_feature_widths(window_ms, p):
    ds = eeg.simulate_subject(1, n_trials=3, device="cpu")
    assert eeg.windowed_features(ds, window_ms).shape == (3, p)
    assert eeg.timepoint_features(ds, 150).shape == (3, 380)


def test_class_signal_survives_windowing():
    ds = eeg.simulate_subject(2, n_trials=200, snr=3.0, device="cpu")
    f = eeg.windowed_features(ds, 100.0)
    diff = f[ds.y == 0].mean(0) - f[ds.y == 1].mean(0)
    assert float(diff.abs().max()) > 0.5


@pytest.mark.parametrize("window_ms", [5.0, 100.0])
def test_features_equal_reference_on_reference_data(window_ms):
    """Given the reference's dataset, the port builds the same features."""
    rds = ref_eeg.simulate_subject(jax.random.PRNGKey(0), n_trials=4)
    ds = eeg.EEGDataset(*(torch.from_numpy(np.array(a)) for a in rds))
    got = eeg.windowed_features(ds, window_ms).numpy()
    want = np.asarray(ref_eeg.windowed_features(rds, window_ms))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(eeg.timepoint_features(ds, 170).numpy(),
                                  np.asarray(ref_eeg.timepoint_features(rds, 170)))
