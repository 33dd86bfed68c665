"""The port's depth metrics (``vfdepth_tpu_torch/utils/metrics.py``, a copy
of the JAX package's numpy module) against the JAX package's, on
``tests/test_metrics.py``'s cases and on seeded random arrays. Both are the
same numpy code on the same inputs, so every number must be equal exactly
(NaN where the JAX package gives NaN): no tolerance."""
import numpy as np
import pytest

from vfdepth_tpu.utils import metrics as jax_metrics
from vfdepth_tpu_torch.utils import metrics
from helpers_torch_threads import port_threads  # noqa: F401


def _same(a, b):
    """Equal, NaN included, for floats, lists and dicts of them."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert (np.isnan(a) and np.isnan(b)) or a == b, (a, b)


def _both(*args):
    got = metrics.compute_depth_metrics(*args)
    want = jax_metrics.compute_depth_metrics(*args)
    _same(got, want)
    return got


def test_names_and_pretty_ts():
    assert metrics.METRIC_NAMES == jax_metrics.METRIC_NAMES
    for ts in (0.0, 59.9, 3723.0, 86400.5):
        assert metrics.pretty_ts(ts) == jax_metrics.pretty_ts(ts)


@pytest.mark.parametrize("case", ["perfect", "known", "random"])
def test_cal_depth_error(case):
    rng = np.random.RandomState(0)
    if case == "perfect":
        d = rng.uniform(1, 50, 1000)
        pred, target = d, d
    elif case == "known":
        pred, target = np.asarray([12.0, 20.0]), np.asarray([10.0, 20.0])
    else:
        target = rng.uniform(0.5, 80.0, 777).astype(np.float32)
        pred = (target * rng.uniform(0.6, 1.6, 777)).astype(np.float32)
    _same(metrics.cal_depth_error(pred, target),
          jax_metrics.cal_depth_error(pred, target))


def test_median_scaling_and_masking_cases():
    """``tests/test_metrics.py``'s scaling, masking and empty-camera cases."""
    rng = np.random.RandomState(1)
    gt = rng.uniform(5.0, 60.0, (1, 2, 20, 24, 1)).astype(np.float32)
    _, _, scales = _both(gt, gt / 2.0, np.ones_like(gt), 0.0, 80.0)
    assert all(abs(s - 2.0) < 0.01 for s in scales)

    gt = np.full((1, 1, 4, 4, 1), 10.0, np.float32)
    gt[0, 0, 0, 0, 0], gt[0, 0, 0, 1, 0] = 500.0, 0.0
    pred = np.full_like(gt, 10.0)
    pred[0, 0, 0, 0, 0], pred[0, 0, 1, 1, 0] = 1.0, 99.0
    occ = np.ones_like(gt)
    occ[0, 0, 1, 1, 0] = 0.0
    metric, _, _ = _both(gt, pred, occ, 0.5, 200.0)
    assert metric["abs_rel"] < 1e-6

    gt = np.full((1, 2, 8, 8, 1), 10.0, np.float32)
    gt[:, 1] = 0.0                          # camera 1: no valid GT
    pred = np.full_like(gt, 20.0)
    metric, _, scales = _both(gt, pred, np.ones_like(gt), 0.5, 200.0)
    assert abs(metric["abs_rel"] - 1.0) < 1e-6 and np.isnan(scales[1])
    gt[:] = 0.0                             # no valid camera: NaN
    metric, median, _ = _both(gt, pred, np.ones_like(gt), 0.5, 200.0)
    assert np.isnan(metric["abs_rel"]) and np.isnan(median["abs_rel"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_arrays(seed):
    """Sparse GT at twice the network resolution (the bilinear lift and the
    nearest mask resize), an even valid count in one camera (the lower
    middle of the "torch median"), and an empty camera."""
    rng = np.random.RandomState(seed)
    b, cams, nh, nw = 2, 3, 12, 20
    gt = np.zeros((b, cams, 2 * nh, 2 * nw, 1), np.float32)
    hits = rng.rand(*gt.shape) < 0.1
    gt[hits] = rng.uniform(0.3, 95.0, hits.sum())
    gt[:, 2] = 0.0
    pred = rng.uniform(1.0, 90.0, (b, cams, nh, nw, 1)).astype(np.float32)
    occ = (rng.rand(b, cams, nh, nw, 1) > 0.2).astype(np.float32)
    # camera 1: exactly 4 valid pixels, an even count
    gt[:, 1] = 0.0
    gt[0, 1, 0:2, 0, 0] = [10.0, 30.0]
    gt[1, 1, 4:6, 4, 0] = [20.0, 40.0]
    occ[:, 1] = 1.0
    metric, median, scales = _both(gt, pred, occ, 0.5, 80.0)
    assert np.isnan(scales[2]) and not np.isnan(scales[1])
    assert all(np.isfinite(v) for v in metric.values())
    assert all(np.isfinite(v) for v in median.values())
