"""deepatlas_torch's confusion-matrix metrics against deepatlas_tpu's:
``iou_from_confusion``, ``recall_from_confusion``,
``precision_from_confusion``, ``per_class_metrics`` and ``metric_eval``.
The confusion counts are exact integers in both packages and the metrics
the same float32 ratios of them: equal bits."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepatlas_tpu.metrics import confusion as jconf
from deepatlas_torch import metrics

NC = 5


@pytest.fixture
def masks(rng):
    truth = rng.randint(0, NC, (2, 7, 9, 6)).astype(np.int32)
    pred = np.where(rng.rand(*truth.shape) < 0.6, truth,
                    rng.randint(0, NC, truth.shape)).astype(np.int32)
    pred[pred == 3] = 0          # class 3 absent from the prediction
    truth[truth == 4] = 1        # class 4 absent from the truth
    return pred, truth


@pytest.mark.parametrize("eps", [0.0, 1e-11])
@pytest.mark.parametrize("name", ["iou", "recall", "precision"])
def test_from_confusion(masks, name, eps):
    pred, truth = masks
    cm = metrics.confusion_matrix(torch.from_numpy(pred),
                                  torch.from_numpy(truth), NC)
    jcm = jconf.confusion_matrix(jnp.asarray(pred), jnp.asarray(truth), NC)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    fn = getattr(metrics, f"{name}_from_confusion")
    ref = getattr(jconf, f"{name}_from_confusion")(jcm, eps)
    np.testing.assert_array_equal(fn(cm, eps).numpy(), np.asarray(ref))


def test_per_class_metrics(masks):
    pred, truth = masks
    got = metrics.per_class_metrics(torch.from_numpy(pred),
                                    torch.from_numpy(truth), NC)
    ref = jconf.per_class_metrics(jnp.asarray(pred), jnp.asarray(truth), NC)
    assert set(got) == set(ref) == {"dice", "iou", "recall", "precision"}
    for key in got:
        assert got[key].shape == (NC,)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    # absent from both: no 0/0
    empty = metrics.per_class_metrics(torch.zeros(4, dtype=torch.long),
                                      torch.zeros(4, dtype=torch.long), 3)
    assert all(torch.isfinite(v).all() for v in empty.values())


@pytest.mark.parametrize("metric", ["dice", "iou", "recall", "precision"])
def test_metric_eval(rng, metric):
    truth = (rng.rand(6, 8, 5) < 0.4).astype(np.uint8)
    pred = (rng.rand(6, 8, 5) < 0.5).astype(np.uint8)
    got = metrics.metric_eval(metric, torch.from_numpy(pred),
                              torch.from_numpy(truth))
    ref = jconf.metric_eval(metric, jnp.asarray(pred), jnp.asarray(truth))
    assert got.shape == ()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="metric"):
        metrics.metric_eval("hausdorff", torch.from_numpy(pred),
                            torch.from_numpy(truth))
