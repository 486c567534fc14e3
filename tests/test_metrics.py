"""Metrics vs numpy oracles: confusion, per-class IoU, accuracy, losses."""

import numpy as np
import jax.numpy as jnp

from iterative_inference_segm.ops import (
    confusion_matrix,
    jaccard,
    masked_crossentropy,
    pixel_accuracy,
)
from iterative_inference_segm.ops.losses import crossentropy_probs, l2_regularization
from iterative_inference_segm.ops.metrics import metrics_from_confusion


def _np_confusion(pred, labels, n):
    cm = np.zeros((n, n), np.int64)
    for t, p in zip(labels.ravel(), pred.ravel()):
        if 0 <= t < n:
            cm[t, p] += 1
    return cm


def test_confusion_matrix_oracle():
    rng = np.random.default_rng(0)
    n = 5
    labels = rng.integers(0, n + 1, size=(2, 16, 16))  # includes void (=5)
    pred = rng.integers(0, n, size=(2, 16, 16))
    cm = np.asarray(confusion_matrix(jnp.asarray(pred), jnp.asarray(labels), n_classes=n))
    np.testing.assert_array_equal(cm, _np_confusion(pred, labels, n))


def test_jaccard_perfect_prediction():
    labels = np.tile(np.arange(4, dtype=np.int32), (1, 8, 2))
    m = jaccard(jnp.asarray(labels), jnp.asarray(labels), n_classes=4)
    np.testing.assert_allclose(np.asarray(m.per_class_iou), 1.0)
    assert float(m.mean_iou) == 1.0
    assert float(m.pixel_accuracy) == 1.0


def test_jaccard_oracle_random():
    rng = np.random.default_rng(1)
    n = 3
    labels = rng.integers(0, n + 1, size=(1, 32, 32))
    pred = rng.integers(0, n, size=(1, 32, 32))
    m = jaccard(jnp.asarray(pred), jnp.asarray(labels), n_classes=n)
    cm = _np_confusion(pred, labels, n)
    ious = []
    for c in range(n):
        inter = cm[c, c]
        union = cm[c, :].sum() + cm[:, c].sum() - inter
        ious.append(inter / union if union else 0.0)
    np.testing.assert_allclose(np.asarray(m.per_class_iou), ious, rtol=1e-6)
    np.testing.assert_allclose(float(m.pixel_accuracy), np.trace(cm) / cm.sum(), rtol=1e-6)


def test_masked_crossentropy_ignores_void():
    n = 3
    logits = np.zeros((1, 2, 2, n), np.float32)
    logits[0, 0, 0, 1] = 10.0
    labels = np.array([[[1, n], [n, n]]], np.int32)  # only (0,0) valid
    loss = float(
        masked_crossentropy(jnp.asarray(logits), jnp.asarray(labels), n_classes=n)
    )
    expected = -np.log(np.exp(10.0) / (np.exp(10.0) + 2.0))
    np.testing.assert_allclose(loss, expected, rtol=1e-3)  # value ~9e-5, f32


def test_masked_crossentropy_all_void_is_zero():
    logits = np.zeros((1, 2, 2, 3), np.float32)
    labels = np.full((1, 2, 2), 3, np.int32)
    assert float(masked_crossentropy(jnp.asarray(logits), jnp.asarray(labels), n_classes=3)) == 0.0


def test_crossentropy_probs_matches_logit_version():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(1, 4, 4, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(1, 4, 4))
    a = float(masked_crossentropy(jnp.asarray(logits), jnp.asarray(labels), n_classes=5))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    b = float(crossentropy_probs(jnp.asarray(probs), jnp.asarray(labels), n_classes=5))
    np.testing.assert_allclose(a, b, rtol=1e-4)


def test_pixel_accuracy():
    labels = np.array([[[0, 1], [2, 3]]], np.int32)
    pred = np.array([[[0, 1], [0, 3]]], np.int32)
    acc = float(pixel_accuracy(jnp.asarray(pred), jnp.asarray(labels), n_classes=3))
    # label 3 is void for n_classes=3 -> 2 of 3 valid correct
    np.testing.assert_allclose(acc, 2 / 3, rtol=1e-6)


def test_l2_regularization_counts_only_weights():
    params = {"a": {"w": jnp.ones((2, 2)), "b": jnp.ones((7,))}}
    assert float(l2_regularization(params)) == 4.0


def test_metrics_from_confusion_absent_class():
    cm = jnp.asarray([[5, 0, 0], [0, 0, 0], [1, 0, 4]])
    m = metrics_from_confusion(cm)
    # class 1 absent from labels and predictions -> excluded from mean
    ious = np.asarray(m.per_class_iou)
    np.testing.assert_allclose(ious[1], 0.0)
    np.testing.assert_allclose(float(m.mean_iou), (5 / 6 + 4 / 5) / 2, rtol=1e-6)


def test_masked_crossentropy_matches_gather_oracle():
    """The one-hot class selection (replaces a class-axis gather, ops/losses
    _select_class) must be value-identical to the take_along_axis gather it
    replaced — it adds exact zeros around the selected element."""
    rng = np.random.default_rng(7)
    n = 11
    logits = rng.normal(size=(2, 9, 13, n)).astype(np.float32) * 5.0
    labels = rng.integers(0, n + 2, size=(2, 9, 13)).astype(np.int32)  # with void
    got = float(masked_crossentropy(jnp.asarray(logits), jnp.asarray(labels), n_classes=n))

    x = logits - logits.max(-1, keepdims=True)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    valid = (labels >= 0) & (labels < n)
    nll = -np.take_along_axis(logp, np.where(valid, labels, 0)[..., None], axis=-1)[..., 0]
    expected = nll[valid].sum() / valid.sum()
    np.testing.assert_allclose(got, expected, rtol=1e-5)
