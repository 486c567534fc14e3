"""Corruption op tests: simplex preservation, statistics, void handling."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iterative_inference_segm.ops import corrupt_onehot, one_hot_probs
from iterative_inference_segm.ops.corruption import corrupt_probs


def test_one_hot_void_rows_are_zero():
    labels = jnp.asarray([[0, 2, 3]])  # 3 == void for n_classes=3
    oh = np.asarray(one_hot_probs(labels, 3))
    np.testing.assert_array_equal(oh[0, 0], [1, 0, 0])
    np.testing.assert_array_equal(oh[0, 2], [0, 0, 0])


def test_corrupt_onehot_stays_on_simplex():
    labels = jax.random.randint(jax.random.PRNGKey(0), (2, 8, 8), 0, 5)
    out = corrupt_onehot(labels, jax.random.PRNGKey(1), n_classes=5, sigma=2.0)
    s = np.asarray(out.sum(-1))
    np.testing.assert_allclose(s, 1.0, rtol=1e-5)
    assert np.asarray(out).min() >= 0


def test_corrupt_onehot_sigma_zero_is_softmax_onehot():
    labels = jnp.asarray([[[1]]])
    out = np.asarray(corrupt_onehot(labels, jax.random.PRNGKey(0), n_classes=3, sigma=0.0))
    expected = np.exp([0, 1, 0]) / np.exp([0, 1, 0]).sum()
    np.testing.assert_allclose(out[0, 0, 0], expected, rtol=1e-5)


def test_corrupt_onehot_noise_level_monotone():
    # Larger sigma must (on average) push mass further from the clean one-hot.
    labels = jax.random.randint(jax.random.PRNGKey(0), (4, 16, 16), 0, 11)
    clean = np.asarray(corrupt_onehot(labels, jax.random.PRNGKey(1), n_classes=11, sigma=0.0))
    deviations = []
    for sigma in (0.1, 0.5, 2.0):
        noisy = np.asarray(corrupt_onehot(labels, jax.random.PRNGKey(1), n_classes=11, sigma=sigma))
        deviations.append(np.abs(noisy - clean).mean())
    assert deviations[0] < deviations[1] < deviations[2]


def test_corrupt_onehot_argmax_mostly_preserved_small_sigma():
    labels = jax.random.randint(jax.random.PRNGKey(2), (2, 32, 32), 0, 11)
    out = corrupt_onehot(labels, jax.random.PRNGKey(3), n_classes=11, sigma=0.2)
    agree = (np.argmax(np.asarray(out), -1) == np.asarray(labels)).mean()
    assert agree > 0.99


def test_corrupt_probs_simplex():
    probs = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(0), (1, 8, 8, 5)), -1)
    out = corrupt_probs(probs, jax.random.PRNGKey(1), sigma=1.0)
    np.testing.assert_allclose(np.asarray(out.sum(-1)), 1.0, rtol=1e-5)


def test_corrupt_deterministic_in_key():
    labels = jax.random.randint(jax.random.PRNGKey(0), (1, 4, 4), 0, 3)
    a = corrupt_onehot(labels, jax.random.PRNGKey(7), n_classes=3, sigma=1.0)
    b = corrupt_onehot(labels, jax.random.PRNGKey(7), n_classes=3, sigma=1.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_corrupt_onehot_void_rows_uniform_at_sigma_zero():
    # void labels (>= n_classes) one-hot to the zero row; softmax of a zero
    # row without noise is the uniform distribution
    labels = jnp.full((1, 8, 8), 7, jnp.int32)
    out = corrupt_onehot(labels, jax.random.PRNGKey(0), n_classes=4, sigma=0.0)
    np.testing.assert_allclose(np.asarray(out), 0.25, rtol=1e-6)


@pytest.mark.parametrize("shape", [(1, 30, 17), (3, 7, 5)])
def test_corrupt_onehot_odd_shapes(shape):
    labels = jax.random.randint(jax.random.PRNGKey(1), shape, 0, 6)
    out = corrupt_onehot(labels, jax.random.PRNGKey(2), n_classes=6, sigma=0.5)
    assert out.shape == (*shape, 6)
    np.testing.assert_allclose(np.asarray(out.sum(-1)), 1.0, rtol=1e-5)


def test_corrupt_probs_sigma_zero_is_softmax():
    probs = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(0), (1, 8, 8, 5)), -1)
    out = corrupt_probs(probs, jax.random.PRNGKey(1), sigma=0.0)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(jax.nn.softmax(probs, -1)), rtol=1e-6, atol=1e-7
    )


@pytest.mark.parametrize("sigma", [0.3, 1.0, 2.0])
def test_corrupt_noise_std_matches_sigma(sigma):
    # On void rows the output is softmax(sigma * z), so a log-ratio of two
    # classes is sigma * (z_i - z_j): zero mean, std sigma * sqrt(2).
    labels = jnp.full((4, 64, 64), 11, jnp.int32)
    out = np.asarray(corrupt_onehot(labels, jax.random.PRNGKey(5), n_classes=11, sigma=sigma))
    d = np.log(out[..., 0]) - np.log(out[..., 1])
    assert abs(d.mean()) < 0.05 * sigma
    assert abs(d.std() / (sigma * np.sqrt(2.0)) - 1.0) < 0.05


def test_corrupt_probs_keeps_dtype():
    probs = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(0), (1, 4, 4, 5)), -1)
    out = corrupt_probs(probs.astype(jnp.bfloat16), jax.random.PRNGKey(1), sigma=1.0)
    assert out.dtype == jnp.bfloat16 and out.shape == probs.shape


def test_corrupt_other_key_other_noise():
    labels = jax.random.randint(jax.random.PRNGKey(0), (1, 16, 16), 0, 3)
    a = corrupt_onehot(labels, jax.random.PRNGKey(9), n_classes=3, sigma=1.0)
    b = corrupt_onehot(labels, jax.random.PRNGKey(10), n_classes=3, sigma=1.0)
    assert not np.allclose(np.asarray(a), np.asarray(b))
