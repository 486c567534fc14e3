"""Segmentation-map corruption: fused one-hot + Gaussian noise + softmax.

This is the rebuild of the reference's ``GaussianNoiseLayerSoftmax``
(``[ref: layers/mylayers.py]``): during DAE training the clean ground-truth
label map is embedded as a probability map, perturbed with Gaussian noise and
renormalized with a softmax so the corrupted input stays on the simplex.

Plain jax: XLA fuses one-hot, noise, add and softmax into a single pass
over the class map, which is a small share of the DAE train step beside the
frozen VGG16 forward and the DAE's forward and backward.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def one_hot_probs(labels: jax.Array, n_classes: int, *, dtype=jnp.float32) -> jax.Array:
    """One-hot encode an integer label map (B,H,W) -> (B,H,W,C).

    Void labels (>= n_classes) map to the all-zero row, matching the
    reference's handling where void pixels carry no target mass.
    """
    return jax.nn.one_hot(labels, n_classes, dtype=dtype)


def corrupt_onehot(
    labels: jax.Array,
    key: jax.Array,
    *,
    n_classes: int,
    sigma: float,
    dtype=jnp.float32,
) -> jax.Array:
    """softmax(one_hot(labels) + sigma * N(0,1)) over the class axis.

    The DAE training corruption for the "from ground truth" regime
    (``[ref: train_dae.py]`` with GaussianNoiseLayerSoftmax). ``sigma=0``
    degenerates to a softmax-smoothed one-hot.
    """
    y = one_hot_probs(labels, n_classes, dtype=dtype)
    noise = jax.random.normal(key, y.shape, dtype=dtype)
    return jax.nn.softmax(y + sigma * noise, axis=-1)


def corrupt_probs(
    probs: jax.Array,
    key: jax.Array,
    *,
    sigma: float,
) -> jax.Array:
    """softmax(probs + sigma * N(0,1)) — corruption applied to an existing
    probability map (e.g. frozen-FCN outputs in the "natural corruption"
    regime of ``[ref: train_dae.py]``)."""
    noise = jax.random.normal(key, probs.shape, dtype=probs.dtype)
    return jax.nn.softmax(probs + sigma * noise, axis=-1)
