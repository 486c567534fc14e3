"""Training losses: void-masked categorical crossentropy + L2 weight decay.

Rebuild of ``[ref: metrics.py]`` ``crossentropy(...)``: the reference flattens
predictions to (pixels, classes), drops pixels whose label is the void class,
and averages categorical crossentropy over the remaining pixels. We keep the
same semantics but stay in NHWC and use a stable fused log-softmax so XLA
emits a single fused reduction (no materialized softmax).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _select_class(logp: jax.Array, labels: jax.Array, n_classes: int) -> jax.Array:
    """logp[..., labels] via a one-hot compare-multiply-reduce.

    A per-pixel ``take_along_axis`` on the CLASS axis is a gather along the
    minor dimension, and its VJP is a scatter. The compare+multiply+reduce
    form is one fused elementwise pass and its VJP is a broadcast multiply. Exact: it picks one
    element and adds true zeros, so the result is bit-identical to the
    gather (barring NaNs in never-selected classes).
    """
    cls = jax.lax.broadcasted_iota(labels.dtype, (n_classes,), 0)
    onehot = (labels[..., None] == cls).astype(logp.dtype)
    return jnp.sum(logp * onehot, axis=-1)


def masked_crossentropy(
    logits: jax.Array,
    labels: jax.Array,
    *,
    n_classes: int,
) -> jax.Array:
    """Mean categorical crossentropy over non-void pixels.

    logits: (B, H, W, C) pre-softmax scores (f32 recommended).
    labels: (B, H, W) int; values >= n_classes (or < 0) are void and excluded.
    Returns a scalar f32. If every pixel is void the loss is 0.
    """
    logits = logits.astype(jnp.float32)
    valid = (labels >= 0) & (labels < n_classes)
    safe_labels = jnp.where(valid, labels, 0)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -_select_class(logp, safe_labels, n_classes)
    nll = jnp.where(valid, nll, 0.0)
    count = jnp.maximum(jnp.sum(valid), 1)
    return jnp.sum(nll) / count


def crossentropy_probs(
    probs: jax.Array,
    labels: jax.Array,
    *,
    n_classes: int,
    eps: float = 1e-7,
) -> jax.Array:
    """Crossentropy against probabilities (already-softmaxed predictions).

    Used when the prediction is an output of the refinement loop (a
    probability map, not logits) — matches how the reference scores the DAE
    reconstruction, which ends in a softmax nonlinearity.
    """
    probs = probs.astype(jnp.float32)
    valid = (labels >= 0) & (labels < n_classes)
    safe_labels = jnp.where(valid, labels, 0)
    logp = jnp.log(jnp.clip(probs, eps, 1.0))
    nll = -_select_class(logp, safe_labels, n_classes)
    nll = jnp.where(valid, nll, 0.0)
    count = jnp.maximum(jnp.sum(valid), 1)
    return jnp.sum(nll) / count


def l2_regularization(params, *, weight_keys: tuple[str, ...] = ("w",)) -> jax.Array:
    """Sum of squared conv weights (biases excluded), for weight decay.

    The reference adds ``weight_decay * lasagne.regularization.l2`` over all
    trainable weights (``[ref: train_fcn8.py]``); optax's additive weight
    decay is the idiomatic equivalent, but this function is kept for loss
    parity checks.
    """
    leaves = []

    def visit(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if isinstance(v, dict) or isinstance(v, (list, tuple)):
                    visit(v)
                elif k in weight_keys:
                    leaves.append(jnp.sum(jnp.square(v.astype(jnp.float32))))
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                visit(v)

    visit(params)
    if not leaves:
        return jnp.asarray(0.0, jnp.float32)
    return sum(leaves)
