"""NamedSharding helpers: batch-sharded activations, replicated params.

Under ``jax.jit`` with these shardings, XLA inserts the gradient ``psum``
(an all-reduce, NCCL on GPUs) automatically — the collective a torch
rebuild would hand-write (SURVEY.md §3.4).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def batch_sharding(mesh: Mesh, ndim: int, *, axis: str = "data", spatial_axis: str | None = None) -> NamedSharding:
    """Shard dim 0 (batch) over ``axis``; optionally dim 1 (H) over ``spatial_axis``."""
    spec = [None] * ndim
    spec[0] = axis
    if spatial_axis is not None and ndim >= 2:
        spec[1] = spatial_axis
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree, *, axis: str = "data", spatial_axis: str | None = None):
    """Device_put every leaf with its batch dim sharded over the mesh."""

    def put(x):
        return jax.device_put(x, batch_sharding(mesh, x.ndim, axis=axis, spatial_axis=spatial_axis))

    return jax.tree.map(put, tree)


def replicate(mesh: Mesh, tree):
    """Device_put every leaf fully replicated."""
    s = replicated_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), tree)


def padded_batch_putter(mesh: Mesh, *, void_label: int, axis: str = "data"):
    """``put(images, labels)`` for the DP training loops: shard a batch over
    ``axis``, padding short batches with zero images and all-void labels.

    Disk splits are rarely divisible by the batch size, so the LAST batch of
    an epoch comes up short and a batch-sharded ``device_put`` would raise
    (and even a divisible short batch would compile a second program).
    Padding is exact: both losses (`ops.losses`) and the confusion matrix
    (`ops.metrics`) mask void labels with a count-guarded denominator, so
    padded rows contribute exactly nothing to loss, gradients, or metrics.
    (With shard_map pmean, an entirely-padded shard averages in a zero loss/
    gradient for the final partial step — the equal-shard-weighting
    semantics every DP step already has.) The padded size is pinned by the
    first batch seen, so the whole run stays one jitted shape.
    """
    n_dev = mesh.shape[axis]
    target = [0]

    def put(images, labels):
        x = np.asarray(images)
        y = np.asarray(labels)
        b = x.shape[0]
        t = max(target[0], -(-b // n_dev) * n_dev)
        target[0] = t
        if b < t:
            x = np.concatenate([x, np.zeros((t - b, *x.shape[1:]), x.dtype)])
            y = np.concatenate([y, np.full((t - b, *y.shape[1:]), void_label, y.dtype)])
        return shard_batch(mesh, (jnp.asarray(x), jnp.asarray(y)), axis=axis)

    return put
