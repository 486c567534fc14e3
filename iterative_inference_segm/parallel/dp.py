"""Explicit SPMD data parallelism via shard_map + psum.

The jit+NamedSharding path (parallel/sharding.py) lets XLA infer the
gradient all-reduce; this module is the explicit formulation — the per-device
program is written once, batch-sharded inputs stay device-local, and the
gradient ``psum`` over the 'data' axis is spelled out. Use it when you want
collectives pinned rather than inferred.

XLA lowers the ``psum`` to an NCCL all-reduce on GPUs — the collective a
torch DDP rebuild would call (SURVEY.md §3.4 — the reference itself is
single-GPU and has neither).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def make_dp_grad_step(
    loss_fn: Callable,
    tx,
    mesh: Mesh,
    *,
    axis: str = "data",
) -> Callable:
    """Build a shard_map'd SGD/Adam step for ``loss_fn(params, batch, rng)``.

    Returns ``step(params, opt_state, batch, rng) -> (params, opt_state, loss)``
    where ``batch`` is a pytree whose leaves are batch-sharded over ``axis``
    and params/opt_state are replicated. Gradients and loss are psum-averaged
    across the axis before the optimizer update, so every device applies the
    identical update (keeping params replicated without re-broadcast).
    """

    def device_step(params, opt_state, batch, rng):
        # Decorrelate per-device randomness: the rng enters replicated, so
        # without folding in the axis index every device would draw identical
        # augmentation crops / corruption noise for its local shard.
        if rng is not None:
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        # per-device loss over the local shard; mean across devices via psum
        loss, grads = jax.value_and_grad(loss_fn)(params, batch, rng)
        loss = jax.lax.pmean(loss, axis)
        grads = jax.lax.pmean(grads, axis)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    batch_spec = P(axis)
    rep = P()

    sharded = shard_map(
        device_step,
        mesh=mesh,
        in_specs=(rep, rep, batch_spec, rep),
        out_specs=(rep, rep, rep),
        check_vma=False,
    )
    return jax.jit(sharded)


def put_dp(mesh: Mesh, params, opt_state, batch, *, axis: str = "data"):
    """Place (params, opt_state) replicated and ``batch`` batch-sharded."""
    rep = NamedSharding(mesh, P())
    params = jax.tree.map(lambda x: jax.device_put(x, rep), params)
    opt_state = jax.tree.map(lambda x: jax.device_put(x, rep), opt_state)

    def shard(x):
        spec = [None] * jnp.ndim(x)
        if spec:
            spec[0] = axis
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    batch = jax.tree.map(shard, batch)
    return params, opt_state, batch
