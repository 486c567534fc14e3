"""Shared training scaffold: optimizer, train state, early stopping.

The reference repeats the same epoch/early-stop/checkpoint scaffold in both
training scripts (SURVEY.md §4.1: "patience-based early stopping on val
jaccard ... save best params"); here it is factored once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax


@dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    max_epochs: int = 500
    patience: int = 25
    batch_size: int = 10
    seed: int = 0
    compute_dtype: Any = jnp.float32
    # rematerialize the forward during backprop (jax.checkpoint): trades
    # FLOPs for activation memory, so larger batches fit on one device
    remat: bool = False


class TrainState(NamedTuple):
    step: jax.Array
    params: Any
    opt_state: Any


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    """Adam + decoupled weight decay on conv weights only (biases and the
    bilinear deconv kernels follow the reference's L2-on-weights choice in
    ``[ref: train_fcn8.py]`` where regularizable=weights)."""

    def weight_mask(params):
        return jax.tree.map_with_path(
            lambda path, _: any(getattr(k, "key", None) == "w" for k in path), params
        )

    return optax.chain(
        optax.add_decayed_weights(cfg.weight_decay, mask=weight_mask),
        optax.adam(cfg.learning_rate),
    )


def init_train_state(params, cfg: TrainConfig) -> tuple[TrainState, optax.GradientTransformation]:
    tx = make_optimizer(cfg)
    return TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params)), tx


class EarlyStopper:
    """Patience-based early stopping on a maximized validation metric."""

    def __init__(self, patience: int):
        self.patience = patience
        self.best = -float("inf")
        self.best_epoch = -1
        self.bad_epochs = 0

    def update(self, epoch: int, value: float) -> bool:
        """Record ``value``; returns True if this is a new best."""
        if value > self.best:
            self.best = value
            self.best_epoch = epoch
            self.bad_epochs = 0
            return True
        self.bad_epochs += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.bad_epochs > self.patience
