"""BASELINE config 5: the full pipeline on the second dataset family
(EM membranes, 1-channel; Polyps, binary) — same code path as CamVid."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iterative_inference_segm.data.config_datasets import EM, POLYPS
from iterative_inference_segm.data.synthetic import synthetic_batches
from iterative_inference_segm.inference import make_refiner
from iterative_inference_segm.models import (
    init_fcn8,
    fcn8_apply,
    init_dae,
    dae_apply,
)
from iterative_inference_segm.train import TrainConfig, train_fcn8, train_dae

import dataclasses

EM_TINY = dataclasses.replace(EM, height=48, width=64, train_crop=(32, 32))
POLYPS_TINY = dataclasses.replace(POLYPS, height=48, width=64, train_crop=(32, 32))


def _data(cfg, n, seed):
    return list(
        synthetic_batches(cfg=cfg, batch_size=2, num_batches=n, height=48, width=64, seed=seed)
    )


def test_em_fcn8_forward_single_channel():
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=EM.n_classes, in_channels=1, fc_channels=16)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 48, 64, 1))
    probs, _ = fcn8_apply(params, x)
    assert probs.shape == (1, 48, 64, 2)


def test_em_training_end_to_end():
    tcfg = TrainConfig(learning_rate=3e-4, weight_decay=0.0, max_epochs=2, patience=10)
    r = train_fcn8(
        dataset=EM_TINY,
        train_data=_data(EM_TINY, 3, 0),
        val_data=_data(EM_TINY, 1, 9),
        tcfg=tcfg,
        fc_channels=16,
    )
    assert r["history"][-1]["train_loss"] < r["history"][0]["train_loss"]


def test_em_dae_and_refinement():
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=2, in_channels=1, fc_channels=16)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=2, h_specs={"pool4": 512})
    refine = make_refiner(
        fcn8_apply, dae_apply, fcn, dae, eps=0.1, num_steps=3, h_taps=("pool4",)
    )
    x = jax.random.normal(jax.random.PRNGKey(2), (2, 48, 64, 1))
    y0, yk = refine(x)
    assert yk.shape == (2, 48, 64, 2)
    np.testing.assert_allclose(np.asarray(yk.sum(-1)), 1.0, rtol=1e-4)


def test_polyps_dae_training():
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=2, in_channels=3, fc_channels=16)
    tcfg = TrainConfig(learning_rate=3e-4, max_epochs=1, patience=5)
    r = train_dae(
        fcn_params=fcn,
        dataset=POLYPS_TINY,
        train_data=_data(POLYPS_TINY, 2, 0),
        val_data=_data(POLYPS_TINY, 1, 9),
        tcfg=tcfg,
        sigma=0.5,
    )
    assert np.isfinite(r["history"][-1]["train_loss"])


def test_binary_confusion_and_metrics():
    from iterative_inference_segm.ops.metrics import jaccard

    labels = np.array([[[0, 1, 2], [1, 0, 2]]], np.int32)  # 2 = void
    pred = np.array([[[0, 1, 1], [0, 0, 0]]], np.int32)
    m = jaccard(jnp.asarray(pred), jnp.asarray(labels), n_classes=2)
    # class0: inter 2 (0,0 & 1,1... compute: true0 at (0,0),(1,1); pred0 at (0,0),(1,0),(1,1)
    #   inter=2 union=3; class1: true at (0,1),(1,0); pred1 at (0,1); inter 1 union 2
    np.testing.assert_allclose(np.asarray(m.per_class_iou), [2 / 3, 1 / 2], rtol=1e-6)
