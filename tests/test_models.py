"""FCN-8 / DAE / context-module model tests (tiny shapes, CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iterative_inference_segm.models import (
    init_fcn8,
    fcn8_apply,
    init_dae,
    dae_apply,
    init_contextmod,
    contextmod_apply,
)
from iterative_inference_segm.models.fcn8 import fcn8_logits

H, W, C = 48, 64, 5


@pytest.fixture(scope="module")
def fcn_params():
    return init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=32)


def test_fcn8_output_is_probability_map(fcn_params):
    x = jax.random.normal(jax.random.PRNGKey(1), (2, H, W, 3))
    probs, _ = fcn8_apply(fcn_params, x)
    assert probs.shape == (2, H, W, C)
    np.testing.assert_allclose(np.asarray(probs.sum(-1)), 1.0, rtol=1e-4)
    assert np.asarray(probs).min() >= 0.0


def test_fcn8_feature_taps(fcn_params):
    x = jnp.zeros((1, H, W, 3))
    _, feats = fcn8_apply(fcn_params, x, return_features=("pool3", "pool4", "fc7", "probs"))
    assert feats["pool3"].shape == (1, 6, 8, 256)
    assert feats["pool4"].shape == (1, 3, 4, 512)
    assert feats["fc7"].shape == (1, 2, 2, 32)
    assert feats["probs"].shape == (1, H, W, C)


def test_fcn8_no_taps_by_default(fcn_params):
    x = jnp.zeros((1, H, W, 3))
    _, feats = fcn8_apply(fcn_params, x)
    assert feats == {}


def test_fcn8_odd_input_sizes(fcn_params):
    # CamVid-like non-power-of-two sizes must flow through ceil pooling +
    # crop alignment without shape errors.
    x = jnp.zeros((1, 45, 60, 3))
    probs, _ = fcn8_apply(fcn_params, x)
    assert probs.shape == (1, 45, 60, C)


def test_fcn8_logits_shape_and_grad(fcn_params):
    x = jax.random.normal(jax.random.PRNGKey(2), (1, H, W, 3))
    logits = fcn8_logits(fcn_params, x)
    assert logits.shape == (1, H, W, C)

    def loss(p):
        return jnp.sum(fcn8_logits(p, x) ** 2)

    # jit: the eager VJP is hundreds of op-by-op dispatches (~18s on CPU);
    # jitted it compiles once (persistent-cached across runs) and runs fast
    g = jax.jit(jax.grad(loss))(fcn_params)
    gnorm = sum(float(jnp.abs(v).sum()) for v in jax.tree.leaves(g))
    assert np.isfinite(gnorm) and gnorm > 0


def test_fcn8_dropout_changes_output(fcn_params):
    x = jax.random.normal(jax.random.PRNGKey(3), (1, H, W, 3))
    p1, _ = fcn8_apply(fcn_params, x, dropout_rng=jax.random.PRNGKey(0))
    p2, _ = fcn8_apply(fcn_params, x, dropout_rng=jax.random.PRNGKey(1))
    p3, _ = fcn8_apply(fcn_params, x)
    assert not np.allclose(np.asarray(p1), np.asarray(p2))
    assert not np.allclose(np.asarray(p1), np.asarray(p3))


def test_fcn8_bf16_compute_close_to_f32(fcn_params):
    x = jax.random.normal(jax.random.PRNGKey(4), (1, H, W, 3))
    pf, _ = fcn8_apply(fcn_params, x, compute_dtype=jnp.float32)
    pb, _ = fcn8_apply(fcn_params, x, compute_dtype=jnp.bfloat16)
    assert pb.dtype == jnp.float32  # score path stays f32
    agree = (np.argmax(np.asarray(pf), -1) == np.argmax(np.asarray(pb), -1)).mean()
    assert agree > 0.95


def test_dae_unconditioned():
    params = init_dae(jax.random.PRNGKey(0), n_classes=C, h_specs={})
    y = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(1), (2, H, W, C)), -1)
    out = dae_apply(params, y, {})
    assert out.shape == y.shape
    np.testing.assert_allclose(np.asarray(out.sum(-1)), 1.0, rtol=1e-4)


def test_dae_conditioned_on_pool4(fcn_params):
    x = jnp.zeros((1, H, W, 3))
    probs, feats = fcn8_apply(fcn_params, x, return_features=("pool4",))
    params = init_dae(jax.random.PRNGKey(0), n_classes=C, h_specs={"pool4": 512})
    out = dae_apply(params, probs, feats)
    assert out.shape == (1, H, W, C)


def test_dae_conditioned_multi_tap(fcn_params):
    x = jnp.zeros((1, H, W, 3))
    probs, feats = fcn8_apply(fcn_params, x, return_features=("pool3", "pool4"))
    params = init_dae(
        jax.random.PRNGKey(0), n_classes=C, h_specs={"pool3": 256, "pool4": 512}
    )
    out = dae_apply(params, probs, feats)
    assert out.shape == (1, H, W, C)


def test_dae_grad_flows_through_y(fcn_params):
    # The refinement loop differentiates the DAE wrt its INPUT map — that
    # gradient path must exist and be finite (SURVEY.md §8 "hard parts").
    x = jnp.zeros((1, H, W, 3))
    probs, feats = fcn8_apply(fcn_params, x, return_features=("pool4",))
    params = init_dae(jax.random.PRNGKey(0), n_classes=C, h_specs={"pool4": 512})

    def energy(y):
        r = dae_apply(params, y, feats)
        return 0.5 * jnp.sum((y - r) ** 2)

    g = jax.grad(energy)(probs)
    assert g.shape == probs.shape
    assert np.isfinite(np.asarray(g)).all()


def test_dae_rejects_unknown_tap():
    with pytest.raises(ValueError):
        init_dae(jax.random.PRNGKey(0), n_classes=C, h_specs={"bogus": 8})


def test_dae_rejects_too_deep_tap():
    with pytest.raises(ValueError):
        init_dae(jax.random.PRNGKey(0), n_classes=C, h_specs={"fc7": 32}, depth=2)


def test_contextmod_shapes_and_simplex():
    params = init_contextmod(jax.random.PRNGKey(0), n_classes=C)
    y = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(1), (1, H, W, C)), -1)
    out = contextmod_apply(params, y)
    assert out.shape == y.shape
    np.testing.assert_allclose(np.asarray(out.sum(-1)), 1.0, rtol=1e-4)


def test_contextmod_differentiable():
    params = init_contextmod(jax.random.PRNGKey(0), n_classes=C, width_mult=1)
    y = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32, C)), -1)
    g = jax.grad(lambda yy: jnp.sum(contextmod_apply(params, yy) ** 2))(y)
    assert np.isfinite(np.asarray(g)).all()


def test_dae_stem_pool_variant(fcn_params):
    from iterative_inference_segm.models.dae import init_dae as _init, dae_apply as _apply

    x = jnp.zeros((1, H, W, 3))
    probs, feats = fcn8_apply(fcn_params, x, return_features=("pool4",))
    params = _init(
        jax.random.PRNGKey(0), n_classes=C, h_specs={"pool4": 512}, depth=3, stem_pool=1
    )
    out = _apply(params, probs, feats, depth=3)
    assert out.shape == (1, H, W, C)
    np.testing.assert_allclose(np.asarray(out.sum(-1)), 1.0, rtol=1e-4)


def test_dae_stem_pool_odd_sizes():
    from iterative_inference_segm.models.dae import init_dae as _init, dae_apply as _apply

    params = _init(jax.random.PRNGKey(0), n_classes=C, h_specs={}, depth=2, stem_pool=1)
    y = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(1), (1, 45, 61, C)), -1)
    out = _apply(params, y, {}, depth=2)
    assert out.shape == (1, 45, 61, C)


def test_dae_stem_pool_grad_flows():
    from iterative_inference_segm.models.dae import init_dae as _init, dae_apply as _apply

    params = _init(jax.random.PRNGKey(0), n_classes=C, h_specs={}, depth=2, stem_pool=1)
    y = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32, C)), -1)
    g = jax.grad(lambda yy: jnp.sum((_apply(params, yy, {}, depth=2) - yy) ** 2))(y)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0


def test_dae_stem_rejects_shallow_tap():
    from iterative_inference_segm.models.dae import init_dae as _init

    with pytest.raises(ValueError):
        _init(jax.random.PRNGKey(0), n_classes=C, h_specs={"input": 3}, stem_pool=1)
