"""Folded per-step tail of the half engine (inference/fused.fold_half_tail):
exact-reassociation checks against the unfolded path, both encoders."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iterative_inference_segm.models import init_fcn8, fcn8_apply
from iterative_inference_segm.models.dae import init_dae, dae_core
from iterative_inference_segm.inference.fused import (
    fold_half_tail,
    folded_core_out,
    folded_step_logits,
    half_logits,
    halfres_refinement_scan,
    halfres_refinement_scan_folded,
    make_half_refiner,
)

C = 5


def _dae():
    dae = init_dae(
        jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512}, depth=3,
        stem_pool=1, widths=(8, 16, 32),
    )
    # randomize the bilinear-init deconvs and the identity-init out so the
    # equivalences are non-trivial
    for k in ("up1", "up2", "up3", "up_stem1"):
        dae[k] = {"w": 0.1 * jax.random.normal(
            jax.random.PRNGKey(hash(k) % 2**31), dae[k]["w"].shape)}
    dae["out"] = {
        "w": 0.5 * jax.random.normal(jax.random.PRNGKey(9), dae["out"]["w"].shape),
        "b": 0.1 * jax.random.normal(jax.random.PRNGKey(10), dae["out"]["b"].shape),
    }
    return dae


@pytest.mark.parametrize("encoder", ["pool", "stride"])
def test_predense_plus_fold_equals_core(encoder):
    dae = _dae()
    h = {"pool4": jax.random.normal(jax.random.PRNGKey(7), (2, 3, 4, 512))}
    x = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(8), (2, 24, 32, C)), -1)

    want = dae_core(dae, x, h, depth=3, stem_pool=1, encoder=encoder)
    fk = fold_half_tail(dae, encoder=encoder)
    pre, sk1 = dae_core(dae, x, h, depth=3, stem_pool=1, encoder=encoder, predense=True)
    got = folded_core_out(fk, pre, sk1, encoder=encoder, out_hw=(24, 32))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("encoder", ["pool", "stride"])
def test_folded_step_logits_match_unfolded(encoder):
    dae = _dae()
    h = {"pool4": jax.random.normal(jax.random.PRNGKey(7), (2, 3, 4, 512))}
    x = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(8), (2, 24, 32, C)), -1)

    s = dae_core(dae, x, h, depth=3, stem_pool=1, encoder=encoder)
    want = half_logits(dae, x, s)
    fk = fold_half_tail(dae, encoder=encoder)
    pre, sk1 = dae_core(dae, x, h, depth=3, stem_pool=1, encoder=encoder, predense=True)
    got = folded_step_logits(fk, pre, sk1, x, encoder=encoder)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("encoder", ["pool", "stride"])
def test_folded_scan_matches_unfolded_scan(encoder):
    dae = _dae()
    h = {"pool4": jax.random.normal(jax.random.PRNGKey(7), (2, 3, 4, 512))}
    y0 = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(3), (2, 48, 64, C)), -1)

    core_fn = lambda xx: dae_core(dae, xx, h, depth=3, stem_pool=1, encoder=encoder)
    predense_fn = lambda xx: dae_core(
        dae, xx, h, depth=3, stem_pool=1, encoder=encoder, predense=True
    )
    want = halfres_refinement_scan(dae, core_fn, y0, eps=0.3, num_steps=3)
    got = halfres_refinement_scan_folded(
        dae, predense_fn, y0, eps=0.3, num_steps=3, encoder=encoder
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-3, atol=1e-4)


def test_make_half_refiner_fold_default_and_equivalence():
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = _dae()
    x = jax.random.normal(jax.random.PRNGKey(2), (2, 48, 64, 3))

    folded = make_half_refiner(fcn8_apply, fcn, dae, eps=0.3, num_steps=2,
                               h_taps=("pool4",), depth=3)  # fold on by default
    unfolded = make_half_refiner(fcn8_apply, fcn, dae, eps=0.3, num_steps=2,
                                 h_taps=("pool4",), depth=3, fold_tail=False)
    _, yk_f = folded(x)
    _, yk_u = unfolded(x)
    np.testing.assert_allclose(np.asarray(yk_f), np.asarray(yk_u), rtol=1e-3, atol=1e-4)


def test_fold_requires_score_and_full_tail():
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = _dae()
    with pytest.raises(ValueError, match="fold_tail"):
        make_half_refiner(fcn8_apply, fcn, dae, eps=0.1, num_steps=1,
                          depth=3, mode="energy", fold_tail=True)
    sep = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512},
                   depth=3, stem_pool=1, tail="sep", widths=(8, 16, 32))
    with pytest.raises(ValueError, match="full"):
        fold_half_tail(sep)
    # energy mode still runs (unfolded path selected by default)
    refine = make_half_refiner(fcn8_apply, fcn, dae, eps=0.1, num_steps=1,
                               h_taps=("pool4",), depth=3, mode="energy")
    x = jax.random.normal(jax.random.PRNGKey(2), (1, 48, 64, 3))
    _, yk = refine(x)
    assert np.isfinite(np.asarray(yk, np.float32)).all()


@pytest.mark.parametrize("encoder", ["pool", "stride"])
def test_fold_composes_weights_at_highest_precision(encoder):
    """Every contraction that composes the folded kernels asks for HIGHEST
    precision, so a GPU never runs it in TF32, and the result matches a
    float64 composition."""
    dae = _dae()
    jaxpr = jax.make_jaxpr(lambda p: fold_half_tail(p, encoder=encoder))(dae)
    dots = [e for e in jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots, "fold_half_tail composed no kernels"
    for e in dots:
        assert e.params["precision"] == (
            jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST
        ), e.params["precision"]

    fk = fold_half_tail(dae, encoder=encoder)
    w_out = np.asarray(dae["out"]["w"][0, 0], np.float64)
    up1p = np.einsum("hwim,mo->hwio", np.asarray(dae["up1"]["w"], np.float64), w_out)
    np.testing.assert_allclose(np.asarray(fk["up1p"]), up1p, rtol=1e-5, atol=1e-6)
    if encoder == "pool":
        bp = np.asarray(dae["score_enc1"]["b"], np.float64) @ w_out + np.asarray(
            dae["out"]["b"], np.float64
        )
        np.testing.assert_allclose(np.asarray(fk["bp"]), bp, rtol=1e-5, atol=1e-6)
