"""Phase-major fused refinement engine == the general engine (same math)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iterative_inference_segm.models import init_fcn8, fcn8_apply
from iterative_inference_segm.models.dae import (
    init_dae,
    dae_apply,
    dae_septail_logits,
    dae_core,
)
from iterative_inference_segm.inference.iterative import make_refiner, refinement_scan
from iterative_inference_segm.inference.fused import (
    fused_refinement_scan,
    make_fused_refiner,
    phase_merge,
    phase_split,
    septail_phase_logits,
)

C = 5


def _septail_dae(key, n_classes=C, depth=3):
    return init_dae(
        key, n_classes=n_classes, h_specs={"pool4": 512}, depth=depth,
        stem_pool=1, tail="sep", widths=(8, 16, 32),
    )


def _rand_params(params, key):
    """Perturb init params so identity/zero inits don't mask layout bugs."""
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(
        treedef,
        [l + 0.1 * jax.random.normal(k, jnp.shape(l)) for l, k in zip(leaves, keys)],
    )


def test_phase_split_merge_roundtrip():
    y = jax.random.normal(jax.random.PRNGKey(0), (2, 8, 12, C))
    ph = phase_split(y)
    assert ph.shape == (2, 2, 2, C, 4, 6)
    # spot indexing convention: [b, ph, pw, c, j, u] == y[b, 2j+ph, 2u+pw, c]
    np.testing.assert_allclose(np.asarray(ph[1, 1, 0, 3, 2, 4]), np.asarray(y[1, 5, 8, 3]))
    np.testing.assert_allclose(np.asarray(phase_merge(ph)), np.asarray(y))


def test_phase_split_rejects_odd():
    with pytest.raises(ValueError):
        phase_split(jnp.zeros((1, 7, 8, C)))


def test_septail_phase_logits_match_nhwc_composition():
    key = jax.random.PRNGKey(1)
    params = _rand_params(_septail_dae(key), jax.random.PRNGKey(2))
    y = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(3), (2, 16, 24, C)), -1)
    s = jax.random.normal(jax.random.PRNGKey(4), (2, 8, 12, C))

    ref = dae_septail_logits(params, s, y)  # NHWC composition (grouped convs)
    # jit: the phase-major tail is ~600 slab ops — eager dispatch dominates
    got = jax.jit(septail_phase_logits)(
        params, jnp.transpose(s, (0, 3, 1, 2)), phase_split(y)
    )
    np.testing.assert_allclose(
        np.asarray(phase_merge(got)), np.asarray(ref), rtol=1e-5, atol=1e-5
    )


def test_fused_scan_matches_general_engine():
    """K fused phase-major steps == dae_apply + refinement_scan, f32."""
    key = jax.random.PRNGKey(5)
    params = _rand_params(_septail_dae(key), jax.random.PRNGKey(6))
    y0 = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(7), (2, 16, 24, C)), -1)
    h = {"pool4": jax.random.normal(jax.random.PRNGKey(8), (2, 1, 2, 512))}

    dae_fn = lambda y: dae_apply(params, y, h, depth=3)
    ref = refinement_scan(dae_fn, y0, eps=0.3, num_steps=3, mode="score")

    core_fn = lambda yp: dae_core(params, yp, h, depth=3, stem_pool=1)
    got = fused_refinement_scan(params, core_fn, y0, eps=0.3, num_steps=3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_make_fused_refiner_end_to_end_matches():
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = _rand_params(_septail_dae(jax.random.PRNGKey(1)), jax.random.PRNGKey(2))
    x = jax.random.normal(jax.random.PRNGKey(3), (2, 48, 64, 3))

    ref = make_refiner(
        fcn8_apply, dae_apply, fcn, dae, eps=0.2, num_steps=2,
        h_taps=("pool4",), dae_kwargs={"depth": 3},
    )
    y0_r, yk_r = ref(x)
    fast = make_fused_refiner(
        fcn8_apply, fcn, dae, eps=0.2, num_steps=2, h_taps=("pool4",), depth=3
    )
    y0_f, yk_f = fast(x)
    np.testing.assert_allclose(np.asarray(y0_f), np.asarray(y0_r), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(yk_f), np.asarray(yk_r), rtol=2e-4, atol=2e-5)
    # the steps actually moved the iterate
    assert float(jnp.abs(yk_r - y0_r).max()) > 1e-4


def test_fused_refiner_rejects_wrong_dae():
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dense = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512},
                     depth=3, stem_pool=1, widths=(8, 16, 32))
    with pytest.raises(ValueError):
        make_fused_refiner(fcn8_apply, fcn, dense, eps=0.1, num_steps=1, depth=3)


def test_fused_scan_is_differentiable_energy_style():
    """The fused path is plain jnp: grads flow through it (energy-mode and
    training compatibility)."""
    params = _rand_params(_septail_dae(jax.random.PRNGKey(9)), jax.random.PRNGKey(10))
    y0 = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(11), (1, 16, 24, C)), -1)
    h = {"pool4": jax.random.normal(jax.random.PRNGKey(12), (1, 1, 2, 512))}
    core_fn = lambda yp: dae_core(params, yp, h, depth=3, stem_pool=1)

    def loss(p):
        cf = lambda yp: dae_core(p, yp, h, depth=3, stem_pool=1)
        return jnp.sum(fused_refinement_scan(p, cf, y0, eps=0.2, num_steps=2))

    g = jax.grad(loss)(params)
    assert float(jnp.abs(g["mix"]["w"]).sum()) > 0
    assert float(jnp.abs(g["enc1"]["w"]).sum()) > 0
