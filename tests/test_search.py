"""(eps, K) grid-search tests — the iterative_inference_valid rebuild."""

import numpy as np
import jax
import jax.numpy as jnp

from iterative_inference_segm.inference import grid_search_eps_k
from iterative_inference_segm.models import (
    init_fcn8,
    fcn8_apply,
    init_dae,
    dae_apply,
)

C = 4


def test_grid_search_shapes_and_selection():
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512})
    rng = np.random.default_rng(0)
    batches = [
        (
            rng.normal(size=(2, 48, 64, 3)).astype(np.float32),
            rng.integers(0, C, size=(2, 48, 64)).astype(np.int32),
        )
        for _ in range(2)
    ]
    res = grid_search_eps_k(
        fcn8_apply, dae_apply, fcn, dae, batches,
        n_classes=C, eps_grid=[0.05, 0.3], k_max=3,
    )
    assert res["miou"].shape == (2, 4)
    assert res["best_eps"] in (0.05, 0.3)
    assert 0 <= res["best_k"] <= 3
    # K=0 rows must agree across eps (no steps -> eps is irrelevant)
    np.testing.assert_allclose(res["miou"][0, 0], res["miou"][1, 0], rtol=1e-6)
    # the reported best really is the max of the table
    assert res["best_miou"] == res["miou"].max()


def test_grid_search_identity_dae_prefers_any_k_equally():
    """If the DAE is replaced by identity (r(y)=y) every (eps, K) gives the
    same mIoU as K=0; the search must not fabricate an improvement."""
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)

    def id_dae_apply(params, y, h, **kw):
        return y

    rng = np.random.default_rng(1)
    batches = [
        (
            rng.normal(size=(1, 48, 64, 3)).astype(np.float32),
            rng.integers(0, C, size=(1, 48, 64)).astype(np.int32),
        )
    ]
    res = grid_search_eps_k(
        fcn8_apply, id_dae_apply, fcn, {}, batches,
        n_classes=C, eps_grid=[0.1, 0.5], k_max=2,
    )
    np.testing.assert_allclose(res["miou"], res["miou"][0, 0], rtol=1e-6)


def test_grid_search_bf16_compute_dtype_runs_and_selects():
    """compute_dtype=bf16 (the throughput numerics) must produce a valid
    search result whose K=0 row matches the f32 search closely (K=0 is the
    bare FCN argmax, robust to bf16)."""
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512})
    rng = np.random.default_rng(1)
    batches = [
        (
            rng.normal(size=(2, 48, 64, 3)).astype(np.float32),
            rng.integers(0, C, size=(2, 48, 64)).astype(np.int32),
        )
    ]
    res16 = grid_search_eps_k(
        fcn8_apply, dae_apply, fcn, dae, batches,
        n_classes=C, eps_grid=[0.3], k_max=2, compute_dtype=jnp.bfloat16,
    )
    res32 = grid_search_eps_k(
        fcn8_apply, dae_apply, fcn, dae, batches,
        n_classes=C, eps_grid=[0.3], k_max=2,
    )
    assert res16["miou"].shape == (1, 3)
    assert np.all(np.isfinite(res16["miou"]))
    np.testing.assert_allclose(res16["miou"][0, 0], res32["miou"][0, 0], atol=0.02)


def test_grid_search_half_rejects_odd_and_wrong_stem():
    from iterative_inference_segm.inference.search import grid_search_eps_k_half
    import pytest

    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae1 = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512},
                    depth=3, stem_pool=1, widths=(8, 16, 32))
    rng = np.random.default_rng(2)
    odd = [(rng.normal(size=(1, 47, 64, 3)).astype(np.float32),
            rng.integers(0, C, size=(1, 47, 64)).astype(np.int32))]
    with pytest.raises(ValueError, match="divisible"):
        grid_search_eps_k_half(fcn8_apply, fcn, dae1, odd, n_classes=C,
                               eps_grid=[0.1], k_max=1, depth=3)
    dae0 = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512})
    even = [(rng.normal(size=(1, 48, 64, 3)).astype(np.float32),
             rng.integers(0, C, size=(1, 48, 64)).astype(np.int32))]
    with pytest.raises(ValueError, match="stem_pool"):
        grid_search_eps_k_half(fcn8_apply, fcn, dae0, even, n_classes=C,
                               eps_grid=[0.1], k_max=1, depth=4)
