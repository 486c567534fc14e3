"""Mirror-architecture DAE (models/dae_mirror.py): the reference-parity
variant — structure, tied weights, switch-based unpooling, positional
checkpoint import, and refinement integration."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iterative_inference_segm.models.dae_mirror import (
    adjoint_kernel,
    init_mirror_dae,
    mirror_dae_apply,
    mirror_depth_of,
    mirror_tied_of,
)
from iterative_inference_segm.ops.conv import conv2d, max_pool, max_unpool


def _rand(key, shape):
    return jax.random.normal(key, shape, dtype=jnp.float32)


def _probs(key, shape):
    return jax.nn.softmax(_rand(key, shape), axis=-1)


def test_shapes_and_simplex():
    k = jax.random.PRNGKey(0)
    params = init_mirror_dae(
        k, n_classes=5, h_specs={"pool1": 4}, depth=3, widths=(8, 12, 16)
    )
    assert mirror_depth_of(params) == 3
    assert not mirror_tied_of(params)
    assert "mid" not in params  # tap at scale 1 < depth: encoder-side concat
    y = _probs(jax.random.PRNGKey(1), (2, 16, 24, 5))
    h = {"pool1": _rand(jax.random.PRNGKey(2), (2, 8, 12, 4))}
    out = mirror_dae_apply(params, y, h, depth=3)
    assert out.shape == y.shape
    np.testing.assert_allclose(np.asarray(out.sum(-1)), 1.0, atol=1e-5)


def test_bottleneck_tap_gets_mid_conv():
    k = jax.random.PRNGKey(0)
    params = init_mirror_dae(
        k, n_classes=5, h_specs={"pool2": 6}, depth=2, widths=(8, 12)
    )
    assert "mid" in params
    assert params["mid"]["w"].shape == (3, 3, 12 + 6, 12)
    y = _probs(jax.random.PRNGKey(1), (2, 16, 24, 5))
    h = {"pool2": _rand(jax.random.PRNGKey(2), (2, 4, 6, 6))}
    out = mirror_dae_apply(params, y, h, depth=2)
    assert out.shape == y.shape


def test_tap_too_deep_rejected():
    with pytest.raises(ValueError, match="scale"):
        init_mirror_dae(
            jax.random.PRNGKey(0), n_classes=5, h_specs={"pool4": 6}, depth=2,
            widths=(8, 12),
        )


def test_tied_structure_and_sensitivity():
    k = jax.random.PRNGKey(0)
    tied = init_mirror_dae(k, n_classes=4, h_specs={}, depth=2, widths=(6, 8), tied=True)
    untied = init_mirror_dae(k, n_classes=4, h_specs={}, depth=2, widths=(6, 8))
    assert mirror_tied_of(tied) and not mirror_tied_of(untied)
    assert set(tied["dec1"]) == {"b"} and set(untied["dec1"]) == {"w", "b"}

    y = _probs(jax.random.PRNGKey(1), (1, 12, 12, 4))
    out0 = mirror_dae_apply(tied, y, {}, depth=2)
    # perturbing an ENCODER kernel must move the decoder's output through the
    # tied path even where the encoder activations are saturated
    bumped = jax.tree.map(lambda x: x, tied)
    bumped["enc1"] = dict(bumped["enc1"], w=tied["enc1"]["w"] + 0.05)
    out1 = mirror_dae_apply(bumped, y, {}, depth=2)
    assert not np.allclose(np.asarray(out0), np.asarray(out1))
    # and gradients flow to encoder kernels through both paths
    g = jax.grad(
        lambda p: jnp.sum(mirror_dae_apply(p, y, {}, depth=2)[..., 0])
    )(tied)
    assert float(jnp.abs(g["enc1"]["w"]).sum()) > 0.0


def test_adjoint_kernel_is_the_conv_transpose():
    k = jax.random.PRNGKey(3)
    w = _rand(k, (3, 3, 5, 7))
    x = _rand(jax.random.PRNGKey(4), (2, 9, 11, 5))
    g = _rand(jax.random.PRNGKey(5), (2, 9, 11, 7))
    _, vjp = jax.vjp(lambda t: conv2d(t, w, padding="SAME"), x)
    want = vjp(g)[0]
    got = conv2d(g, adjoint_kernel(w), padding="SAME")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_max_unpool_places_values_at_argmax():
    pre = jnp.asarray(
        [[1.0, 5.0, 2.0, 0.0],
         [3.0, 4.0, 0.0, 7.0],
         [9.0, 0.0, 1.0, 1.0],
         [0.0, 8.0, 2.0, 3.0]]
    )[None, :, :, None]
    pooled = max_pool(pre, window=2, stride=2, ceil_mode=True)
    g = jnp.asarray([[10.0, 20.0], [30.0, 40.0]])[None, :, :, None]
    up = np.asarray(max_unpool(g, pre))[0, :, :, 0]
    want = np.zeros((4, 4), np.float32)
    want[0, 1] = 10.0   # argmax of tl window (5)
    want[1, 3] = 20.0   # 7
    want[2, 0] = 30.0   # 9
    want[3, 3] = 40.0   # 3 (bottom-right window [[1,1],[2,3]])
    np.testing.assert_array_equal(up, want)
    np.testing.assert_allclose(np.asarray(pooled)[0, :, :, 0],
                               [[5.0, 7.0], [9.0, 3.0]])


def test_max_unpool_ceil_mode_odd_input():
    pre = _rand(jax.random.PRNGKey(0), (1, 5, 7, 3))
    pooled = max_pool(pre, window=2, stride=2, ceil_mode=True)
    up = max_unpool(pooled, pre)
    assert up.shape == pre.shape
    # every pooled value lands exactly once: total mass preserved
    np.testing.assert_allclose(
        float(jnp.sum(up)), float(jnp.sum(pooled)), rtol=1e-5
    )


def _to_positional(params, depth, tied):
    """Export a mirror pytree to the assumed Lasagne positional order
    (OIHW kernels) — the synthetic 'reference checkpoint' for the
    roundtrip test."""
    arrays = []

    def add(entry, with_w):
        if with_w:
            arrays.append(np.transpose(np.asarray(entry["w"]), (3, 2, 0, 1)))
        arrays.append(np.asarray(entry["b"]))

    for i in range(depth):
        add(params[f"enc{i + 1}"], True)
    if "mid" in params:
        add(params["mid"], True)
    for i in reversed(range(depth)):
        add(params[f"dec{i + 1}"], not tied)
    add(params["out"], True)
    return arrays


@pytest.mark.parametrize("tied", [False, True])
def test_positional_import_roundtrip(tmp_path, tied):
    from iterative_inference_segm.utils.import_weights import import_mirror_dae_npz

    src = init_mirror_dae(
        jax.random.PRNGKey(7), n_classes=5, h_specs={"pool2": 6}, depth=2,
        widths=(8, 12), tied=tied,
    )
    path = tmp_path / "dae_ref.npz"
    np.savez(path, *_to_positional(src, 2, tied))

    template = init_mirror_dae(
        jax.random.PRNGKey(99), n_classes=5, h_specs={"pool2": 6}, depth=2,
        widths=(8, 12), tied=tied,
    )
    got = import_mirror_dae_npz(path, template)
    for name, entry in src.items():
        for k, v in entry.items():
            np.testing.assert_array_equal(
                np.asarray(got[name][k]), np.asarray(v), err_msg=f"{name}/{k}"
            )
    # forwards agree bit-for-bit
    y = _probs(jax.random.PRNGKey(1), (2, 12, 16, 5))
    h = {"pool2": _rand(jax.random.PRNGKey(2), (2, 3, 4, 6))}
    np.testing.assert_array_equal(
        np.asarray(mirror_dae_apply(src, y, h, depth=2)),
        np.asarray(mirror_dae_apply(got, y, h, depth=2)),
    )


def test_positional_import_rejects_wrong_order(tmp_path):
    from iterative_inference_segm.utils.import_weights import import_mirror_dae_npz

    src = init_mirror_dae(
        jax.random.PRNGKey(7), n_classes=5, h_specs={}, depth=2, widths=(8, 12)
    )
    arrays = _to_positional(src, 2, False)
    arrays[0], arrays[2] = arrays[2], arrays[0]  # swap enc1.W with enc2.W
    path = tmp_path / "bad.npz"
    np.savez(path, *arrays)
    with pytest.raises(ValueError, match="expected"):
        import_mirror_dae_npz(path, src)


@pytest.mark.parametrize("mode", ["score", "energy"])
def test_refinement_runs_through_mirror(mode):
    from iterative_inference_segm.inference.iterative import refinement_scan

    params = init_mirror_dae(
        jax.random.PRNGKey(0), n_classes=5, h_specs={"pool1": 4}, depth=2,
        widths=(6, 8),
    )
    y0 = _probs(jax.random.PRNGKey(1), (2, 12, 16, 5))
    h = {"pool1": _rand(jax.random.PRNGKey(2), (2, 6, 8, 4))}
    dae_fn = lambda y: mirror_dae_apply(params, y, h, depth=2)
    yk = refinement_scan(dae_fn, y0, eps=0.1, num_steps=3, mode=mode)
    assert yk.shape == y0.shape
    assert bool(jnp.all(jnp.isfinite(yk)))
    assert not np.allclose(np.asarray(yk), np.asarray(y0))


def test_train_mirror_smoke(tmp_path):
    import dataclasses

    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.data.synthetic import synthetic_batches
    from iterative_inference_segm.models import init_fcn8
    from iterative_inference_segm.train import TrainConfig, train_dae
    from iterative_inference_segm.utils.checkpoint import read_npz_meta

    cfg = dataclasses.replace(CAMVID, train_crop=(32, 32))
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=cfg.n_classes, fc_channels=32)
    data = list(synthetic_batches(cfg=cfg, batch_size=2, num_batches=2,
                                  height=48, width=64, seed=0))
    res = train_dae(
        fcn_params=fcn, dataset=cfg, train_data=data, val_data=data,
        tcfg=TrainConfig(max_epochs=1, batch_size=2, seed=0),
        h_taps=("pool3",), sigma=0.5, from_gt=True,
        dae_depth=3, dae_widths=(8, 12, 16), dae_tied=True, arch="mirror",
        workdir=str(tmp_path), augment=False,
    )
    assert np.isfinite(res["history"][0]["train_loss"])
    meta = read_npz_meta(tmp_path / "best_dae.npz")
    assert meta["arch"] == "mirror"
    assert meta["tied"] is True
    assert meta["depth"] == 3
