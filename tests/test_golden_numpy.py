"""Golden parity tests: tiny fixed-weight models vs a from-scratch numpy
re-implementation of the layer semantics (SURVEY.md §5 'Parity': with the
reference mount empty, the numpy oracle pins down conv/pool/deconv/crop
semantics so any future weight import can be checked bit-for-bit)."""

import numpy as np
import jax
import jax.numpy as jnp

from iterative_inference_segm.ops.conv import (
    conv2d,
    conv_transpose2d,
    max_pool,
    crop_to,
    bilinear_kernel,
)


# ---------------------------------------------------------------------------
# numpy oracle layers (naive, obviously-correct implementations)
# ---------------------------------------------------------------------------


def np_conv2d_same(x, w, b=None):
    B, H, W, Ci = x.shape
    kh, kw, _, Co = w.shape
    ph, pw = kh // 2, kw // 2
    xp = np.pad(x, ((0, 0), (ph, kh - 1 - ph), (pw, kw - 1 - pw), (0, 0)))
    out = np.zeros((B, H, W, Co), np.float64)
    for i in range(kh):
        for j in range(kw):
            out += np.einsum("bhwc,co->bhwo", xp[:, i : i + H, j : j + W, :], w[i, j])
    if b is not None:
        out += b
    return out


def np_max_pool_ceil(x):
    B, H, W, C = x.shape
    Ho, Wo = -(-H // 2), -(-W // 2)
    xp = np.full((B, Ho * 2, Wo * 2, C), -np.inf)
    xp[:, :H, :W, :] = x
    return xp.reshape(B, Ho, 2, Wo, 2, C).max(axis=(2, 4))


def np_conv_transpose(x, w, stride):
    """Input-dilated conv with total padding k+s-2 split (hi, lo) = the exact
    semantics of ops.conv.conv_transpose2d."""
    B, H, W, Ci = x.shape
    kh, kw, _, Co = w.shape
    dil_h, dil_w = (H - 1) * stride + 1, (W - 1) * stride + 1
    xd = np.zeros((B, dil_h, dil_w, Ci))
    xd[:, ::stride, ::stride, :] = x
    pad_h, pad_w = kh + stride - 2, kw + stride - 2
    plo_h, phi_h = pad_h - pad_h // 2, pad_h // 2
    plo_w, phi_w = pad_w - pad_w // 2, pad_w // 2
    xp = np.pad(xd, ((0, 0), (plo_h, phi_h), (plo_w, phi_w), (0, 0)))
    Ho, Wo = H * stride, W * stride
    out = np.zeros((B, Ho, Wo, Co), np.float64)
    for i in range(kh):
        for j in range(kw):
            out += np.einsum("bhwc,co->bhwo", xp[:, i : i + Ho, j : j + Wo, :], w[i, j])
    return out


def np_crop_center(x, th, tw):
    _, H, W, _ = x.shape
    oh, ow = (H - th) // 2, (W - tw) // 2
    return x[:, oh : oh + th, ow : ow + tw, :]


def np_softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# ---------------------------------------------------------------------------
# layer-level goldens
# ---------------------------------------------------------------------------


def test_conv2d_same_even_kernel_alignment():
    # 'SAME' with even kernels has an asymmetric-pad convention; pin it.
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 6, 6, 2)).astype(np.float32)
    w = rng.normal(size=(3, 3, 2, 3)).astype(np.float32)
    got = np.asarray(conv2d(jnp.asarray(x), jnp.asarray(w), padding="SAME"))
    np.testing.assert_allclose(got, np_conv2d_same(x, w), rtol=1e-4, atol=1e-5)


def test_max_pool_odd_sizes_golden():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    got = np.asarray(max_pool(jnp.asarray(x)))
    np.testing.assert_allclose(got, np_max_pool_ceil(x), rtol=1e-6)


def test_conv_transpose_golden_s2_and_s8():
    rng = np.random.default_rng(2)
    for stride, k in [(2, 4), (8, 16)]:
        x = rng.normal(size=(1, 5, 6, 3)).astype(np.float32)
        w = rng.normal(size=(k, k, 3, 2)).astype(np.float32) * 0.1
        got = np.asarray(conv_transpose2d(jnp.asarray(x), jnp.asarray(w), stride=stride))
        ref = np_conv_transpose(x, w, stride)
        assert got.shape == ref.shape == (1, 5 * stride, 6 * stride, 2)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# end-to-end golden: a miniature FCN-8 with fixed weights, numpy vs jax
# ---------------------------------------------------------------------------


def _mini_fcn8_numpy(params, x, n_classes):
    """The full FCN-8 dataflow (conv/pool encoder, fc convs, score fusions,
    x2/x2/x8 deconvs, crops, softmax) in numpy."""
    g = lambda n: {k: np.asarray(v, np.float64) for k, v in params[n].items()}
    h = x
    feats = {}
    pool = 0
    stages = [
        ("conv1_1",), ("conv1_2",), "P",
        ("conv2_1",), ("conv2_2",), "P",
        ("conv3_1",), ("conv3_2",), ("conv3_3",), "P",
        ("conv4_1",), ("conv4_2",), ("conv4_3",), "P",
        ("conv5_1",), ("conv5_2",), ("conv5_3",), "P",
    ]
    for st in stages:
        if st == "P":
            pool += 1
            h = np_max_pool_ceil(h)
            feats[f"pool{pool}"] = h
        else:
            p = g(st[0])
            h = np.maximum(np_conv2d_same(h, p["w"], p["b"]), 0.0)
    p = g("fc6")
    h = np.maximum(np_conv2d_same(h, p["w"], p["b"]), 0.0)
    p = g("fc7")
    h = np.maximum(np_conv2d_same(h, p["w"], p["b"]), 0.0)

    p = g("score_fr")
    score = np_conv2d_same(h, p["w"], p["b"])
    up2 = np_conv_transpose(score, np.asarray(params["upscore2"]["w"], np.float64), 2)
    p = g("score_pool4")
    sp4 = np_conv2d_same(feats["pool4"], p["w"], p["b"])
    up2 = np_crop_center(up2, sp4.shape[1], sp4.shape[2])
    fuse4 = up2 + sp4
    up4 = np_conv_transpose(fuse4, np.asarray(params["upscore_pool4"]["w"], np.float64), 2)
    p = g("score_pool3")
    sp3 = np_conv2d_same(feats["pool3"], p["w"], p["b"])
    up4 = np_crop_center(up4, sp3.shape[1], sp3.shape[2])
    fuse3 = up4 + sp3
    up8 = np_conv_transpose(fuse3, np.asarray(params["upscore8"]["w"], np.float64), 8)
    logits = np_crop_center(up8, x.shape[1], x.shape[2])
    return np_softmax(logits)


def test_fcn8_forward_matches_numpy_golden():
    from iterative_inference_segm.models import init_fcn8, fcn8_apply

    n_classes = 3
    params = init_fcn8(jax.random.PRNGKey(42), n_classes=n_classes, fc_channels=8)
    x = np.random.default_rng(7).normal(size=(1, 48, 64, 3)).astype(np.float32)
    got, _ = fcn8_apply(params, jnp.asarray(x))
    ref = _mini_fcn8_numpy(jax.device_get(params), x.astype(np.float64), n_classes)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=5e-3, atol=1e-4)
    # argmax parity must be essentially exact
    agree = (np.asarray(got).argmax(-1) == ref.argmax(-1)).mean()
    assert agree > 0.999


def test_refinement_update_golden_with_real_dae():
    """One score step with the real (tiny) DAE: y1 = y0 - eps*(y0 - r(y0)).
    Pins that refinement_scan applies exactly this update."""
    from iterative_inference_segm.models import init_dae, dae_apply
    from iterative_inference_segm.inference import refinement_scan

    n_classes = 3
    dae = init_dae(jax.random.PRNGKey(0), n_classes=n_classes, h_specs={})
    y0 = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(1), (1, 16, 16, n_classes)), -1)
    r = dae_apply(dae, y0, {})
    expected = np.asarray(y0) - 0.2 * (np.asarray(y0) - np.asarray(r))
    got = refinement_scan(lambda y: dae_apply(dae, y, {}), y0, eps=0.2, num_steps=1)
    np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-5, atol=1e-6)
