"""Unit tests for core ops vs numpy oracles (SURVEY.md §5 test strategy)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iterative_inference_segm.ops import (
    conv2d,
    conv_transpose2d,
    max_pool,
    crop_to,
    bilinear_kernel,
)
from iterative_inference_segm.ops.conv import upsample_pool_indices, avg_pool


def test_conv2d_matches_numpy_valid_1x1():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    w = rng.normal(size=(1, 1, 3, 4)).astype(np.float32)
    out = conv2d(jnp.asarray(x), jnp.asarray(w), padding="SAME")
    ref = np.einsum("bhwc,co->bhwo", x, w[0, 0])
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-5)


def test_conv2d_same_padding_shape():
    x = jnp.zeros((1, 9, 11, 2))
    w = jnp.zeros((3, 3, 2, 5))
    assert conv2d(x, w, padding="SAME").shape == (1, 9, 11, 5)


def test_conv2d_3x3_oracle():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 6, 6, 2)).astype(np.float32)
    w = rng.normal(size=(3, 3, 2, 3)).astype(np.float32)
    out = np.asarray(conv2d(jnp.asarray(x), jnp.asarray(w), padding="SAME"))
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = np.zeros((1, 6, 6, 3), np.float32)
    for i in range(6):
        for j in range(6):
            patch = xp[0, i : i + 3, j : j + 3, :]
            ref[0, i, j] = np.tensordot(patch, w, axes=([0, 1, 2], [0, 1, 2]))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_max_pool_ceil_mode_sizes():
    # The FCN-8 encoder chain on CamVid: 360 -> 180 -> 90 -> 45 -> 23 -> 12.
    h = 360
    x = jnp.zeros((1, h, 480, 1))
    sizes = []
    for _ in range(5):
        x = max_pool(x, window=2, stride=2, ceil_mode=True)
        sizes.append((x.shape[1], x.shape[2]))
    assert sizes == [(180, 240), (90, 120), (45, 60), (23, 30), (12, 15)]


def test_max_pool_values():
    x = jnp.asarray(np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1))
    out = max_pool(x, window=2, stride=2)
    expected = np.array([[5, 7], [13, 15]], dtype=np.float32).reshape(1, 2, 2, 1)
    np.testing.assert_array_equal(np.asarray(out), expected)


def test_max_pool_ceil_pads_with_neg_inf_not_zero():
    x = jnp.full((1, 3, 3, 1), -5.0)
    out = max_pool(x, window=2, stride=2, ceil_mode=True)
    assert out.shape == (1, 2, 2, 1)
    np.testing.assert_array_equal(np.asarray(out), np.full((1, 2, 2, 1), -5.0))


def test_conv_transpose_doubles_size():
    x = jnp.zeros((1, 23, 30, 11))
    w = bilinear_kernel(4, 11, 11)
    out = conv_transpose2d(x, w, stride=2)
    assert out.shape == (1, 46, 60, 11)


def test_conv_transpose_x8():
    x = jnp.zeros((2, 45, 60, 11))
    w = bilinear_kernel(16, 11, 11)
    out = conv_transpose2d(x, w, stride=8)
    assert out.shape == (2, 360, 480, 11)


def test_bilinear_upsample_interpolates_constant():
    # A constant map must stay (approximately) constant in the interior
    # under bilinear upsampling.
    x = jnp.ones((1, 8, 8, 3))
    w = bilinear_kernel(4, 3, 3)
    out = np.asarray(conv_transpose2d(x, w, stride=2))
    interior = out[0, 2:-2, 2:-2, :]
    np.testing.assert_allclose(interior, 1.0, rtol=1e-5)


def test_bilinear_upsample_linear_ramp():
    # Bilinear upsampling of a linear ramp stays linear in the interior.
    ramp = np.arange(8, dtype=np.float32)
    x = jnp.asarray(np.tile(ramp[None, :, None, None], (1, 1, 8, 1)))
    w = bilinear_kernel(4, 1, 1)
    out = np.asarray(conv_transpose2d(x, w, stride=2))[0, :, 4, 0]
    d = np.diff(out[3:-3])
    np.testing.assert_allclose(d, d[0], atol=1e-5)


def test_crop_to_center():
    x = jnp.asarray(np.arange(36, dtype=np.float32).reshape(1, 6, 6, 1))
    out = crop_to(x, 4, 4)
    assert out.shape == (1, 4, 4, 1)
    assert float(out[0, 0, 0, 0]) == 7.0  # offset (1,1)


def test_crop_to_rejects_growth():
    with pytest.raises(ValueError):
        crop_to(jnp.zeros((1, 4, 4, 1)), 6, 6)


def test_unpool_repeat():
    x = jnp.asarray(np.array([[1.0, 2.0], [3.0, 4.0]]).reshape(1, 2, 2, 1))
    out = np.asarray(upsample_pool_indices(x, factor=2))
    assert out.shape == (1, 4, 4, 1)
    np.testing.assert_array_equal(out[0, :2, :2, 0], [[1, 1], [1, 1]])
    np.testing.assert_array_equal(out[0, 2:, 2:, 0], [[4, 4], [4, 4]])


def test_avg_pool():
    x = jnp.asarray(np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1))
    out = np.asarray(avg_pool(x, window=2, stride=2))
    np.testing.assert_allclose(out[0, :, :, 0], [[2.5, 4.5], [10.5, 12.5]])


def test_avg_pool_conv_path_matches_reduce_window():
    # The small-C fast path (identity-kernel conv) must agree with the
    # reduce_window formulation that wide maps still use. C=11 takes the conv
    # path; C=128 takes reduce_window; compare both against numpy.
    rng = np.random.default_rng(0)
    for c in (11, 128):
        x = rng.standard_normal((2, 6, 8, c)).astype(np.float32)
        out = np.asarray(avg_pool(jnp.asarray(x), window=2, stride=2))
        ref = 0.25 * (x[:, 0::2, 0::2] + x[:, 1::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 1::2])
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_avg_pool_conv_path_differentiable():
    # the DAE stem pools through avg_pool during training — grads must flow
    x = jnp.asarray(np.random.default_rng(1).standard_normal((1, 4, 4, 3)), jnp.float32)
    g = jax.grad(lambda x: jnp.sum(avg_pool(x, window=2, stride=2) ** 2))(x)
    assert g.shape == x.shape
    assert bool(jnp.any(g != 0))


def test_conv2d_dilation_shape():
    x = jnp.zeros((1, 16, 16, 4))
    w = jnp.zeros((3, 3, 4, 4))
    out = conv2d(x, w, padding="SAME", dilation=4)
    assert out.shape == (1, 16, 16, 4)


def test_conv2d_bf16_accumulates_f32():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 8, 8, 64)).astype(np.float32)
    w = rng.normal(size=(3, 3, 64, 32)).astype(np.float32)
    out32 = np.asarray(conv2d(jnp.asarray(x), jnp.asarray(w), padding="SAME"))
    outbf = np.asarray(
        conv2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), padding="SAME")
    ).astype(np.float32)
    # bf16 inputs, f32 accumulation: mean relative error stays ~1e-2 (the
    # max can spike where the 576-term reduction cancels to near zero).
    rel = np.abs(outbf - out32) / (np.abs(out32) + 1.0)
    assert rel.mean() < 1e-2


def test_conv_transpose_phase_matches_dilated():
    # the phase-major (space-to-depth) formulation must be numerically
    # identical to the input-dilated reference semantics, fwd and grads
    from iterative_inference_segm.ops.conv import (
        _conv_transpose2d_dilated,
        conv_transpose2d_phase,
    )

    rng = np.random.default_rng(5)
    for stride, k in [(2, 4), (8, 16)]:
        x = jnp.asarray(rng.normal(size=(2, 5, 7, 3)).astype(np.float32))
        w = jnp.asarray(rng.normal(size=(k, k, 3, 4)).astype(np.float32))
        a = _conv_transpose2d_dilated(x, w, stride=stride)
        b = jax.jit(lambda xx, ww: conv_transpose2d_phase(xx, ww, stride=stride))(x, w)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)

        # jitted grads: the s=8 phase-kernel builder is 64 scatter .at[].add
        # ops — eager that's hundreds of dispatches per VJP
        ga = jax.jit(jax.grad(lambda xx, ww: jnp.sum(_conv_transpose2d_dilated(xx, ww, stride=stride) ** 2), argnums=(0, 1)))(x, w)
        gb = jax.jit(jax.grad(lambda xx, ww: jnp.sum(conv_transpose2d_phase(xx, ww, stride=stride) ** 2), argnums=(0, 1)))(x, w)
        for u, v in zip(ga, gb):
            np.testing.assert_allclose(np.asarray(u), np.asarray(v), rtol=1e-3, atol=1e-4)


def test_conv_transpose_phase_odd_kernel_falls_back():
    from iterative_inference_segm.ops.conv import conv_transpose2d_phase

    x = jnp.zeros((1, 4, 4, 2))
    w = jnp.zeros((3, 3, 2, 2))  # k != 2*stride
    out = conv_transpose2d_phase(x, w, stride=2)
    assert out.shape == (1, 8, 8, 2)
