"""Convolution / pooling / upsampling primitives, NHWC.

Design notes
------------
* Layout is **NHWC** throughout (channels-last, the layout cuDNN's tensor
  core convolutions prefer). The reference is NCHW (Theano), but layout is
  an implementation detail, not an API contract.
* ``conv2d`` wraps ``lax.conv_general_dilated``; XLA hands dense convs to
  cuDNN or its own generated kernels.
* ``conv_transpose2d`` is defined as an **input-dilated convolution**
  (lhs_dilation) — this is mathematically the
  transpose of a strided conv and exactly what the reference's Lasagne
  ``Deconv2DLayer`` computes. ``[ref: models/fcn8.py]`` uses k=4,s=2 and
  k=16,s=8 deconvs with bilinear initialization.
* ``max_pool`` supports ceil-mode window counting (Theano's
  ``ignore_border=False``), which the reference relies on so that e.g.
  360/2^4 -> 23 rather than 22; skip fusion shapes depend on it.
* ``crop_to`` reproduces the Caffe/Lasagne center-crop used to align skip
  connections (``[ref: layers/mylayers.py]`` CropLayer).

All functions are pure and jittable. bf16 convolutions accumulate in f32
inside the library kernels and round only the output; no explicit
preferred_element_type is requested, because that would break the conv
VJP's dtype matching under jax.grad.
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# NHWC activations, HWIO weights.
_DIMSPEC = ("NHWC", "HWIO", "NHWC")


def _precision_for(dtype):
    """f32 inputs contract at HIGHEST precision (default precision may round
    operands to TF32 on the GPU — unacceptable on the parity-critical
    refinement path); bf16 inputs use default (they are already bf16 and
    accumulate in f32)."""
    return lax.Precision.HIGHEST if dtype == jnp.float32 else None


def conv2d(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    stride: int | tuple[int, int] = 1,
    padding: str | Sequence[tuple[int, int]] = "SAME",
    dilation: int | tuple[int, int] = 1,
) -> jax.Array:
    """2-D convolution (cross-correlation), NHWC x HWIO -> NHWC.

    Equivalent of Lasagne ``Conv2DLayer(pad='same')`` in the reference models
    when called with the default ``padding='SAME'``.
    """
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(dilation, int):
        dilation = (dilation, dilation)
    # NOTE: no preferred_element_type here — requesting an f32 output from
    # bf16 inputs breaks the conv VJP's dtype matching (cotangent f32 vs
    # weights bf16) under jax.grad.
    out = lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        window_strides=stride,
        padding=padding,
        rhs_dilation=dilation,
        dimension_numbers=_DIMSPEC,
        precision=_precision_for(x.dtype),
    )
    if b is not None:
        out = out + b.astype(out.dtype)
    return out.astype(x.dtype)


def conv_transpose2d(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    stride: int = 2,
) -> jax.Array:
    """Transposed convolution with output size exactly ``stride * input``.

    Implemented as an input-dilated (fractionally-strided) convolution:
    lhs_dilation=stride with symmetric padding chosen so that
    ``out = stride * in``.  This is numerically the adjoint of a
    strided conv, i.e. what Theano/Lasagne's ``Deconv2DLayer`` computes in the
    reference's upsampling path ``[ref: models/fcn8.py]`` (upscore2 /
    upscore_pool4 / upscore8) and DAE decoder ``[ref: models/DAE_h.py]``.

    w: (kh, kw, cin, cout) operating on x: (B, H, W, cin).
    For a kernel k and stride s the total padding is ``k + s - 2``; we split
    it symmetrically (Caffe-style center alignment; any residual offset is
    absorbed by the crop layers that follow every deconv in FCN-8).

    For the k == 2*stride kernels (every deconv in FCN-8 and the DAE) this
    dispatches to the phase-major formulation ``conv_transpose2d_phase``,
    which computes the same values without convolving a mostly-zero
    dilated tensor; the input-dilated path below is the reference semantics
    both are tested against.
    """
    if int(w.shape[0]) == 2 * stride and int(w.shape[1]) == 2 * stride:
        return conv_transpose2d_phase(x, w, b, stride=stride)
    return _conv_transpose2d_dilated(x, w, b, stride=stride)


def _conv_transpose2d_dilated(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    stride: int = 2,
) -> jax.Array:
    """Input-dilated (lhs_dilation) transposed conv — the reference path."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    pad_h = kh + stride - 2
    pad_w = kw + stride - 2
    padding = (
        (pad_h - pad_h // 2, pad_h // 2),
        (pad_w - pad_w // 2, pad_w // 2),
    )
    out = lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        window_strides=(1, 1),
        padding=padding,
        lhs_dilation=(stride, stride),
        dimension_numbers=_DIMSPEC,
        precision=_precision_for(x.dtype),
    )
    if b is not None:
        out = out + b.astype(out.dtype)
    return out.astype(x.dtype)


def conv_transpose2d_phase(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    stride: int = 2,
) -> jax.Array:
    """``conv_transpose2d`` reformulated as a phase-major conv.

    For the k = 2*stride kernels used throughout (4/2 FCN skip upsamplers,
    16/8 upscore8, DAE decoder), the input-dilated formulation makes XLA
    convolve a mostly-zero dilated tensor at OUTPUT resolution with tiny
    channel counts. Equivalent algebra: every output
    pixel (s*i+a, s*j+b) reads a fixed 2x2 window of the low-res input with
    phase-dependent kernel taps, so the whole deconv is ONE 3x3 conv at
    INPUT resolution with s*s*C_out output channels followed by a
    phase-interleave reshape. Bit-equivalent to
    ``conv_transpose2d`` (same padding convention); tested against it.
    """
    kh, kw_ = int(w.shape[0]), int(w.shape[1])
    if kh != 2 * stride or kw_ != 2 * stride:
        # general case: fall back to the input-dilated formulation
        return _conv_transpose2d_dilated(x, w, b, stride=stride)
    cin, cout = int(w.shape[2]), int(w.shape[3])
    s = stride
    pad_total = kh + s - 2
    pad_lo = pad_total - pad_total // 2

    # Build the phase-major 3x3 kernel once per weight value (jit caches it
    # as part of the traced graph; it is a cheap scatter of w's taps).
    w3 = jnp.zeros((3, 3, cin, s * s * cout), dtype=w.dtype)
    for a in range(s):
        kh0 = (pad_lo - a) % s
        for t in range(2):
            k_h = kh0 + t * s
            if not (0 <= k_h < kh):
                continue
            slot_h = (a + k_h - pad_lo) // s + 1
            for b_ in range(s):
                kw0 = (pad_lo - b_) % s
                for u in range(2):
                    k_w = kw0 + u * s
                    if not (0 <= k_w < kw_):
                        continue
                    slot_w = (b_ + k_w - pad_lo) // s + 1
                    phase = a * s + b_
                    w3 = w3.at[
                        slot_h, slot_w, :, phase * cout : (phase + 1) * cout
                    ].add(w[k_h, k_w])

    bsz, h, wd, _ = x.shape
    out = lax.conv_general_dilated(
        x,
        w3.astype(x.dtype),
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=_DIMSPEC,
        precision=_precision_for(x.dtype),
    ).astype(x.dtype)
    out = out.reshape(bsz, h, wd, s, s, cout)
    out = out.transpose(0, 1, 3, 2, 4, 5).reshape(bsz, h * s, wd * s, cout)
    if b is not None:
        out = out + b.astype(out.dtype)
    return out


def conv2d_depthwise(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    padding: str | Sequence[tuple[int, int]] = "SAME",
) -> jax.Array:
    """Depthwise 2-D convolution: w is (kh, kw, C) applied per channel.

    Used by the separable refinement tail (see models/dae.py 'sep' tail):
    spatial filtering stays per-channel so the full-res work stays cheap;
    channel mixing happens once in a following 1x1. Lowered via
    ``feature_group_count`` so XLA differentiates it for training; the
    phase-major engine re-expresses the same math as shift-and-add slab
    arithmetic (inference/fused.py).
    """
    c = x.shape[-1]
    if w.ndim != 3 or int(w.shape[2]) != c:
        raise ValueError(f"depthwise weight (kh,kw,C) expected, got {w.shape} for C={c}")
    out = lax.conv_general_dilated(
        x,
        w[:, :, None, :].astype(x.dtype),  # (kh, kw, 1, C): one filter per group
        window_strides=(1, 1),
        padding=padding,
        dimension_numbers=_DIMSPEC,
        feature_group_count=c,
        precision=_precision_for(x.dtype),
    )
    if b is not None:
        out = out + b.astype(out.dtype)
    return out.astype(x.dtype)


def conv_transpose2d_depthwise(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    stride: int = 2,
) -> jax.Array:
    """Depthwise transposed conv: w (kh, kw, C), out = stride * in spatially.

    Same padding convention as ``conv_transpose2d`` (k + s - 2 split
    symmetrically), restricted to one filter per channel — the separable
    tail's upsampler (bilinear interpolation is depthwise by nature, so this
    loses nothing at init and learns per-channel taps).
    """
    c = x.shape[-1]
    if w.ndim != 3 or int(w.shape[2]) != c:
        raise ValueError(f"depthwise weight (kh,kw,C) expected, got {w.shape} for C={c}")
    kh, kw = int(w.shape[0]), int(w.shape[1])
    pad_h = kh + stride - 2
    pad_w = kw + stride - 2
    padding = (
        (pad_h - pad_h // 2, pad_h // 2),
        (pad_w - pad_w // 2, pad_w // 2),
    )
    out = lax.conv_general_dilated(
        x,
        w[:, :, None, :].astype(x.dtype),
        window_strides=(1, 1),
        padding=padding,
        lhs_dilation=(stride, stride),
        dimension_numbers=_DIMSPEC,
        feature_group_count=c,
        precision=_precision_for(x.dtype),
    )
    if b is not None:
        out = out + b.astype(out.dtype)
    return out.astype(x.dtype)


def max_pool(
    x: jax.Array,
    *,
    window: int = 2,
    stride: int = 2,
    ceil_mode: bool = True,
) -> jax.Array:
    """Max pooling over H, W with optional ceil-mode output size.

    ``ceil_mode=True`` reproduces Theano pooling with ``ignore_border=False``
    (the reference's encoders depend on it: 360 -> 180 -> 90 -> 45 -> 23 -> 12).
    Ceil mode pads the bottom/right with -inf so partial windows count.
    """
    b, h, wd, c = x.shape
    if ceil_mode:
        out_h = -(-max(h - window, 0) // stride) + 1
        out_w = -(-max(wd - window, 0) // stride) + 1
        need_h = (out_h - 1) * stride + window - h
        need_w = (out_w - 1) * stride + window - wd
        if need_h > 0 or need_w > 0:
            neg = jnp.finfo(x.dtype).min if jnp.issubdtype(x.dtype, jnp.floating) else jnp.iinfo(x.dtype).min
            x = jnp.pad(
                x,
                ((0, 0), (0, max(need_h, 0)), (0, max(need_w, 0)), (0, 0)),
                constant_values=neg,
            )
    # NOTE: the init value must be a Python scalar literal — JAX pattern-
    # matches (reduce_window, max, -inf literal) to attach the select-based
    # VJP; a traced init breaks reverse-mode autodiff through the pool.
    init = -float("inf") if jnp.issubdtype(x.dtype, jnp.floating) else int(jnp.iinfo(x.dtype).min)
    return lax.reduce_window(
        x,
        init,
        lax.max,
        window_dimensions=(1, window, window, 1),
        window_strides=(1, stride, stride, 1),
        padding="VALID",
    )


def avg_pool(x: jax.Array, *, window: int = 2, stride: int = 2) -> jax.Array:
    """Average pooling (VALID), used by DAE variants.

    For small channel counts (the class-map stem pools) this runs as a
    window x window stride-s convolution with an identity-expanded kernel,
    accumulated in f32 (the 1/w^2 scale is a power of two, so products are
    exact in bf16 — hence the power-of-two window gate below; a window=3
    pool would scale by 1/9, inexact in bf16, and must keep reduce_window).
    Wide maps keep the reduce_window path — a CxC eye kernel would do C
    times the work per output.
    """
    c = int(x.shape[-1])
    pow2_window = window > 0 and (window & (window - 1)) == 0
    if jnp.issubdtype(x.dtype, jnp.floating) and c <= 64 and pow2_window:
        eye = jnp.eye(c, dtype=x.dtype) / (window * window)
        w = jnp.broadcast_to(eye[None, None], (window, window, c, c))
        return conv2d(x, w, stride=stride, padding="VALID")
    summed = lax.reduce_window(
        x,
        0.0,
        lax.add,
        window_dimensions=(1, window, window, 1),
        window_strides=(1, stride, stride, 1),
        padding="VALID",
    )
    return summed / (window * window)


def crop_to(x: jax.Array, target_h: int, target_w: int) -> jax.Array:
    """Center-crop NHWC ``x`` spatially to (target_h, target_w).

    Caffe-style offset crop used to align deconv outputs with skip-connection
    feature maps (``[ref: layers/mylayers.py]`` CropLayer). Offsets are
    ``(size - target) // 2``; shapes are static so this is free under jit.
    """
    _, h, w, _ = x.shape
    if h < target_h or w < target_w:
        raise ValueError(f"crop_to: input {(h, w)} smaller than target {(target_h, target_w)}")
    oh = (h - target_h) // 2
    ow = (w - target_w) // 2
    return x[:, oh : oh + target_h, ow : ow + target_w, :]


def upsample_pool_indices(x: jax.Array, *, factor: int = 2) -> jax.Array:
    """Nearest-neighbour unpooling (repeat) — the DAE decoder's inverse-pool.

    The reference's unpooling utilities live in ``[ref: layers/mylayers.py]``;
    a repeat-based unpool keeps shapes static and fuses into the
    surrounding convs, which is why we do not carry argmax switches.
    """
    x = jnp.repeat(x, factor, axis=1)
    return jnp.repeat(x, factor, axis=2)


def max_unpool(g: jax.Array, pre: jax.Array, *, window: int = 2, stride: int = 2) -> jax.Array:
    """Switch-based max-unpooling: scatter ``g`` to the argmax positions of
    ``pre``'s pooling windows (the SegNet/mirror-DAE inverse of ``max_pool``).

    Formulated as the exact adjoint (VJP) of ``max_pool`` at
    ``pre`` — XLA lowers it to ``select_and_scatter``, the same primitive a
    pooling backward pass uses, so there is no materialized integer switch
    tensor (the reference's unpooling keeps Theano argmax switches;
    ``[ref: layers/mylayers.py]``). Exactly one position per window receives
    each value (select_and_scatter's first-max tie-break). Linear and
    differentiable in ``g``; the switches are constants (``pre`` enters
    through ``stop_gradient``), matching the reference semantics where the
    encoder's pooling pattern is data, not a differentiation path.
    """
    pre = lax.stop_gradient(pre)
    _, vjp = jax.vjp(
        lambda t: max_pool(t, window=window, stride=stride, ceil_mode=True), pre
    )
    (out,) = vjp(g.astype(pre.dtype))
    return out.astype(g.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def bilinear_kernel(k: int, cin: int, cout: int, dtype=jnp.float32) -> jax.Array:
    """Bilinear interpolation kernel of shape (k, k, cin, cout).

    Matches the classic FCN deconv initialization (Long et al.), which the
    reference loads for its upsampling layers ``[ref: models/fcn8.py]``:
    channel i of the input feeds only channel i of the output with a
    separable triangle filter.
    """
    factor = (k + 1) // 2
    if k % 2 == 1:
        center = factor - 1.0
    else:
        center = factor - 0.5
    og = np.ogrid[:k, :k]
    filt = (1.0 - abs(og[0] - center) / factor) * (1.0 - abs(og[1] - center) / factor)
    w = np.zeros((k, k, cin, cout), dtype=np.float32)
    for i in range(min(cin, cout)):
        w[:, :, i, i] = filt
    return jnp.asarray(w, dtype=dtype)


def init_conv(
    key: jax.Array,
    kh: int,
    kw: int,
    cin: int,
    cout: int,
    *,
    dtype=jnp.float32,
    scale: str = "glorot",
) -> dict:
    """He/Glorot-initialized conv params {'w': (kh,kw,cin,cout), 'b': (cout,)}."""
    fan_in = kh * kw * cin
    fan_out = kh * kw * cout
    if scale == "glorot":
        std = math.sqrt(2.0 / (fan_in + fan_out))
    elif scale == "he":
        std = math.sqrt(2.0 / fan_in)
    else:
        raise ValueError(scale)
    w = jax.random.normal(key, (kh, kw, cin, cout), dtype=jnp.float32) * std
    return {"w": w.astype(dtype), "b": jnp.zeros((cout,), dtype=dtype)}


def init_conv_transpose_bilinear(k: int, cin: int, cout: int, *, dtype=jnp.float32) -> dict:
    """Transposed-conv params initialized to bilinear upsampling (no bias)."""
    return {"w": bilinear_kernel(k, cin, cout, dtype=dtype)}


def bilinear_kernel_depthwise(k: int, c: int, dtype=jnp.float32) -> jax.Array:
    """Per-channel bilinear triangle filter, (k, k, C)."""
    full = np.asarray(bilinear_kernel(k, 1, 1, dtype=jnp.float32))[:, :, 0, 0]
    return jnp.asarray(np.repeat(full[:, :, None], c, axis=2), dtype=dtype)


def delta_kernel_depthwise(k: int, c: int, dtype=jnp.float32) -> jax.Array:
    """Per-channel identity (center delta) filter, (k, k, C); odd k."""
    w = np.zeros((k, k, c), np.float32)
    w[k // 2, k // 2, :] = 1.0
    return jnp.asarray(w, dtype=dtype)
