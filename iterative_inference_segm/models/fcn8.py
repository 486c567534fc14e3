"""FCN-8: VGG16 fully-convolutional segmenter with skip fusions.

Rebuild of ``[ref: models/fcn8.py]`` (``buildFCN8``): the Long
et al. FCN-8s topology — VGG16 conv stack, fc6/fc7 as convolutions, per-scale
1x1 score layers, two skip fusions (pool4, pool3), and x2/x2/x8 transposed-
conv upsampling initialized to bilinear interpolation, ending in a per-pixel
softmax over ``n_classes``.

Differences from the reference that are deliberate choices:
* NHWC layout, bf16 compute / f32 accumulation option (``compute_dtype``),
* 'SAME' conv padding + ceil-mode pooling + center crops (the Lasagne build
  uses pad='same' convs and Theano ignore_border=False pooling; crops align
  the deconv outputs exactly as the reference's CropLayers do),
* params are a flat dict pytree -> trivially shardable / serializable.

The ``return_features`` mechanism mirrors the reference's ``layer=[...]``
argument, which selects intermediate outputs to expose for DAE conditioning
(``[ref: models/fcn8.py]`` exposes e.g. pool3/pool4/fc7 and 'probs').
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from iterative_inference_segm.ops.conv import (
    conv2d,
    conv_transpose2d,
    crop_to,
    init_conv,
    init_conv_transpose_bilinear,
    max_pool,
)

# VGG16 convolutional topology: (name, kernel, out_channels); 'P' = 2x2 pool.
_VGG = [
    ("conv1_1", 3, 64), ("conv1_2", 3, 64), "P",
    ("conv2_1", 3, 128), ("conv2_2", 3, 128), "P",
    ("conv3_1", 3, 256), ("conv3_2", 3, 256), ("conv3_3", 3, 256), "P",
    ("conv4_1", 3, 512), ("conv4_2", 3, 512), ("conv4_3", 3, 512), "P",
    ("conv5_1", 3, 512), ("conv5_2", 3, 512), ("conv5_3", 3, 512), "P",
]

# Feature taps a caller may request, mirroring the reference's `layer=` names.
FCN8_FEATURES = ("input", "pool1", "pool2", "pool3", "pool4", "pool5", "fc7", "score", "probs")

# Channel width of each tappable feature (n_classes-independent ones only).
FCN8_FEATURE_CHANNELS = {
    "pool1": 64,
    "pool2": 128,
    "pool3": 256,
    "pool4": 512,
    "pool5": 512,
    "fc7": 4096,
}


def init_fcn8(
    key: jax.Array,
    *,
    n_classes: int = 11,
    in_channels: int = 3,
    fc_channels: int = 4096,
    dtype=jnp.float32,
) -> dict:
    """Initialize the FCN-8 param pytree.

    The reference loads Caffe-converted VGG weights from .npz
    (``[ref: models/fcn8.py]`` load_weights); here random init is the default
    and ``utils.checkpoint.load_npz`` can overwrite leaves with pretrained
    values when available.
    """
    params: dict = {}
    keys = iter(jax.random.split(key, 32))
    cin = in_channels
    for item in _VGG:
        if item == "P":
            continue
        name, k, cout = item
        params[name] = init_conv(next(keys), k, k, cin, cout, dtype=dtype, scale="he")
        cin = cout
    params["fc6"] = init_conv(next(keys), 7, 7, 512, fc_channels, dtype=dtype, scale="he")
    params["fc7"] = init_conv(next(keys), 1, 1, fc_channels, fc_channels, dtype=dtype, scale="he")
    params["score_fr"] = init_conv(next(keys), 1, 1, fc_channels, n_classes, dtype=dtype)
    params["score_pool4"] = init_conv(next(keys), 1, 1, 512, n_classes, dtype=dtype)
    params["score_pool3"] = init_conv(next(keys), 1, 1, 256, n_classes, dtype=dtype)
    # Upsampling deconvs, bilinear-initialized (learned afterwards), no bias —
    # exactly the reference's Deconv2DLayer(b=None) configuration.
    params["upscore2"] = init_conv_transpose_bilinear(4, n_classes, n_classes, dtype=dtype)
    params["upscore_pool4"] = init_conv_transpose_bilinear(4, n_classes, n_classes, dtype=dtype)
    params["upscore8"] = init_conv_transpose_bilinear(16, n_classes, n_classes, dtype=dtype)
    return params


def fcn8_apply(
    params: dict,
    x: jax.Array,
    *,
    return_features: Sequence[str] = (),
    dropout_rng: jax.Array | None = None,
    dropout_rate: float = 0.5,
    compute_dtype=jnp.float32,
    probs_dtype=jnp.float32,
) -> tuple[jax.Array, dict]:
    """FCN-8 forward pass.

    x: (B, H, W, in_channels) float image batch, NHWC.
    Returns ``(probs, features)`` where probs is (B, H, W, C) softmax output
    cropped back to the input resolution and ``features`` holds the requested
    taps (always at compute_dtype except 'probs'/'score' which are f32).

    Dropout after fc6/fc7 is applied only when ``dropout_rng`` is given
    (training), matching the reference's DropoutLayer placement.

    ``probs_dtype``: output dtype of the softmax (normalization itself is
    always f32). The throughput pipeline passes bf16 so the full-res
    probability map is written once at the refinement carry's dtype instead
    of materializing f32 and re-casting.

    Factored as ``fcn8_backbone`` (VGG stack through pool5) composed with
    ``fcn8_head`` (fc6..softmax + skip-fusion decoder) — the model's
    natural internal seam, also used as a pipeline-parallel stage boundary
    (parallel/pp.py 3-stage split).
    """
    pools, feats = fcn8_backbone(
        params, x, return_features=return_features, compute_dtype=compute_dtype
    )
    probs, head_feats = fcn8_head(
        params,
        pools,
        (x.shape[1], x.shape[2]),
        return_features=return_features,
        dropout_rng=dropout_rng,
        dropout_rate=dropout_rate,
        probs_dtype=probs_dtype,
    )
    feats.update(head_feats)
    return probs, feats


def fcn8_backbone(
    params: dict,
    x: jax.Array,
    *,
    return_features: Sequence[str] = (),
    compute_dtype=jnp.float32,
) -> tuple[dict, dict]:
    """The VGG16 conv stack through pool5 (the backbone half of
    ``fcn8_apply``). Returns ``(pools, feats)``: ``pools`` always holds the
    'pool3'/'pool4'/'pool5' maps the head's skip fusions need (at
    compute_dtype), ``feats`` the requested backbone taps."""
    feats: dict = {}
    want = set(return_features)
    h = x.astype(compute_dtype)
    if "input" in want:
        feats["input"] = h

    pools: dict = {}
    pool_idx = 0
    for item in _VGG:
        if item == "P":
            pool_idx += 1
            h = max_pool(h, window=2, stride=2, ceil_mode=True)
            name = f"pool{pool_idx}"
            pools[name] = h
            if name in want:
                feats[name] = h
            continue
        name, _, _ = item
        p = params[name]
        h = conv2d(h, p["w"], p["b"], padding="SAME")
        h = jax.nn.relu(h)
    return {k: pools[k] for k in ("pool3", "pool4", "pool5")}, feats


def fcn8_head(
    params: dict,
    pools: dict,
    in_hw: tuple[int, int],
    *,
    return_features: Sequence[str] = (),
    dropout_rng: jax.Array | None = None,
    dropout_rate: float = 0.5,
    probs_dtype=jnp.float32,
) -> tuple[jax.Array, dict]:
    """fc6..softmax + skip-fusion decoder from the backbone's pool maps
    (the head half of ``fcn8_apply``). ``in_hw`` is the input (H, W) the
    decoder output is cropped back to; the compute dtype follows the pool
    maps'. Returns ``(probs, feats)`` with the head taps
    ('fc7'/'score'/'probs')."""
    feats: dict = {}
    want = set(return_features)
    pool3, pool4, h = pools["pool3"], pools["pool4"], pools["pool5"]

    # fc6 / fc7 as convolutions.
    p = params["fc6"]
    h = jax.nn.relu(conv2d(h, p["w"], p["b"], padding="SAME"))
    if dropout_rng is not None:
        k1, k2 = jax.random.split(dropout_rng)
        keep = 1.0 - dropout_rate
        h = h * jax.random.bernoulli(k1, keep, h.shape).astype(h.dtype) / keep
    p = params["fc7"]
    h = jax.nn.relu(conv2d(h, p["w"], p["b"], padding="SAME"))
    if dropout_rng is not None:
        h = h * jax.random.bernoulli(k2, keep, h.shape).astype(h.dtype) / keep
    if "fc7" in want:
        feats["fc7"] = h

    # Score + skip-fusion decoder runs at compute_dtype (f32 accumulation is
    # pinned inside conv2d/conv_transpose2d); logits are emitted in f32. The
    # parity-critical configuration keeps compute_dtype=f32, where convs use
    # HIGHEST precision — see ops.conv._precision_for.
    p = params["score_fr"]
    score = conv2d(h, p["w"], p["b"], padding="SAME")

    up2 = conv_transpose2d(score, params["upscore2"]["w"], stride=2)
    sp4 = conv2d(
        pool4,
        params["score_pool4"]["w"],
        params["score_pool4"]["b"],
        padding="SAME",
    )
    up2 = crop_to(up2, sp4.shape[1], sp4.shape[2])
    fuse4 = up2 + sp4

    up4 = conv_transpose2d(fuse4, params["upscore_pool4"]["w"], stride=2)
    sp3 = conv2d(
        pool3,
        params["score_pool3"]["w"],
        params["score_pool3"]["b"],
        padding="SAME",
    )
    up4 = crop_to(up4, sp3.shape[1], sp3.shape[2])
    fuse3 = up4 + sp3

    up8 = conv_transpose2d(fuse3, params["upscore8"]["w"], stride=8)
    cropped = crop_to(up8, in_hw[0], in_hw[1])
    logits = cropped.astype(jnp.float32)

    if "score" in want:
        feats["score"] = logits
    if probs_dtype == jnp.bfloat16 and "score" not in want:
        # Throughput path: softmax directly on the compute-dtype logits
        # (jax.nn.softmax subtracts the max first, so bf16 stays in range) —
        # skips the f32 materialization of the full-res map. The parity path
        # (f32 probs, or any caller tapping 'score') keeps the f32 softmax.
        probs = jax.nn.softmax(cropped.astype(jnp.bfloat16), axis=-1)
    else:
        probs = jax.nn.softmax(logits, axis=-1).astype(probs_dtype)
    if "probs" in want:
        feats["probs"] = probs
    return probs, feats


def fcn8_logits(params: dict, x: jax.Array, *, dropout_rng=None, compute_dtype=jnp.float32) -> jax.Array:
    """Pre-softmax scores at input resolution (training loss wants logits)."""
    probs, feats = fcn8_apply(
        params,
        x,
        return_features=("score",),
        dropout_rng=dropout_rng,
        compute_dtype=compute_dtype,
    )
    return feats["score"]
