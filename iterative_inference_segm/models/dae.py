"""Conditional denoising autoencoder (DAE) over segmentation probability maps.

Rebuild of ``[ref: models/DAE_h.py]`` (``buildDAE``): the DAE maps
a corrupted class-probability map ``y~`` (noisy one-hot GT, or frozen-FCN
softmax output) back toward the clean ground truth, optionally *conditioned*
on intermediate FCN-8 feature maps ``h`` concatenated at the matching spatial
scale. By Alain & Bengio (2014), ``r(y~, h) - y~`` then estimates the
conditional score ``d log p(y|h) / dy`` — the quantity the iterative
inference loop follows.

Architecture (re-designed, mirroring the reference's encoder/decoder
shape rather than a heavy U-Net):

* **Encoder**: conv3x3 + ReLU + ceil-mode 2x2 max-pool per scale, channel
  widths configurable (default (32, 64, 128, 256)); FCN-8 conditioning taps
  are channel-concatenated at the scale where they live (pool4 -> /16),
  exactly like the reference's ConcatLayer conditioning.
* **Decoder**: FCN-8-style — a 1x1 score projection to ``n_classes`` at the
  bottleneck, then a chain of k=4 s=2 bilinear-initialized transposed convs
  on class-width maps, each fused (add) with a 1x1 score projection of the
  matching encoder feature map. This is the reference's unpool/deconv
  decoder re-expressed the way FCN-8 upsamples: detail is recovered through
  cheap score fusions instead of full-width feature concats, which keeps the
  per-refinement-step cost ~7 GFLOPs at 360x480 instead of ~240 (the
  5-step refinement loop runs the decoder 5x per image — BASELINE.json:5's
  1000 img/s/chip target demands a lean score network).

Ceil-mode pooling matches the FCN-8 encoder exactly, so ``h`` taps align
shape-for-shape at every scale (360x480 -> 23x30 at /16).

On tied weights: the reference's ``buildDAE`` exposes a tied/untied choice
for its mirrored conv/unpool decoder (classic-DAE weight tying,
W_dec = W_enc^T). This rebuild's decoder is deliberately NOT a mirror — it
is an FCN-style score-fusion chain (1x1 projections + class-width deconvs),
so there is no transpose-shaped decoder weight to tie; all weights are
untied/learned, which is also the reference's default.

The whole function is differentiable in ``y`` — the iterative-inference
engine takes ``jax.vjp``/``jax.grad`` through it, as the reference does via
``T.grad`` (``[ref: iterative_inference.py]``).
"""

from __future__ import annotations

from typing import Mapping

import jax
import jax.numpy as jnp

from iterative_inference_segm.ops.conv import (
    bilinear_kernel_depthwise,
    conv2d,
    conv2d_depthwise,
    conv_transpose2d,
    conv_transpose2d_depthwise,
    crop_to,
    delta_kernel_depthwise,
    init_conv,
    init_conv_transpose_bilinear,
    max_pool,
)
from iterative_inference_segm.models.fcn8 import FCN8_FEATURE_CHANNELS

# Spatial scale (log2 downsampling factor) of each conditioning tap.
_H_SCALE = {
    "input": 0,
    "pool1": 1,
    "pool2": 2,
    "pool3": 3,
    "pool4": 4,
    "pool5": 5,
    "fc7": 5,
}

# Channel width of each conditioning tap (input = RGB image).
DAE_H_CHANNELS = dict(FCN8_FEATURE_CHANNELS, input=3)

DEFAULT_WIDTHS = (32, 64, 128, 256)


def init_dae(
    key: jax.Array,
    *,
    n_classes: int = 11,
    h_specs: Mapping[str, int] | None = None,
    depth: int = 4,
    widths: tuple[int, ...] = DEFAULT_WIDTHS,
    stem_pool: int = 0,
    tail: str = "full",
    dtype=jnp.float32,
) -> dict:
    """Initialize the DAE param pytree.

    h_specs maps conditioning tap name -> channel count, mirroring the
    reference's ``concat_h`` flag in ``[ref: train_dae.py]`` (default
    conditioning on 'pool4'). ``depth`` is the number of pooling stages
    below the stem; ``widths[:depth]`` are the encoder channels.

    ``stem_pool`` > 0 avg-pools the probability map that many times BEFORE
    the first conv, so every feature-width op runs at /2^stem_pool or below;
    full-resolution detail re-enters through a 1x1 'score_input' fusion of
    the raw map added after the final upsample. This is the latency
    optimization for the refinement loop (full-res small-channel convs are
    memory-bound passes that dominate a DAE step); stem_pool=0 keeps the
    classic layout. Encoder stage i then sits at scale /2^(stem_pool+i).

    ``tail`` selects how the stem_pool=1 variant returns to full resolution:

    * ``'full'`` — dense 4x4 CxC transposed conv + dense 3x3 CxC
      score_input (the round-1 layout).
    * ``'sep'``  — separable: DEPTHWISE 4x4 bilinear-init upsampler +
      depthwise 3x3 on the raw map + one shared 1x1 channel mix. Same
      expressive role, but every full-res op is per-channel, which is what
      the phase-major engine (inference/fused.fused_refinement_scan) needs
      to express the tail as shift-and-add slab arithmetic. Init: bilinear up +
      identity passthrough + identity mix, so step 0 of training already
      computes logits = up(s) + y.
    """
    if tail not in ("full", "sep"):
        raise ValueError(f"unknown tail {tail!r}; expected 'full' or 'sep'")
    if tail == "sep" and stem_pool != 1:
        raise ValueError("tail='sep' is defined for stem_pool=1 (the flagship layout)")
    if h_specs is None:
        h_specs = {"pool4": DAE_H_CHANNELS["pool4"]}
    for name in h_specs:
        if name not in _H_SCALE:
            raise ValueError(f"unknown conditioning tap {name!r}; known: {sorted(_H_SCALE)}")
        if _H_SCALE[name] > depth + stem_pool:
            raise ValueError(
                f"tap {name!r} lives at scale /{2 ** _H_SCALE[name]} deeper than "
                f"stem_pool+depth {stem_pool + depth}"
            )
        if _H_SCALE[name] < stem_pool:
            raise ValueError(
                f"tap {name!r} at scale /{2 ** _H_SCALE[name]} is shallower than the "
                f"stem (/{2 ** stem_pool}); conditioning above the stem is unsupported"
            )
    if depth > len(widths):
        raise ValueError(f"depth {depth} exceeds len(widths) {len(widths)}")
    widths = tuple(widths[:depth])

    params: dict = {}
    keys = iter(jax.random.split(key, 4 * depth + 2 * stem_pool + 8))

    # h taps concatenated at the *input* of the conv at their scale.
    def h_extra(scale: int) -> int:
        return sum(c for n, c in h_specs.items() if _H_SCALE[n] == scale)

    cin = n_classes + h_extra(stem_pool)
    for i, cout in enumerate(widths):
        params[f"enc{i + 1}"] = init_conv(next(keys), 3, 3, cin, cout, dtype=dtype, scale="he")
        cin = cout + h_extra(stem_pool + i + 1)

    params["bottleneck"] = init_conv(next(keys), 3, 3, cin, widths[-1], dtype=dtype, scale="he")

    # FCN-style decoder: score projections + class-width deconv chain.
    params["score_bottleneck"] = init_conv(next(keys), 1, 1, widths[-1], n_classes, dtype=dtype)
    for i in reversed(range(depth)):
        params[f"up{i + 1}"] = init_conv_transpose_bilinear(4, n_classes, n_classes, dtype=dtype)
        params[f"score_enc{i + 1}"] = init_conv(next(keys), 1, 1, widths[i], n_classes, dtype=dtype)
    params["out"] = init_conv(next(keys), 1, 1, n_classes, n_classes, dtype=dtype)
    if tail == "sep":
        eye = jnp.eye(n_classes, dtype=dtype)[None, None]
        params["up_stem_dw"] = {"w": bilinear_kernel_depthwise(4, n_classes, dtype=dtype)}
        params["score_input_dw"] = {"w": delta_kernel_depthwise(3, n_classes, dtype=dtype)}
        params["mix"] = {"w": eye, "b": jnp.zeros((n_classes,), dtype=dtype)}
        return params
    for j in range(stem_pool):
        params[f"up_stem{j + 1}"] = init_conv_transpose_bilinear(4, n_classes, n_classes, dtype=dtype)
    if stem_pool:
        # 3x3 (not 1x1): the stem discards full-res detail, so this fusion is
        # the ONLY full-resolution signal path — give it a spatial footprint.
        # Still cheap: C->C at class width.
        params["score_input"] = init_conv(next(keys), 3, 3, n_classes, n_classes, dtype=dtype)
    return params


def dae_stem_pool_of(params: dict) -> int:
    """Number of stem pooling levels encoded in a param tree."""
    if "up_stem_dw" in params:
        return 1
    return sum(1 for k in params if k.startswith("up_stem"))


def dae_tail_of(params: dict) -> str:
    return "sep" if "up_stem_dw" in params else "full"


def precompute_bottleneck_h(
    params: dict,
    h: Mapping[str, jax.Array],
    *,
    depth: int,
    stem_pool: int,
    in_hw: tuple[int, int],
) -> tuple[jax.Array, tuple[int, int], dict] | tuple[None, None, dict]:
    """Fold bottleneck-scale conditioning taps into a loop-invariant bias.

    The refinement scan runs ``dae_core`` K+1 times per image, and the
    bottleneck conv's input is ``concat(x_enc, h_taps)`` — but the h part
    never changes across steps. By linearity of convolution over the channel
    concat, its contribution is a fixed additive bias:

        conv(concat(x, v), W) = conv(x, W[:, :, :cx]) + conv(v, W[:, :, cx:])

    Returns ``(h_bias, crop_hw, remaining_h)`` where ``h_bias`` is the
    precomputed conv of the (cropped, concatenated) bottleneck-scale taps
    with the bottleneck kernel's h columns, ``crop_hw`` the spatial dims the
    in-scan x must be cropped to (replicating concat_h's mutual crop), and
    ``remaining_h`` the taps at other scales (still handled by concat).
    Exact — bit-identical reassociation of the same convolution. Engines
    pass the result to ``dae_core(..., bottleneck_h=...)``; measured ~0.04
    ms/img off the K=5 pipeline at batch 128.

    ``in_hw`` are the spatial dims of the core's input (post-stem map).
    """
    scale = stem_pool + depth
    taps = [(n, v) for n, v in h.items() if _H_SCALE[n] == scale]
    remaining = {n: v for n, v in h.items() if _H_SCALE[n] != scale}
    if not taps:
        return None, None, remaining

    def ceil_div(a: int, b: int) -> int:
        return -(-a // b)

    # x dims at the bottleneck input: depth ceil-mode 2x2 pools from in_hw
    xh = ceil_div(in_hw[0], 1 << depth)
    xw = ceil_div(in_hw[1], 1 << depth)
    # replicate concat_h's sequential mutual crops
    pieces = []
    ch, cw = xh, xw
    for _, v in taps:
        vh, vw = min(int(v.shape[1]), ch), min(int(v.shape[2]), cw)
        pieces.append(crop_to(v, vh, vw))
        ch, cw = vh, vw
    pieces = [crop_to(v, ch, cw) for v in pieces]
    vcat = jnp.concatenate(pieces, axis=-1)

    w = params["bottleneck"]["w"]
    cx = int(w.shape[2]) - int(vcat.shape[-1])
    w_h = w[:, :, cx:, :]
    h_bias = conv2d(vcat, w_h, padding="SAME")  # at the taps' compute dtype
    return h_bias, (ch, cw), remaining


def dae_core(
    params: dict,
    x: jax.Array,
    h: Mapping[str, jax.Array] | None = None,
    *,
    depth: int = 4,
    stem_pool: int | None = None,
    bottleneck_h: tuple | None = None,
    encoder: str = "pool",
    predense: bool = False,
) -> jax.Array:
    """Encoder + decoder on the (post-stem) map: x at /2^stem_pool -> score
    map s at the same scale (after the 'out' 1x1).

    ``predense=True`` stops the decoder BEFORE its final input-scale stage
    and returns ``(pre, skip1)`` instead: for the pool encoder, ``pre`` is
    the fused state at /2 of the core scale (the input of ``up1``) and
    ``skip1`` the stage-1 pre-pool features; for the stride encoder,
    ``pre`` is the state after the ``score_enc1`` fusion (``skip1`` is
    None — stride skips live below the core scale). The half engine's
    folded tail (inference/fused.fold_half_tail) consumes this to express
    up1 + score_enc1 + out + score_input as fewer convolutions per
    refinement step; ``out(pre ...)`` remains recoverable exactly by
    linearity.

    Factored out of ``dae_apply`` so the refinement engines can run exactly
    this mid-res core between tail steps. ``x`` must already be at compute
    dtype. ``bottleneck_h`` is the output of ``precompute_bottleneck_h``
    (loop-invariant conditioning folded into a bias); when given, ``h``
    must be the ``remaining_h`` it returned.

    ``encoder`` selects the downsampling style (param shapes are IDENTICAL
    — like ``depth``, the caller must pass the value the checkpoint was
    trained with):

    * ``'pool'``   — conv3x3 + ReLU + ceil-mode 2x2 max-pool per stage,
      skips taken PRE-pool (the classic layout; default).
    * ``'stride'`` — stride-2 conv3x3 + ReLU per stage, skips at the
      post-reduction scale, decoder fuses each skip BEFORE upsampling.
      It removes three reduce_window passes and quarters each conv's
      output positions. The refinement loop runs the core K+1 times per
      image, so this is a step-cost lever; accuracy is validated by the same
      demo protocol as every flagship config (ARCHITECTURE.md).
    """
    if encoder not in ("pool", "stride"):
        raise ValueError(f"unknown encoder {encoder!r}; expected 'pool' or 'stride'")
    if stem_pool is None:
        stem_pool = dae_stem_pool_of(params)
    h = dict(h or {})
    by_scale: dict[int, list[jax.Array]] = {}
    for name, v in h.items():
        by_scale.setdefault(_H_SCALE[name], []).append(v)

    def concat_h(x: jax.Array, scale: int) -> jax.Array:
        for v in by_scale.get(scale, []):
            v = v.astype(x.dtype)
            v = crop_to(v, min(v.shape[1], x.shape[1]), min(v.shape[2], x.shape[2]))
            x = crop_to(x, v.shape[1], v.shape[2])
            x = jnp.concatenate([x, v], axis=-1)
        return x

    in_hw = (int(x.shape[1]), int(x.shape[2]))
    x = concat_h(x, stem_pool)
    skips = []
    for i in range(depth):
        p = params[f"enc{i + 1}"]
        if encoder == "stride":
            x = jax.nn.relu(conv2d(x, p["w"], p["b"], stride=2, padding="SAME"))
            skips.append(x)
        else:
            x = jax.nn.relu(conv2d(x, p["w"], p["b"], padding="SAME"))
            skips.append(x)
            x = max_pool(x, window=2, stride=2, ceil_mode=True)
        x = concat_h(x, stem_pool + i + 1)

    p = params["bottleneck"]
    if bottleneck_h is not None and bottleneck_h[0] is not None:
        h_bias, (ch, cw), _ = bottleneck_h
        x = crop_to(x, ch, cw)
        cx = int(x.shape[-1])
        x = conv2d(x, p["w"][:, :, :cx, :], p["b"], padding="SAME")
        x = jax.nn.relu(x + h_bias.astype(x.dtype))
    else:
        x = jax.nn.relu(conv2d(x, p["w"], p["b"], padding="SAME"))

    # Decoder on class-width score maps, at compute_dtype (f32 accumulation
    # is pinned inside the conv wrappers; the f32-compute_dtype configuration
    # is the parity path). Only the final softmax is forced to f32.
    p = params["score_bottleneck"]
    s = conv2d(x, p["w"], p["b"], padding="SAME")
    if encoder == "stride":
        # skips live at (/2^(sp+1) .. /2^(sp+depth)); fuse each at its own
        # scale, THEN upsample — ends at the input scale like the pool path
        # (the ceil-doubling chain can overshoot odd inputs; crop back).
        for i in reversed(range(depth)):
            p = params[f"score_enc{i + 1}"]
            sk = conv2d(skips[i], p["w"], p["b"], padding="SAME")
            s = crop_to(s, sk.shape[1], sk.shape[2])
            s = s + sk
            if predense and i == 0:
                return s, None
            s = conv_transpose2d(s, params[f"up{i + 1}"]["w"], stride=2)
        s = crop_to(s, min(s.shape[1], in_hw[0]), min(s.shape[2], in_hw[1]))
    else:
        for i in reversed(range(depth)):
            if predense and i == 0:
                return s, skips[0]
            skip = skips[i]
            s = conv_transpose2d(s, params[f"up{i + 1}"]["w"], stride=2)
            p = params[f"score_enc{i + 1}"]
            sk = conv2d(skip, p["w"], p["b"], padding="SAME")
            s = crop_to(s, sk.shape[1], sk.shape[2])
            s = s + sk

    p = params["out"]
    return conv2d(s, p["w"], p["b"], padding="SAME")


def dae_septail_logits(params: dict, s: jax.Array, y: jax.Array) -> jax.Array:
    """Separable tail, XLA composition: logits = mix(up_dw(s) + dw3x3(y)) + b.

    ``s`` is the half-res score map from ``dae_core``; ``y`` the full-res
    input probability map (already at compute dtype). Differentiable — DAE
    training, energy mode, and the score-mode engines all run this same
    math (the phase-major engine re-lays it out; see inference/fused.py).
    """
    u = conv_transpose2d_depthwise(s, params["up_stem_dw"]["w"], stride=2)
    u = crop_to(u, y.shape[1], y.shape[2])
    d = conv2d_depthwise(y, params["score_input_dw"]["w"], padding="SAME")
    p = params["mix"]
    return conv2d(u + d, p["w"], p["b"], padding="SAME")


def dae_apply(
    params: dict,
    y: jax.Array,
    h: Mapping[str, jax.Array] | None = None,
    *,
    depth: int = 4,
    compute_dtype=jnp.float32,
    out_dtype=jnp.float32,
    encoder: str = "pool",
) -> jax.Array:
    """DAE forward: corrupted probability map (+ conditioning) -> denoised map.

    y: (B, H, W, C) probability map; h: dict of FCN-8 feature taps.
    Returns (B, H, W, C) softmax probabilities at the input resolution.
    The stem/tail configuration is inferred from the params (presence of
    ``up_stem*`` / ``up_stem_dw`` entries), so one apply serves all layouts.

    ``out_dtype``: dtype of the softmax output. f32 (default) is the parity
    path; the throughput configuration passes bf16 so the whole refinement
    carry stays bf16 (halves full-res HBM traffic in the scan).
    """
    from iterative_inference_segm.ops.conv import avg_pool

    stem_pool = dae_stem_pool_of(params)
    x = y.astype(compute_dtype)
    for _ in range(stem_pool):
        # avg (not max) pooling on the stem: the input is a probability map
        # and the pooled map should stay a smoothed distribution. Edge-pad to
        # even so the decoder's x2 chain can always be cropped back down.
        ph, pw = x.shape[1] % 2, x.shape[2] % 2
        if ph or pw:
            x = jnp.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
        x = avg_pool(x, window=2, stride=2)

    s = dae_core(params, x, h, depth=depth, stem_pool=stem_pool, encoder=encoder)

    if dae_tail_of(params) == "sep":
        s = dae_septail_logits(params, s, y.astype(s.dtype))
    elif stem_pool:
        # upsample the stem scales back to /1 and fuse full-res detail via a
        # 1x1 score of the raw input map
        for j in range(stem_pool):
            s = conv_transpose2d(s, params[f"up_stem{j + 1}"]["w"], stride=2)
        s = crop_to(s, y.shape[1], y.shape[2])
        p = params["score_input"]
        s = s + conv2d(y.astype(s.dtype), p["w"], p["b"], padding="SAME")

    logits = crop_to(s, y.shape[1], y.shape[2])
    if out_dtype == jnp.bfloat16:
        # Throughput path (bf16 refinement carry): softmax the compute-dtype
        # logits directly — skips a full-res f32 materialization per
        # refinement step. Parity path (f32 out) keeps the f32 softmax.
        return jax.nn.softmax(logits.astype(jnp.bfloat16), axis=-1)
    return jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(out_dtype)
