"""Dilated-convolution context module — the reference's alternative refiner.

Rebuild of ``[ref: models/contextmod.py]`` (``buildDAE_contextmod``):
a Yu & Koltun (2016) context module operating directly on the corrupted
probability map at full resolution — a stack of 3x3 convs with exponentially
increasing dilation (1, 1, 2, 4, 8, 16, 1) followed by a 1x1 projection back
to ``n_classes`` and a softmax. Used as an ablation architecture for the
score network in place of the pooling DAE.

Dilated convs lower to ``rhs_dilation`` in ``lax.conv_general_dilated`` —
fully static shapes, no pooling so no crop bookkeeping.
"""

from __future__ import annotations

from typing import Mapping

import jax
import jax.numpy as jnp

from iterative_inference_segm.ops.conv import conv2d, init_conv

_DILATIONS = (1, 1, 2, 4, 8, 16, 1)


def init_contextmod(
    key: jax.Array,
    *,
    n_classes: int = 11,
    width_mult: int = 2,
    h_channels: int = 0,
    dtype=jnp.float32,
) -> dict:
    """Params for the context module. ``h_channels`` > 0 enables input-scale
    conditioning (concat of an FCN tap upsampled/cropped to input size)."""
    params: dict = {}
    keys = iter(jax.random.split(key, len(_DILATIONS) + 2))
    width = n_classes * width_mult
    cin = n_classes + h_channels
    for i, _d in enumerate(_DILATIONS):
        params[f"ctx{i + 1}"] = init_conv(next(keys), 3, 3, cin, width, dtype=dtype, scale="he")
        cin = width
    params["out"] = init_conv(next(keys), 1, 1, width, n_classes, dtype=dtype)
    return params


def contextmod_apply(
    params: dict,
    y: jax.Array,
    h: Mapping[str, jax.Array] | None = None,
    *,
    compute_dtype=jnp.float32,
) -> jax.Array:
    """Context-module forward: (B,H,W,C) probs -> (B,H,W,C) denoised probs."""
    x = y.astype(compute_dtype)
    if h:
        for v in h.values():
            if v.shape[1:3] != x.shape[1:3]:
                raise ValueError(
                    "contextmod conditioning must be at input scale; got "
                    f"{v.shape[1:3]} vs {x.shape[1:3]}"
                )
            x = jnp.concatenate([x, v.astype(x.dtype)], axis=-1)
    for i, d in enumerate(_DILATIONS):
        p = params[f"ctx{i + 1}"]
        x = jax.nn.relu(conv2d(x, p["w"], p["b"], padding="SAME", dilation=d))
    p = params["out"]
    logits = conv2d(
        x.astype(jnp.float32), p["w"].astype(jnp.float32), p["b"].astype(jnp.float32), padding="SAME"
    )
    return jax.nn.softmax(logits, axis=-1)
