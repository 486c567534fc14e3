"""Pooled-scale refinement engines: the throughput paths for the K-step scan.

This module holds the HALF/QUARTER engine family (``halfres_refinement_scan``
and friends — K refinement steps on the class map POOLED to the DAE's stem
scale, /2 or /4, plus ONE full-resolution rectification), the folded
per-step tail that composes its linear ops into fewer convolutions
(``fold_half_tail``), and the phase-major ``fused`` experiment this module
was first built around (kept as a documented negative result; see its
docstrings). The benched flagship and every >1000 img/s configuration run
through the half/quarter scans here.

Why the pooled engines exist: most of a full-resolution refinement step is
not the DAE's mid-resolution encoder/decoder but the handful of
FULL-RESOLUTION class-map ops around it (stem avg-pool, 4x4 deconv back to
/1, 3x3 score_input, softmax, the y-update). With only C=11 channels these
are memory-bound passes between conv boundaries that XLA cannot fuse away.
The half/quarter engines therefore iterate on the pooled map and pay the
full-resolution tail once.

The ``fused`` experiment carries the refinement state phase-major and
channel-leading, ``y_ph (B, 2, 2, C, H/2, W/2)`` (phases = row/col parity),
so every full-res tail op becomes shift-and-add arithmetic that XLA fuses
into a couple of passes:

* stem avg-pool  = mean over the 4 phase planes (pure elementwise);
* k=4 s=2 depthwise deconv = per-phase 2x2 taps of the half-res map
  (phase-major algebra of ops/conv.conv_transpose2d_phase);
* depthwise 3x3 on the full-res map = 9 shifted phase-plane FMAs;
* 1x1 channel mix = C^2 slab FMAs over the channel dim;
* softmax over C = reductions over a leading dim.

Requires the separable tail (models/dae.py ``tail='sep'``): with dense CxC
spatial kernels the slab count multiplies by C. Everything here is plain
jnp — differentiable (energy mode, training) and exactly equal to
dae_apply + refinement_scan modulo float reassociation (tested in
tests/test_fused.py).

Reference semantics: ``[ref: iterative_inference.py]`` (the K-step update
loop, SURVEY.md §4.3); this module changes only how the arithmetic is laid
out.
"""

from __future__ import annotations

from typing import Callable, Mapping

import jax
import jax.numpy as jnp
from jax import lax

from iterative_inference_segm.models.dae import (
    dae_core,
    dae_stem_pool_of,
    dae_tail_of,
    precompute_bottleneck_h,
)


def phase_split(y: jax.Array) -> jax.Array:
    """(B, H, W, C) -> (B, 2, 2, C, H/2, W/2); [b, ph, pw, c, j, u] = y[b, 2j+ph, 2u+pw, c]."""
    b, h, w, c = y.shape
    if h % 2 or w % 2:
        raise ValueError(f"phase_split needs even H, W; got {(h, w)}")
    y = y.reshape(b, h // 2, 2, w // 2, 2, c)
    return y.transpose(0, 2, 4, 5, 1, 3)


def phase_merge(y_ph: jax.Array) -> jax.Array:
    """Inverse of ``phase_split``."""
    b, _, _, c, hh, wh = y_ph.shape
    return y_ph.transpose(0, 4, 1, 5, 2, 3).reshape(b, 2 * hh, 2 * wh, c)


def _shift2(x: jax.Array, dh: int, dw: int) -> jax.Array:
    """out[..., j, u] = x[..., j+dh, u+dw], zero-filled outside (|d| <= 1)."""
    if dh:
        pad = [(0, 0)] * (x.ndim - 2) + [(max(-dh, 0), max(dh, 0)), (0, 0)]
        x = jnp.pad(x, pad)
        x = x[..., max(dh, 0) : x.shape[-2] - max(-dh, 0), :]
    if dw:
        pad = [(0, 0)] * (x.ndim - 1) + [(max(-dw, 0), max(dw, 0))]
        x = jnp.pad(x, pad)
        x = x[..., max(dw, 0) : x.shape[-1] - max(-dw, 0)]
    return x


# k=4 s=2 transposed-conv taps per output phase, matching conv_transpose2d's
# symmetric padding (pad_lo = 2): out[2j+0] = w[0]*s[j-1] + w[2]*s[j];
# out[2j+1] = w[1]*s[j] + w[3]*s[j+1]. Entries: (kernel index, source shift).
_DECONV_TAPS = {0: ((0, -1), (2, 0)), 1: ((1, 0), (3, 1))}


def septail_phase_logits(
    params: dict, s_cl: jax.Array, y_ph: jax.Array
) -> jax.Array:
    """Separable tail on phase planes: logits_ph (B, 2, 2, C, Hh, Wh).

    ``s_cl``: channel-leading half-res score map (B, C, Hh, Wh) from
    ``dae_core``; ``y_ph``: phase-split current iterate. Same math as
    models.dae.dae_septail_logits, re-laid-out.
    """
    c = s_cl.shape[1]
    w_up = params["up_stem_dw"]["w"]  # (4, 4, C)
    w_si = params["score_input_dw"]["w"]  # (3, 3, C)
    mix = params["mix"]["w"][0, 0]  # (C, C)
    bias = params["mix"]["b"]  # (C,)

    dt = y_ph.dtype
    w_up = w_up.astype(dt)
    w_si = w_si.astype(dt)
    mix = mix.astype(dt)

    def chan(w):  # (C,) -> broadcast over (B, C, Hh, Wh)
        return w[None, :, None, None]

    phases = []
    for ph in range(2):
        row = []
        for pw in range(2):
            # depthwise 4x4 deconv of s: 2x2 taps for this phase
            acc = None
            for kh, dh in _DECONV_TAPS[ph]:
                for kw, dw_ in _DECONV_TAPS[pw]:
                    t = _shift2(s_cl, dh, dw_) * chan(w_up[kh, kw])
                    acc = t if acc is None else acc + t
            # depthwise 3x3 on the full-res iterate: 9 phase-mapped taps
            for dr in (-1, 0, 1):
                src_ph = (ph + dr) % 2
                dh = (ph + dr) // 2
                for dc in (-1, 0, 1):
                    src_pw = (pw + dc) % 2
                    dw_ = (pw + dc) // 2
                    plane = y_ph[:, src_ph, src_pw]
                    acc = acc + _shift2(plane, dh, dw_) * chan(w_si[1 + dr, 1 + dc])
            # 1x1 channel mix as C^2 slab FMAs (stays elementwise-fusable;
            # a dot over the leading C dim would force transposes)
            logits = [
                sum(acc[:, ci] * mix[ci, co] for ci in range(c)) + bias[co].astype(dt)
                for co in range(c)
            ]
            row.append(jnp.stack(logits, axis=1))
        phases.append(jnp.stack(row, axis=1))
    return jnp.stack(phases, axis=1)


def fused_refinement_scan(
    params: dict,
    core_fn: Callable[[jax.Array], jax.Array],
    y0: jax.Array,
    *,
    eps: float | jax.Array,
    num_steps: int,
    state_dtype=None,
) -> jax.Array:
    """K score-refinement steps with a phase-major carry; returns y_K (NHWC).

    ``core_fn(y_pool_nhwc) -> s_nhwc`` is the mid-res encoder/decoder (a
    closure over dae params + conditioning h, i.e. ``dae_core`` after the
    stem). Layout conversions in and out of NHWC happen at HALF resolution
    only (1/4 of the full-res traffic); the full-res math never leaves the
    channel-leading phase layout.
    """
    if state_dtype is None:
        state_dtype = y0.dtype
    y_ph0 = phase_split(y0).astype(state_dtype)
    eps = jnp.asarray(eps, state_dtype)

    def step(y_ph, _):
        y_pool = jnp.mean(
            y_ph.astype(jnp.float32) if state_dtype == jnp.bfloat16 else y_ph, axis=(1, 2)
        ).astype(state_dtype)  # (B, C, Hh, Wh): the stem avg-pool
        s = core_fn(jnp.transpose(y_pool, (0, 2, 3, 1)))  # NHWC half-res
        s_cl = jnp.transpose(s, (0, 3, 1, 2)).astype(state_dtype)
        logits = septail_phase_logits(params, s_cl, y_ph).astype(jnp.float32)
        r = jax.nn.softmax(logits, axis=3).astype(state_dtype)
        y_ph_new = y_ph - eps * (y_ph - r)
        return y_ph_new, None

    y_ph_k, _ = lax.scan(step, y_ph0, None, length=num_steps)
    return phase_merge(y_ph_k).astype(y0.dtype)


def half_logits(params: dict, x: jax.Array, s: jax.Array) -> jax.Array:
    """Half-resolution tail logits: the score fusion applied at the pooled
    scale (the half engine's per-step denoiser head). ``s`` = dae_core(x)."""
    from iterative_inference_segm.ops.conv import conv2d, conv2d_depthwise

    if dae_tail_of(params) == "sep":
        d = conv2d_depthwise(x, params["score_input_dw"]["w"].astype(x.dtype))
        p = params["mix"]
        return conv2d(s + d, p["w"], p["b"], padding="SAME")
    p = params["score_input"]
    return s + conv2d(x, p["w"], p["b"], padding="SAME")


def full_logits(params: dict, s_k: jax.Array, y: jax.Array) -> jax.Array:
    """Full-resolution rectification logits from a (refined) pooled-scale
    score map: exactly the DAE's stem-tail applied once — the ``up_stem``
    deconv chain back to /1 (one deconv per stem level, like ``dae_apply``)
    + score_input on y."""
    from iterative_inference_segm.ops.conv import conv2d, conv_transpose2d, crop_to

    if dae_tail_of(params) == "sep":
        from iterative_inference_segm.models.dae import dae_septail_logits

        return dae_septail_logits(params, s_k, y)
    u = s_k
    for j in range(dae_stem_pool_of(params)):
        u = conv_transpose2d(u, params[f"up_stem{j + 1}"]["w"], stride=2)
    u = crop_to(u, y.shape[1], y.shape[2])
    p = params["score_input"]
    return u + conv2d(y.astype(u.dtype), p["w"], p["b"], padding="SAME")


def fold_half_tail(params: dict, *, encoder: str = "pool") -> dict:
    """Compose the per-step tail's linear ops into fewer convolutions.

    The half engine's step tail (``up1`` deconv + ``score_enc1`` + ``out`` +
    ``score_input``) pays one materialized pass per conv boundary at the
    pooled scale. ``out`` is a 1x1 LINEAR map applied to a sum, so it folds
    into the kernels feeding it (exact reassociation in f32, like
    ``precompute_bottleneck_h``):

        out(up1(u) + se1(k) + b_se1) + b_out = up1'(u) + se1'(k) + b'

    and for the pool encoder ``se1'`` (1x1 on skip1) and ``score_input``
    (3x3 on x) merge into ONE 3x3 conv over ``concat(skip1, x)`` (se1'
    centered). The merged conv saves one materialized pass per step; stride
    encoders have no core-scale skip, so only the out-fold applies.

    Kernels are composed in f32 at HIGHEST precision (a default-precision
    f32 contraction may run in TF32 on the GPU, which would make the folded
    pipeline drift from the unfolded one) and kept f32 (the conv wrappers
    cast to the activation dtype at use — one rounding instead of two).
    This is weight preprocessing: it costs nothing per image. Requires
    tail='full' and stem_pool>=1 (the whole pooled-engine family: half
    AND quarter — tests/test_half_engine.py pins folded==unfolded at both
    stem depths).
    """
    if dae_tail_of(params) != "full" or dae_stem_pool_of(params) < 1:
        raise ValueError("fold_half_tail requires a stem_pool>=1, tail='full' DAE")
    f32 = jnp.float32
    hi = lax.Precision.HIGHEST
    w_out = params["out"]["w"][0, 0].astype(f32)  # (C, C)
    b_out = params["out"]["b"].astype(f32)
    up1p = jnp.einsum("hwim,mo->hwio", params["up1"]["w"].astype(f32), w_out, precision=hi)
    si_w = params["score_input"]["w"].astype(f32)  # (3, 3, C, C)
    si_b = params["score_input"]["b"].astype(f32)
    fk = {"up1p": up1p, "b_out": b_out, "si_w": si_w, "si_b": si_b}
    if encoder == "pool":
        se1_w = params["score_enc1"]["w"].astype(f32)  # (1, 1, c1, C)
        se1_b = params["score_enc1"]["b"].astype(f32)
        se1p_w = jnp.einsum("hwim,mo->hwio", se1_w, w_out, precision=hi)
        bp = jnp.matmul(se1_b, w_out, precision=hi) + b_out
        c1 = int(se1_w.shape[2])
        cat_w = jnp.zeros((3, 3, c1 + int(si_w.shape[2]), int(si_w.shape[3])), f32)
        cat_w = cat_w.at[1, 1, :c1, :].set(se1p_w[0, 0]).at[:, :, c1:, :].set(si_w)
        fk.update(se1p_w=se1p_w, bp=bp, cat_w=cat_w, cat_b=bp + si_b)
    return fk


def folded_step_logits(
    fk: dict, pre: jax.Array, skip1: jax.Array | None, x: jax.Array, *, encoder: str
) -> jax.Array:
    """Per-step denoiser logits from the predense core state (== out(core)+
    score_input(x) by linearity; see ``fold_half_tail``)."""
    from iterative_inference_segm.ops.conv import conv2d, conv_transpose2d, crop_to

    s = conv_transpose2d(pre, fk["up1p"], stride=2)
    if encoder == "pool":
        cat = jnp.concatenate([skip1, x.astype(skip1.dtype)], axis=-1)
        sk = conv2d(cat, fk["cat_w"], fk["cat_b"], padding="SAME")
        return crop_to(s, sk.shape[1], sk.shape[2]) + sk
    s = crop_to(s, x.shape[1], x.shape[2]) + fk["b_out"].astype(s.dtype)
    return s + conv2d(x, fk["si_w"], fk["si_b"], padding="SAME")


def folded_core_out(
    fk: dict, pre: jax.Array, skip1: jax.Array | None, *, encoder: str,
    out_hw: tuple[int, int],
) -> jax.Array:
    """Recover the STANDARD core output s (dae_core's post-``out`` result)
    from the predense state — one extra cheap fusion per refine call, used
    by the final full-res rectification so its math stays byte-compatible
    with the unfolded engine's ``full_logits(s_k, y0)``."""
    from iterative_inference_segm.ops.conv import conv2d, conv_transpose2d, crop_to

    s = conv_transpose2d(pre, fk["up1p"], stride=2)
    if encoder == "pool":
        sk = conv2d(skip1, fk["se1p_w"], fk["bp"], padding="SAME")
        return crop_to(s, sk.shape[1], sk.shape[2]) + sk
    return crop_to(s, out_hw[0], out_hw[1]) + fk["b_out"].astype(s.dtype)


def _half_denoise(params: dict, core_fn: Callable, x: jax.Array, state_dtype) -> jax.Array:
    """The half engine's per-step denoiser: r(x) = softmax(core(x) + tail_h(x))."""
    s = core_fn(x).astype(state_dtype)
    return jax.nn.softmax(half_logits(params, x, s), -1)


def half_step_gradient(
    params: dict,
    core_fn: Callable,
    x: jax.Array,
    *,
    mode: str,
    state_dtype,
    s: jax.Array | None = None,
) -> jax.Array:
    """Refinement gradient at the pooled scale.

    ``'score'`` is the direct Alain-Bengio estimate x - r(x) (the benched
    flagship numerics, unchanged). ``'energy'`` differentiates through the
    pooled denoiser — d/dx [ 0.5*||x - r(x)||^2 ] with r = core + half tail,
    all plain jnp, so ``jax.grad`` flows through the mid-res encoder/decoder
    exactly as the reference's ``T.grad`` flows through its DAE
    (``[ref: iterative_inference.py]``, SURVEY.md §4.3) — at the pooled
    scale this engine iterates on.

    ``s`` (score mode only): a precomputed ``core_fn(x)`` to share with a
    same-step rectification (the search's one-core-call-per-step trick);
    energy mode must run the core inside the differentiated function.
    """
    if mode == "score":
        if s is not None:
            return x - jax.nn.softmax(half_logits(params, x, s), -1)
        return x - _half_denoise(params, core_fn, x, state_dtype)
    if mode == "energy":

        def energy(xx):
            r = _half_denoise(params, core_fn, xx, state_dtype)
            return 0.5 * jnp.sum(jnp.square(xx - r))

        return jax.grad(energy)(x)
    raise ValueError(f"unknown mode {mode!r}; expected 'score' or 'energy'")


def full_rect_gradient(params: dict, s_k: jax.Array, y: jax.Array, *, mode: str) -> jax.Array:
    """Gradient of the one full-resolution rectification step.

    ``s_k`` (the core output at the final pooled iterate) is a constant of
    the rectification — the update variable is the full-res map ``y``, which
    enters through the tail's score_input path. In energy mode the gradient
    therefore carries the tail Jacobian only (the pooled trajectory's core
    Jacobians were already applied at their own steps).
    """

    def denoise(yy):
        return jax.nn.softmax(full_logits(params, s_k, yy), -1)

    if mode == "score":
        return y - denoise(y)
    if mode == "energy":

        def energy(yy):
            r = denoise(yy)
            return 0.5 * jnp.sum(jnp.square(yy - r))

        return jax.grad(energy)(y)
    raise ValueError(f"unknown mode {mode!r}; expected 'score' or 'energy'")


def _pooled_carry(params: dict, y0: jax.Array, state_dtype):
    """Shared prologue of the pooled-engine scans: validate the
    preconditions (stem_pool>=1 DAE, H/W divisible by the pooling factor)
    and build the pooled carry ``x0 = avg_pool^sp(y0)``. One source of
    truth for both the unfolded and folded scans — these invariants define
    the engine, so a future change must hit both paths at once.

    Returns ``(sp, state_dtype, x0)`` with ``state_dtype`` defaulted to
    ``y0.dtype``.
    """
    sp = dae_stem_pool_of(params)
    if sp < 1:
        raise ValueError("half engine requires a stem_pool>=1 DAE")
    if state_dtype is None:
        state_dtype = y0.dtype
    _, h, w, _ = y0.shape
    if h % (1 << sp) or w % (1 << sp):
        raise ValueError(f"half engine requires H, W divisible by {1 << sp}")

    from iterative_inference_segm.ops.conv import avg_pool

    x0 = y0.astype(state_dtype)
    for _ in range(sp):
        x0 = avg_pool(x0, window=2, stride=2)
    return sp, state_dtype, x0


def halfres_refinement_scan(
    params: dict,
    core_fn: Callable[[jax.Array], jax.Array],
    y0: jax.Array,
    *,
    eps: float | jax.Array,
    num_steps: int,
    state_dtype=None,
    mode: str = "score",
) -> jax.Array:
    """K refinement steps on the POOLED class map + one full-res rectification.

    The throughput configuration ("half engine"). Most of a full-fidelity
    refinement step is materialized full-resolution passes between the
    tail's conv boundaries, not the mid-res encoder/decoder. This engine
    keeps the ITERATION entirely at half resolution (the scale the DAE's
    stem pools to anyway):

        x_0 = avg_pool(y_0)
        x_{k+1} = x_k - eps * (x_k - softmax(core(x_k) + si_h(x_k)))
        y_K = y_0 - eps * (y_0 - softmax(up(core(x_K)) + si(y_0)))

    where ``si_h`` reuses the tail's score_input kernel at half resolution
    and the LAST line is one standard full-res tail application injecting
    the original full-res detail. This is an approximation of K full-res
    steps (pool and softmax do not commute); its accuracy is validated
    end-to-end by the synthetic demo (scripts/demo_synthetic.py --engine
    half reproduces the full engine's refinement gain; see
    ARCHITECTURE.md). (eps, K) are re-searched on the validation split for
    this engine, exactly as the reference tunes its own loop
    (``[ref: iterative_inference_valid.py]``).

    Works with both tails: 'full' (dense score_input/up_stem) and 'sep'.

    ``mode``: 'score' (default — the benched flagship numerics, softmax at
    state_dtype per step) or 'energy' (grad-through-the-denoiser at the
    pooled scale + tail-Jacobian rectification; see ``half_step_gradient`` /
    ``full_rect_gradient``). Both rules run inside the same single scan.

    stem_pool=2 DAEs iterate at QUARTER resolution (the "quarter engine":
    every per-step pass costs 1/16 of full res) with the same one-full-res
    rectification — each extra stem level trades step cost against
    iteration fidelity; accuracy per config is validated by the demo
    protocol like every engine (ARCHITECTURE.md).
    """
    if mode not in ("score", "energy"):
        raise ValueError(f"unknown mode {mode!r}; expected 'score' or 'energy'")
    _, state_dtype, x0 = _pooled_carry(params, y0, state_dtype)
    eps_s = jnp.asarray(eps, state_dtype)

    def step(x, _):
        # score mode: softmax at state_dtype — jax.nn.softmax subtracts the
        # max first, so bf16 logits stay in range; bf16 probabilities carry
        # ~2-3 decimal digits, plenty for a blend that feeds an argmax.
        # Accuracy of the full bf16 configuration is demo-verified
        # (ARCHITECTURE.md).
        g = half_step_gradient(params, core_fn, x, mode=mode, state_dtype=state_dtype)
        return x - eps_s * g, None

    x_k, _ = lax.scan(step, x0, None, length=num_steps)

    # Final rectification runs at state_dtype end-to-end: with a bf16 state
    # this halves the full-res HBM passes of the one expensive step. The
    # result is returned at state_dtype; the consumer is an argmax (or a
    # metrics pass), neither of which needs f32.
    s_k = core_fn(x_k).astype(state_dtype)
    y0s = y0.astype(state_dtype)
    return y0s - eps_s * full_rect_gradient(params, s_k, y0s, mode=mode)


def halfres_refinement_scan_folded(
    params: dict,
    predense_fn: Callable[[jax.Array], tuple],
    y0: jax.Array,
    *,
    eps: float | jax.Array,
    num_steps: int,
    state_dtype=None,
    encoder: str = "pool",
) -> jax.Array:
    """Score-mode half engine with the folded per-step tail.

    Same update rule as ``halfres_refinement_scan(mode='score')`` with the
    tail convolutions composed per ``fold_half_tail`` — equal up to the f32
    reassociation of the composed kernels (tested in tests/test_fold_tail.py)
    and measured faster in the K-step scan. ``predense_fn(x) -> (pre, skip1)``
    is ``dae_core(..., predense=True)`` closed over params/conditioning.
    The final rectification recovers the standard core output and runs the
    byte-identical ``full_logits`` path. stem_pool=2 DAEs iterate at
    quarter resolution (see ``halfres_refinement_scan``).
    """
    _, state_dtype, x0 = _pooled_carry(params, y0, state_dtype)
    fk = fold_half_tail(params, encoder=encoder)
    eps_s = jnp.asarray(eps, state_dtype)

    def step(x, _):
        pre, sk1 = predense_fn(x)
        logits = folded_step_logits(fk, pre, sk1, x, encoder=encoder).astype(state_dtype)
        r = jax.nn.softmax(logits, -1)
        return x - eps_s * (x - r), None

    x_k, _ = lax.scan(step, x0, None, length=num_steps)

    pre, sk1 = predense_fn(x_k)
    s_k = folded_core_out(
        fk, pre, sk1, encoder=encoder, out_hw=(int(x_k.shape[1]), int(x_k.shape[2]))
    ).astype(state_dtype)
    y0s = y0.astype(state_dtype)
    r_full = jax.nn.softmax(full_logits(params, s_k, y0s), -1)
    return y0s - eps_s * (y0s - r_full)


def make_half_refiner(
    fcn_apply: Callable,
    fcn_params,
    dae_params: dict,
    *,
    eps: float,
    num_steps: int,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 3,
    compute_dtype=jnp.float32,
    state_dtype=None,
    encoder: str = "pool",
    mode: str = "score",
    fold_tail: bool | None = None,
) -> Callable[[jax.Array], tuple[jax.Array, jax.Array]]:
    """Jitted image batch -> (y0, yK) via the half-resolution engine.

    ``encoder`` must match the style the DAE was trained with
    (models.dae.dae_core: 'pool' classic / 'stride' strided-conv).
    ``mode``: 'score' or 'energy' (see ``halfres_refinement_scan``).
    ``fold_tail``: use the folded per-step tail (``fold_half_tail`` —
    measured faster, equal modulo f32 reassociation). Default (None):
    on for score mode with the 'full' tail; energy mode and the 'sep'
    tail keep the unfolded path."""
    if fold_tail is None:
        fold_tail = mode == "score" and dae_tail_of(dae_params) == "full"
    if fold_tail and (mode != "score" or dae_tail_of(dae_params) != "full"):
        raise ValueError("fold_tail requires score mode and tail='full'")

    # params as jit ARGUMENTS — a closure would bake the weights into the
    # executable as constants
    _refine = jax.jit(flagship_forward_fn(
        fcn_apply=fcn_apply, eps=eps, num_steps=num_steps, h_taps=h_taps,
        depth=depth, compute_dtype=compute_dtype, state_dtype=state_dtype,
        encoder=encoder, mode=mode, fold_tail=fold_tail,
    ))

    def refine(x: jax.Array) -> tuple[jax.Array, jax.Array]:
        return _refine(fcn_params, dae_params, x)

    return refine


def flagship_forward_fn(
    *,
    fcn_apply: Callable | None = None,
    eps: float = 0.1,
    num_steps: int = 5,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 3,
    compute_dtype=jnp.bfloat16,
    state_dtype=None,
    encoder: str = "pool",
    mode: str = "score",
    fold_tail: bool = True,
) -> Callable:
    """The flagship pipeline as ONE pure function (params are ARGUMENTS, not
    compiled-in constants; callers jit): ``forward(fcn_params, dae_params, x) ->
    (y0, y_k)``. FCN-8 forward with the conditioning taps, K pooled-map
    refinement steps at the DAE's stem scale (stem_pool inferred from the
    param tree: 1 = half engine, 2 = quarter), one full-res rectification,
    optionally the folded per-step tail (``fold_half_tail``).

    Single definition shared by ``bench.py``, ``tools/serve_bench.py``,
    ``__graft_entry__.entry()``, and ``make_half_refiner`` so the benched
    configuration cannot drift between harnesses.
    """
    if fcn_apply is None:
        from iterative_inference_segm.models.fcn8 import fcn8_apply as fcn_apply

    def forward(fcn_params, dae_params, x):
        # probs at the carry dtype: identical numerics on every surface
        # (bf16 carry => bf16 y0, no f32 full-res round trip)
        y0, h = fcn_apply(
            fcn_params, x, return_features=h_taps, compute_dtype=compute_dtype,
            probs_dtype=state_dtype or compute_dtype,
        )
        y_k = halfres_refine(
            dae_params, y0, h, (x.shape[1], x.shape[2]),
            eps=eps, num_steps=num_steps, depth=depth,
            compute_dtype=compute_dtype, state_dtype=state_dtype,
            encoder=encoder, mode=mode, fold_tail=fold_tail,
        )
        return y0, y_k

    return forward


def halfres_refine(
    dae_params: dict,
    y0: jax.Array,
    h,
    in_hw: tuple[int, int],
    *,
    eps: float,
    num_steps: int,
    depth: int,
    compute_dtype,
    state_dtype=None,
    encoder: str = "pool",
    mode: str = "score",
    fold_tail: bool | None = None,
) -> jax.Array:
    """The pooled-engine refinement from a precomputed FCN forward: K steps
    on the stem-scale class map + one full-res rectification. ``in_hw`` is
    the full-resolution (H, W); stem_pool comes from the param tree.
    ``fold_tail=None`` folds whenever legal (score mode, 'full' tail) —
    the benched default. Shared by ``flagship_forward_fn`` and the serving
    ``Predictor`` so every surface runs the same numerics."""
    if fold_tail is None:
        fold_tail = mode == "score" and dae_tail_of(dae_params) == "full"
    sp = dae_stem_pool_of(dae_params)
    bh = precompute_bottleneck_h(
        dae_params, h, depth=depth, stem_pool=sp,
        in_hw=(in_hw[0] >> sp, in_hw[1] >> sp),
    )

    if fold_tail:

        def predense_fn(x_half):
            return dae_core(
                dae_params, x_half.astype(compute_dtype), bh[2],
                depth=depth, stem_pool=sp, bottleneck_h=bh, encoder=encoder,
                predense=True,
            )

        return halfres_refinement_scan_folded(
            dae_params, predense_fn, y0, eps=eps, num_steps=num_steps,
            state_dtype=state_dtype or compute_dtype, encoder=encoder,
        )

    def core_fn(x_half):
        return dae_core(
            dae_params, x_half.astype(compute_dtype), bh[2],
            depth=depth, stem_pool=sp, bottleneck_h=bh, encoder=encoder,
        )

    return halfres_refinement_scan(
        dae_params, core_fn, y0, eps=eps, num_steps=num_steps,
        state_dtype=state_dtype or compute_dtype, mode=mode,
    )


def make_fused_refiner(
    fcn_apply: Callable,
    fcn_params,
    dae_params: dict,
    *,
    eps: float,
    num_steps: int,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 3,
    compute_dtype=jnp.float32,
    state_dtype=None,
    encoder: str = "pool",
) -> Callable[[jax.Array], tuple[jax.Array, jax.Array]]:
    """Jitted image batch -> (y0, yK) using the phase-major fast path.

    Drop-in for ``inference.iterative.make_refiner`` for score mode with a
    stem_pool=1 separable-tail DAE (the flagship); other configurations
    should use the general engine.
    """
    if dae_tail_of(dae_params) != "sep" or dae_stem_pool_of(dae_params) != 1:
        raise ValueError("fused refiner requires a stem_pool=1, tail='sep' DAE")

    @jax.jit
    def _refine(fcn_params, dae_params, x):
        y0, h = fcn_apply(
            fcn_params, x, return_features=h_taps, compute_dtype=compute_dtype
        )

        def core_fn(y_pool_nhwc):
            return dae_core(
                dae_params, y_pool_nhwc.astype(compute_dtype), h,
                depth=depth, stem_pool=1, encoder=encoder,
            )

        y_k = fused_refinement_scan(
            dae_params, core_fn, y0,
            eps=eps, num_steps=num_steps,
            state_dtype=state_dtype or compute_dtype,
        )
        return y0, y_k

    def refine(x: jax.Array) -> tuple[jax.Array, jax.Array]:
        return _refine(fcn_params, dae_params, x)

    return refine
