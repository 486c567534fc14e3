"""(eps, K) hyperparameter search on the validation split.

Rebuild of ``[ref: iterative_inference_valid.py]`` (SURVEY.md §4.4): grid
search over step size eps and step count K on the validation set; the best
pair is then used on test.

Instead of re-running the loop per (eps, K) pair like the
reference, we run ONE K_max-step trajectory per eps (``refine_with_trajectory``)
and score every prefix K <= K_max from the stacked iterates — scoring all K
values costs one run. eps is a traced scalar, so all eps values share a
single compiled program.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from iterative_inference_segm.inference.iterative import refine_with_trajectory
from iterative_inference_segm.ops.metrics import confusion_matrix, metrics_from_confusion


def grid_search_eps_k(
    fcn_apply: Callable,
    dae_apply: Callable,
    fcn_params,
    dae_params,
    batches: Iterable[tuple[np.ndarray, np.ndarray]],
    *,
    n_classes: int,
    eps_grid: Sequence[float],
    k_max: int,
    h_taps: tuple[str, ...] = ("pool4",),
    mode: str = "score",
    renorm: str = "none",
    dae_kwargs: dict | None = None,
    compute_dtype=jnp.float32,
) -> dict:
    """Evaluate mIoU for every (eps in eps_grid, K in 0..k_max) on ``batches``.

    Returns {'best_eps', 'best_k', 'best_miou', 'miou': (n_eps, k_max+1) array}.
    ``batches`` yields (images NHWC, labels BHW); it is re-iterated per eps,
    so pass a list (validation sets are small: CamVid val = 101 images).
    ``compute_dtype`` sets the FCN/score-net compute precision so (eps, K)
    can be selected under the numerics they will run at (pass bf16 when the
    eval refiner runs bf16).
    """
    batches = list(batches)
    dae_kwargs = dict(dae_kwargs or {})
    dae_kwargs.setdefault("compute_dtype", compute_dtype)

    # params are jit ARGUMENTS: closing over them bakes the weights into the
    # executable as constants.
    @jax.jit
    def trajectory_cms(fcn_params, dae_params, eps: jax.Array, x: jax.Array, labels: jax.Array) -> jax.Array:
        y0, h = fcn_apply(fcn_params, x, return_features=h_taps, compute_dtype=compute_dtype)
        dae_fn = lambda y: dae_apply(dae_params, y, h, **dae_kwargs)
        traj = refine_with_trajectory(
            dae_fn, y0, eps=eps, num_steps=k_max, mode=mode, renorm=renorm
        )
        preds = jnp.argmax(traj, axis=-1)  # (K+1, B, H, W)
        return jax.vmap(
            lambda p: confusion_matrix(p, labels, n_classes=n_classes)
        )(preds)  # (K+1, C, C)

    miou = np.zeros((len(eps_grid), k_max + 1), dtype=np.float64)
    for ei, eps in enumerate(eps_grid):
        cms = None
        for x, labels in batches:
            c = trajectory_cms(
                fcn_params, dae_params,
                jnp.asarray(eps, jnp.float32), jnp.asarray(x), jnp.asarray(labels),
            )
            cms = c if cms is None else cms + c
        cms = jax.device_get(cms)
        for k in range(k_max + 1):
            miou[ei, k] = float(metrics_from_confusion(jnp.asarray(cms[k])).mean_iou)

    best_flat = int(np.argmax(miou))
    best_ei, best_k = divmod(best_flat, k_max + 1)
    return {
        "best_eps": float(eps_grid[best_ei]),
        "best_k": int(best_k),
        "best_miou": float(miou[best_ei, best_k]),
        "miou": miou,
    }


def grid_search_eps_k_half(
    fcn_apply: Callable,
    fcn_params,
    dae_params,
    batches: Iterable[tuple[np.ndarray, np.ndarray]],
    *,
    n_classes: int,
    eps_grid: Sequence[float],
    k_max: int,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 3,
    compute_dtype=jnp.float32,
    encoder: str = "pool",
    mode: str = "score",
) -> dict:
    """(eps, K) search for the HALF engine (inference/fused.py).

    The half engine's K means "K pooled-map steps + one full-res
    rectification", so its K=0 is one rectification pass, not identity.
    Scoring reuses the general search's one-trajectory trick: the scan over
    K emits the confusion matrix of rectify(x_k) at every k (one dae_core
    call per k — the rectification shares the step's core output), and eps
    is traced so the whole grid is one compiled program. ``mode`` selects
    the update rule ('score' / 'energy') — the step math is the engine's own
    helpers, so selection runs the numerics that will be deployed: score
    mode with the 'full' tail uses the FOLDED step tail exactly like
    ``make_half_refiner``'s default (fused.fold_half_tail); energy and the
    'sep' tail use the unfolded gradients.
    """
    from iterative_inference_segm.inference.fused import (
        fold_half_tail,
        folded_core_out,
        folded_step_logits,
        full_logits,
        full_rect_gradient,
        half_step_gradient,
    )
    from iterative_inference_segm.models.dae import (
        dae_core,
        dae_stem_pool_of,
        dae_tail_of,
    )
    from iterative_inference_segm.ops.conv import avg_pool

    batches = list(batches)
    # Fail the same preconditions the engine itself enforces BEFORE scoring:
    # otherwise an odd-height val set silently pools one row short here and
    # the eval refiner then rejects the searched config.
    sp = dae_stem_pool_of(dae_params)
    if sp < 1:
        raise ValueError("half-engine search requires a stem_pool>=1 DAE")
    for x, _ in batches:
        if x.shape[1] % (1 << sp) or x.shape[2] % (1 << sp):
            raise ValueError(
                f"half engine requires H, W divisible by {1 << sp}; got batch {x.shape}"
            )
    fold = mode == "score" and dae_tail_of(dae_params) == "full"

    @jax.jit
    def scan_cms(fcn_params, dae_params, eps: jax.Array, x_img: jax.Array, labels: jax.Array) -> jax.Array:
        # probs/carry/softmaxes all at compute_dtype so bf16 selection runs
        # the SAME numerics as the deployed bf16 engine (make_half_refiner
        # passes probs_dtype=state_dtype and softmaxes at the state dtype)
        y0, h = fcn_apply(
            fcn_params, x_img, return_features=h_taps, compute_dtype=compute_dtype,
            probs_dtype=compute_dtype,
        )
        from iterative_inference_segm.models.dae import precompute_bottleneck_h

        bh = precompute_bottleneck_h(
            dae_params, h, depth=depth, stem_pool=sp,
            in_hw=(x_img.shape[1] >> sp, x_img.shape[2] >> sp),
        )
        core_fn = lambda xx: dae_core(
            dae_params, xx.astype(compute_dtype), bh[2],
            depth=depth, stem_pool=sp, bottleneck_h=bh, encoder=encoder,
        )
        x0 = y0
        for _ in range(sp):
            x0 = avg_pool(x0, window=2, stride=2)

        eps_c = eps.astype(compute_dtype)

        if fold:
            fk = fold_half_tail(dae_params, encoder=encoder)
            predense_fn = lambda xx: dae_core(
                dae_params, xx.astype(compute_dtype), bh[2],
                depth=depth, stem_pool=sp, bottleneck_h=bh, encoder=encoder,
                predense=True,
            )

            def step(xc, _):
                pre, sk1 = predense_fn(xc)
                s = folded_core_out(
                    fk, pre, sk1, encoder=encoder,
                    out_hw=(int(xc.shape[1]), int(xc.shape[2])),
                ).astype(compute_dtype)
                r_full = jax.nn.softmax(full_logits(dae_params, s, y0), -1)
                y_k = y0 - eps_c * (y0 - r_full)
                cm = confusion_matrix(jnp.argmax(y_k, -1), labels, n_classes=n_classes)
                logits = folded_step_logits(fk, pre, sk1, xc, encoder=encoder)
                r = jax.nn.softmax(logits.astype(compute_dtype), -1)
                xc = xc - eps_c * (xc - r)
                return xc, cm
        else:

            def step(xc, _):
                s = core_fn(xc).astype(compute_dtype)
                y_k = y0 - eps_c * full_rect_gradient(dae_params, s, y0, mode=mode)
                cm = confusion_matrix(jnp.argmax(y_k, -1), labels, n_classes=n_classes)
                xc = xc - eps_c * half_step_gradient(
                    dae_params, core_fn, xc, mode=mode, state_dtype=compute_dtype,
                    s=s if mode == "score" else None,
                )
                return xc, cm

        _, cms = jax.lax.scan(step, x0, None, length=k_max + 1)
        return cms  # (k_max+1, C, C): row k = engine with num_steps=k

    miou = np.zeros((len(eps_grid), k_max + 1), dtype=np.float64)
    for ei, eps in enumerate(eps_grid):
        cms = None
        for x, labels in batches:
            c = scan_cms(
                fcn_params, dae_params,
                jnp.asarray(eps, jnp.float32), jnp.asarray(x), jnp.asarray(labels),
            )
            cms = c if cms is None else cms + c
        cms = jax.device_get(cms)
        for k in range(k_max + 1):
            miou[ei, k] = float(metrics_from_confusion(jnp.asarray(cms[k])).mean_iou)

    best_flat = int(np.argmax(miou))
    best_ei, best_k = divmod(best_flat, k_max + 1)
    return {
        "best_eps": float(eps_grid[best_ei]),
        "best_k": int(best_k),
        "best_miou": float(miou[best_ei, best_k]),
        "miou": miou,
    }
