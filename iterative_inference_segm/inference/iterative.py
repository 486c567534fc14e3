"""Iterative inference: refine segmentation maps by following the DAE score.

This is THE core capability of the reference (``[ref: iterative_inference.py]``,
SURVEY.md §4.3): starting from the FCN-8 softmax output ``y0``, take K small
gradient steps on the conditional energy whose score the DAE estimates,

    y_{k+1} = y_k - eps * dE/dy |_{y_k},      dE/dy ∝ (y_k - r(y_k, h)),

where ``r`` is the trained DAE conditioned on frozen FCN-8 features ``h``.

Design vs. the reference:
* The reference compiles ONE step as a ``theano.function`` and drives the K
  iterations from Python — K host<->device round-trips per batch. Here the
  whole K-step loop is a single ``lax.scan`` inside one jitted program: the
  trajectory never leaves the chip (north star, BASELINE.json:5).
* Two update rules, selected by ``mode``:
  - ``'score'``  : g = y - r(y, h). Direct Alain-Bengio score estimate; no
                   differentiation needed (one DAE forward per step).
  - ``'energy'`` : g = d/dy [ 0.5 * ||y - r(y, h)||^2 ]. Differentiates
                   through the DAE (one forward + one VJP per step) — the
                   Theano ``T.grad``-through-the-graph formulation the
                   reference uses. Both are exposed because the published
                   ablations compare them.
* ``renorm='softmax'`` re-projects iterates onto the simplex after each step
  (the reference keeps iterates as probability maps); ``'none'`` leaves the
  raw iterate (scores stay well-behaved for small eps*K).
"""

from __future__ import annotations

from typing import Callable, Mapping

import jax
import jax.numpy as jnp
from jax import lax


def _step_gradient(
    dae_fn: Callable[[jax.Array], jax.Array],
    y: jax.Array,
    *,
    mode: str,
) -> jax.Array:
    """Gradient of the refinement objective at y."""
    if mode == "score":
        return y - dae_fn(y)
    if mode == "energy":

        def energy(yy):
            r = dae_fn(yy)
            return 0.5 * jnp.sum(jnp.square(yy - r))

        return jax.grad(energy)(y)
    raise ValueError(f"unknown mode {mode!r}; expected 'score' or 'energy'")


def refinement_scan(
    dae_fn: Callable[[jax.Array], jax.Array],
    y0: jax.Array,
    *,
    eps: float | jax.Array,
    num_steps: int,
    mode: str = "score",
    renorm: str = "none",
    unroll: int | bool = 1,
) -> jax.Array:
    """Run K refinement steps as ONE on-chip ``lax.scan``; returns y_K.

    ``dae_fn`` must already close over the DAE params and the conditioning
    features ``h`` (they are loop-invariant: the FCN runs once per image,
    SURVEY.md §4.3). ``num_steps`` is static (scan length); ``eps`` may be a
    traced scalar, so (eps, K) grid search can reuse one compiled program
    across eps values.

    ``unroll`` is forwarded to ``lax.scan``. Unrolling does not fuse across
    the step's conv boundaries; the knob exists for experimentation, keep
    the default 1.
    """

    def step(y, _):
        g = _step_gradient(dae_fn, y, mode=mode)
        y = y - eps * g
        if renorm == "softmax":
            y = jax.nn.softmax(jnp.log(jnp.clip(y, 1e-8, None)), axis=-1)
        elif renorm != "none":
            raise ValueError(f"unknown renorm {renorm!r}")
        return y, None

    y_k, _ = lax.scan(step, y0, None, length=num_steps, unroll=unroll)
    return y_k


def refine_with_trajectory(
    dae_fn: Callable[[jax.Array], jax.Array],
    y0: jax.Array,
    *,
    eps: float | jax.Array,
    num_steps: int,
    mode: str = "score",
    renorm: str = "none",
) -> jax.Array:
    """Like ``refinement_scan`` but stacks every iterate: (K+1, B, H, W, C).

    Used by the (eps, K) validation search (``[ref:
    iterative_inference_valid.py]``) — evaluating all intermediate steps of
    one K_max-step run scores every K <= K_max for free — and by the PNG
    trajectory dumps the reference produces.
    """

    def step(y, _):
        g = _step_gradient(dae_fn, y, mode=mode)
        y = y - eps * g
        if renorm == "softmax":
            y = jax.nn.softmax(jnp.log(jnp.clip(y, 1e-8, None)), axis=-1)
        return y, y

    _, ys = lax.scan(step, y0, None, length=num_steps)
    return jnp.concatenate([y0[None], ys], axis=0)


def make_refiner(
    fcn_apply: Callable,
    dae_apply: Callable,
    fcn_params,
    dae_params,
    *,
    eps: float,
    num_steps: int,
    h_taps: tuple[str, ...] = ("pool4",),
    mode: str = "score",
    renorm: str = "none",
    compute_dtype=jnp.float32,
    dae_kwargs: Mapping | None = None,
) -> Callable[[jax.Array], tuple[jax.Array, jax.Array]]:
    """Build the jitted end-to-end refiner: image batch -> (y0, yK).

    One XLA program per (shape, K): FCN-8 forward (h computed once),
    ``lax.scan`` over K DAE score steps, zero host round-trips — the
    flagship configuration of BASELINE.json configs 2-3.
    """
    dae_kwargs = dict(dae_kwargs or {})
    dae_kwargs.setdefault("compute_dtype", compute_dtype)

    # params enter the jitted program as ARGUMENTS (the returned closure
    # binds them at call time): closing over them would bake the weights
    # into the executable as constants.
    @jax.jit
    def _refine(fcn_params, dae_params, x):
        y0, h = fcn_apply(
            fcn_params, x, return_features=h_taps, compute_dtype=compute_dtype
        )
        dae_fn = lambda y: dae_apply(dae_params, y, h, **dae_kwargs)
        y_k = refinement_scan(
            dae_fn, y0, eps=eps, num_steps=num_steps, mode=mode, renorm=renorm
        )
        return y0, y_k

    def refine(x: jax.Array) -> tuple[jax.Array, jax.Array]:
        return _refine(fcn_params, dae_params, x)

    return refine
