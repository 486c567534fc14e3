"""Score-network architecture registry: ONE dispatch table for the zoo.

The reference's model zoo is three builders (fcn8 / DAE_h / contextmod)
selected by string inside each workload script (SURVEY.md §3.1). Here five
surfaces serve/train/search the score networks — ``inference.Predictor``
(twice: construction and ``from_npz``), ``scripts/iterative_inference.py``,
``scripts/demo_synthetic.py``, and ``train/train_dae.py`` — and each used to
hand-copy its own ``'dae'|'mirror'|'contextmod'`` switch ladder. That is the
drift class ADVICE r2 caught in the wild (one copy of the contextmod wrapper
silently dropped ``compute_dtype`` under ``--bf16``). Every ladder now
routes through this table; adding a score network means one entry here:

* :func:`score_apply_fn`   — normalized ``(params, y, h, **kw)`` apply
* :func:`score_kwargs`     — per-step kwargs the refinement loop passes
* :func:`init_score_template` — param template (the npz load target)
* :func:`expected_meta`    — load-side ``check_npz_meta`` expectation
* :func:`checkpoint_meta`  — save-side metadata stamped by the trainer
"""

from __future__ import annotations

import jax.numpy as jnp

SCORE_ARCHS = ("dae", "mirror", "contextmod")


def validate_arch(arch: str) -> None:
    if arch not in SCORE_ARCHS:
        raise ValueError(
            f"unknown score-network arch {arch!r}; expected one of {SCORE_ARCHS}"
        )


def score_apply_fn(arch: str):
    """Normalized ``(params, y, h, **kw)`` apply for the refinement loop.

    Engines and search paths inject ``compute_dtype`` (plus the arch's
    :func:`score_kwargs`) through ``**kw``. ``contextmod_apply`` accepts
    only ``compute_dtype``, so its wrapper forwards that one and drops the
    rest — dropping ``compute_dtype`` too would silently run the score net
    in f32 under bf16 deployment (the ADVICE r2 bug this table prevents
    from recurring).
    """
    validate_arch(arch)
    if arch == "mirror":
        from iterative_inference_segm.models.dae_mirror import mirror_dae_apply

        return mirror_dae_apply
    if arch == "contextmod":
        from iterative_inference_segm.models.contextmod import contextmod_apply

        return lambda p, y, h, **kw: contextmod_apply(
            p, y, h, compute_dtype=kw.get("compute_dtype", jnp.float32)
        )
    from iterative_inference_segm.models.dae import dae_apply

    return dae_apply


def score_kwargs(arch: str, *, depth: int, encoder: str = "pool") -> dict:
    """Per-step apply kwargs the refinement machinery passes as dae_kwargs."""
    validate_arch(arch)
    if arch == "mirror":
        return {"depth": depth}
    if arch == "contextmod":
        return {}
    return {"depth": depth, "encoder": encoder}


def init_score_template(
    arch: str,
    key,
    *,
    n_classes: int,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 4,
    stem_pool: int = 0,
    tail: str = "full",
    widths: tuple[int, ...] | None = None,
    tied: bool = False,
):
    """Init the arch's param template (the load target for checkpoints).

    contextmod conditions at input scale only — any other tap would fail
    the scale check inside ``contextmod_apply`` at trace time anyway, so
    reject it here with the flag name (empty taps = unconditioned, legal).
    """
    validate_arch(arch)
    from iterative_inference_segm.models.dae import DAE_H_CHANNELS

    if arch == "contextmod":
        from iterative_inference_segm.models.contextmod import init_contextmod

        bad = [t for t in h_taps if t != "input"]
        if bad:
            raise ValueError(
                f"contextmod conditions at input scale only; got taps {bad}"
            )
        h_ch = DAE_H_CHANNELS["input"] if "input" in h_taps else 0
        return init_contextmod(key, n_classes=n_classes, h_channels=h_ch)
    h_specs = {name: DAE_H_CHANNELS[name] for name in h_taps}
    extra = {"widths": tuple(widths)} if widths else {}
    if arch == "mirror":
        from iterative_inference_segm.models.dae_mirror import init_mirror_dae

        return init_mirror_dae(
            key, n_classes=n_classes, h_specs=h_specs, depth=depth, tied=tied, **extra
        )
    from iterative_inference_segm.models.dae import init_dae

    return init_dae(
        key, n_classes=n_classes, h_specs=h_specs, depth=depth,
        stem_pool=stem_pool, tail=tail, **extra,
    )


def expected_meta(
    arch: str,
    *,
    depth: int,
    stem_pool: int = 0,
    tail: str = "full",
    widths: tuple[int, ...] | None = None,
    encoder: str = "pool",
    tied: bool = False,
) -> dict:
    """Load-side ``check_npz_meta`` expectation: the shape-invisible knobs
    that would otherwise load silently under the wrong flag (ADVICE r2).
    ``widths`` is validated only when the caller declares it (a checkpoint
    missing a declared key warns rather than failing — old exports)."""
    validate_arch(arch)
    if arch == "contextmod":
        return {"arch": "contextmod"}
    w = {"widths": tuple(widths)} if widths else {}
    if arch == "mirror":
        return {"arch": "mirror", "depth": depth, "tied": tied, **w}
    return {
        "arch": "dae", "encoder": encoder, "depth": depth,
        "stem_pool": stem_pool, "tail": tail, **w,
    }


def checkpoint_meta(
    arch: str,
    *,
    h_taps: tuple[str, ...],
    depth: int,
    stem_pool: int = 0,
    tail: str = "full",
    widths: tuple[int, ...] | None = None,
    encoder: str = "pool",
    tied: bool = False,
) -> dict:
    """Save-side twin of :func:`expected_meta`: what the trainer stamps into
    ``best_dae.npz``. Always records the resolved widths (defaulted from
    ``DEFAULT_WIDTHS``) so a later load can verify them."""
    validate_arch(arch)
    if arch == "contextmod":
        return {"arch": arch, "h": tuple(h_taps)}
    from iterative_inference_segm.models.dae import DEFAULT_WIDTHS

    resolved = tuple(widths) if widths else DEFAULT_WIDTHS[:depth]
    if arch == "mirror":
        return {
            "arch": arch, "depth": depth, "tied": tied,
            "widths": resolved, "h": tuple(h_taps),
        }
    return {
        "arch": arch, "encoder": encoder, "depth": depth,
        "stem_pool": stem_pool, "tail": tail,
        "widths": resolved, "h": tuple(h_taps),
    }
