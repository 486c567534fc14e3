"""Pipeline parallelism: GPipe-style microbatch pipelining over a mesh axis.

The reference is single-GPU (SURVEY.md §3.4), so this axis — like SP and TP
— is a rebuild extension: the fourth parallelism axis the framework ships
(DP/SP/TP/PP). Each pipeline stage runs one contiguous slice of the
network, microbatches stream through the stages, and inter-stage
activations move between devices via ``lax.ppermute``. What each variant buys differs:
``make_gpipe_stacked`` shards per-stage params P('stage') — true parameter
residency, the split for a model that does not fit on one chip — while
``make_gpipe`` (heterogeneous stages, used by ``make_pp_flagship``) keeps
params replicated (``lax.switch`` traces every branch, so stage_params
enter with in_specs P()); the flagship pipeline therefore splits compute
and activation footprint, not parameter memory.

SPMD formulation — no hand-written send/recv loops, no per-stage processes:

* ONE SPMD program over a ``'stage'`` mesh axis (``jax.shard_map``). Each
  device picks its stage's computation with ``lax.switch`` on
  ``lax.axis_index('stage')`` (heterogeneous stages) or by slicing its own
  shard of stage-stacked params (``make_gpipe_stacked`` — homogeneous
  stages, true per-stage parameter residency).
* The GPipe schedule is a single ``lax.scan`` over T = M + S - 1 ticks
  (M microbatches, S stages). Per tick every stage runs once and hands its
  output wire to the next stage with one ``ppermute`` — the classic bubble
  of (S-1)/T idle ticks, amortized by M.
* The backward pass needs no second schedule: ``jax.grad`` of the whole
  pipelined function reverse-pipelines automatically, because the
  transpose of ``ppermute`` is the inverse ``ppermute`` and the transpose
  of ``lax.scan`` runs ticks backwards. Training through a pipeline is
  ``jax.grad(pipeline_loss)`` — tested equal to the sequential gradient in
  tests/test_pp.py.
* Emitted results stay sharded: the last stage's outputs are returned via
  an ``out_specs`` entry over the stage axis, so collecting them costs no
  collective (callers slice the last stage's shard).

Data-flow contract (``make_gpipe``): the per-microbatch INPUT stream and
the inter-stage WIRE are separate pytrees. The stream is replicated across
the stage axis (sharded only over the optional DP axis), so stage-0 inputs
never ride the ppermute; only the wire — the activations the stages
actually exchange, a SINGLE fixed pytree format because SPMD programs
cannot permute shape-heterogeneous buffers — crosses devices each tick. Every
stage function receives both ``(wire, inp)``: stage 0 reads ``inp`` and
ignores its (zero) wire, later stages read the wire and may consult
``inp``'s static shape. ``make_gpipe_stacked`` (homogeneous layers) keeps
the classic uniform format where the stream IS the wire format and the
combinator injects it at stage 0 — there is no dead payload in that case
by construction.

Composes with DP: build the mesh with both axes, e.g.
``make_mesh(('data', 'stage'), (2, 2))``, pass ``batch_axis='data'``, and
shard the microbatch batch dim over 'data' as usual.

Reference semantics: none to mirror — ``[ref: SURVEY.md §3.4]`` records the
reference has no multi-device path at all; the pipeline split of the
flagship (FCN-8 forward | K-step pooled refinement + rectification) follows
the model's own two-subnetwork structure (fcn8_build | buildDAE + the
iterative_inference loop, SURVEY.md §4.3).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def split_microbatches(tree, num_microbatches: int):
    """Leaves (B, ...) -> (M, B/M, ...). B must divide evenly."""

    def split(a):
        b = a.shape[0]
        if b % num_microbatches:
            raise ValueError(
                f"batch {b} not divisible by num_microbatches {num_microbatches}"
            )
        return a.reshape((num_microbatches, b // num_microbatches) + a.shape[1:])

    return jax.tree.map(split, tree)


def merge_microbatches(tree):
    """Inverse of ``split_microbatches``: (M, Bm, ...) -> (M*Bm, ...)."""
    return jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), tree)


def _specs(
    tree,
    batch_axis: str | None,
    *,
    lead_axes: tuple[str | None, ...],
    validate: bool = True,
):
    """Per-leaf PartitionSpecs: ``lead_axes`` for the leading dims, then the
    per-microbatch batch dim over ``batch_axis`` (the DP composition).
    ``validate=False`` for OUT specs built from an input-shaped template
    (the emitted leaves carry extra stage/tick dims the template lacks)."""
    lead = len(lead_axes)

    def spec(a):
        if validate and jnp.ndim(a) < lead + 1:
            raise ValueError(
                f"pipeline leaves need at least {lead + 1} dims "
                f"(…, batch, features); got rank {jnp.ndim(a)}"
            )
        return P(*lead_axes, batch_axis)

    return jax.tree.map(spec, tree)


def _check_stage_axis(mesh: Mesh, stage_axis: str):
    if stage_axis not in mesh.shape:
        raise ValueError(
            f"mesh {dict(mesh.shape)} has no '{stage_axis}' axis — pipeline "
            f"meshes need one, e.g. make_mesh(('data', '{stage_axis}'), (n, 2))"
        )
    return mesh.shape[stage_axis]


def _gpipe_schedule(
    run_stage: Callable,
    stream,
    wire0,
    *,
    stage_axis: str,
    num_stages: int,
    num_microbatches: int,
    remat: bool = False,
):
    """The per-device GPipe schedule (runs inside shard_map).

    ``run_stage(wire, inp) -> wire`` already dispatches on this device's
    stage. ``stream``: (M, Bm, ...) leaves, replicated over the stage axis;
    ``wire0``: the zero initial wire, (Bm, ...) leaves. Returns the
    per-device emit stream with a leading singleton stage dim,
    (1, T, Bm, ...), for an out_spec over ``stage_axis``.

    ``remat``: checkpoint each tick's stage compute so the scan transpose
    (the reverse pipeline) recomputes activations from the tick's input
    wire. ``prevent_cse=False`` because the checkpoint sits inside a
    ``lax.scan`` body, where the CSE-prevention barriers are unnecessary
    overhead (per the jax.checkpoint contract).
    """
    if remat:
        run_stage = jax.checkpoint(run_stage, prevent_cse=False)
    s = num_stages
    m = num_microbatches
    t_total = m + s - 1

    def pad(a):
        if t_total == m:
            return a
        z = jnp.zeros((t_total - m,) + a.shape[1:], a.dtype)
        return jnp.concatenate([a, z], axis=0)

    stream = jax.tree.map(pad, stream)
    perm = [(i, i + 1) for i in range(s - 1)]

    def tick(carry, inp):
        out = run_stage(carry, inp)
        # hand each stage's wire to its successor; stage 0 receives zeros
        # (ppermute semantics for unlisted destinations), matching its role
        # as the stream reader
        if perm:
            nxt = jax.tree.map(lambda a: lax.ppermute(a, stage_axis, perm), out)
        else:
            nxt = out
        return nxt, out

    _, emits = lax.scan(tick, wire0, stream)
    return jax.tree.map(lambda a: a[None], emits)


def _collect_last_stage(stacked, *, num_stages: int, num_microbatches: int):
    """(S, T, Bm, ...) -> the last stage's M valid emits (ticks S-1..T-1)."""
    s = num_stages
    return jax.tree.map(
        lambda a: a[s - 1, s - 1 : s - 1 + num_microbatches], stacked
    )


def make_gpipe(
    stage_fns: Sequence[Callable],
    mesh: Mesh,
    *,
    stage_axis: str = "stage",
    batch_axis: str | None = None,
    remat: bool = False,
) -> Callable:
    """Heterogeneous-stage pipeline:
    ``pipeline(stage_params, stream, wire0) -> wires``.

    ``remat=True`` wraps each tick's stage compute in ``jax.checkpoint``:
    the reverse pipeline then recomputes a tick's activations from its
    input wire instead of storing every tick's internals — the standard
    memory/FLOP trade for pipelined TRAINING, where the T = M + S − 1
    ticks would otherwise each hold a full stage's residuals.

    ``stage_fns[i](stage_params[i], wire, inp) -> wire`` — ``inp`` is the
    per-microbatch stream element (stage 0's input; later stages may use
    its static shape), ``wire`` the inter-stage pytree every stage emits in
    the same format. ``stage_params`` is a tuple of per-stage pytrees,
    replicated across the mesh (``lax.switch`` traces every branch on every
    device, so heterogeneous params cannot be stage-resident; use
    ``make_gpipe_stacked`` for homogeneous stages when per-stage parameter
    residency is the point). ``stream`` leaves are (M, Bm, ...); ``wire0``
    is the zero initial wire with (Bm, ...) leaves — build with
    ``jnp.zeros`` from the stage-0 output shapes. The microbatch batch dim
    of both is optionally sharded over ``batch_axis`` (DP×PP). Returns
    wires of (M, Bm, ...) layout holding the last stage's outputs.
    """
    num_stages = _check_stage_axis(mesh, stage_axis)
    if len(stage_fns) != num_stages:
        raise ValueError(
            f"{len(stage_fns)} stage fns for a {num_stages}-wide '{stage_axis}' axis"
        )

    def pipeline(stage_params, stream, wire0):
        m = jax.tree.leaves(stream)[0].shape[0]

        def spmd(stage_params, stream, wire0):
            def run_stage(wire, inp):
                branches = [
                    lambda w, x, i=i: stage_fns[i](stage_params[i], w, x)
                    for i in range(num_stages)
                ]
                return lax.switch(lax.axis_index(stage_axis), branches, wire, inp)

            return _gpipe_schedule(
                run_stage,
                stream,
                wire0,
                stage_axis=stage_axis,
                num_stages=num_stages,
                num_microbatches=m,
                remat=remat,
            )

        stacked = shard_map(
            spmd,
            mesh=mesh,
            in_specs=(
                P(),
                _specs(stream, batch_axis, lead_axes=(None,)),
                _specs(wire0, batch_axis, lead_axes=()),
            ),
            out_specs=_specs(wire0, batch_axis, lead_axes=(stage_axis, None), validate=False),
            check_vma=False,
        )(stage_params, stream, wire0)
        return _collect_last_stage(
            stacked, num_stages=num_stages, num_microbatches=m
        )

    return pipeline


def make_gpipe_stacked(
    stage_fn: Callable,
    mesh: Mesh,
    *,
    stage_axis: str = "stage",
    batch_axis: str | None = None,
    remat: bool = False,
) -> Callable:
    """Homogeneous-stage pipeline with per-stage parameter residency:
    ``pipeline(stage_params, wires) -> wires``.

    ``stage_fn(params_i, wire) -> wire`` is ONE function over a uniform
    format (the stream IS the wire format — the combinator injects each
    microbatch at stage 0, so unlike ``make_gpipe`` there is no separate
    stream pytree and no dead ppermute payload by construction).
    ``stage_params`` leaves carry a leading stage dim (S, ...) and are
    sharded over ``stage_axis`` — each device materializes only its own
    stage's slice (the memory split that makes PP worth running: a model
    too big for one chip's HBM lives S-ways sharded). The scan-over-layers
    dual: where ``lax.scan`` runs stacked layers in time on one chip, this
    runs them in space across chips with microbatches in flight.
    """
    num_stages = _check_stage_axis(mesh, stage_axis)

    def pipeline(stage_params, wires):
        m = jax.tree.leaves(wires)[0].shape[0]
        for leaf in jax.tree.leaves(stage_params):
            if leaf.shape[0] != num_stages:
                raise ValueError(
                    f"stacked stage params need leading dim {num_stages}; got {leaf.shape}"
                )

        def spmd(stage_params, wires):
            local = jax.tree.map(lambda a: a[0], stage_params)
            idx = lax.axis_index(stage_axis)

            def run_stage(wire, inp):
                # uniform format: stage 0 swaps in the streamed microbatch
                wire_in = jax.tree.map(
                    lambda a, b: jnp.where(idx == 0, a, b), inp, wire
                )
                return stage_fn(local, wire_in)

            wire0 = jax.tree.map(lambda a: jnp.zeros(a.shape[1:], a.dtype), wires)
            return _gpipe_schedule(
                run_stage,
                wires,
                wire0,
                stage_axis=stage_axis,
                num_stages=num_stages,
                num_microbatches=m,
                remat=remat,
            )

        stacked = shard_map(
            spmd,
            mesh=mesh,
            in_specs=(P(stage_axis), _specs(wires, batch_axis, lead_axes=(None,))),
            out_specs=_specs(wires, batch_axis, lead_axes=(stage_axis, None), validate=False),
            check_vma=False,
        )(stage_params, wires)
        return _collect_last_stage(
            stacked, num_stages=num_stages, num_microbatches=m
        )

    return pipeline


def make_pp_flagship(
    mesh: Mesh,
    *,
    eps: float,
    num_steps: int,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 3,
    compute_dtype=jnp.bfloat16,
    state_dtype=None,
    encoder: str = "pool",
    mode: str = "score",
    fold_tail: bool | None = None,
    engine: str = "half",
    renorm: str = "none",
    dae_arch: str = "dae",
    stage_axis: str = "stage",
    batch_axis: str | None = None,
    fcn_apply: Callable | None = None,
) -> Callable:
    """The flagship pipeline split at the model's natural seams.

    The split depth follows the mesh: a size-2 ``stage_axis`` splits
    FCN-8 forward | pooled refinement; size 3 splits VGG backbone |
    FCN-8 head | pooled refinement (``models.fcn8.fcn8_backbone`` /
    ``fcn8_head`` — the deeper split balances the backbone's ~2/3 of the
    FLOPs against the fc6-heavy head). ``engine`` picks the refinement
    stage's loop: 'half' (default) routes through the SAME
    ``halfres_refine`` path every other surface uses (inference/fused.py);
    'general' runs the reference-semantics full-resolution
    ``refinement_scan`` (inference/iterative.py) and serves all three
    score-network architectures (``dae_arch``, registry-dispatched) with
    the ``renorm`` knob. Either way the pipelined numerics are the
    sequential engine's numerics by construction (tested in
    tests/test_pp.py). The
    permuted wire carries only downstream-consumed activations ({y0,
    h-taps, yK}, plus the pool3/4/5 maps between backbone and head in the
    3-stage split — pool3/pool5 ride the head→refine hop unconsumed, the
    price of the SPMD uniform wire); the image stream stays out of the
    ppermute (``make_gpipe`` data-flow contract). The 3-stage split
    conditions the DAE from backbone taps only (``h_taps`` ⊆
    pool3/pool4/pool5, read straight from the wire's pool slots).

    Returns ``forward(fcn_params, dae_params, images) -> (y0, y_k)`` where
    ``images`` is (M, Bm, H, W, 3) — microbatches streaming through the
    stages (``split_microbatches`` to build); compose with DP over
    ``batch_axis``.
    """
    n_stages = _check_stage_axis(mesh, stage_axis)
    if n_stages not in (2, 3):
        raise ValueError(
            f"the flagship pipeline splits 2 or 3 ways; mesh axis "
            f"'{stage_axis}' has size {n_stages}"
        )
    if fcn_apply is None:
        from iterative_inference_segm.models.fcn8 import fcn8_apply as fcn_apply

    if engine == "half":
        from iterative_inference_segm.inference.fused import halfres_refine

        if dae_arch != "dae":
            raise ValueError("engine='half' pipelines dae_arch='dae' only")
        if renorm != "none":
            raise ValueError(
                "renorm is a general-engine knob (the pooled engine's update "
                "has no renormalization step); pass engine='general'"
            )
        probs_dtype = state_dtype or compute_dtype

        def refine(dae_params, y0, h, in_hw):
            return halfres_refine(
                dae_params,
                y0,
                h,
                in_hw,
                eps=eps,
                num_steps=num_steps,
                depth=depth,
                compute_dtype=compute_dtype,
                state_dtype=state_dtype,
                encoder=encoder,
                mode=mode,
                fold_tail=fold_tail,
            )

    elif engine == "general":
        # the reference-semantics loop (every step at full resolution,
        # inference/iterative.py) behind the same pipeline seams; serves
        # all three score-network architectures via the registry
        from iterative_inference_segm.inference.iterative import refinement_scan
        from iterative_inference_segm.models.registry import (
            score_apply_fn,
            score_kwargs,
        )

        if state_dtype is not None or fold_tail is not None:
            raise ValueError(
                "state_dtype/fold_tail are pooled-engine knobs; the general "
                "engine carries f32 full-res state with the unfolded tail"
            )
        s_apply = score_apply_fn(dae_arch)
        s_kw = dict(score_kwargs(dae_arch, depth=depth, encoder=encoder))
        s_kw["compute_dtype"] = compute_dtype
        probs_dtype = jnp.float32  # the general engine's parity convention

        def refine(dae_params, y0, h, in_hw):
            dae_fn = lambda y: s_apply(dae_params, y, h, **s_kw)
            return refinement_scan(
                dae_fn, y0, eps=eps, num_steps=num_steps, mode=mode, renorm=renorm
            )

    else:
        raise ValueError(f"unknown engine {engine!r}; expected 'half' or 'general'")

    def zeros_like_struct(s):
        return jnp.zeros(s.shape, s.dtype)

    if n_stages == 2:

        def fcn_fwd(fcn_params, x):
            return fcn_apply(
                fcn_params,
                x,
                return_features=h_taps,
                compute_dtype=compute_dtype,
                probs_dtype=probs_dtype,
            )

        def stage0(fcn_params, wire, x):
            y0, h = fcn_fwd(fcn_params, x)
            return {**wire, "y0": y0, "h": h}

        def stage1(dae_params, wire, x):
            y_k = refine(
                dae_params, wire["y0"], wire["h"], (x.shape[1], x.shape[2])
            )
            return {**wire, "yk": y_k}

        stage_fns = (stage0, stage1)

        def make_wire0(fcn_params, mb):
            y0_s, h_s = jax.eval_shape(fcn_fwd, fcn_params, mb)
            return {
                "y0": zeros_like_struct(y0_s),
                "h": jax.tree.map(zeros_like_struct, h_s),
                "yk": zeros_like_struct(y0_s),
            }

        def stage_params_of(fcn_params, dae_params):
            return (fcn_params, dae_params)

    else:
        from iterative_inference_segm.models.fcn8 import (
            fcn8_backbone,
            fcn8_head,
        )

        if not set(h_taps) <= {"pool3", "pool4", "pool5"}:
            raise ValueError(
                "the 3-stage flagship pipeline conditions the DAE from the "
                f"backbone's pool taps (pool3/pool4/pool5); got {h_taps!r}"
            )

        def stage0(fcn_params, wire, x):
            pools, _ = fcn8_backbone(fcn_params, x, compute_dtype=compute_dtype)
            return {**wire, "pools": pools}

        def stage1(fcn_params, wire, x):
            y0, _ = fcn8_head(
                fcn_params,
                wire["pools"],
                (x.shape[1], x.shape[2]),
                probs_dtype=probs_dtype,
            )
            return {**wire, "y0": y0}

        def stage2(dae_params, wire, x):
            h = {t: wire["pools"][t] for t in h_taps}
            y_k = refine(dae_params, wire["y0"], h, (x.shape[1], x.shape[2]))
            return {**wire, "yk": y_k}

        stage_fns = (stage0, stage1, stage2)

        def make_wire0(fcn_params, mb):
            pools_s, _ = jax.eval_shape(
                lambda p, x: fcn8_backbone(p, x, compute_dtype=compute_dtype),
                fcn_params,
                mb,
            )
            y0_s, _ = jax.eval_shape(
                lambda p, pl: fcn8_head(
                    p, pl, (mb.shape[1], mb.shape[2]), probs_dtype=probs_dtype
                ),
                fcn_params,
                pools_s,
            )
            return {
                "pools": jax.tree.map(zeros_like_struct, pools_s),
                "y0": zeros_like_struct(y0_s),
                "yk": zeros_like_struct(y0_s),
            }

        def stage_params_of(fcn_params, dae_params):
            # the two FCN stages reference the same pytree — the same device
            # buffers, no duplication
            return (fcn_params, fcn_params, dae_params)

    pipeline = make_gpipe(
        stage_fns, mesh, stage_axis=stage_axis, batch_axis=batch_axis
    )

    def forward(fcn_params, dae_params, images):
        if images.ndim != 5:
            raise ValueError(
                f"images must be (M, Bm, H, W, 3) microbatches; got {images.shape}"
            )
        wire0 = make_wire0(fcn_params, images[0])
        out = pipeline(stage_params_of(fcn_params, dae_params), images, wire0)
        return out["y0"], out["yk"]

    return forward
