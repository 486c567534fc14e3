"""Pipeline-parallelism tests on the faked 8-device CPU mesh (SURVEY.md §5).

Correctness contract of parallel/pp.py: the GPipe schedule (shard_map +
scan-over-ticks + ppermute hand-off) computes EXACTLY the sequential
composition of its stages, for any microbatch count, for heterogeneous
(lax.switch) and homogeneous-stacked (per-stage param residency) stages,
composed with DP, and under jax.grad (the transposed schedule is the
reverse pipeline).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from iterative_inference_segm.models import init_fcn8
from iterative_inference_segm.models.dae import DAE_H_CHANNELS, init_dae
from iterative_inference_segm.inference.fused import flagship_forward_fn
from iterative_inference_segm.parallel import (
    make_gpipe,
    make_gpipe_stacked,
    make_mesh,
    make_pp_flagship,
    merge_microbatches,
    split_microbatches,
)

C = 5


def _two_stages():
    k0 = jax.random.normal(jax.random.PRNGKey(0), (4, 4))
    k1 = jax.random.normal(jax.random.PRNGKey(1), (4, 4))

    # make_gpipe data-flow contract: stage 0 reads the stream element,
    # later stages read the permuted wire
    def s0(p, w, x):
        return {**w, "a": jnp.tanh(x["a"] @ p)}

    def s1(p, w, x):
        return {**w, "a": w["a"] @ p + 1.0}

    def seq(params, x):
        return jnp.tanh(x @ params[0]) @ params[1] + 1.0

    return (k0, k1), (s0, s1), seq


def _wire0(x):
    return {"a": jnp.zeros(x.shape[1:], x.dtype)}


def test_microbatch_split_merge_roundtrip(cpu_devices):
    x = jnp.arange(24.0).reshape(12, 2)
    xm = split_microbatches(x, 4)
    assert xm.shape == (4, 3, 2)
    np.testing.assert_array_equal(np.asarray(merge_microbatches(xm)), np.asarray(x))


def test_gpipe_heterogeneous_matches_sequential(cpu_devices):
    params, (s0, s1), seq = _two_stages()
    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    pipe = make_gpipe((s0, s1), mesh)
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 3, 4))
    out = jax.jit(pipe)(params, {"a": x}, _wire0(x))
    np.testing.assert_allclose(
        np.asarray(out["a"]), np.asarray(seq(params, x)), rtol=1e-5
    )


def test_gpipe_single_microbatch_and_many(cpu_devices):
    """The schedule is valid at every bubble ratio: M=1 (pure bubble) and
    M >> S both reduce to the sequential composition."""
    params, (s0, s1), seq = _two_stages()
    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    pipe = make_gpipe((s0, s1), mesh)
    for m in (1, 7):
        x = jax.random.normal(jax.random.PRNGKey(m), (m, 2, 4))
        out = jax.jit(pipe)(params, {"a": x}, _wire0(x))
        np.testing.assert_allclose(
            np.asarray(out["a"]), np.asarray(seq(params, x)), rtol=1e-5
        )


def test_gpipe_stage_count_mismatch_raises(cpu_devices):
    params, (s0, s1), _ = _two_stages()
    mesh = make_mesh(("stage",), (4,), devices=jax.devices()[:4])
    try:
        make_gpipe((s0, s1), mesh)
        raise AssertionError("expected ValueError on 2 fns over a 4-wide axis")
    except ValueError as e:
        assert "stage" in str(e)


def test_gpipe_missing_stage_axis_raises(cpu_devices):
    """Passing a plain DP mesh (no 'stage' axis) — the likeliest misuse of
    the pp API — must raise a self-explanatory ValueError, not a KeyError."""
    from iterative_inference_segm.parallel import make_pp_flagship

    params, (s0, s1), _ = _two_stages()
    mesh = make_mesh(("data",), devices=jax.devices()[:2])
    for build in (
        lambda: make_gpipe((s0, s1), mesh),
        lambda: make_gpipe_stacked(s0, mesh),
        lambda: make_pp_flagship(mesh, eps=0.1, num_steps=2),
    ):
        try:
            build()
            raise AssertionError("expected ValueError on a mesh without 'stage'")
        except ValueError as e:
            assert "no 'stage' axis" in str(e)


def test_gpipe_stacked_matches_sequential(cpu_devices):
    """Homogeneous 4-stage pipeline with stage-stacked params (each device
    holds only its own slice — P('stage') in_spec)."""
    mesh = make_mesh(("stage",), (4,), devices=jax.devices()[:4])
    ks = jax.random.normal(jax.random.PRNGKey(3), (4, 4, 4))

    def stage(p, w):
        return {**w, "a": jnp.tanh(w["a"] @ p)}

    def seq(ps, a):
        for i in range(4):
            a = jnp.tanh(a @ ps[i])
        return a

    pipe = make_gpipe_stacked(stage, mesh)
    x = jax.random.normal(jax.random.PRNGKey(4), (6, 2, 4))
    out = jax.jit(pipe)(ks, {"a": x})
    np.testing.assert_allclose(
        np.asarray(out["a"]), np.asarray(seq(ks, x)), rtol=1e-5, atol=1e-6
    )


def test_gpipe_grad_matches_sequential(cpu_devices):
    """jax.grad through the pipelined schedule == sequential gradient: the
    ppermute/scan transposes implement the reverse pipeline for free."""
    mesh = make_mesh(("stage",), (4,), devices=jax.devices()[:4])
    ks = jax.random.normal(jax.random.PRNGKey(3), (4, 4, 4))

    def stage(p, w):
        return {**w, "a": jnp.tanh(w["a"] @ p)}

    def seq(ps, a):
        for i in range(4):
            a = jnp.tanh(a @ ps[i])
        return a

    pipe = make_gpipe_stacked(stage, mesh)
    x = jax.random.normal(jax.random.PRNGKey(4), (6, 2, 4))
    g_pipe = jax.jit(jax.grad(lambda ps: jnp.sum(pipe(ps, {"a": x})["a"] ** 2)))(ks)
    g_ref = jax.jit(jax.grad(lambda ps: jnp.sum(seq(ps, x) ** 2)))(ks)
    np.testing.assert_allclose(
        np.asarray(g_pipe), np.asarray(g_ref), rtol=1e-4, atol=1e-5
    )


def _flagship_pair():
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(
        jax.random.PRNGKey(1),
        n_classes=C,
        h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
        depth=3,
        stem_pool=1,
    )
    return fcn, dae


def test_pp_flagship_matches_sequential(cpu_devices):
    """2-stage flagship pipeline (FCN forward | pooled refinement) ==
    flagship_forward_fn on the same params, both y0 and y_K."""
    fcn, dae = _flagship_pair()
    x = jax.random.normal(jax.random.PRNGKey(2), (8, 64, 64, 3))
    seq = flagship_forward_fn(num_steps=3, depth=3, eps=0.1, compute_dtype=jnp.float32)
    y0_ref, yk_ref = jax.jit(seq)(fcn, dae, x)

    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    pp = make_pp_flagship(mesh, eps=0.1, num_steps=3, depth=3, compute_dtype=jnp.float32)
    y0, yk = jax.jit(pp)(fcn, dae, split_microbatches(x, 4))
    np.testing.assert_allclose(
        np.asarray(merge_microbatches(y0)), np.asarray(y0_ref), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(merge_microbatches(yk)), np.asarray(yk_ref), rtol=1e-5, atol=1e-6
    )


def test_pp_flagship_composes_with_dp(cpu_devices):
    """('data', 'stage') mesh: microbatch batch dim sharded over DP while
    stages pipeline over 'stage' — same numerics."""
    fcn, dae = _flagship_pair()
    x = jax.random.normal(jax.random.PRNGKey(2), (8, 64, 64, 3))
    seq = flagship_forward_fn(num_steps=3, depth=3, eps=0.1, compute_dtype=jnp.float32)
    _, yk_ref = jax.jit(seq)(fcn, dae, x)

    mesh = make_mesh(("data", "stage"), (2, 2), devices=jax.devices()[:4])
    pp = make_pp_flagship(
        mesh, eps=0.1, num_steps=3, depth=3, compute_dtype=jnp.float32,
        batch_axis="data",
    )
    _, yk = jax.jit(pp)(fcn, dae, split_microbatches(x, 4))
    np.testing.assert_allclose(
        np.asarray(merge_microbatches(yk)), np.asarray(yk_ref), rtol=1e-5, atol=1e-6
    )


def test_pp_flagship_wrong_stage_width_raises(cpu_devices):
    mesh = make_mesh(("stage",), (4,), devices=jax.devices()[:4])
    try:
        make_pp_flagship(mesh, eps=0.1, num_steps=3)
        raise AssertionError("expected ValueError on a 4-wide stage axis")
    except ValueError as e:
        assert "2 or 3" in str(e)


def test_pp_flagship_three_stage_matches_sequential(cpu_devices):
    """Size-3 stage axis selects the deeper split (VGG backbone | FCN-8
    head | pooled refinement, via fcn8_backbone/fcn8_head) — same numerics
    as the sequential flagship."""
    fcn, dae = _flagship_pair()
    x = jax.random.normal(jax.random.PRNGKey(7), (6, 64, 64, 3))
    seq = flagship_forward_fn(num_steps=3, depth=3, eps=0.1, compute_dtype=jnp.float32)
    y0_ref, yk_ref = jax.jit(seq)(fcn, dae, x)

    mesh = make_mesh(("stage",), (3,), devices=jax.devices()[:3])
    pp = make_pp_flagship(mesh, eps=0.1, num_steps=3, depth=3, compute_dtype=jnp.float32)
    y0, yk = jax.jit(pp)(fcn, dae, split_microbatches(x, 3))
    np.testing.assert_allclose(
        np.asarray(merge_microbatches(y0)), np.asarray(y0_ref), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(merge_microbatches(yk)), np.asarray(yk_ref), rtol=1e-5, atol=1e-6
    )


def test_pp_flagship_three_stage_rejects_head_taps(cpu_devices):
    mesh = make_mesh(("stage",), (3,), devices=jax.devices()[:3])
    try:
        make_pp_flagship(mesh, eps=0.1, num_steps=3, h_taps=("fc7",))
        raise AssertionError("expected ValueError on a head tap in 3-stage pp")
    except ValueError as e:
        assert "pool" in str(e)


def test_pp_flagship_grad_matches_sequential(cpu_devices):
    """Training THROUGH the pipelined flagship: the gradient of a loss on
    y_K w.r.t. the DAE params equals the sequential flagship's gradient —
    the reverse pipeline (ppermute/scan transposes) is exact on the real
    model, not just toy stages."""
    fcn, dae = _flagship_pair()
    x = jax.random.normal(jax.random.PRNGKey(5), (4, 64, 64, 3))
    seq = flagship_forward_fn(num_steps=2, depth=3, eps=0.1, compute_dtype=jnp.float32)

    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    pp = make_pp_flagship(mesh, eps=0.1, num_steps=2, depth=3, compute_dtype=jnp.float32)
    xm = split_microbatches(x, 2)

    def loss_seq(dae_p):
        _, yk = seq(fcn, dae_p, x)
        return jnp.mean(jnp.square(yk))

    def loss_pp(dae_p):
        _, yk = pp(fcn, dae_p, xm)
        return jnp.mean(jnp.square(merge_microbatches(yk)))

    g_seq = jax.jit(jax.grad(loss_seq))(dae)
    g_pp = jax.jit(jax.grad(loss_pp))(dae)
    for a, b in zip(jax.tree.leaves(g_seq), jax.tree.leaves(g_pp)):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-4, atol=1e-6
        )


@pytest.mark.parametrize(
    "kw",
    [
        {"stem_pool": 2},            # quarter engine through the pipeline
        {"mode": "energy"},          # grad-through-the-DAE update per step
        {"encoder": "stride"},       # strided-conv encoder (no core skip)
    ],
    ids=["quarter", "energy", "stride"],
)
def test_pp_flagship_engine_variants_match_sequential(cpu_devices, kw):
    """Every pooled-engine variant the flagship serves (quarter iteration
    scale, energy mode, stride encoder) routes through the same
    halfres_refine inside the pipeline — each must equal its sequential
    counterpart."""
    stem_pool = kw.pop("stem_pool", 1)
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(
        jax.random.PRNGKey(1), n_classes=C,
        h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3,
        stem_pool=stem_pool,
    )
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 64, 64, 3))
    seq = flagship_forward_fn(
        num_steps=2, depth=3, eps=0.1, compute_dtype=jnp.float32,
        fold_tail=None, **kw,
    )
    _, yk_ref = jax.jit(seq)(fcn, dae, x)

    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    pp = make_pp_flagship(
        mesh, eps=0.1, num_steps=2, depth=3, compute_dtype=jnp.float32, **kw
    )
    _, yk = jax.jit(pp)(fcn, dae, split_microbatches(x, 2))
    np.testing.assert_allclose(
        np.asarray(merge_microbatches(yk)), np.asarray(yk_ref),
        rtol=1e-5, atol=1e-6,
    )


def test_gpipe_stacked_composes_with_dp(cpu_devices):
    """Stage-stacked params under a ('data','stage') mesh: per-stage
    residency and batch sharding at once."""
    mesh = make_mesh(("data", "stage"), (2, 2), devices=jax.devices()[:4])
    ks = jax.random.normal(jax.random.PRNGKey(3), (2, 4, 4))

    def stage(p, w):
        return {**w, "a": jnp.tanh(w["a"] @ p)}

    def seq(ps, a):
        for i in range(2):
            a = jnp.tanh(a @ ps[i])
        return a

    pipe = make_gpipe_stacked(stage, mesh, batch_axis="data")
    x = jax.random.normal(jax.random.PRNGKey(4), (3, 4, 4))  # M=3, Bm=4
    out = jax.jit(pipe)(ks, {"a": x})
    np.testing.assert_allclose(
        np.asarray(out["a"]), np.asarray(seq(ks, x)), rtol=1e-5, atol=1e-6
    )


def test_pp_flagship_bf16_matches_sequential(cpu_devices):
    """The benched dtype path (bf16 compute/state, folded tail) through the
    pipeline is BIT-identical to the sequential flagship: same ops in the
    same order, only the device placement differs."""
    fcn, dae = _flagship_pair()
    x = jax.random.normal(jax.random.PRNGKey(6), (4, 64, 64, 3))
    seq = flagship_forward_fn(num_steps=3, depth=3, eps=0.1)  # bf16 defaults
    _, yk_ref = jax.jit(seq)(fcn, dae, x)

    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    pp = make_pp_flagship(mesh, eps=0.1, num_steps=3, depth=3)
    _, yk = jax.jit(pp)(fcn, dae, split_microbatches(x, 2))
    np.testing.assert_array_equal(
        np.asarray(merge_microbatches(yk).astype(jnp.float32)),
        np.asarray(yk_ref.astype(jnp.float32)),
    )


def test_pp_flagship_general_engine_matches_sequential(cpu_devices):
    """engine='general' pipelines the reference-semantics full-resolution
    refinement_scan — equal to the sequential make_refiner path."""
    from iterative_inference_segm.inference import make_refiner
    from iterative_inference_segm.models import fcn8_apply
    from iterative_inference_segm.models.registry import score_apply_fn

    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(
        jax.random.PRNGKey(1), n_classes=C,
        h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=4,
    )
    x = jax.random.normal(jax.random.PRNGKey(8), (4, 64, 64, 3))

    seq = make_refiner(
        fcn8_apply, score_apply_fn("dae"), fcn, dae,
        eps=0.1, num_steps=3, h_taps=("pool4",), mode="score",
        compute_dtype=jnp.float32, dae_kwargs={"depth": 4},
    )
    y0_ref, yk_ref = seq(x)

    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    pp = make_pp_flagship(
        mesh, eps=0.1, num_steps=3, depth=4, compute_dtype=jnp.float32,
        engine="general",
    )
    y0, yk = jax.jit(pp)(fcn, dae, split_microbatches(x, 2))
    np.testing.assert_allclose(
        np.asarray(merge_microbatches(y0)), np.asarray(y0_ref), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(merge_microbatches(yk)), np.asarray(yk_ref), rtol=1e-5, atol=1e-6
    )


def test_pp_flagship_inert_knob_validation(cpu_devices):
    """Engine-specific knobs error loudly instead of being silently dropped
    (renorm is general-only; state_dtype/fold_tail are pooled-only)."""
    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="renorm"):
        make_pp_flagship(mesh, eps=0.1, num_steps=2, renorm="softmax")
    with pytest.raises(ValueError, match="pooled-engine knobs"):
        make_pp_flagship(
            mesh, eps=0.1, num_steps=2, engine="general", fold_tail=True
        )


def test_pp_steady_state_comm_is_one_ppermute_per_tick(cpu_devices):
    """Communication contract of the schedule: the compiled while-loop body
    (the steady-state tick) contains exactly ONE collective-permute — the
    wire hand-off — and no all-reduce/all-gather. Result collection outside
    the loop may move the last stage's shard (epilogue, not per-tick)."""
    params, (s0, s1), _ = _two_stages()
    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    pipe = make_gpipe((s0, s1), mesh)
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 3, 4))
    hlo = (
        jax.jit(pipe)
        .lower(params, {"a": x}, _wire0(x))
        .compile()
        .as_text()
    )
    body_lines = [l for l in hlo.splitlines() if "while/body" in l]
    assert sum("collective-permute(" in l for l in body_lines) == 1, body_lines
    assert not any("all-reduce(" in l for l in body_lines), body_lines
    assert not any("all-gather(" in l for l in body_lines), body_lines


def test_pp_general_serves_mirror_arch(cpu_devices):
    """The reference-parity mirror DAE through the pipeline (engine=
    'general', dae_arch='mirror') equals its sequential make_refiner run —
    a reference user's exact architecture serves pipelined."""
    from iterative_inference_segm.inference import make_refiner
    from iterative_inference_segm.models import fcn8_apply
    from iterative_inference_segm.models.registry import (
        init_score_template,
        score_apply_fn,
    )

    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    mirror = init_score_template(
        "mirror", jax.random.PRNGKey(1), n_classes=C, depth=4
    )
    x = jax.random.normal(jax.random.PRNGKey(9), (4, 64, 64, 3))

    seq = make_refiner(
        fcn8_apply, score_apply_fn("mirror"), fcn, mirror,
        eps=0.1, num_steps=2, h_taps=("pool4",), mode="score",
        compute_dtype=jnp.float32, dae_kwargs={"depth": 4},
    )
    _, yk_ref = seq(x)

    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    pp = make_pp_flagship(
        mesh, eps=0.1, num_steps=2, depth=4, compute_dtype=jnp.float32,
        engine="general", dae_arch="mirror",
    )
    _, yk = jax.jit(pp)(fcn, mirror, split_microbatches(x, 2))
    yk = np.asarray(merge_microbatches(yk))
    # the mirror decoder's max-unpool switches are sensitive to fusion
    # order, so a handful of tie pixels (~0.1%) differ at the 1e-3 level
    # between the pipelined and sequential compilations — assert
    # probability closeness at that scale plus argmax agreement
    np.testing.assert_allclose(yk, np.asarray(yk_ref), atol=5e-3)
    agree = (yk.argmax(-1) == np.asarray(yk_ref).argmax(-1)).mean()
    assert agree > 0.999, agree


def test_pp_three_stage_general_engine(cpu_devices):
    """The cross term: deeper 3-stage split x general engine — backbone |
    head | full-res reference-semantics refinement."""
    from iterative_inference_segm.inference import make_refiner
    from iterative_inference_segm.models import fcn8_apply
    from iterative_inference_segm.models.registry import score_apply_fn

    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(
        jax.random.PRNGKey(1), n_classes=C,
        h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=4,
    )
    x = jax.random.normal(jax.random.PRNGKey(10), (6, 64, 64, 3))

    seq = make_refiner(
        fcn8_apply, score_apply_fn("dae"), fcn, dae,
        eps=0.1, num_steps=2, h_taps=("pool4",), mode="score",
        compute_dtype=jnp.float32, dae_kwargs={"depth": 4},
    )
    _, yk_ref = seq(x)

    mesh = make_mesh(("stage",), (3,), devices=jax.devices()[:3])
    pp = make_pp_flagship(
        mesh, eps=0.1, num_steps=2, depth=4, compute_dtype=jnp.float32,
        engine="general",
    )
    _, yk = jax.jit(pp)(fcn, dae, split_microbatches(x, 3))
    np.testing.assert_allclose(
        np.asarray(merge_microbatches(yk)), np.asarray(yk_ref),
        rtol=1e-5, atol=1e-6,
    )


def test_gpipe_remat_grad_matches(cpu_devices):
    """remat=True (jax.checkpoint around each tick's stage compute) changes
    memory, not math: gradients equal the non-remat pipeline's."""
    mesh = make_mesh(("stage",), (4,), devices=jax.devices()[:4])
    ks = jax.random.normal(jax.random.PRNGKey(3), (4, 4, 4))

    def stage(p, w):
        return {**w, "a": jnp.tanh(w["a"] @ p)}

    x = jax.random.normal(jax.random.PRNGKey(4), (6, 2, 4))
    pipe = make_gpipe_stacked(stage, mesh)
    pipe_r = make_gpipe_stacked(stage, mesh, remat=True)
    g = jax.jit(jax.grad(lambda ps: jnp.sum(pipe(ps, {"a": x})["a"] ** 2)))(ks)
    g_r = jax.jit(jax.grad(lambda ps: jnp.sum(pipe_r(ps, {"a": x})["a"] ** 2)))(ks)
    np.testing.assert_allclose(np.asarray(g_r), np.asarray(g), rtol=1e-5, atol=1e-6)

    params, (s0, s1), _ = _two_stages()
    mesh2 = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    het = make_gpipe((s0, s1), mesh2)
    het_r = make_gpipe((s0, s1), mesh2, remat=True)
    xh = jax.random.normal(jax.random.PRNGKey(5), (3, 2, 4))
    gh = jax.jit(jax.grad(
        lambda ps: jnp.sum(het(ps, {"a": xh}, _wire0(xh))["a"] ** 2)
    ))(params)
    gh_r = jax.jit(jax.grad(
        lambda ps: jnp.sum(het_r(ps, {"a": xh}, _wire0(xh))["a"] ** 2)
    ))(params)
    for a, b in zip(jax.tree.leaves(gh), jax.tree.leaves(gh_r)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5, atol=1e-6)
