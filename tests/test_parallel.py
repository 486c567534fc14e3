"""Data-parallel tests on the faked 8-device CPU mesh (SURVEY.md §5)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from iterative_inference_segm.models import init_fcn8, fcn8_apply, init_dae, dae_apply
from iterative_inference_segm.models.fcn8 import fcn8_logits
from iterative_inference_segm.ops.losses import masked_crossentropy
from iterative_inference_segm.parallel import (
    make_mesh,
    batch_sharding,
    replicate,
    shard_batch,
)

C = 4


def test_make_mesh_all_devices(cpu_devices):
    mesh = make_mesh(("data",))
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == ("data",)


def test_make_mesh_2d(cpu_devices):
    mesh = make_mesh(("data", "space"), (4, 2))
    assert mesh.devices.shape == (4, 2)


def test_shard_batch_puts_batch_axis(cpu_devices):
    mesh = make_mesh(("data",))
    x = np.zeros((8, 4, 4, 3), np.float32)
    xs = shard_batch(mesh, x)
    assert xs.sharding.spec in (P("data"), P("data", None, None, None))


def test_dp_forward_matches_single_device(cpu_devices):
    mesh = make_mesh(("data",))
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 48, 64, 3))

    ref, _ = jax.jit(lambda p, xx: fcn8_apply(p, xx))(params, x)

    params_r = replicate(mesh, params)
    x_s = jax.device_put(x, batch_sharding(mesh, 4))
    out, _ = jax.jit(lambda p, xx: fcn8_apply(p, xx))(params_r, x_s)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_dp_gradients_match_single_device(cpu_devices):
    """Batch-sharded loss gradient == single-device gradient (XLA inserts the
    cross-device psum; this is the correctness contract of the DP path)."""
    mesh = make_mesh(("data",))
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 48, 64, 3))
    labels = jax.random.randint(jax.random.PRNGKey(2), (8, 48, 64), 0, C)

    def loss_fn(p, xx, ll):
        return masked_crossentropy(fcn8_logits(p, xx), ll, n_classes=C)

    g_ref = jax.jit(jax.grad(loss_fn))(params, x, labels)

    params_r = replicate(mesh, params)
    x_s = jax.device_put(x, batch_sharding(mesh, 4))
    l_s = jax.device_put(labels, batch_sharding(mesh, 3))
    g_dp = jax.jit(jax.grad(loss_fn))(params_r, x_s, l_s)

    ref_leaves = jax.tree.leaves(g_ref)
    dp_leaves = jax.tree.leaves(g_dp)
    for a, b in zip(ref_leaves, dp_leaves):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=5e-3, atol=1e-5)


def test_dp_refinement_batch_sharded(cpu_devices):
    """Config 3/5-style batched refinement with the batch over the mesh."""
    from iterative_inference_segm.inference import make_refiner

    mesh = make_mesh(("data",))
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512})
    refine = make_refiner(
        fcn8_apply, dae_apply, replicate(mesh, fcn), replicate(mesh, dae),
        eps=0.1, num_steps=2, h_taps=("pool4",),
    )
    x = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(2), (8, 48, 64, 3)),
        batch_sharding(mesh, 4),
    )
    y0, yk = refine(x)
    assert yk.shape == (8, 48, 64, C)
    # output keeps the batch sharding (no accidental gather to one device)
    assert y0.sharding.spec in (P("data"), P("data", None, None, None))


def test_spatial_sharding_forward(cpu_devices):
    """Optional H-axis (spatial) sharding: forward must still be correct.
    XLA handles halo exchange for convs on sharded spatial dims."""
    mesh = make_mesh(("data", "space"), (4, 2))
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 48, 64, 3))
    ref, _ = jax.jit(lambda p, xx: fcn8_apply(p, xx))(params, x)
    params_r = replicate(mesh, params)
    x_s = jax.device_put(x, batch_sharding(mesh, 4, spatial_axis="space"))
    out, _ = jax.jit(lambda p, xx: fcn8_apply(p, xx))(params_r, x_s)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_dp_half_engine_batch_sharded(cpu_devices):
    """The throughput (half) engine under data-parallel batch sharding:
    output correct vs single-device and stays batch-sharded."""
    from iterative_inference_segm.inference.fused import make_half_refiner

    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512},
                   depth=3, stem_pool=1, widths=(8, 16, 32))
    x = jax.random.normal(jax.random.PRNGKey(2), (8, 48, 64, 3))

    refine = make_half_refiner(fcn8_apply, fcn, dae, eps=0.3, num_steps=2,
                               h_taps=("pool4",), depth=3)
    y0_ref, yk_ref = refine(x)

    mesh = make_mesh(("data",))
    refine_dp = make_half_refiner(fcn8_apply, replicate(mesh, fcn), replicate(mesh, dae),
                                  eps=0.3, num_steps=2, h_taps=("pool4",), depth=3)
    x_s = jax.device_put(x, batch_sharding(mesh, 4))
    y0_dp, yk_dp = refine_dp(x_s)
    np.testing.assert_allclose(np.asarray(yk_dp), np.asarray(yk_ref), rtol=5e-4, atol=5e-5)
    assert yk_dp.sharding.spec in (P("data"), P("data", None, None, None))


def test_sp_sharded_refinement_matches_unsharded(cpu_devices):
    """VERDICT r1 weak #8: the refinement scan itself — fcn8_apply + K
    score steps through the DAE — sharded over the 'space' (H) axis must
    equal the unsharded result. XLA inserts the halo exchanges for every
    conv in both the FCN and the in-scan DAE."""
    from iterative_inference_segm.inference import make_refiner

    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512})
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 48, 64, 3))

    refine_ref = make_refiner(
        fcn8_apply, dae_apply, fcn, dae, eps=0.2, num_steps=3, h_taps=("pool4",)
    )
    y0_ref, yk_ref = refine_ref(x)

    mesh = make_mesh(("data", "space"), (2, 4))
    refine_sp = make_refiner(
        fcn8_apply, dae_apply, replicate(mesh, fcn), replicate(mesh, dae),
        eps=0.2, num_steps=3, h_taps=("pool4",),
    )
    x_s = jax.device_put(x, batch_sharding(mesh, 4, spatial_axis="space"))
    y0_sp, yk_sp = refine_sp(x_s)

    np.testing.assert_allclose(np.asarray(y0_sp), np.asarray(y0_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(yk_sp), np.asarray(yk_ref), rtol=5e-4, atol=5e-5)
    # refinement must actually have moved the iterate (non-vacuous check)
    assert float(jnp.abs(yk_ref - y0_ref).max()) > 1e-4


def test_sp_sharded_half_engine_matches_unsharded(cpu_devices):
    """The half engine under a dp x sp mesh (H sharded over 'space'): the
    stem avg-pool, pooled-map scan, and full-res rectification all cross the
    spatial shard boundary — XLA must insert the halo exchanges and the
    result must equal the unsharded engine."""
    from iterative_inference_segm.inference.fused import make_half_refiner

    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512},
                   depth=3, stem_pool=1, widths=(8, 16, 32))
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 48, 64, 3))

    refine_ref = make_half_refiner(fcn8_apply, fcn, dae, eps=0.3, num_steps=2,
                                   h_taps=("pool4",), depth=3)
    y0_ref, yk_ref = refine_ref(x)

    mesh = make_mesh(("data", "space"), (2, 4))
    refine_sp = make_half_refiner(fcn8_apply, replicate(mesh, fcn), replicate(mesh, dae),
                                  eps=0.3, num_steps=2, h_taps=("pool4",), depth=3)
    x_s = jax.device_put(x, batch_sharding(mesh, 4, spatial_axis="space"))
    y0_sp, yk_sp = refine_sp(x_s)

    np.testing.assert_allclose(np.asarray(y0_sp), np.asarray(y0_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(yk_sp), np.asarray(yk_ref), rtol=5e-4, atol=5e-5)
    assert float(jnp.abs(yk_ref - y0_ref).max()) > 1e-4


def test_shard_map_dp_step_matches_single_device(cpu_devices):
    """Explicit shard_map+psum DP step == single-device step (same update)."""
    import optax
    from iterative_inference_segm.parallel.dp import make_dp_grad_step, put_dp
    from iterative_inference_segm.models.fcn8 import fcn8_logits
    from iterative_inference_segm.ops.losses import masked_crossentropy

    mesh = make_mesh(("data",))
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    # sgd: updates are linear in grads, so single-device vs shard_map
    # equivalence is testable at f32 tolerances (adam's rsqrt normalization
    # amplifies reduction-order noise on near-zero grads)
    tx = optax.sgd(1e-2)
    opt_state = tx.init(params)
    batch = {
        "images": jax.random.normal(jax.random.PRNGKey(1), (8, 48, 64, 3)),
        "labels": jax.random.randint(jax.random.PRNGKey(2), (8, 48, 64), 0, C),
    }

    def loss_fn(p, b, rng):
        return masked_crossentropy(fcn8_logits(p, b["images"]), b["labels"], n_classes=C)

    # single-device reference update
    def ref_step(p, o, b):
        loss, grads = jax.value_and_grad(loss_fn)(p, b, None)
        updates, o = tx.update(grads, o, p)
        return jax.tree.map(lambda x, u: x + u, p, updates), o, loss

    p_ref, _, loss_ref = jax.jit(ref_step)(params, opt_state, batch)

    step = make_dp_grad_step(loss_fn, tx, mesh)
    p_r, o_r, b_r = put_dp(mesh, params, opt_state, batch)
    p_dp, _, loss_dp = step(p_r, o_r, b_r, None)

    np.testing.assert_allclose(float(loss_dp), float(loss_ref), rtol=1e-5)
    for a, b2 in zip(jax.tree.leaves(p_ref), jax.tree.leaves(p_dp)):
        np.testing.assert_allclose(np.asarray(b2), np.asarray(a), rtol=2e-3, atol=1e-5)


def test_shard_map_dp_rng_decorrelated_across_devices(cpu_devices):
    """Each device must draw DIFFERENT randomness from the replicated rng
    (ADVICE r1: identical per-device noise reduces effective randomness)."""
    import optax
    from iterative_inference_segm.parallel.dp import make_dp_grad_step, put_dp

    mesh = make_mesh(("data",))
    n_dev = mesh.devices.size
    params = {"w": jnp.zeros(())}
    tx = optax.sgd(1.0)
    opt_state = tx.init(params)
    rng = jax.random.PRNGKey(42)

    # grad wrt w is exactly the device's noise draw; after pmean the sgd
    # update reveals the mean draw across devices.
    def loss_fn(p, b, r):
        return p["w"] * jax.random.normal(r, ())

    step = make_dp_grad_step(loss_fn, tx, mesh)
    p_r, o_r, b_r = put_dp(mesh, params, opt_state, {"t": jnp.zeros((n_dev,))})
    p_new, _, _ = step(p_r, o_r, b_r, rng)
    per_dev = np.array(
        [jax.random.normal(jax.random.fold_in(rng, i), ()) for i in range(n_dev)]
    )
    np.testing.assert_allclose(np.asarray(p_new["w"]), -per_dev.mean(), rtol=1e-5)
    # and the draws genuinely differ device-to-device
    assert np.std(per_dev) > 1e-3


def test_shard_map_dp_psum_actually_averages(cpu_devices):
    """Different data on each shard -> the update reflects ALL shards."""
    import optax
    from iterative_inference_segm.parallel.dp import make_dp_grad_step, put_dp

    mesh = make_mesh(("data",))
    params = {"w": jnp.zeros((4,))}
    tx = optax.sgd(1.0)
    opt_state = tx.init(params)
    # per-sample target varies: grad of mean((w - t)^2) = 2*(w - mean(t))
    targets = jnp.arange(8.0)

    def loss_fn(p, b, rng):
        return jnp.mean((p["w"][None, :] - b["t"][:, None]) ** 2)

    step = make_dp_grad_step(loss_fn, tx, mesh)
    p_r, o_r, b_r = put_dp(mesh, params, opt_state, {"t": targets})
    p_new, _, _ = step(p_r, o_r, b_r, None)
    # loss means over the 4 w-components too, so grad = 2*(w - mean(t))/4;
    # sgd(1.0): w <- 0 + 2*3.5/4 = 1.75 — reflecting ALL shards' targets
    np.testing.assert_allclose(np.asarray(p_new["w"]), 1.75, rtol=1e-5)


def test_dp_step_compiled_comm_is_one_fused_allreduce(cpu_devices):
    """Communication contract of the explicit DP step: XLA fuses the loss
    pmean and EVERY per-leaf gradient pmean into exactly ONE all-reduce per
    step (no gathers/permutes) — the collective runs once, as the
    shard_map formulation intends."""
    import optax

    from iterative_inference_segm.parallel.dp import make_dp_grad_step

    mesh = make_mesh(("data",))
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    tx = optax.adam(1e-3)

    def loss_fn(p, batch, rng):
        x, y = batch
        return masked_crossentropy(fcn8_logits(p, x), y, n_classes=C)

    step = make_dp_grad_step(loss_fn, tx, mesh)
    x = jnp.zeros((8, 48, 64, 3))
    y = jnp.zeros((8, 48, 64), jnp.int32)
    hlo = (
        step.lower(params, tx.init(params), (x, y), jax.random.PRNGKey(0))
        .compile()
        .as_text()
    )
    lines = hlo.splitlines()
    assert sum("all-reduce(" in l for l in lines) == 1, [
        l for l in lines if "all-reduce(" in l
    ]
    for op in ("collective-permute(", "all-gather(", "all-to-all("):
        assert not any(op in l for l in lines), op


def test_sp_forward_compiled_comm_is_halo_exchange(cpu_devices):
    """Communication contract of spatial sharding: convs/pools on the
    H-sharded maps compile to collective-permute HALO EXCHANGES (neighbor
    transfers of boundary rows), with at most one all-gather where the
    /32-scale map becomes smaller than the shard count — never an
    all-reduce, and never a wholesale gather-per-layer."""
    from jax.sharding import NamedSharding

    mesh = make_mesh(("data", "space"), (4, 2))
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    repl = NamedSharding(mesh, P())
    p_struct = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=repl), params
    )
    x_struct = jax.ShapeDtypeStruct(
        (4, 48, 64, 3), jnp.float32,
        sharding=batch_sharding(mesh, 4, spatial_axis="space"),
    )
    hlo = (
        jax.jit(lambda p, xx: fcn8_apply(p, xx)[0])
        .lower(p_struct, x_struct)
        .compile()
        .as_text()
    )
    lines = hlo.splitlines()
    assert sum("collective-permute(" in l for l in lines) >= 1
    assert sum("all-gather(" in l for l in lines) <= 1, [
        l for l in lines if "all-gather(" in l
    ]
    assert not any("all-reduce(" in l for l in lines)
