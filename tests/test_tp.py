"""Tensor-parallel (fc6/fc7 column->row) tests on the faked 8-device mesh.

The contract under test: annotating ONLY the params with `parallel.tp`'s
shardings and jitting the untouched `fcn8_apply` yields the same numbers as
the replicated run — GSPMD propagates the channel sharding through
relu/dropout and inserts the fc7 partial-sum all-reduce itself (SURVEY.md
§3.4 is single-GPU; TP is a rebuild extension, see parallel/tp.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from iterative_inference_segm.models import init_fcn8, fcn8_apply
from iterative_inference_segm.models.fcn8 import fcn8_logits
from iterative_inference_segm.ops.losses import masked_crossentropy
from iterative_inference_segm.parallel import make_mesh, batch_sharding
from iterative_inference_segm.parallel.tp import shard_params_tp, tp_shardings

C = 4


def _axis_at(x, dim):
    """Mesh axis partitioning dim ``dim`` of ``x`` (GSPMD trims trailing
    Nones from output specs, so index defensively)."""
    spec = x.sharding.spec
    return spec[dim] if dim < len(spec) else None


def _tiny(fc=16):
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=fc)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 48, 64, 3))
    return params, x


def test_tp_shardings_layout(cpu_devices):
    mesh = make_mesh(("data", "model"), (4, 2))
    params, _ = _tiny()
    specs = tp_shardings(params, mesh)
    assert specs["fc6"]["w"].spec == P(None, None, None, "model")
    assert specs["fc6"]["b"].spec == P("model")
    assert specs["fc7"]["w"].spec == P(None, None, "model", None)
    assert specs["fc7"]["b"].spec == P()
    assert specs["conv1_1"]["w"].spec == P()
    # the big kernels really land sharded on devices
    p_tp = shard_params_tp(params, mesh)
    assert p_tp["fc6"]["w"].sharding.spec == P(None, None, None, "model")


def test_tp_requires_divisible_fc_width(cpu_devices):
    mesh = make_mesh(("data", "model"), (2, 4))
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=18)
    with pytest.raises(ValueError, match="not divisible"):
        tp_shardings(params, mesh)


def test_tp_forward_matches_replicated(cpu_devices):
    mesh = make_mesh(("data", "model"), (4, 2))
    params, x = _tiny()

    ref, _ = jax.jit(lambda p, xx: fcn8_apply(p, xx))(params, x)

    p_tp = shard_params_tp(params, mesh)
    x_s = jax.device_put(x, batch_sharding(mesh, 4))
    out, _ = jax.jit(lambda p, xx: fcn8_apply(p, xx))(p_tp, x_s)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_tp_forward_matches_on_model_only_mesh(cpu_devices):
    """TP with no DP axis: the whole batch replicated, fc channels over 8."""
    mesh = make_mesh(("model",))
    params, x = _tiny(fc=32)
    ref, _ = jax.jit(lambda p, xx: fcn8_apply(p, xx))(params, x)
    p_tp = shard_params_tp(params, mesh)
    out, _ = jax.jit(lambda p, xx: fcn8_apply(p, xx))(p_tp, x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_tp_gradients_match_and_stay_sharded(cpu_devices):
    """Grad wrt TP params == replicated grad, and the fc6/fc7 grad leaves
    come back SHARDED (so optimizer moments inherit the layout — the memory
    win that motivates TP on the 411 MB parity-width fc6 kernel)."""
    mesh = make_mesh(("data", "model"), (4, 2))
    params, x = _tiny()
    labels = jax.random.randint(jax.random.PRNGKey(2), (4, 48, 64), 0, C)

    def loss_fn(p, xx, ll):
        return masked_crossentropy(fcn8_logits(p, xx), ll, n_classes=C)

    g_ref = jax.jit(jax.grad(loss_fn))(params, x, labels)

    p_tp = shard_params_tp(params, mesh)
    x_s = jax.device_put(x, batch_sharding(mesh, 4))
    l_s = jax.device_put(labels, batch_sharding(mesh, 3))
    g_tp = jax.jit(jax.grad(loss_fn))(p_tp, x_s, l_s)

    for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g_tp)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=5e-3, atol=1e-5)
    assert _axis_at(g_tp["fc6"]["w"], 3) == "model"
    assert _axis_at(g_tp["fc7"]["w"], 2) == "model"


def test_tp_train_step_shards_optimizer_state(cpu_devices):
    """One adam step under jit with TP params: updated params keep the TP
    layout and the optax moments for fc6/fc7 are sharded the same way."""
    import optax

    mesh = make_mesh(("data", "model"), (4, 2))
    params, x = _tiny()
    labels = jax.random.randint(jax.random.PRNGKey(2), (4, 48, 64), 0, C)
    tx = optax.adam(1e-3)

    def loss_fn(p, xx, ll):
        return masked_crossentropy(fcn8_logits(p, xx), ll, n_classes=C)

    @jax.jit
    def step(p, o, xx, ll):
        g = jax.grad(loss_fn)(p, xx, ll)
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), o

    p_tp = shard_params_tp(params, mesh)
    opt = jax.jit(tx.init)(p_tp)
    x_s = jax.device_put(x, batch_sharding(mesh, 4))
    l_s = jax.device_put(labels, batch_sharding(mesh, 3))
    p2, o2 = step(p_tp, opt, x_s, l_s)

    assert _axis_at(p2["fc6"]["w"], 3) == "model"
    mu = o2[0].mu if hasattr(o2[0], "mu") else o2[0]["mu"]
    assert _axis_at(mu["fc6"]["w"], 3) == "model"
    assert _axis_at(mu["fc7"]["w"], 2) == "model"
    assert np.all(np.isfinite(np.asarray(p2["fc6"]["b"], dtype=np.float32)))


def test_tp_compiled_comm_is_one_allreduce(cpu_devices):
    """Communication contract of the TP layout: the compiled forward
    contains exactly ONE all-reduce — fc7's partial-sum reduction over the
    'model' axis — and no collective-permute; GSPMD keeps the fc6->relu->fc7
    chain local to each shard as designed."""
    from iterative_inference_segm.parallel.tp import tp_shardings

    params = init_fcn8(jax.random.PRNGKey(0), n_classes=4, fc_channels=16)
    mesh = make_mesh(("model",), (2,), devices=jax.devices()[:2])
    shardings = tp_shardings(params, mesh)
    p_struct = jax.tree.map(
        lambda a, s: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=s),
        params,
        shardings,
    )
    x = jax.ShapeDtypeStruct((2, 48, 64, 3), jnp.float32)
    hlo = (
        jax.jit(lambda p, xx: fcn8_apply(p, xx)[0])
        .lower(p_struct, x)
        .compile()
        .as_text()
    )
    lines = hlo.splitlines()
    assert sum("all-reduce(" in l for l in lines) == 1, [
        l for l in lines if "all-reduce(" in l
    ]
    assert not any("collective-permute(" in l for l in lines)
