"""Checkpoint round-trips: flat npz export/import + step-directory pytrees."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iterative_inference_segm.models import init_fcn8
from iterative_inference_segm.utils.checkpoint import (
    save_npz,
    load_npz,
    save_checkpoint,
    restore_checkpoint,
    latest_step,
)
from iterative_inference_segm.utils.experiment import build_experiment_name, MetricLogger


def _tree_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_npz_roundtrip(tmp_path):
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=3, fc_channels=8)
    path = tmp_path / "p.npz"
    save_npz(path, jax.device_get(params))
    restored = load_npz(path, params)
    _tree_equal(params, restored)


def test_npz_shape_mismatch_raises(tmp_path):
    params = {"a": {"w": jnp.ones((2, 2))}}
    save_npz(tmp_path / "p.npz", params)
    bad_template = {"a": {"w": jnp.ones((3, 3))}}
    with pytest.raises(ValueError):
        load_npz(tmp_path / "p.npz", bad_template)


def test_npz_missing_key_raises(tmp_path):
    save_npz(tmp_path / "p.npz", {"a": {"w": jnp.ones((2,))}})
    with pytest.raises(KeyError):
        load_npz(tmp_path / "p.npz", {"a": {"w": jnp.ones((2,)), "b": jnp.ones((1,))}})


def test_npz_meta_roundtrip_and_validation(tmp_path):
    """Architecture metadata (ADVICE r2): stored under __meta__/, invisible
    to weight loading, validated by check_npz_meta — mismatches raise,
    absent metadata warns."""
    from iterative_inference_segm.utils.checkpoint import (
        check_npz_meta,
        read_npz_meta,
    )

    params = {"a": {"w": jnp.ones((2, 2))}}
    path = tmp_path / "p.npz"
    save_npz(path, params, meta={
        "arch": "dae", "encoder": "stride", "depth": 3, "tied": False,
        "widths": (8, 16, 32), "h": ("pool4",),
    })
    meta = read_npz_meta(path)
    assert meta["arch"] == "dae" and meta["encoder"] == "stride"
    assert meta["depth"] == 3 and meta["tied"] is False
    assert meta["widths"] == (8, 16, 32) and meta["h"] == ("pool4",)
    # weights load unchanged (meta keys skipped)
    _tree_equal(params, load_npz(path, params))

    check_npz_meta(path, {"encoder": "stride", "widths": [8, 16, 32]})  # ok
    with pytest.raises(ValueError, match="encoder"):
        check_npz_meta(path, {"encoder": "pool"})
    with pytest.warns(UserWarning, match="no metadata"):
        check_npz_meta(path, {"nonexistent_knob": 1})

    # a metadata-free export (old checkpoint): everything warns, nothing raises
    save_npz(tmp_path / "old.npz", params)
    assert read_npz_meta(tmp_path / "old.npz") == {}
    with pytest.warns(UserWarning):
        check_npz_meta(tmp_path / "old.npz", {"encoder": "pool"})


def test_predictor_rejects_wrong_encoder_flag(tmp_path):
    """The shape-invisible encoder knob must fail LOUDLY at serving time
    when it contradicts the checkpoint's stamped metadata (ADVICE r2 —
    the silent-degradation footgun)."""
    from iterative_inference_segm.inference import Predictor
    from iterative_inference_segm.models import init_dae, init_fcn8 as _init_fcn8
    from iterative_inference_segm.models.dae import DAE_H_CHANNELS

    fcn = _init_fcn8(jax.random.PRNGKey(0), n_classes=11, fc_channels=8)
    save_npz(tmp_path / "fcn.npz", jax.device_get(fcn), meta={"arch": "fcn8"})
    dae = init_dae(jax.random.PRNGKey(1), n_classes=11,
                   h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                   depth=3, stem_pool=1, widths=(4, 8, 8))
    save_npz(tmp_path / "dae.npz", jax.device_get(dae), meta={
        "arch": "dae", "encoder": "stride", "depth": 3, "stem_pool": 1,
        "tail": "full", "widths": (4, 8, 8),
    })
    with pytest.raises(ValueError, match="encoder"):
        Predictor.from_npz(
            str(tmp_path / "fcn.npz"), str(tmp_path / "dae.npz"),
            fc_channels=8, dae_depth=3, dae_stem_pool=1,
            dae_widths=(4, 8, 8), dae_encoder="pool",
        )


def test_checkpoint_roundtrip(tmp_path):
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=3, fc_channels=8)
    save_checkpoint(tmp_path, 7, params)
    assert latest_step(tmp_path) == 7
    restored = restore_checkpoint(tmp_path, 7, jax.tree.map(np.zeros_like, params))
    _tree_equal(params, restored)


def _train_state():
    from iterative_inference_segm.train.loop import TrainConfig, make_optimizer

    params = init_fcn8(jax.random.PRNGKey(0), n_classes=3, fc_channels=8)
    tx = make_optimizer(TrainConfig())
    opt = tx.init(params)
    grads = jax.tree.map(jnp.ones_like, params)
    _, opt = tx.update(grads, opt, params)  # nonzero moments, count 1
    return {"params": params, "opt_state": opt}


def test_checkpoint_async_save_then_restore(tmp_path):
    """wait=False writes on a background thread; the host copy is taken
    before save_checkpoint returns, and restore waits for the write."""
    from iterative_inference_segm.utils.checkpoint import wait_for_checkpoints

    state = _train_state()
    host = jax.device_get(state)
    save_checkpoint(tmp_path, 0, host, wait=False)
    save_checkpoint(tmp_path, 1, host, wait=False)
    restored = restore_checkpoint(tmp_path, 1, state)
    wait_for_checkpoints()
    assert latest_step(tmp_path) == 1
    _tree_equal(state, restored)
    assert type(restored["opt_state"]) is type(state["opt_state"])


def test_checkpoint_bf16_leaves_roundtrip(tmp_path):
    tree = {"w": jnp.linspace(-3, 3, 12, dtype=jnp.bfloat16).reshape(3, 4),
            "n": jnp.arange(3, dtype=jnp.int32)}
    save_checkpoint(tmp_path, 0, tree)
    restored = restore_checkpoint(tmp_path, 0, tree)
    assert restored["w"].dtype == jnp.bfloat16 and restored["n"].dtype == jnp.int32
    _tree_equal(tree, restored)


def test_checkpoint_overwrite_keeps_one_step_dir(tmp_path):
    save_checkpoint(tmp_path, 3, {"a": jnp.zeros((2,))})
    save_checkpoint(tmp_path, 3, {"a": jnp.ones((2,))})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3"]
    restored = restore_checkpoint(tmp_path, 3, {"a": jnp.zeros((2,))})
    np.testing.assert_array_equal(np.asarray(restored["a"]), [1.0, 1.0])


@pytest.mark.parametrize(
    "template,error",
    [({"a": jnp.zeros((3,))}, ValueError), ({"a": jnp.zeros((2,)), "b": jnp.zeros(())}, KeyError)],
)
def test_checkpoint_template_mismatch_raises(tmp_path, template, error):
    save_checkpoint(tmp_path, 0, {"a": jnp.zeros((2,))})
    with pytest.raises(error):
        restore_checkpoint(tmp_path, 0, template)


def test_wait_for_checkpoints_reraises_background_error(tmp_path):
    from iterative_inference_segm.utils.checkpoint import wait_for_checkpoints

    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    save_checkpoint(blocker, 0, {"a": jnp.zeros((2,))}, wait=False)
    with pytest.raises(OSError):
        wait_for_checkpoints()
    wait_for_checkpoints()  # the error is reported once


def test_latest_step_empty(tmp_path):
    assert latest_step(tmp_path / "nope") is None


def test_build_experiment_name_deterministic():
    a = build_experiment_name("fcn8", lr=1e-3, dataset="camvid", sigma=0.5)
    b = build_experiment_name("fcn8", sigma=0.5, dataset="camvid", lr=1e-3)
    assert a == b
    assert "lr=0.001" in a and "dataset=camvid" in a


def test_metric_logger_roundtrip(tmp_path):
    ml = MetricLogger(tmp_path)
    ml.log(0, loss=1.5, note="hello")
    ml.log(1, loss=jnp.float32(0.5))
    recs = ml.read()
    assert len(recs) == 2
    assert recs[0]["loss"] == 1.5
    assert recs[1]["loss"] == 0.5


def test_restore_checkpoint_sharded_tp_layout(tmp_path, cpu_devices):
    """Save from a single-device (replicated) run, restore directly INTO the
    fc6/fc7 TP layout on a mesh — values identical, leaves laid out per
    tp_shardings with no host-side full-size materialize step. The save and
    restore topologies are independent (production restart contract)."""
    from iterative_inference_segm.parallel import make_mesh
    from iterative_inference_segm.parallel.tp import tp_shardings
    from iterative_inference_segm.utils.checkpoint import (
        restore_checkpoint_sharded,
    )

    params = init_fcn8(jax.random.PRNGKey(0), n_classes=3, fc_channels=8)
    save_checkpoint(tmp_path / "ck", 3, jax.device_get(params))

    mesh = make_mesh(("data", "model"), (4, 2))
    shardings = tp_shardings(params, mesh)
    restored = restore_checkpoint_sharded(tmp_path / "ck", 3, params, shardings)

    _tree_equal(restored, params)
    assert restored["fc6"]["w"].sharding == shardings["fc6"]["w"]
    assert restored["fc7"]["w"].sharding == shardings["fc7"]["w"]
    # a replicated leaf really is replicated on the mesh
    assert restored["conv1_1"]["w"].sharding == shardings["conv1_1"]["w"]


def test_restore_checkpoint_sharded_from_sharded_save(tmp_path, cpu_devices):
    """The inverse direction: a TP-sharded state checkpoints and restores
    replicated (topology-change restart, e.g. scaling in)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from iterative_inference_segm.parallel import make_mesh
    from iterative_inference_segm.parallel.tp import shard_params_tp
    from iterative_inference_segm.utils.checkpoint import (
        restore_checkpoint_sharded,
    )

    params = init_fcn8(jax.random.PRNGKey(1), n_classes=3, fc_channels=8)
    mesh = make_mesh(("data", "model"), (4, 2))
    sharded = shard_params_tp(params, mesh)
    save_checkpoint(tmp_path / "ck", 0, sharded)

    repl = jax.tree.map(lambda _: NamedSharding(mesh, P()), params)
    restored = restore_checkpoint_sharded(tmp_path / "ck", 0, params, repl)
    _tree_equal(restored, params)
    assert restored["fc6"]["w"].sharding.is_fully_replicated
