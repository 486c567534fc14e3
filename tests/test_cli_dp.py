"""Multi-device (DP) paths driven from the workload ENTRY POINTS — the
VERDICT r2 missing-#3 seam: parallelism must be reachable via
``--devices``, not only through the parallel/ library (exercised by
tests/test_parallel.py). Runs on the faked 8-device CPU mesh."""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    path = os.path.join(_ROOT, "scripts", name)
    spec = importlib.util.spec_from_file_location(name.removesuffix(".py"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mesh_from_flag_semantics():
    from iterative_inference_segm.parallel.mesh import mesh_from_flag

    assert mesh_from_flag(None) is None
    assert mesh_from_flag("1") is None  # single device: plain path
    m = mesh_from_flag("auto")
    assert m.shape["data"] == len(jax.devices())
    assert mesh_from_flag("4", batch_size=8).shape["data"] == 4
    with pytest.raises(ValueError, match="divisible"):
        mesh_from_flag("8", batch_size=12)
    with pytest.raises(ValueError, match="visible"):
        mesh_from_flag(str(len(jax.devices()) + 1))


def test_train_fcn8_cli_dp(tmp_path, capsys):
    train_fcn8 = _load_script("train_fcn8.py")
    rc = train_fcn8.main([
        "--synthetic", "--tiny", "--max-epochs", "1", "--batch-size", "8",
        "--num-train-batches", "2", "--num-val-batches", "1",
        "--devices", "8", "--workdir", str(tmp_path / "fcn"),
    ])
    assert rc in (0, None)
    out = capsys.readouterr().out
    assert "data-parallel over 8 devices" in out
    assert (tmp_path / "fcn" / "best_fcn8.npz").exists()


def test_train_dae_cli_dp_then_sharded_inference(tmp_path, capsys):
    train_dae = _load_script("train_dae.py")
    iterative_inference = _load_script("iterative_inference.py")

    workdir = tmp_path / "dae"
    rc = train_dae.main([
        "--synthetic", "--tiny", "--max-epochs", "1", "--batch-size", "8",
        "--num-train-batches", "2", "--num-val-batches", "1",
        "--dae-stem-pool", "1", "--dae-depth", "3",
        "--dae-widths", "8", "16", "32",
        "--devices", "8", "--workdir", str(workdir),
    ])
    assert rc in (0, None)
    dae_npz = workdir / "best_dae.npz"
    assert dae_npz.exists()

    rc = iterative_inference.main([
        "--synthetic", "--tiny", "--num-steps", "1",
        "--batch-size", "8", "--num-batches", "1",
        "--dae-npz", str(dae_npz),
        "--dae-stem-pool", "1", "--dae-depth", "3",
        "--dae-widths", "8", "16", "32",
        "--engine", "half", "--devices", "8",
    ])
    assert rc == 0
    assert "sharded over 8 devices" in capsys.readouterr().out


def test_dp_eval_step_matches_single_device():
    """The DP eval step (psum'd confusion counts) must agree exactly with the
    single-device step — FCN-8 eval is deterministic, so this is an equality,
    not a smoke test."""
    import dataclasses

    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.models import init_fcn8
    from iterative_inference_segm.parallel.mesh import make_mesh
    from iterative_inference_segm.train.loop import TrainConfig, make_optimizer
    from iterative_inference_segm.train.train_fcn8 import make_fcn8_train_step

    cfg = dataclasses.replace(CAMVID, train_crop=(32, 32))
    tcfg = TrainConfig(batch_size=8, seed=0)
    tx = make_optimizer(tcfg)
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=cfg.n_classes, fc_channels=16)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 48, 64, 3)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, size=(8, 48, 64)).astype(np.int32)

    _, eval_single = make_fcn8_train_step(cfg, tcfg, tx, fc_channels=16)
    mesh = make_mesh(("data",))
    _, eval_dp = make_fcn8_train_step(cfg, tcfg, tx, fc_channels=16, mesh=mesh)

    cm_s, loss_s = eval_single(params, jnp.asarray(x), jnp.asarray(y))
    cm_d, loss_d = eval_dp(params, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(np.asarray(cm_s), np.asarray(cm_d))
    # loss: pmean of per-shard means — equal up to f32 reassociation
    np.testing.assert_allclose(float(loss_s), float(loss_d), rtol=1e-3)


def test_dp_train_step_improves_loss():
    """One DP step on a shared batch must produce a replicated update that
    reduces the loss on that batch (sanity of the pmean'd grads wiring)."""
    import dataclasses

    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.models import init_fcn8
    from iterative_inference_segm.parallel.mesh import make_mesh
    from iterative_inference_segm.train.loop import TrainConfig, make_optimizer
    from iterative_inference_segm.train.train_fcn8 import make_fcn8_train_step

    cfg = dataclasses.replace(CAMVID, train_crop=(32, 32))
    tcfg = TrainConfig(batch_size=8, seed=0, learning_rate=1e-3)
    tx = make_optimizer(tcfg)
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=cfg.n_classes, fc_channels=16)
    opt_state = tx.init(params)

    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 48, 64, 3)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, size=(8, 48, 64)).astype(np.int32)

    mesh = make_mesh(("data",))
    train_dp, _ = make_fcn8_train_step(cfg, tcfg, tx, augment=False, fc_channels=16, mesh=mesh)
    p, o, loss0 = train_dp(params, opt_state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(2))
    for _ in range(3):
        p, o, loss = train_dp(p, o, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(2))
    assert float(loss) < float(loss0)
    # update is replicated: every leaf is fully addressable and identical
    leaf = jax.tree.leaves(p)[0]
    assert leaf.sharding.is_fully_replicated


def test_sharded_inference_pads_short_last_batch(tmp_path, capsys):
    """Disk splits are rarely divisible by the batch: with --devices the
    short LAST batch must be padded to the compiled batch and the padded
    rows sliced back off the predictions."""
    from tests.test_first_contact import _write_camvid_tree

    data_root = tmp_path / "camvid"
    _write_camvid_tree(data_root, n=5)  # 5 % 4 != 0

    iterative_inference = _load_script("iterative_inference.py")
    rc = iterative_inference.main([
        "--dataset", "camvid", "--data-root", str(data_root),
        "--tiny", "--num-steps", "1", "--batch-size", "4",
        "--dae-widths", "8", "16", "32", "64",
        "--devices", "4",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "sharded over 4 devices" in out
    assert "per-class IoU" in out


def test_padded_batch_putter_is_exact(cpu_devices):
    """Padding a short batch (zero images + void labels) must leave the
    confusion counts EXACTLY those of the real rows — the invariant that
    makes DP training/eval on non-divisible disk splits correct."""
    import dataclasses

    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.models import init_fcn8
    from iterative_inference_segm.parallel.mesh import make_mesh
    from iterative_inference_segm.parallel.sharding import padded_batch_putter
    from iterative_inference_segm.train.loop import TrainConfig, make_optimizer
    from iterative_inference_segm.train.train_fcn8 import make_fcn8_train_step

    cfg = dataclasses.replace(CAMVID, train_crop=(32, 32))
    tcfg = TrainConfig(batch_size=8, seed=0)
    tx = make_optimizer(tcfg)
    params = init_fcn8(jax.random.PRNGKey(0), n_classes=cfg.n_classes, fc_channels=16)

    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 48, 64, 3)).astype(np.float32)  # 5 % 4 != 0
    y = rng.integers(0, cfg.n_classes, size=(5, 48, 64)).astype(np.int32)

    _, eval_single = make_fcn8_train_step(cfg, tcfg, tx, fc_channels=16)
    cm_ref, _ = eval_single(params, jnp.asarray(x), jnp.asarray(y))

    mesh = make_mesh(("data",), devices=jax.devices()[:4])
    _, eval_dp = make_fcn8_train_step(cfg, tcfg, tx, fc_channels=16, mesh=mesh)
    put = padded_batch_putter(mesh, void_label=cfg.void_label)
    xb, yb = put(x, y)
    assert xb.shape[0] == 8  # padded to a multiple of the axis size
    cm_dp, loss = eval_dp(params, xb, yb)
    np.testing.assert_array_equal(np.asarray(cm_dp), np.asarray(cm_ref))
    assert np.isfinite(float(loss))


def test_dp_training_pads_short_last_batch(tmp_path, capsys):
    """Disk splits are rarely divisible by the batch: with --devices both
    trainers' epoch loops hit a short LAST batch, which must be padded (not
    crash the batch-sharded device_put)."""
    from tests.test_first_contact import _write_camvid_tree

    data_root = tmp_path / "camvid"
    # 5 % 4 != 0; images at least the --tiny train_crop of 64x64
    _write_camvid_tree(data_root, splits=("train", "val"), n=5, hw=(64, 64))

    train_fcn8 = _load_script("train_fcn8.py")
    rc = train_fcn8.main([
        "--dataset", "camvid", "--data-root", str(data_root),
        "--tiny", "--max-epochs", "1", "--batch-size", "4",
        "--devices", "4", "--workdir", str(tmp_path / "fcn"),
    ])
    assert rc in (0, None)
    out = capsys.readouterr().out
    assert "data-parallel over 4 devices" in out
    assert (tmp_path / "fcn" / "best_fcn8.npz").exists()


def test_dp_training_on_u8_wire(tmp_path, capsys):
    """--packed --wire u8 --devices N: raw uint8 batches shard over the mesh
    (4x fewer bytes per device_put) and the jitted DP step normalizes/casts
    on-chip. (The native loader pads its own tail batches, so the putter's
    pad branch is exercised separately by
    test_padded_batch_putter_uint8_short_batch.)"""
    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.data.native_loader import pack_dataset

    rng = np.random.default_rng(0)
    packed = tmp_path / "packed"
    packed.mkdir()
    for split, n in (("train", 6), ("val", 4)):  # 6 % 4 != 0 -> padded tail
        imgs = rng.integers(0, 256, (n, 96, 128, 3), np.uint8)
        labs = rng.integers(0, CAMVID.n_classes, (n, 96, 128)).astype(np.int32)
        pack_dataset(packed / f"{split}.iist", imgs, labs, CAMVID)

    train_fcn8 = _load_script("train_fcn8.py")
    rc = train_fcn8.main([
        "--packed", str(packed), "--wire", "u8", "--tiny",
        "--max-epochs", "1", "--batch-size", "4",
        "--devices", "4", "--workdir", str(tmp_path / "fcn"),
    ])
    assert rc in (0, None)
    assert "data-parallel over 4 devices" in capsys.readouterr().out
    assert (tmp_path / "fcn" / "best_fcn8.npz").exists()


def test_padded_batch_putter_uint8_short_batch():
    """A non-packed uint8 source with a short tail must pad with zero image
    BYTES and uint8 void labels, preserving dtypes through the sharded put —
    the u8-wire contract for DP sources that do not self-pad."""
    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.parallel.mesh import make_mesh
    from iterative_inference_segm.parallel.sharding import padded_batch_putter

    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (5, 8, 8, 3), np.uint8)  # 5 % 4 != 0
    y = rng.integers(0, CAMVID.n_classes, (5, 8, 8)).astype(np.uint8)

    mesh = make_mesh(("data",), devices=jax.devices()[:4])
    put = padded_batch_putter(mesh, void_label=CAMVID.void_label)
    xb, yb = put(x, y)
    assert xb.shape[0] == yb.shape[0] == 8
    assert xb.dtype == jnp.uint8 and yb.dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(xb)[:5], x)
    np.testing.assert_array_equal(np.asarray(yb)[:5], y)
    assert (np.asarray(xb)[5:] == 0).all()
    assert (np.asarray(yb)[5:] == CAMVID.void_label).all()


def test_iterative_inference_cli_pp_matches_sequential(capsys):
    """--pp (the 2-stage pipeline, composed with DP at --devices 4) must
    report EXACTLY the sequential half engine's metrics: same params (seeded
    random init), same synthetic split, f32 numerics — the pipelined seam
    may not perturb a single prediction."""
    iterative_inference = _load_script("iterative_inference.py")
    base = [
        "--synthetic", "--tiny", "--num-steps", "3", "--engine", "half",
        "--dae-stem-pool", "1", "--dae-depth", "3", "--batch-size", "8",
        "--num-batches", "2", "--seed", "7",
    ]

    rc = iterative_inference.main(base)
    assert rc in (0, None)
    seq_out = capsys.readouterr().out

    rc = iterative_inference.main(
        base + ["--pp", "--devices", "4", "--pp-microbatches", "2"]
    )
    assert rc in (0, None)
    pp_out = capsys.readouterr().out
    assert "pipeline-parallel serving: 2 stages x 2-wide DP" in pp_out

    seq_metrics = [l for l in seq_out.splitlines() if "mIoU" in l]
    pp_metrics = [l for l in pp_out.splitlines() if "mIoU" in l]
    assert seq_metrics and seq_metrics == pp_metrics


def test_iterative_inference_cli_pp_general_engine(capsys):
    """--pp --engine general: the reference-semantics loop served through
    the pipeline, metrics identical to the sequential general engine."""
    iterative_inference = _load_script("iterative_inference.py")
    base = [
        "--synthetic", "--tiny", "--num-steps", "3", "--engine", "general",
        "--dae-depth", "4", "--batch-size", "8", "--num-batches", "2",
        "--seed", "7",
    ]
    rc = iterative_inference.main(base)
    assert rc in (0, None)
    seq_out = capsys.readouterr().out

    rc = iterative_inference.main(base + ["--pp", "--devices", "2"])
    assert rc in (0, None)
    pp_out = capsys.readouterr().out
    assert "pipeline-parallel serving: 2 stages" in pp_out
    seq_metrics = [l for l in seq_out.splitlines() if "mIoU" in l]
    pp_metrics = [l for l in pp_out.splitlines() if "mIoU" in l]
    assert seq_metrics and seq_metrics == pp_metrics


def test_iterative_inference_cli_pp_three_stage(capsys):
    """--pp-stages 3 --devices 6: the deeper split (backbone | head |
    refinement) composed with 2-wide DP, metrics identical to sequential."""
    iterative_inference = _load_script("iterative_inference.py")
    base = [
        "--synthetic", "--tiny", "--num-steps", "3", "--engine", "half",
        "--dae-stem-pool", "1", "--dae-depth", "3", "--batch-size", "8",
        "--num-batches", "2", "--seed", "7",
    ]
    rc = iterative_inference.main(base)
    assert rc in (0, None)
    seq_out = capsys.readouterr().out

    rc = iterative_inference.main(
        base + ["--pp", "--pp-stages", "3", "--devices", "6"]
    )
    assert rc in (0, None)
    pp_out = capsys.readouterr().out
    assert "pipeline-parallel serving: 3 stages x 2-wide DP" in pp_out
    seq_metrics = [l for l in seq_out.splitlines() if "mIoU" in l]
    pp_metrics = [l for l in pp_out.splitlines() if "mIoU" in l]
    assert seq_metrics and seq_metrics == pp_metrics


def test_iterative_inference_cli_pp_u8_wire(tmp_path, capsys):
    """--pp composes with the u8 packed wire: raw bytes cross the link,
    the loader's on-device normalize (file-header stats) feeds the
    pipeline. Smoke: completes and reports the IoU table."""
    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.data.native_loader import pack_dataset

    rng = np.random.default_rng(0)
    packed = tmp_path / "packed"
    packed.mkdir()
    imgs = rng.integers(0, 256, (4, 96, 128, 3), np.uint8)
    labs = rng.integers(0, CAMVID.n_classes, (4, 96, 128)).astype(np.int32)
    pack_dataset(packed / "test.iist", imgs, labs, CAMVID)

    iterative_inference = _load_script("iterative_inference.py")
    rc = iterative_inference.main([
        "--packed", str(packed), "--wire", "u8", "--tiny",
        "--num-steps", "2", "--engine", "half",
        "--dae-stem-pool", "1", "--dae-depth", "3",
        "--dae-widths", "8", "16", "32",
        "--batch-size", "4", "--pp", "--devices", "2",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "pipeline-parallel serving: 2 stages" in out
    assert "per-class IoU" in out
