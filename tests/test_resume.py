"""Checkpoint/resume: a killed run restarts from the latest epoch state."""

import numpy as np
import jax

from iterative_inference_segm.data.synthetic import synthetic_batches
from iterative_inference_segm.models import init_fcn8
from iterative_inference_segm.train import TrainConfig, train_fcn8, train_dae
from tests.test_train import TINY


def _data():
    train = list(synthetic_batches(cfg=TINY, batch_size=2, num_batches=2, height=48, width=64, seed=0))
    val = list(synthetic_batches(cfg=TINY, batch_size=2, num_batches=1, height=48, width=64, seed=9))
    return train, val


def test_fcn8_resume_continues_from_checkpoint(tmp_path):
    train, val = _data()
    tcfg2 = TrainConfig(learning_rate=1e-3, max_epochs=2, patience=10, seed=0)
    tcfg4 = TrainConfig(learning_rate=1e-3, max_epochs=4, patience=10, seed=0)

    # run 2 epochs ("the run dies"), then restart asking for 4
    r1 = train_fcn8(dataset=TINY, train_data=train, val_data=val, tcfg=tcfg2,
                    fc_channels=16, workdir=str(tmp_path))
    assert len(r1["history"]) == 2

    r2 = train_fcn8(dataset=TINY, train_data=train, val_data=val, tcfg=tcfg4,
                    fc_channels=16, workdir=str(tmp_path))
    # resumed run executes only epochs 2..3 but reports the merged history
    epochs_run = [h["epoch"] for h in r2["history"]]
    assert epochs_run[-1] == 3
    assert len(epochs_run) == 4  # 2 restored + 2 new


def test_fcn8_resume_disabled_restarts(tmp_path):
    train, val = _data()
    tcfg = TrainConfig(learning_rate=1e-3, max_epochs=1, patience=10, seed=0)
    train_fcn8(dataset=TINY, train_data=train, val_data=val, tcfg=tcfg,
               fc_channels=16, workdir=str(tmp_path))
    r = train_fcn8(dataset=TINY, train_data=train, val_data=val, tcfg=tcfg,
                   fc_channels=16, workdir=str(tmp_path), resume=False)
    assert [h["epoch"] for h in r["history"]] == [0]


def test_fcn8_resume_restores_true_best_params(tmp_path):
    """Regression (VERDICT r1 weak #5): after restore, best_params must come
    from best_fcn8.npz (the actual best epoch), not the latest checkpoint."""
    from iterative_inference_segm.utils.checkpoint import load_npz

    train, val = _data()
    tcfg2 = TrainConfig(learning_rate=1e-3, max_epochs=2, patience=10, seed=0)
    r1 = train_fcn8(dataset=TINY, train_data=train, val_data=val, tcfg=tcfg2,
                    fc_channels=16, workdir=str(tmp_path))

    # Doctor the on-disk best npz to a recognizable value, then resume with
    # max_epochs == already-run epochs (no new training happens): the
    # returned params must equal the npz, NOT the latest checkpoint.
    import numpy as np
    from iterative_inference_segm.utils.checkpoint import save_npz

    marked = jax.tree.map(lambda a: np.full(np.shape(a), 7.25, np.float32), r1["params"])
    save_npz(tmp_path / "best_fcn8.npz", marked)
    r2 = train_fcn8(dataset=TINY, train_data=train, val_data=val, tcfg=tcfg2,
                    fc_channels=16, workdir=str(tmp_path))
    leaf = jax.tree.leaves(r2["params"])[0]
    np.testing.assert_allclose(np.asarray(leaf), 7.25)


def test_dae_resume(tmp_path):
    train, val = _data()
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=TINY.n_classes, fc_channels=16)
    tcfg1 = TrainConfig(learning_rate=1e-3, max_epochs=1, patience=10, seed=0)
    tcfg3 = TrainConfig(learning_rate=1e-3, max_epochs=3, patience=10, seed=0)
    train_dae(fcn_params=fcn, dataset=TINY, train_data=train, val_data=val,
              tcfg=tcfg1, workdir=str(tmp_path), sigma=0.5)
    r = train_dae(fcn_params=fcn, dataset=TINY, train_data=train, val_data=val,
                  tcfg=tcfg3, workdir=str(tmp_path), sigma=0.5)
    assert [h["epoch"] for h in r["history"]][-1] == 2
    assert len(r["history"]) == 3
