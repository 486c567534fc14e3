"""First-contact rehearsal (VERDICT r2 weak #7): the actual day-one command
path — ``scripts/iterative_inference.py --dataset camvid --data-root <tree>
--fcn-reference-npz <positional Lasagne npz> --search`` — end-to-end through
the CLI, on a CamVid-layout fixture tree and a synthetic reference-era
checkpoint. The pieces (import, disk loaders, search) are unit-tested
elsewhere; this pins the SEAM so the day real CamVid data + published
weights appear, the one command is already rehearsed."""

import importlib.util
import os

import numpy as np
import jax
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    path = os.path.join(_ROOT, "scripts", name)
    spec = importlib.util.spec_from_file_location(name.removesuffix(".py"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_camvid_tree(root, splits=("val", "test"), n=4, hw=(48, 64), n_classes=11):
    rng = np.random.default_rng(0)
    for split in splits:
        (root / split).mkdir(parents=True)
        (root / f"{split}annot").mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8)
            Image.fromarray(img).save(root / split / f"f{i:03d}.png")
            lab = rng.integers(0, n_classes, size=hw).astype(np.uint8)
            Image.fromarray(lab).save(root / f"{split}annot" / f"f{i:03d}.png")


def test_first_contact_rehearsal(tmp_path, capsys):
    from iterative_inference_segm.models import init_fcn8

    # tests reuse the synthetic reference-checkpoint builders the import unit
    # tests already validate — this test is about the CLI seam
    from tests.test_import_weights import (
        _positional_list,
        _synthetic_reference_checkpoint,
    )

    data_root = tmp_path / "camvid"
    _write_camvid_tree(data_root)

    # a reference-era positional np.savez(*get_all_param_values(net)) for the
    # --tiny template (fc_channels=64)
    template = init_fcn8(jax.random.PRNGKey(0), n_classes=11, fc_channels=64)
    ckpt = _synthetic_reference_checkpoint(template, np.random.default_rng(1))
    ref_npz = tmp_path / "reference_fcn8.npz"
    np.savez(ref_npz, *_positional_list(template, ckpt))

    iterative_inference = _load_script("iterative_inference.py")
    rc = iterative_inference.main([
        "--dataset", "camvid", "--data-root", str(data_root),
        "--fcn-reference-npz", str(ref_npz),
        "--tiny", "--search", "--eps-grid", "0.1", "--k-max", "1",
        "--batch-size", "2",
        "--dae-widths", "8", "16", "32", "64",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "val search: best eps=" in out
    assert "step 0 (FCN-8 baseline): mIoU" in out
    assert "per-class IoU" in out
    # the CamVid class table printed in full
    assert "sky" in out and "bicyclist" in out


@pytest.mark.parametrize("tied", [False, True])
def test_first_contact_mirror_rehearsal(tmp_path, capsys, tied):
    """PARITY.md §3B: the mirror-DAE import command through the real CLI —
    reference-era positional FCN npz + positional mirror-DAE npz (tied and
    untied layouts), ending in the searched per-class IoU table."""
    from iterative_inference_segm.models import init_fcn8
    from iterative_inference_segm.models.dae import DAE_H_CHANNELS
    from iterative_inference_segm.models.dae_mirror import init_mirror_dae

    from tests.test_import_weights import (
        _positional_list,
        _synthetic_reference_checkpoint,
    )
    from tests.test_mirror_dae import _to_positional

    data_root = tmp_path / "camvid"
    _write_camvid_tree(data_root)

    template = init_fcn8(jax.random.PRNGKey(0), n_classes=11, fc_channels=64)
    ckpt = _synthetic_reference_checkpoint(template, np.random.default_rng(1))
    fcn_npz = tmp_path / "reference_fcn8.npz"
    np.savez(fcn_npz, *_positional_list(template, ckpt))

    # a reference-era positional mirror-DAE checkpoint (the assumed Lasagne
    # build order — utils.import_weights.group_mirror_dae_arrays)
    dae_src = init_mirror_dae(
        jax.random.PRNGKey(3), n_classes=11,
        h_specs={"pool1": DAE_H_CHANNELS["pool1"]}, depth=2, widths=(8, 12),
        tied=tied,
    )
    dae_npz = tmp_path / "reference_dae.npz"
    np.savez(dae_npz, *_to_positional(dae_src, 2, tied))

    iterative_inference = _load_script("iterative_inference.py")
    argv = [
        "--dataset", "camvid", "--data-root", str(data_root),
        "--fcn-reference-npz", str(fcn_npz),
        "--arch", "mirror", "--dae-mirror-npz", str(dae_npz),
        "--dae-depth", "2", "--dae-widths", "8", "12",
        "--concat-h", "pool1",
        "--tiny", "--search", "--eps-grid", "0.1", "--k-max", "1",
        "--batch-size", "2",
    ]
    if tied:
        argv.append("--dae-tied")
    rc = iterative_inference.main(argv)
    assert rc == 0
    out = capsys.readouterr().out
    assert "val search: best eps=" in out
    assert "step 0 (FCN-8 baseline): mIoU" in out
    assert "per-class IoU" in out
