"""CLI round-trip: a DAE trained through scripts/train_dae.py with a
non-default architecture (sep tail, custom widths) must load and refine
through scripts/iterative_inference.py with the matching flags — pins the
flag plumbing that reconstructs the param-tree template at inference."""

import importlib.util
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    path = os.path.join(_ROOT, "scripts", name)
    spec = importlib.util.spec_from_file_location(name.removesuffix(".py"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tail,widths", [("sep", ["8", "16", "32"])])
def test_train_then_infer_nondefault_dae_arch(tmp_path, tail, widths):
    train_dae = _load_script("train_dae.py")
    iterative_inference = _load_script("iterative_inference.py")

    workdir = tmp_path / "dae"
    rc = train_dae.main([
        "--synthetic", "--tiny", "--max-epochs", "1",
        "--batch-size", "4", "--num-train-batches", "2", "--num-val-batches", "1",
        "--dae-stem-pool", "1", "--dae-depth", "3",
        "--dae-tail", tail, "--dae-widths", *widths,
        "--workdir", str(workdir),
    ])
    assert rc in (0, None)
    dae_npz = workdir / "best_dae.npz"
    assert dae_npz.exists(), f"missing {dae_npz}; dir: {list(workdir.iterdir())}"

    rc = iterative_inference.main([
        "--synthetic", "--tiny", "--num-steps", "2",
        "--batch-size", "2", "--num-batches", "1",
        "--dae-npz", str(dae_npz),
        "--dae-stem-pool", "1", "--dae-depth", "3",
        "--dae-tail", tail, "--dae-widths", *widths,
        "--engine", "half",
    ])
    assert rc == 0


def test_mirror_arch_train_then_infer_and_reference_npz(tmp_path):
    """The mirror parity arch drives through both CLIs: train with
    --arch mirror, refine with the trained npz, AND load a synthetic
    reference-format positional checkpoint via --dae-mirror-npz."""
    import numpy as np
    import jax

    train_dae = _load_script("train_dae.py")
    iterative_inference = _load_script("iterative_inference.py")

    workdir = tmp_path / "mirror"
    rc = train_dae.main([
        "--synthetic", "--tiny", "--max-epochs", "1",
        "--batch-size", "4", "--num-train-batches", "2", "--num-val-batches", "1",
        "--arch", "mirror", "--dae-depth", "3", "--dae-widths", "8", "16", "32",
        "--concat-h", "pool3",
        "--workdir", str(workdir),
    ])
    assert rc in (0, None)
    dae_npz = workdir / "best_dae.npz"
    assert dae_npz.exists()

    rc = iterative_inference.main([
        "--synthetic", "--tiny", "--num-steps", "2",
        "--batch-size", "2", "--num-batches", "1",
        "--arch", "mirror", "--dae-npz", str(dae_npz),
        "--dae-depth", "3", "--dae-widths", "8", "16", "32",
        "--concat-h", "pool3",
    ])
    assert rc == 0

    # reference-format positional npz (tied variant) through --dae-mirror-npz
    from iterative_inference_segm.models import init_mirror_dae
    from tests.test_mirror_dae import _to_positional

    src = init_mirror_dae(
        jax.random.PRNGKey(3), n_classes=11,
        h_specs={"pool3": 256}, depth=3, widths=(8, 16, 32), tied=True,
    )
    ref = tmp_path / "mirror_ref.npz"
    np.savez(ref, *_to_positional(src, 3, True))
    rc = iterative_inference.main([
        "--synthetic", "--tiny", "--num-steps", "1",
        "--batch-size", "2", "--num-batches", "1",
        "--arch", "mirror", "--dae-tied", "--dae-mirror-npz", str(ref),
        "--dae-depth", "3", "--dae-widths", "8", "16", "32",
        "--concat-h", "pool3",
    ])
    assert rc == 0


def test_packed_u8_wire_trains_both_nets(tmp_path):
    """--packed --wire u8: raw uint8 batches cross the host->device link and
    both trainers normalize/cast on-chip (input_scale=255 inside the jitted
    step). Pins the whole seam: pack -> native raw batches -> CLI -> train."""
    import numpy as np

    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.data.native_loader import pack_dataset

    rng = np.random.default_rng(0)
    packed = tmp_path / "packed"
    packed.mkdir()
    for split, n in (("train", 8), ("val", 4), ("test", 4)):
        imgs = rng.integers(0, 256, (n, 96, 128, 3), np.uint8)
        labs = rng.integers(0, CAMVID.n_classes, (n, 96, 128)).astype(np.int32)
        pack_dataset(packed / f"{split}.iist", imgs, labs, CAMVID)

    train_fcn8 = _load_script("train_fcn8.py")
    fcn_dir = tmp_path / "fcn8"
    rc = train_fcn8.main([
        "--packed", str(packed), "--wire", "u8", "--tiny",
        "--max-epochs", "1", "--batch-size", "4",
        "--workdir", str(fcn_dir),
    ])
    assert rc in (0, None)
    assert (fcn_dir / "best_fcn8.npz").exists()

    train_dae = _load_script("train_dae.py")
    dae_dir = tmp_path / "dae"
    rc = train_dae.main([
        "--packed", str(packed), "--wire", "u8", "--tiny",
        "--max-epochs", "1", "--batch-size", "4",
        "--fcn-npz", str(fcn_dir / "best_fcn8.npz"),
        "--dae-stem-pool", "1", "--dae-depth", "3",
        "--dae-widths", "8", "16", "32",
        "--workdir", str(dae_dir),
    ])
    assert rc in (0, None)
    assert (dae_dir / "best_dae.npz").exists()

    # the inference workload evaluates straight from the packed file on the
    # same wire (device-resident on-chip-normalized batches)
    iterative_inference = _load_script("iterative_inference.py")
    rc = iterative_inference.main([
        "--packed", str(packed), "--wire", "u8", "--tiny",
        "--batch-size", "4", "--num-steps", "2",
        "--fcn-npz", str(fcn_dir / "best_fcn8.npz"),
        "--dae-npz", str(dae_dir / "best_dae.npz"),
        "--dae-stem-pool", "1", "--dae-depth", "3",
        "--dae-widths", "8", "16", "32",
        "--engine", "half",
    ])
    assert rc == 0
