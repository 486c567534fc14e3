"""Real on-disk layouts for the EM / Polyps dataset families (VERDICT r1
missing #1): tiny fixture trees exercising every accepted layout plus the
unified dispatcher and the pack_dataset route."""

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image

from iterative_inference_segm.data.config_datasets import EM, POLYPS
from iterative_inference_segm.data.em import load_split as load_em
from iterative_inference_segm.data.polyps import load_split as load_polyps
from iterative_inference_segm.data.loaders import load_dataset_split


@pytest.fixture()
def isbi_tree(tmp_path):
    """ISBI-style multi-page TIFF stacks: 30 slices of 512x512 (shrunk to 64)."""
    import dataclasses

    cfg = dataclasses.replace(EM, height=64, width=64)
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 256, size=(30, 64, 64), dtype=np.uint8)
    # label slices: white (255) cell interior, black membrane grid
    lab = np.zeros((30, 64, 64), np.uint8)
    lab[:, ::7, :] = 0
    lab[:] = 255
    lab[:, ::7, :] = 0
    frames_v = [Image.fromarray(v) for v in vol]
    frames_l = [Image.fromarray(l) for l in lab]
    frames_v[0].save(tmp_path / "train-volume.tif", save_all=True, append_images=frames_v[1:])
    frames_l[0].save(tmp_path / "train-labels.tif", save_all=True, append_images=frames_l[1:])
    return tmp_path, cfg, vol, lab


def test_em_isbi_stack_splits(isbi_tree):
    root, cfg, vol, lab = isbi_tree
    tr_i, tr_l = load_em(root, "train", cfg)
    va_i, va_l = load_em(root, "val", cfg)
    te_i, te_l = load_em(root, "test", cfg)
    assert tr_i.shape == (24, 64, 64, 1) and va_i.shape == (3, 64, 64, 1)
    assert te_i.shape == (3, 64, 64, 1)
    # deterministic slice partition, [0,1] scaling, binarized labels
    np.testing.assert_allclose(tr_i[..., 0], vol[:24].astype(np.float32) / 255.0)
    np.testing.assert_array_equal(va_l, (lab[24:27] > 127).astype(np.int32))
    assert set(np.unique(tr_l)) <= {0, 1}


def test_em_unknown_split_raises(isbi_tree):
    root, cfg, _, _ = isbi_tree
    with pytest.raises(ValueError):
        load_em(root, "blurf", cfg)


def _write_dir_dataset(root, split, n, hw, *, img_sub="images", lab_sub="labels",
                       channels=3, lab_values=(0, 255)):
    rng = np.random.default_rng(hash(split) % 2**32)
    (root / split / img_sub).mkdir(parents=True)
    (root / split / lab_sub).mkdir(parents=True)
    for i in range(n):
        img = rng.integers(0, 256, size=(*hw, channels), dtype=np.uint8)
        if channels == 1:
            Image.fromarray(img[..., 0]).save(root / split / img_sub / f"s{i:02d}.png")
        else:
            Image.fromarray(img).save(root / split / img_sub / f"s{i:02d}.png")
        lab = rng.choice(np.array(lab_values, np.uint8), size=hw)
        Image.fromarray(lab).save(root / split / lab_sub / f"mask_s{i:02d}.png")


def test_polyps_dir_layout_with_valid_alias_and_resize(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(POLYPS, height=48, width=40)
    _write_dir_dataset(tmp_path, "train", 3, (24, 20), lab_sub="masks")
    _write_dir_dataset(tmp_path, "valid", 2, (48, 40), lab_sub="masks")  # 'valid' alias
    tr_i, tr_l = load_polyps(tmp_path, "train", cfg)
    va_i, va_l = load_polyps(tmp_path, "val", cfg)
    assert tr_i.shape == (3, 48, 40, 3)  # resized up to canonical size
    assert va_i.shape == (2, 48, 40, 3)
    assert tr_l.shape == (3, 48, 40) and set(np.unique(tr_l)) <= {0, 1}
    assert tr_i.dtype == np.float32 and tr_i.max() <= 1.0


def test_em_directory_layout(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(EM, height=32, width=32)
    _write_dir_dataset(tmp_path, "train", 2, (32, 32), channels=1)
    imgs, labs = load_em(tmp_path, "train", cfg)
    assert imgs.shape == (2, 32, 32, 1)
    assert set(np.unique(labs)) <= {0, 1}


def test_dispatcher_routes_by_name(isbi_tree):
    root, cfg, _, _ = isbi_tree
    imgs, labs = load_dataset_split("em", root, "val", cfg)
    assert imgs.shape == (3, 64, 64, 1)
    with pytest.raises(ValueError):
        load_dataset_split("nope", root, "val", cfg)


def test_missing_layout_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_polyps(tmp_path, "train", POLYPS)


def test_mismatched_counts_raise(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(POLYPS, height=16, width=16)
    _write_dir_dataset(tmp_path, "train", 2, (16, 16), lab_sub="masks")
    # remove one mask
    masks = sorted((tmp_path / "train" / "masks").iterdir())
    masks[0].unlink()
    with pytest.raises(ValueError):
        load_polyps(tmp_path, "train", cfg)


def test_pack_em_end_to_end(isbi_tree, tmp_path_factory):
    """BASELINE config 5's second-dataset path: real EM layout -> packed IIST
    -> native loader round trip."""
    root, cfg, _, _ = isbi_tree
    out = tmp_path_factory.mktemp("packed")
    from iterative_inference_segm.data.native_loader import NativeDataset, pack_dataset

    imgs, labs = load_em(root, "val", cfg)
    pack_dataset(out / "val.iist", imgs, labs, cfg)
    with NativeDataset(out / "val.iist") as ds:
        assert (ds.n, ds.height, ds.width, ds.channels) == (3, 64, 64, 1)
        batches = list(ds.batches(3))
    assert len(batches) == 1
    np.testing.assert_array_equal(batches[0][1], labs)
