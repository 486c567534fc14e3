"""Native C++ input runtime tests: pack/iterate round-trip, shuffle, threads."""

import numpy as np
import pytest

from iterative_inference_segm.data.config_datasets import CAMVID
from iterative_inference_segm.data.native_loader import NativeDataset, pack_dataset


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    rng = np.random.default_rng(0)
    n, h, w, c = 13, 24, 32, 3
    images = rng.integers(0, 256, size=(n, h, w, c), dtype=np.uint8)
    labels = rng.integers(0, 12, size=(n, h, w)).astype(np.int32)
    path = tmp_path_factory.mktemp("data") / "toy.iist"
    pack_dataset(path, images, labels, CAMVID)
    return path, images, labels


def _denormalize(img):
    mean = np.array(CAMVID.mean, np.float32)
    std = np.array(CAMVID.std, np.float32)
    return (img * std + mean) * 255.0


def test_open_and_info(packed):
    path, images, labels = packed
    with NativeDataset(path) as ds:
        assert (ds.n, ds.height, ds.width, ds.channels) == images.shape
        assert ds.n_classes == 11


def test_roundtrip_values_and_order(packed):
    path, images, labels = packed
    with NativeDataset(path) as ds:
        got_imgs, got_labs = [], []
        for bi, bl in ds.batches(4):
            got_imgs.append(bi)
            got_labs.append(bl)
    # 13 samples -> 4 batches, last padded to 4
    assert len(got_imgs) == 4
    all_imgs = np.concatenate(got_imgs)[:13]
    all_labs = np.concatenate(got_labs)[:13]
    np.testing.assert_array_equal(all_labs, labels)
    # normalization round-trips to the original uint8 values
    np.testing.assert_allclose(_denormalize(all_imgs), images.astype(np.float32), atol=0.51)


def test_tail_padding_is_void(packed):
    path, _, _ = packed
    with NativeDataset(path) as ds:
        batches = list(ds.batches(4))
    last_imgs, last_labs = batches[-1]
    # sample 13 fills index 0; indices 1..3 are padding
    assert (last_labs[1:] == 11).all()
    assert (last_imgs[1:] == 0.0).all()


def test_drop_last(packed):
    path, _, _ = packed
    with NativeDataset(path) as ds:
        assert len(list(ds.batches(4, drop_last=True))) == 3


def test_shuffle_deterministic_and_complete(packed):
    path, _, labels = packed
    with NativeDataset(path) as ds:
        a = [l.copy() for _, l in ds.batches(4, shuffle=True, seed=7)]
        b = [l.copy() for _, l in ds.batches(4, shuffle=True, seed=7)]
        c = [l.copy() for _, l in ds.batches(4, shuffle=True, seed=8)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    # every sample appears exactly once per epoch
    seen = np.concatenate(a)[:13]
    orig_keys = sorted(labels.reshape(13, -1).sum(1).tolist())
    got_keys = sorted(seen.reshape(13, -1).sum(1).tolist())
    assert orig_keys == got_keys


def test_multithreaded_epoch_complete_and_ordered(packed):
    # batches are produced by many workers but must be DELIVERED in batch-
    # index order (reorder buffer) — epoch iteration is deterministic.
    path, _, labels = packed
    with NativeDataset(path) as ds:
        ref = [l.copy() for _, l in ds.batches(2, shuffle=True, seed=3, n_threads=1)]
        for _ in range(10):
            labs = [l.copy() for _, l in ds.batches(2, shuffle=True, seed=3, n_threads=7)]
            assert len(labs) == len(ref)
            for a, b in zip(labs, ref):
                np.testing.assert_array_equal(a, b)
    seen = np.concatenate(ref)[:13]
    assert sorted(seen.reshape(13, -1).sum(1).tolist()) == sorted(
        labels.reshape(13, -1).sum(1).tolist()
    )


def test_multiple_epochs_reuse_handle(packed):
    path, _, _ = packed
    with NativeDataset(path) as ds:
        for _ in range(3):
            assert len(list(ds.batches(4))) == 4


def test_raw_wire_mode_roundtrip(packed):
    # raw=True ships the stored uint8 bytes verbatim (4x fewer bytes over the
    # host->device link); the consumer normalizes on-device with
    # normalize_image(..., input_scale=255).
    path, images, labels = packed
    with NativeDataset(path) as ds:
        got = list(ds.batches(4, raw=True))
    assert all(i.dtype == np.uint8 and l.dtype == np.uint8 for i, l in got)
    all_imgs = np.concatenate([i for i, _ in got])[:13]
    all_labs = np.concatenate([l for _, l in got])[:13]
    np.testing.assert_array_equal(all_imgs, images)
    np.testing.assert_array_equal(all_labs.astype(np.int32), labels)
    # tail padding: zero image bytes, void labels
    last_imgs, last_labs = got[-1]
    assert (last_imgs[1:] == 0).all()
    assert (last_labs[1:] == CAMVID.n_classes).all()


def test_raw_wire_mode_shuffle_matches_f32_order(packed):
    # the two wire modes draw the SAME shuffled order for the same seed
    path, _, _ = packed
    with NativeDataset(path) as ds:
        raw = [l.copy() for _, l in ds.batches(4, shuffle=True, seed=5, raw=True)]
        f32 = [l.copy() for _, l in ds.batches(4, shuffle=True, seed=5)]
    for a, b in zip(raw, f32):
        np.testing.assert_array_equal(a.astype(np.int32), b)


def test_raw_wire_mode_exposes_stats(packed):
    # on-device normalization needs the header statistics
    path, _, _ = packed
    with NativeDataset(path) as ds:
        assert ds.mean == pytest.approx(CAMVID.mean, abs=1e-6)
        assert ds.std == pytest.approx(CAMVID.std, abs=1e-6)


def test_pack_maps_negative_void_to_void_label(tmp_path):
    # Regression (ADVICE r1 medium): -1 void markers must become
    # cfg.void_label, not be clipped onto class 0.
    images = np.zeros((1, 4, 4, 3), np.uint8)
    labels = np.array([[[-1, 0, 3, 255], [10, -1, 11, 200], [0, 0, 0, 0], [-1, -1, -1, -1]]])
    pack_dataset(tmp_path / "void.iist", images, labels, CAMVID)
    with NativeDataset(tmp_path / "void.iist") as ds:
        (_, labs), = list(ds.batches(1))
    expected = np.where((labels < 0) | (labels >= CAMVID.n_classes), CAMVID.void_label, labels)
    np.testing.assert_array_equal(labs[0], expected[0])


def test_pack_validates_shapes(tmp_path):
    with pytest.raises(ValueError):
        pack_dataset(
            tmp_path / "bad.iist",
            np.zeros((2, 4, 4, 3), np.uint8),
            np.zeros((3, 4, 4), np.int32),
            CAMVID,
        )


def test_open_missing_file():
    with pytest.raises(FileNotFoundError):
        NativeDataset("/nonexistent/path.iist")


def test_raw_wire_single_channel(tmp_path):
    # EM-style C=1 data through the raw gather
    import dataclasses

    from iterative_inference_segm.data.config_datasets import EM

    cfg = dataclasses.replace(EM, height=12, width=16)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (5, 12, 16, 1), np.uint8)
    labs = rng.integers(0, cfg.n_classes, (5, 12, 16)).astype(np.int32)
    pack_dataset(tmp_path / "em.iist", imgs, labs, cfg)
    with NativeDataset(tmp_path / "em.iist") as ds:
        got = list(ds.batches(5, raw=True))
    np.testing.assert_array_equal(got[0][0], imgs)
    np.testing.assert_array_equal(got[0][1].astype(np.int32), labs)


def test_stale_generator_mode_mismatch_raises(packed):
    # a partially-consumed f32 generator must fail loudly (not truncate
    # silently) once a raw epoch supersedes it on the same handle
    path, _, _ = packed
    with NativeDataset(path) as ds:
        f32_gen = ds.batches(4)
        next(f32_gen)
        raw_gen = ds.batches(4, raw=True)  # starts a raw epoch
        next(raw_gen)
        with pytest.raises(RuntimeError, match="raw"):
            next(f32_gen)


def test_stale_lib_rebuild_failure_falls_back(monkeypatch):
    # if the on-demand rebuild of a stale .so fails but a library exists,
    # loading warns and uses it instead of crashing the data path
    import subprocess
    import warnings

    from iterative_inference_segm.data import native_loader as nl

    nl._load_lib()  # ensure the library exists (builds if needed)
    old = nl._LIB_PATH.stat()
    monkeypatch.setattr(nl, "_lib", None)  # force a reload
    import os

    os.utime(nl._LIB_PATH, (old.st_atime, 1.0))  # make it look stale
    try:
        def boom(*a, **k):
            raise subprocess.CalledProcessError(1, "make")

        monkeypatch.setattr(nl.subprocess, "run", boom)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            lib = nl._load_lib()
        assert lib is not None
        assert any("rebuild failed" in str(x.message) for x in w)
    finally:
        os.utime(nl._LIB_PATH, (old.st_atime, old.st_mtime))
    # monkeypatch teardown restores nl._lib to the pre-test library
