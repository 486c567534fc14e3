"""EM membrane-stack (ISBI-2012-style) dataset loading.

The reference reaches EM through the external ``dataset_loaders`` package
(``[ref: data_loader.py]``, SURVEY.md §1 — "EM membrane stacks" is its second
dataset family). Two on-disk layouts are supported here:

* **ISBI stack layout** (how the challenge distributes it): multi-page TIFFs
  at the root —

      <root>/train-volume.tif     30 grayscale 512x512 slices
      <root>/train-labels.tif     30 binary membrane maps
      <root>/test-volume.tif      (optional, unlabeled)

  The 30 labeled slices are carved train/val/test = 24/3/3 in slice order
  (the public test labels were never released, so local evaluation uses the
  labeled tail — deterministic and documented rather than hidden).

* **Directory layout** — ``<root>/<split>/images/*`` + ``<root>/<split>/labels/*``
  (also accepts CamVid-style ``<split>`` / ``<split>annot`` directories).

Labels are binarized: raw > 127 -> class 1 (non-membrane / cell interior,
ISBI encodes it white), raw <= 127 -> class 0 (membrane). Matches
``config_datasets.EM`` (class_names = membrane, non_membrane).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from iterative_inference_segm.data.config_datasets import DatasetConfig, EM

# train/val/test slice partition of the 30 labeled ISBI slices
ISBI_SPLIT_SLICES = {"train": (0, 24), "val": (24, 27), "test": (27, 30)}


def _read_tiff_stack(path: Path) -> np.ndarray:
    """Read a multi-page TIFF into (N, H, W) uint8."""
    from PIL import Image

    img = Image.open(path)
    frames = []
    i = 0
    while True:
        try:
            img.seek(i)
        except EOFError:
            break
        frames.append(np.asarray(img.convert("L"), dtype=np.uint8))
        i += 1
    if not frames:
        raise ValueError(f"empty TIFF stack: {path}")
    return np.stack(frames)


def _binarize_labels(raw: np.ndarray) -> np.ndarray:
    return (raw > 127).astype(np.int32)


def load_split(
    root: str | os.PathLike,
    split: str,
    cfg: DatasetConfig = EM,
) -> tuple[np.ndarray, np.ndarray]:
    """Load an EM split: (images f32 [0,1] (N,H,W,1), labels i32 (N,H,W))."""
    root = Path(root)
    vol = root / "train-volume.tif"
    if vol.exists():
        if split not in ISBI_SPLIT_SLICES:
            raise ValueError(f"unknown EM split {split!r}; expected {sorted(ISBI_SPLIT_SLICES)}")
        lo, hi = ISBI_SPLIT_SLICES[split]
        images = _read_tiff_stack(vol)[lo:hi]
        labels = _binarize_labels(_read_tiff_stack(root / "train-labels.tif")[lo:hi])
        return images.astype(np.float32)[..., None] / 255.0, labels

    from iterative_inference_segm.data.loaders import load_image_label_dir

    return load_image_label_dir(
        root, split, cfg,
        label_transform=_binarize_labels,
        grayscale=True,
        label_subdirs=("labels", "masks", f"{split}annot"),
    )
