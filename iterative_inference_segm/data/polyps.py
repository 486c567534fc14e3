"""CVC Polyps (colonoscopy) dataset loading.

The reference's third dataset family, reached through ``dataset_loaders``
(``[ref: data_loader.py]``, SURVEY.md §1 "CVC Polyps endoscopy"). Public
distributions (CVC-ClinicDB / CVC-ColonDB / the 912 split) ship as per-split
directories of frames plus binary polyp masks:

    <root>/<split>/images/*.{bmp,png,tif,jpg}
    <root>/<split>/masks/*.{bmp,png,tif}        (white = polyp)

with split names train / valid|val / test. Masks binarize to class 1
(polyp) for raw > 127, class 0 (background) otherwise — matching
``config_datasets.POLYPS``. Frames are resized to the dataset's canonical
(cfg.height, cfg.width); masks resize with nearest-neighbour.
"""

from __future__ import annotations

import os

import numpy as np

from iterative_inference_segm.data.config_datasets import DatasetConfig, POLYPS
from iterative_inference_segm.data.loaders import load_image_label_dir


def _binarize_mask(raw: np.ndarray) -> np.ndarray:
    return (raw > 127).astype(np.int32)


def load_split(
    root: str | os.PathLike,
    split: str,
    cfg: DatasetConfig = POLYPS,
) -> tuple[np.ndarray, np.ndarray]:
    """Load a Polyps split: (images f32 [0,1] (N,H,W,3), labels i32 (N,H,W))."""
    return load_image_label_dir(
        root, split, cfg, label_transform=_binarize_mask, grayscale=False
    )
