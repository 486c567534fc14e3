"""Colorized segmentation dumps (parity with the reference's PNG outputs).

Rebuild of the image-dump helpers in ``[ref: helpers.py]`` using the per-
dataset palettes from ``[ref: config_datasets.py]``.
"""

from __future__ import annotations

import os

import numpy as np

from iterative_inference_segm.data.config_datasets import DatasetConfig


def colorize_labels(labels: np.ndarray, cfg: DatasetConfig) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) uint8 using the dataset palette.
    Out-of-range labels (void) take the last palette entry."""
    labels = np.asarray(labels)
    idx = np.clip(labels, 0, len(cfg.palette) - 1)
    return cfg.palette[idx]


def save_label_png(path: str | os.PathLike, labels: np.ndarray, cfg: DatasetConfig) -> None:
    from PIL import Image

    Image.fromarray(colorize_labels(labels, cfg)).save(path)
