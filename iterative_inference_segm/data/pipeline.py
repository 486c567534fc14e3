"""Jittable preprocessing: normalize, random crop, horizontal flip.

The reference's augmentation lives host-side in ``dataset_loaders`` threads
(SURVEY.md §4.5: crop 224x224 train / full-size eval, hflip, normalize).
Here every transform is a pure jax function on batched arrays so it fuses
into the training program on-chip; the host only decodes bytes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from iterative_inference_segm.data.config_datasets import DatasetConfig


def normalize_image(
    x: jax.Array, cfg: DatasetConfig, *, input_scale: float = 1.0
) -> jax.Array:
    """(x/input_scale - mean) / std with per-dataset statistics; any float
    dtype in, f32 out.

    ``input_scale`` declares the input encoding explicitly: 1.0 (default) for
    the repo-wide [0,1] convention (every in-repo loader emits [0,1] f32),
    255.0 for raw byte-range input. The encoding is a property of the data
    source, never inferred from batch content — a data-dependent guess would
    normalize a genuinely dark [0,255] image differently from its batch-mates.
    """
    x = x.astype(jnp.float32)
    if input_scale != 1.0:
        x = x / jnp.float32(input_scale)
    mean = jnp.asarray(cfg.mean, jnp.float32)
    std = jnp.asarray(cfg.std, jnp.float32)
    return (x - mean) / std


def random_crop_and_flip(
    key: jax.Array,
    image: jax.Array,
    labels: jax.Array,
    *,
    crop: tuple[int, int],
) -> tuple[jax.Array, jax.Array]:
    """Per-sample random crop + horizontal flip for a batch (vmapped inside).

    image: (B, H, W, C) f32; labels: (B, H, W) int. Crop offsets and flip
    bits are drawn per sample. Uses dynamic_slice so the compiled program has
    static output shapes.
    """
    b, h, w, _ = image.shape
    ch, cw = crop
    k_off, k_flip = jax.random.split(key)
    oy = jax.random.randint(k_off, (b,), 0, h - ch + 1)
    ox = jax.random.randint(jax.random.fold_in(k_off, 1), (b,), 0, w - cw + 1)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))

    # Separable row/column take_along_axis with the flip folded into the
    # column indices, in place of a vmapped dynamic_slice (a per-sample
    # offset gather): each gather indexes rows or columns, never the channel
    # dim, and the folded flip removes the whole-crop `where` pass. Element
    # selection is identical to crop-then-flip — outputs are bit-equal to
    # the dynamic_slice form (pinned by test_data.py), and normalize/crop
    # order is measured neutral so callers need not change.
    rows = oy[:, None] + jnp.arange(ch)
    cols = ox[:, None] + jnp.arange(cw)
    cols = jnp.where(flip[:, None], cols[:, ::-1], cols)
    img_r = jnp.take_along_axis(image, rows[:, :, None, None], axis=1)
    img_c = jnp.take_along_axis(img_r, cols[:, None, :, None], axis=2)
    lab_r = jnp.take_along_axis(labels, rows[:, :, None], axis=1)
    lab_c = jnp.take_along_axis(lab_r, cols[:, None, :], axis=2)
    return img_c, lab_c


def eval_preprocess(image: jax.Array, cfg: DatasetConfig) -> jax.Array:
    """Full-resolution eval path: normalization only (reference evaluates at
    native 360x480 without crops)."""
    return normalize_image(image, cfg)
