"""Data layer: dataset configs, loaders, jittable preprocessing.

Rebuild of ``[ref: data_loader.py]`` + the external ``dataset_loaders``
package the reference wraps (SURVEY.md §4.5). The host side only decodes and
batches; geometric/photometric preprocessing (crop, flip, normalize) and the
label corruption are jittable and run on-chip, fused into the surrounding
program (north star, BASELINE.json:5).
"""

from iterative_inference_segm.data.config_datasets import DATASET_CONFIGS, DatasetConfig
from iterative_inference_segm.data.synthetic import synthetic_batches, synthetic_example
from iterative_inference_segm.data.pipeline import (
    normalize_image,
    random_crop_and_flip,
    eval_preprocess,
)
from iterative_inference_segm.data.camvid import load_split, iterate_split
from iterative_inference_segm.data.loaders import load_dataset_split
from iterative_inference_segm.data.prefetch import device_prefetch
from iterative_inference_segm.data.native_loader import NativeDataset, pack_dataset
