"""Utilities: checkpointing, experiment naming, visualization."""

from iterative_inference_segm.utils.checkpoint import (
    save_checkpoint,
    restore_checkpoint,
    restore_checkpoint_sharded,
    save_npz,
    load_npz,
)
from iterative_inference_segm.utils.experiment import (
    build_experiment_name,
    MetricLogger,
)
from iterative_inference_segm.utils.colorize import colorize_labels, save_label_png
