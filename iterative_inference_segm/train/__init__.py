"""Training workloads: shared trainer scaffold + FCN-8 / DAE loops.

Rebuild of ``[ref: train_fcn8.py]`` and ``[ref: train_dae.py]`` (SURVEY.md
§4.1-4.2): optax Adam + weight decay, per-epoch train/val metrics, early
stopping on validation jaccard with patience, npz checkpoints of the best
model.
"""

from iterative_inference_segm.train.loop import (
    TrainConfig,
    TrainState,
    EarlyStopper,
    make_optimizer,
)
from iterative_inference_segm.train.train_fcn8 import train_fcn8
from iterative_inference_segm.train.train_dae import train_dae
