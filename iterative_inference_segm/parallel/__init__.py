"""Parallelism: device meshes, shardings, data-parallel step transforms.

The reference is single-process single-GPU (SURVEY.md §3.4); the rebuild's
first-class parallelism axis is data parallelism over a ``jax.sharding``
mesh, with gradient reductions compiled by XLA into collectives. Optional spatial
(H/W) sharding is provided for the batched-refinement configs, tensor
parallelism for the fc6/fc7 classifier pair (``parallel.tp``, the 96%-of-
params kernels), and GPipe-style pipeline parallelism (``parallel.pp`` —
microbatches streaming through per-stage network slices via ppermute) when
the model must be split across chips.
"""

from iterative_inference_segm.parallel.mesh import make_mesh, local_device_count
from iterative_inference_segm.parallel.sharding import (
    batch_sharding,
    replicated_sharding,
    shard_batch,
    replicate,
)
from iterative_inference_segm.parallel.tp import tp_shardings, shard_params_tp
from iterative_inference_segm.parallel.pp import (
    make_gpipe,
    make_gpipe_stacked,
    make_pp_flagship,
    split_microbatches,
    merge_microbatches,
)
