"""Core ops: convs, pooling, cropping, corruption, losses, metrics.

These are the rebuild's equivalents of the reference's implicit native tier
(Theano-generated CUDA + cuDNN; see SURVEY.md §3.3) and of the custom Lasagne
layers in ``[ref: layers/mylayers.py]``.
"""

from iterative_inference_segm.ops.conv import (
    conv2d,
    conv_transpose2d,
    max_pool,
    crop_to,
    bilinear_kernel,
    init_conv,
    init_conv_transpose_bilinear,
)
from iterative_inference_segm.ops.corruption import (
    corrupt_onehot,
    one_hot_probs,
)
from iterative_inference_segm.ops.losses import (
    masked_crossentropy,
    l2_regularization,
)
from iterative_inference_segm.ops.metrics import (
    confusion_matrix,
    jaccard,
    pixel_accuracy,
    SegMetrics,
)
