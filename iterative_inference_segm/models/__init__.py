"""Model zoo: FCN-8 segmenter, conditional DAE score network, context module.

Re-designs of ``[ref: models/fcn8.py]``, ``[ref: models/DAE_h.py]``
and ``[ref: models/contextmod.py]`` — pure functions over param pytrees, NHWC,
bf16-capable with f32 accumulation.
"""

from iterative_inference_segm.models.fcn8 import (
    init_fcn8,
    fcn8_apply,
    FCN8_FEATURES,
)
from iterative_inference_segm.models.dae import (
    init_dae,
    dae_apply,
    DAE_H_CHANNELS,
)
from iterative_inference_segm.models.contextmod import (
    init_contextmod,
    contextmod_apply,
)
from iterative_inference_segm.models.dae_mirror import (
    init_mirror_dae,
    mirror_dae_apply,
)
