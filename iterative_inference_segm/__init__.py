"""iterative_inference_segm — iterative-inference segmentation in JAX.

A JAX/XLA framework with the capabilities of the reference
``adri-romsor/iterative_inference_segm`` (Theano/Lasagne implementation of
"Image Segmentation by Iterative Inference from Conditional Score Estimation",
arXiv:1705.07450):

* an FCN-8 fully-convolutional segmentation network (VGG16 backbone, skip
  fusions, learned bilinear-initialized transposed-conv upsampling),
* a denoising autoencoder (DAE) trained as a conditional score network over
  segmentation probability maps, optionally conditioned on intermediate FCN-8
  feature maps ``h``,
* the iterative-inference refinement loop ``y <- y - eps * dE/dy`` where
  ``dE/dy ∝ (y - r(y, h))``, compiled into a single on-chip ``lax.scan``.

Provenance note: the reference mount at /root/reference is EMPTY (verified in
SURVEY.md §0); reference citations in this package are therefore given as
``[ref: <public repo path>]`` against the public GitHub layout reconstructed
in SURVEY.md §3.1 and cannot carry line numbers.
"""

__version__ = "0.1.0"

from iterative_inference_segm import ops, models, inference, data, parallel, utils  # noqa: F401
