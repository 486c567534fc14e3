"""Iterative-inference engine: K score/energy gradient steps in one lax.scan."""

from iterative_inference_segm.inference.iterative import (
    refinement_scan,
    make_refiner,
    refine_with_trajectory,
)
from iterative_inference_segm.inference.search import (
    grid_search_eps_k,
    grid_search_eps_k_half,
)
from iterative_inference_segm.inference.fused import (
    make_half_refiner,
    make_fused_refiner,
    halfres_refinement_scan,
    halfres_refine,
    flagship_forward_fn,
)
from iterative_inference_segm.inference.predictor import Predictor
