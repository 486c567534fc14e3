"""bf16-vs-f32 parity guards for the performance path.

The flagship bench runs bf16 compute; parity demands the refined predictions
stay essentially identical to the f32 path (BASELINE 'within 0.3 IoU
points'). These tests pin argmax agreement between the two dtype policies on
the full pipeline at small shapes.
"""

import numpy as np
import jax
import jax.numpy as jnp

from iterative_inference_segm.inference import make_refiner
from iterative_inference_segm.models import (
    init_fcn8,
    fcn8_apply,
    init_dae,
    dae_apply,
)

C = 5


def _pipeline_outputs(compute_dtype):
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=32)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512})
    refine = make_refiner(
        fcn8_apply, dae_apply, fcn, dae, eps=0.1, num_steps=3,
        h_taps=("pool4",), compute_dtype=compute_dtype,
    )
    x = jax.random.normal(jax.random.PRNGKey(2), (2, 48, 64, 3))
    y0, yk = refine(x)
    return np.asarray(y0), np.asarray(yk)


def test_bf16_refinement_argmax_parity_with_f32():
    y0_f, yk_f = _pipeline_outputs(jnp.float32)
    y0_b, yk_b = _pipeline_outputs(jnp.bfloat16)
    agree0 = (y0_f.argmax(-1) == y0_b.argmax(-1)).mean()
    agreek = (yk_f.argmax(-1) == yk_b.argmax(-1)).mean()
    assert agree0 > 0.97, agree0
    assert agreek > 0.97, agreek
    # probability maps stay close in L1
    assert np.abs(yk_f - yk_b).mean() < 0.02


def test_bf16_refinement_stays_probability_map():
    _, yk = _pipeline_outputs(jnp.bfloat16)
    assert np.isfinite(yk).all()
    np.testing.assert_allclose(yk.sum(-1), 1.0, rtol=1e-3)
