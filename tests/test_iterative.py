"""Iterative-inference engine tests: golden numpy trajectory, scan fusion."""

import numpy as np
import jax
import jax.numpy as jnp

from iterative_inference_segm.inference import (
    refinement_scan,
    refine_with_trajectory,
    make_refiner,
)
from iterative_inference_segm.models import (
    init_fcn8,
    fcn8_apply,
    init_dae,
    dae_apply,
)

C = 4


def _linear_dae(W, b):
    """A toy 'DAE' r(y) = y @ W + b acting on the class axis — lets the
    refinement update be reproduced exactly in numpy."""

    def fn(y):
        return jnp.einsum("bhwc,cd->bhwd", y, W) + b

    return fn


def test_score_mode_matches_numpy_golden():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(C, C)).astype(np.float32) * 0.1 + np.eye(C, dtype=np.float32)
    b = rng.normal(size=(C,)).astype(np.float32) * 0.01
    y0 = rng.random((2, 3, 5, C)).astype(np.float32)
    eps, K = 0.2, 6

    got = np.asarray(
        refinement_scan(_linear_dae(jnp.asarray(W), jnp.asarray(b)), jnp.asarray(y0), eps=eps, num_steps=K)
    )

    y = y0.copy()
    for _ in range(K):
        r = y @ W + b
        y = y - eps * (y - r)
    np.testing.assert_allclose(got, y, rtol=1e-5, atol=1e-6)


def test_energy_mode_matches_numpy_golden():
    # E(y) = 0.5||y - (yW + b)||^2  =>  dE/dy = (I - W)(y - yW - b) ... with
    # the gradient through BOTH appearances of y: dE/dy = (y - r(y)) @ (I - W)^T
    rng = np.random.default_rng(1)
    W = rng.normal(size=(C, C)).astype(np.float32) * 0.1
    b = np.zeros((C,), np.float32)
    y0 = rng.random((1, 2, 3, C)).astype(np.float32)
    eps, K = 0.1, 4

    got = np.asarray(
        refinement_scan(
            _linear_dae(jnp.asarray(W), jnp.asarray(b)),
            jnp.asarray(y0),
            eps=eps,
            num_steps=K,
            mode="energy",
        )
    )

    I = np.eye(C, dtype=np.float32)
    y = y0.copy()
    for _ in range(K):
        resid = y - (y @ W + b)
        grad = resid @ (I - W).T
        y = y - eps * grad
    np.testing.assert_allclose(got, y, rtol=1e-4, atol=1e-6)


def test_zero_steps_identity():
    y0 = jnp.ones((1, 2, 2, C)) / C
    out = refinement_scan(lambda y: y * 0.5, y0, eps=0.3, num_steps=0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(y0))


def test_fixed_point_is_stationary():
    # If r(y) == y the score is zero and iterates must not move.
    y0 = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(0), (1, 4, 4, C)), -1)
    out = refinement_scan(lambda y: y, y0, eps=0.5, num_steps=10)
    np.testing.assert_allclose(np.asarray(out), np.asarray(y0), rtol=1e-6)


def test_trajectory_prefix_consistency():
    # refine_with_trajectory[k] must equal refinement_scan with num_steps=k.
    rng = np.random.default_rng(2)
    W = jnp.asarray(rng.normal(size=(C, C)).astype(np.float32) * 0.1)
    b = jnp.zeros((C,))
    y0 = jnp.asarray(rng.random((1, 3, 3, C)).astype(np.float32))
    dae_fn = _linear_dae(W, b)
    traj = refine_with_trajectory(dae_fn, y0, eps=0.15, num_steps=5)
    assert traj.shape == (6, 1, 3, 3, C)
    np.testing.assert_array_equal(np.asarray(traj[0]), np.asarray(y0))
    for k in [1, 3, 5]:
        direct = refinement_scan(dae_fn, y0, eps=0.15, num_steps=k)
        np.testing.assert_allclose(np.asarray(traj[k]), np.asarray(direct), rtol=1e-5)


def test_softmax_renorm_keeps_simplex():
    rng = np.random.default_rng(3)
    W = jnp.asarray(rng.normal(size=(C, C)).astype(np.float32) * 0.3)
    y0 = jax.nn.softmax(jnp.asarray(rng.normal(size=(1, 4, 4, C)).astype(np.float32)), -1)
    out = refinement_scan(_linear_dae(W, jnp.zeros((C,))), y0, eps=0.3, num_steps=8, renorm="softmax")
    s = np.asarray(out).sum(-1)
    np.testing.assert_allclose(s, 1.0, rtol=1e-4)
    assert np.asarray(out).min() >= 0


def test_traced_eps_one_compile_many_values():
    # eps is a traced scalar: one jitted program serves the whole eps grid.
    trace_count = 0
    dae_fn = lambda y: y * 0.9

    @jax.jit
    def run(eps, y0):
        nonlocal trace_count
        trace_count += 1
        return refinement_scan(dae_fn, y0, eps=eps, num_steps=3)

    y0 = jnp.ones((1, 2, 2, C)) / C
    outs = [run(jnp.float32(e), y0) for e in (0.05, 0.1, 0.2)]
    assert trace_count == 1
    assert not np.allclose(np.asarray(outs[0]), np.asarray(outs[2]))


def test_end_to_end_refiner_runs_and_is_single_program():
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512})
    refine = make_refiner(
        fcn8_apply, dae_apply, fcn, dae, eps=0.1, num_steps=2, h_taps=("pool4",)
    )
    x = jax.random.normal(jax.random.PRNGKey(2), (1, 48, 64, 3))
    y0, yk = refine(x)
    assert y0.shape == yk.shape == (1, 48, 64, C)
    assert not np.allclose(np.asarray(y0), np.asarray(yk))
    # the whole thing lowers to ONE jitted computation (scan stays on-chip):
    lowered = jax.jit(lambda xx: refine(xx)).lower(x)
    text = lowered.as_text()
    assert "while" in text  # lax.scan lowers to a single while loop in HLO


def test_refinement_improves_miou_with_oracle_denoiser():
    """Capability guarantee, decoupled from training noise: given a score
    network that contracts toward the ground truth (an oracle denoiser),
    K refinement steps must strictly improve mIoU over the noisy y0."""
    from iterative_inference_segm.ops.corruption import corrupt_onehot
    from iterative_inference_segm.ops.metrics import jaccard

    n_classes = 6
    labels = jax.random.randint(jax.random.PRNGKey(0), (2, 24, 32), 0, n_classes)
    gt = jax.nn.one_hot(labels, n_classes)
    # heavily corrupted starting point (argmax agreement well below 1)
    y0 = corrupt_onehot(labels, jax.random.PRNGKey(1), n_classes=n_classes, sigma=2.0)

    oracle = lambda y: 0.5 * y + 0.5 * gt
    yk = refinement_scan(oracle, y0, eps=0.5, num_steps=6, mode="score")

    m0 = jaccard(jnp.argmax(y0, -1), labels, n_classes=n_classes)
    mk = jaccard(jnp.argmax(yk, -1), labels, n_classes=n_classes)
    assert float(m0.mean_iou) < 0.9  # corruption actually hurt
    assert float(mk.mean_iou) > float(m0.mean_iou) + 0.05
    assert float(mk.mean_iou) > 0.95  # converged close to the oracle target


def test_full_refiner_odd_image_sizes():
    # CamVid-like odd spatial sizes through FCN + DAE + scan end-to-end
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512})
    refine = make_refiner(
        fcn8_apply, dae_apply, fcn, dae, eps=0.1, num_steps=2, h_taps=("pool4",)
    )
    x = jax.random.normal(jax.random.PRNGKey(2), (1, 45, 61, 3))
    y0, yk = refine(x)
    assert yk.shape == (1, 45, 61, C)
    np.testing.assert_allclose(np.asarray(yk.sum(-1)), 1.0, rtol=1e-3)
