"""Predictor (serving API) tests: chunking, padding, npz loading."""

import numpy as np
import jax
import pytest

import dataclasses

from iterative_inference_segm.data.config_datasets import CAMVID
from iterative_inference_segm.inference import Predictor
from iterative_inference_segm.models import init_fcn8, init_dae
from iterative_inference_segm.utils.checkpoint import save_npz

TINY = dataclasses.replace(CAMVID, n_classes=4, void_label=4, height=48, width=64)


@pytest.fixture(scope="module")
def params():
    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=4, fc_channels=16)
    dae = init_dae(jax.random.PRNGKey(1), n_classes=4, h_specs={"pool4": 512})
    return fcn, dae


def test_predict_fcn_only(params):
    fcn, _ = params
    p = Predictor(fcn, dataset=TINY, batch_size=2, num_steps=0)
    imgs = np.random.default_rng(0).random((3, 48, 64, 3)).astype(np.float32)
    labels = p.predict(imgs)
    assert labels.shape == (3, 48, 64)
    assert labels.dtype == np.int32
    assert labels.min() >= 0 and labels.max() < 4


def test_predict_with_refinement_and_probs(params):
    fcn, dae = params
    p = Predictor(fcn, dae, dataset=TINY, batch_size=2, num_steps=2, eps=0.1)
    imgs = np.random.default_rng(1).random((2, 48, 64, 3)).astype(np.float32)
    labels, probs = p.predict(imgs, return_probs=True)
    assert probs.shape == (2, 48, 64, 4)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-4)
    np.testing.assert_array_equal(labels, probs.argmax(-1))


def test_predict_half_engine(params):
    fcn, _ = params
    import jax.numpy as jnp

    dae1 = init_dae(jax.random.PRNGKey(2), n_classes=4, h_specs={"pool4": 512},
                    depth=3, stem_pool=1, widths=(8, 16, 32))
    p = Predictor(fcn, dae1, dataset=TINY, batch_size=2, num_steps=2, eps=0.3,
                  engine="half", compute_dtype=jnp.float32,
                  dae_kwargs={"depth": 3})
    imgs = np.random.default_rng(2).random((2, 48, 64, 3)).astype(np.float32)
    labels, probs = p.predict(imgs, return_probs=True)
    assert labels.shape == (2, 48, 64)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=2e-3)
    # half engine with num_steps=0 still rectifies (engine semantics)
    p0 = Predictor(fcn, dae1, dataset=TINY, batch_size=2, num_steps=0, eps=0.3,
                   engine="half", compute_dtype=jnp.float32,
                   dae_kwargs={"depth": 3})
    base = Predictor(fcn, None, dataset=TINY, batch_size=2, num_steps=0)
    _, pr_rect = p0.predict(imgs, return_probs=True)
    _, pr_base = base.predict(imgs, return_probs=True)
    assert np.abs(pr_rect - pr_base).max() > 1e-5


def test_predictor_input_scale_byte_range(params):
    # byte-range input declared via input_scale=255 must predict the same
    # labels as the equivalent [0,1] input (explicit contract, no heuristic)
    fcn, _ = params
    imgs01 = np.random.default_rng(7).random((2, 48, 64, 3)).astype(np.float32)
    p01 = Predictor(fcn, dataset=TINY, batch_size=2, num_steps=0)
    p255 = Predictor(fcn, dataset=TINY, batch_size=2, num_steps=0, input_scale=255.0)
    a = p01.predict(imgs01)
    b = p255.predict(imgs01 * 255.0)
    # x*255/255 is not bit-exact, so argmax ties may flip on isolated pixels
    assert np.mean(a != b) < 1e-3


def test_predict_chunking_matches_single_shot(params):
    fcn, dae = params
    imgs = np.random.default_rng(2).random((5, 48, 64, 3)).astype(np.float32)
    small = Predictor(fcn, dae, dataset=TINY, batch_size=2, num_steps=1)
    big = Predictor(fcn, dae, dataset=TINY, batch_size=5, num_steps=1)
    np.testing.assert_array_equal(small.predict(imgs), big.predict(imgs))


def test_predictor_dp_sharded_matches_single_device(params):
    from iterative_inference_segm.parallel import make_mesh

    fcn, dae = params
    mesh = make_mesh(("data",))
    imgs = np.random.default_rng(4).random((5, 48, 64, 3)).astype(np.float32)
    single = Predictor(fcn, dae, dataset=TINY, batch_size=8, num_steps=1)
    sharded = Predictor(fcn, dae, dataset=TINY, batch_size=8, num_steps=1, mesh=mesh)
    np.testing.assert_array_equal(single.predict(imgs), sharded.predict(imgs))


def test_predictor_mesh_rejects_indivisible_batch(params):
    from iterative_inference_segm.parallel import make_mesh

    fcn, _ = params
    mesh = make_mesh(("data",))
    with pytest.raises(ValueError, match="divisible"):
        Predictor(fcn, dataset=TINY, batch_size=3, mesh=mesh)


def test_predictor_from_npz(tmp_path, params):
    fcn, dae = params
    save_npz(tmp_path / "fcn.npz", jax.device_get(fcn))
    save_npz(tmp_path / "dae.npz", jax.device_get(dae))
    p = Predictor.from_npz(
        str(tmp_path / "fcn.npz"), str(tmp_path / "dae.npz"),
        dataset=TINY, fc_channels=16, batch_size=2, num_steps=1,
    )
    imgs = np.random.default_rng(3).random((2, 48, 64, 3)).astype(np.float32)
    direct = Predictor(fcn, dae, dataset=TINY, batch_size=2, num_steps=1)
    np.testing.assert_array_equal(p.predict(imgs), direct.predict(imgs))


def test_predictor_from_npz_nondefault_dae_arch(tmp_path, params):
    # a sep-tail / custom-width DAE (train_dae.py --dae-tail sep --dae-widths)
    # must be servable: from_npz rebuilds the matching template
    import jax.numpy as jnp

    fcn, _ = params
    dae = init_dae(jax.random.PRNGKey(5), n_classes=4, h_specs={"pool4": 512},
                   depth=3, stem_pool=1, widths=(8, 16, 32), tail="sep")
    save_npz(tmp_path / "fcn.npz", jax.device_get(fcn))
    save_npz(tmp_path / "dae.npz", jax.device_get(dae))
    p = Predictor.from_npz(
        str(tmp_path / "fcn.npz"), str(tmp_path / "dae.npz"),
        dataset=TINY, fc_channels=16, batch_size=2, num_steps=1,
        dae_depth=3, dae_stem_pool=1, dae_tail="sep", dae_widths=(8, 16, 32),
        engine="half", compute_dtype=jnp.float32, eps=0.3,
    )
    imgs = np.random.default_rng(6).random((2, 48, 64, 3)).astype(np.float32)
    labels = p.predict(imgs)
    assert labels.shape == (2, 48, 64)


def test_predictor_serves_mirror_arch(tmp_path):
    """The serving surface covers the reference-parity mirror DAE: direct
    pytrees AND the from_npz path with stamped metadata."""
    import jax
    import numpy as np

    from iterative_inference_segm.inference import Predictor
    from iterative_inference_segm.models import init_fcn8, init_mirror_dae
    from iterative_inference_segm.utils.checkpoint import save_npz

    fcn = init_fcn8(jax.random.PRNGKey(0), n_classes=11, fc_channels=8)
    dae = init_mirror_dae(
        jax.random.PRNGKey(1), n_classes=11, h_specs={"pool3": 256},
        depth=3, widths=(4, 8, 8), tied=True,
    )
    p = Predictor(fcn, dae, dae_arch="mirror", h_taps=("pool3",),
                  dae_kwargs={"depth": 3}, eps=0.2, num_steps=2, batch_size=2)
    imgs = np.random.default_rng(0).random((3, 48, 64, 3), np.float32)
    labels = p.predict(imgs)
    assert labels.shape == (3, 48, 64)
    assert labels.dtype == np.int32

    save_npz(tmp_path / "fcn.npz", jax.device_get(fcn), meta={"arch": "fcn8"})
    save_npz(tmp_path / "dae.npz", jax.device_get(dae), meta={
        "arch": "mirror", "depth": 3, "tied": True, "widths": (4, 8, 8),
    })
    p2 = Predictor.from_npz(
        str(tmp_path / "fcn.npz"), str(tmp_path / "dae.npz"),
        fc_channels=8, dae_arch="mirror", dae_depth=3, dae_tied=True,
        dae_widths=(4, 8, 8), h_taps=("pool3",),
        eps=0.2, num_steps=2, batch_size=2,
    )
    np.testing.assert_array_equal(p2.predict(imgs), labels)

    # half engine refuses non-dae archs loudly
    import pytest

    with pytest.raises(ValueError, match="dae_arch"):
        Predictor(fcn, dae, dae_arch="mirror", engine="half")


def test_predictor_pp_matches_half_engine(params):
    """pp_mesh serving (2-stage pipeline + composed DP) returns the exact
    probabilities of the single-program half engine in f32 — the serving
    seam of parallel/pp.py."""
    import jax.numpy as jnp

    from iterative_inference_segm.parallel import make_mesh

    fcn, _ = params
    dae1 = init_dae(jax.random.PRNGKey(2), n_classes=4, h_specs={"pool4": 512},
                    depth=3, stem_pool=1, widths=(8, 16, 32))
    common = dict(dataset=TINY, batch_size=4, num_steps=2, eps=0.3,
                  engine="half", compute_dtype=jnp.float32,
                  dae_kwargs={"depth": 3})
    seq = Predictor(fcn, dae1, **common)

    mesh = make_mesh(("data", "stage"), (2, 2), devices=jax.devices()[:4])
    pp = Predictor(fcn, dae1, pp_mesh=mesh, pp_microbatches=2, **common)

    imgs = np.random.default_rng(3).random((6, 48, 64, 3)).astype(np.float32)
    lab_seq, pr_seq = seq.predict(imgs, return_probs=True)
    lab_pp, pr_pp = pp.predict(imgs, return_probs=True)
    np.testing.assert_array_equal(lab_pp, lab_seq)
    np.testing.assert_allclose(pr_pp, pr_seq, rtol=1e-5, atol=1e-6)


def test_predictor_pp_validation(params):
    from iterative_inference_segm.parallel import make_mesh

    fcn, dae = params
    mesh = make_mesh(("stage",), (2,), devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="DAE"):
        Predictor(fcn, None, dataset=TINY, pp_mesh=mesh, num_steps=2)
    dae1 = init_dae(jax.random.PRNGKey(2), n_classes=4, h_specs={"pool4": 512},
                    depth=3, stem_pool=1, widths=(8, 16, 32))
    with pytest.raises(ValueError, match="divisible"):
        Predictor(fcn, dae1, dataset=TINY, pp_mesh=mesh, engine="half",
                  num_steps=2, batch_size=3, pp_microbatches=2,
                  dae_kwargs={"depth": 3})
