"""Serving-facing predictor: checkpoint -> jitted fixed-shape inference.

The reference stops at research scripts; a production rebuild needs a
deployment entry point. ``Predictor`` wraps frozen FCN-8 (+ optional DAE
refinement) behind a single object:

* loads weights from flat-npz exports (``utils.checkpoint``) or takes pytrees,
* compiles ONE fixed-batch XLA program (static shapes; arbitrary request
  sizes are chunked and zero-padded to the compiled batch),
* returns integer label maps (+ optionally probabilities),
* optionally shards each compiled batch over a ``jax.sharding.Mesh``
  ('data' axis, params replicated) — multi-chip serving is the same jitted
  program with NamedSharding-annotated inputs; XLA partitions it.

All compute (FCN forward, K-step refinement scan, argmax) runs in one jitted
program per chunk.
"""

from __future__ import annotations

from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np

from iterative_inference_segm.data.config_datasets import DatasetConfig, CAMVID
from iterative_inference_segm.data.pipeline import normalize_image
from iterative_inference_segm.inference.iterative import refinement_scan
from iterative_inference_segm.models import fcn8_apply


class Predictor:
    def __init__(
        self,
        fcn_params,
        dae_params=None,
        *,
        dataset: DatasetConfig = CAMVID,
        eps: float = 0.1,
        num_steps: int = 5,
        h_taps: tuple[str, ...] = ("pool4",),
        mode: str = "score",
        engine: str = "general",
        dae_arch: str = "dae",
        batch_size: int = 8,
        compute_dtype=jnp.bfloat16,
        normalize: bool = True,
        input_scale: float = 1.0,
        dae_kwargs: Mapping | None = None,
        mesh=None,
        pp_mesh=None,
        pp_microbatches: int = 2,
    ):
        """``dae_arch`` selects the score network the general engine serves:
        'dae' (the score-fusion flagship), 'mirror' (the reference-
        parity variant, models/dae_mirror.py), or 'contextmod'. The half
        engine is 'dae'-only (the pooled iteration needs the stem layout).

        ``pp_mesh`` serves through the stage pipeline (parallel/pp.py)
        instead of the single-program path: a mesh with a 'stage' axis of
        size 2 (FCN forward | pooled refinement) or 3 (VGG backbone |
        FCN-8 head | refinement), plus an optional 'data' axis for
        composed DP; ``pp_microbatches`` in flight per compiled batch.
        Works with both engines ('half' pipelines the pooled loop,
        'general' the reference-semantics full-res loop; a DAE is required
        either way); mutually exclusive with ``mesh`` (whose DP eval
        sharding the pipeline subsumes)."""
        self.cfg = dataset
        self.batch_size = batch_size
        self._mesh = mesh
        if mesh is not None:
            from iterative_inference_segm.parallel.sharding import (
                batch_sharding,
                replicate,
            )

            n_dp = mesh.shape["data"]
            if batch_size % n_dp:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by mesh 'data' size {n_dp}"
                )
            fcn_params = replicate(mesh, fcn_params)
            if dae_params is not None:
                dae_params = replicate(mesh, dae_params)
            self._x_sharding = batch_sharding(mesh, 4)
        self._fcn = fcn_params
        self._dae = dae_params
        dae_kwargs = dict(dae_kwargs or {})
        refine = dae_params is not None and (num_steps > 0 or engine == "half")
        if engine not in ("general", "half"):
            raise ValueError(f"unknown engine {engine!r}; expected 'general' or 'half'")
        from iterative_inference_segm.models.registry import score_apply_fn

        score_apply = score_apply_fn(dae_arch)  # validates the arch name
        if engine == "half" and dae_arch != "dae":
            raise ValueError("engine='half' serves dae_arch='dae' only")

        if pp_mesh is not None:
            if mesh is not None:
                raise ValueError(
                    "pass either mesh (DP eval sharding) or pp_mesh (pipeline)"
                )
            if not refine:
                raise ValueError(
                    "pp_mesh pipelines the refinement serving path: requires "
                    "a DAE and num_steps > 0 (or engine='half', which always "
                    "runs its rectification pass)"
                )
            from iterative_inference_segm.parallel.pp import (
                make_pp_flagship,
                merge_microbatches,
                split_microbatches,
            )

            if pp_microbatches < 1:
                raise ValueError(
                    f"pp_microbatches must be >= 1; got {pp_microbatches}"
                )
            pp_batch_axis = "data" if "data" in pp_mesh.shape else None
            pp_dp = pp_mesh.shape.get("data", 1)
            if batch_size % (pp_microbatches * pp_dp):
                raise ValueError(
                    f"batch_size {batch_size} not divisible by "
                    f"pp_microbatches {pp_microbatches} x DP width {pp_dp}"
                )
            pp_fwd = make_pp_flagship(
                pp_mesh, eps=eps, num_steps=num_steps, h_taps=h_taps,
                depth=dae_kwargs.get("depth", 4), compute_dtype=compute_dtype,
                encoder=dae_kwargs.get("encoder", "pool"), mode=mode,
                engine=engine, dae_arch=dae_arch,
                batch_axis=pp_batch_axis,
            )

            def _predict_pp(fcn_params, dae_params, x):
                if normalize:
                    x = normalize_image(x, dataset, input_scale=input_scale)
                _, yk = pp_fwd(
                    fcn_params, dae_params, split_microbatches(x, pp_microbatches)
                )
                y = merge_microbatches(yk)
                return jnp.argmax(y, axis=-1).astype(jnp.int32), y.astype(jnp.float32)

            self._predict = jax.jit(_predict_pp)
            return

        def _predict(fcn_params, dae_params, x):
            if normalize:
                # input_scale declares the input encoding explicitly (1.0 for
                # [0,1] floats, 255.0 for byte-range) — the round-1 max(x)>2
                # auto-detection was removed as a data-dependent footgun
                x = normalize_image(x, dataset, input_scale=input_scale)
            y0, h = fcn8_apply(
                fcn_params, x, return_features=h_taps if refine else (),
                compute_dtype=compute_dtype,
                # bf16 probs only when the half engine actually refines at
                # bf16 — an unrefined Predictor must return the same f32
                # softmax baseline as every other path
                probs_dtype=compute_dtype if (refine and engine == "half") else jnp.float32,
            )
            y = y0
            if refine and engine == "half":
                # the ONE shared pooled-engine refinement (inference/fused.
                # halfres_refine): serving runs the same numerics as the
                # benched flagship, folded tail whenever legal
                from iterative_inference_segm.inference.fused import halfres_refine

                y = halfres_refine(
                    dae_params, y0, h, (x.shape[1], x.shape[2]),
                    eps=eps, num_steps=num_steps,
                    depth=dae_kwargs.get("depth", 4),
                    compute_dtype=compute_dtype,
                    encoder=dae_kwargs.get("encoder", "pool"),
                    mode=mode,
                )
            elif refine:
                dae_fn = lambda yy: score_apply(
                    dae_params, yy, h, compute_dtype=compute_dtype, **dae_kwargs
                )
                y = refinement_scan(dae_fn, y0, eps=eps, num_steps=num_steps, mode=mode)
            return jnp.argmax(y, axis=-1).astype(jnp.int32), y.astype(jnp.float32)

        self._predict = jax.jit(_predict)

    @classmethod
    def from_npz(
        cls,
        fcn_npz: str,
        dae_npz: str | None = None,
        *,
        dataset: DatasetConfig = CAMVID,
        fc_channels: int = 4096,
        dae_depth: int = 4,
        dae_stem_pool: int = 0,
        dae_tail: str = "full",
        dae_widths: tuple[int, ...] | None = None,
        dae_encoder: str = "pool",
        dae_arch: str = "dae",
        dae_tied: bool = False,
        h_taps: tuple[str, ...] = ("pool4",),
        **kwargs,
    ) -> "Predictor":
        from iterative_inference_segm.models import init_fcn8
        from iterative_inference_segm.models.registry import (
            expected_meta,
            init_score_template,
            score_kwargs,
        )
        from iterative_inference_segm.utils.checkpoint import check_npz_meta, load_npz

        fcn_t = init_fcn8(
            jax.random.PRNGKey(0), n_classes=dataset.n_classes,
            in_channels=dataset.in_channels, fc_channels=fc_channels,
        )
        fcn = load_npz(fcn_npz, fcn_t)
        dae = None
        if dae_npz:
            # Fail fast on shape-invisible architecture mismatches (notably
            # encoder='pool'|'stride' — ADVICE r2); shape-visible knobs would
            # fail in load_npz anyway, but this error names the flag.
            expect = expected_meta(
                dae_arch, depth=dae_depth, stem_pool=dae_stem_pool,
                tail=dae_tail, widths=dae_widths, encoder=dae_encoder,
                tied=dae_tied,
            )
            check_npz_meta(dae_npz, expect, context=f"Predictor.from_npz({dae_npz})")
            dae_t = init_score_template(
                dae_arch, jax.random.PRNGKey(0), n_classes=dataset.n_classes,
                h_taps=h_taps, depth=dae_depth, stem_pool=dae_stem_pool,
                tail=dae_tail, widths=dae_widths, tied=dae_tied,
            )
            dae = load_npz(dae_npz, dae_t)
        return cls(
            fcn, dae, dataset=dataset, h_taps=h_taps, dae_arch=dae_arch,
            dae_kwargs=score_kwargs(dae_arch, depth=dae_depth, encoder=dae_encoder),
            **kwargs,
        )

    def predict(self, images: np.ndarray, *, return_probs: bool = False):
        """images: (N, H, W, C) float in [0,1] (the repo-wide convention).
        For byte-range [0,255] input construct the Predictor with
        ``input_scale=255.0``. Returns (N, H, W) int32 labels
        [, (N, H, W, n_classes) f32 probs]."""
        images = np.asarray(images, np.float32)
        n = images.shape[0]
        labels_out = []
        probs_out = []
        for start in range(0, n, self.batch_size):
            chunk = images[start : start + self.batch_size]
            got = chunk.shape[0]
            if got < self.batch_size:
                pad = np.zeros((self.batch_size - got, *chunk.shape[1:]), np.float32)
                chunk = np.concatenate([chunk, pad])
            if self._mesh is not None:
                # shard straight from host memory — device_put on the numpy
                # chunk avoids landing the whole batch on device 0 first
                xj = jax.device_put(chunk, self._x_sharding)
            else:
                xj = jnp.asarray(chunk)
            lab, probs = self._predict(self._fcn, self._dae, xj)
            labels_out.append(np.asarray(lab)[:got])
            if return_probs:
                probs_out.append(np.asarray(probs)[:got])
        labels = np.concatenate(labels_out)
        if return_probs:
            return labels, np.concatenate(probs_out)
        return labels
