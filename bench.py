"""Benchmark: FCN-8 + K-step DAE refinement throughput on one GPU.

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "images/sec/device",
     "device": {"platform": "gpu", "kind": "...", "count": N}}

The default configuration is the flagship pipeline: CamVid 360x480 images
through FCN-8 (producing y0 and the conditioning features h), then K=5 DAE
score-refinement steps fused into a single ``lax.scan``, at batch 128 in
bf16. Each timed call ends in ``jax.block_until_ready``. The benchmark
refuses to run without a GPU: a CPU number is not a device number.

Usage: python bench.py [--batch N] [--steps K] [--iters I] [--height H]
                       [--width W] [--dtype bf16|f32]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--fc-channels", type=int, default=4096)
    # Flagship DAE config: stem_pool=1, depth=3 — accuracy-verified by the
    # synthetic demo (+10.1 mIoU over the FCN with the natural-corruption
    # sigma=0 recipe, vs +10.4 for the full-res stem0/d4 variant) and ~20%
    # faster. Both configs demonstrably deliver the refinement capability.
    p.add_argument("--dae-stem-pool", type=int, default=1,
                   help="DAE stem pooling levels (0 = classic full-res encoder)")
    p.add_argument("--dae-depth", type=int, default=None,
                   help="score-network depth (default 3 for --arch dae, "
                        "4 for --arch mirror — each arch's shipped config)")
    p.add_argument("--dae-widths", nargs="*", type=int, default=None,
                   help="encoder channel widths (default from models.dae)")
    p.add_argument("--dae-encoder", choices=["pool", "stride"], default="pool",
                   help="DAE encoder style: classic conv+maxpool or stride-2 "
                        "convs (same param shapes; see models.dae.dae_core)")
    p.add_argument("--dae-tail", choices=["full", "sep"], default="full",
                   help="refinement tail: dense CxC (round-1) or separable "
                        "(depthwise up + depthwise 3x3 + 1x1 mix)")
    p.add_argument("--arch", choices=["dae", "mirror"], default="dae",
                   help="score network: 'dae' (score-fusion flagship) or "
                        "'mirror' (strict-parity conv/pool <-> unpool/conv "
                        "architecture, models/dae_mirror.py; requires "
                        "--engine general — it has no pooled-stem variant)")
    p.add_argument("--mode", choices=["score", "energy"], default="score",
                   help="refinement update: direct score (y - r(y,h)) or "
                        "energy (grad through the DAE of 0.5*||y - r||^2, "
                        "the reference's T.grad formulation); half/quarter "
                        "and general engines both support either")
    p.add_argument("--engine", choices=["general", "half", "fused"], default="half",
                   help="refinement engine: 'general' = full-fidelity lax.scan "
                        "over dae_apply (reference semantics); 'half' = K steps "
                        "on the pooled map + one full-res rectification (the "
                        "throughput configuration, accuracy-validated by the "
                        "synthetic demo); 'fused' = phase-major experiment "
                        "(slower than general — kept for the record)")
    p.add_argument("--state-dtype", choices=["bf16", "f32", "compute"], default="compute",
                   help="refinement carry dtype for the general engine "
                        "('compute' follows --dtype)")
    p.add_argument("--no-fold-tail", action="store_true",
                   help="half engine: disable the folded per-step tail "
                        "(inference/fused.fold_half_tail) for A/B runs")
    p.add_argument("--preset", choices=["fast"], default=None,
                   help="named configuration: 'fast' = fc512 + stride "
                        "encoder + quarter engine. Overrides the individual "
                        "config flags")
    args = p.parse_args()
    if args.preset == "fast":
        args.fc_channels = 512
        args.dae_encoder = "stride"
        args.dae_stem_pool = 2
        args.dae_depth = 3
        args.engine = "half"
        args.dae_tail = "full"
        args.arch = "dae"
        args.mode = "score"
    if args.arch == "mirror" and args.engine != "general":
        raise SystemExit("--arch mirror requires --engine general (the mirror "
                         "architecture is full-res only — no pooled stem)")
    if args.mode == "energy" and args.engine == "fused":
        raise SystemExit("--mode energy is not supported by the fused "
                         "phase-major experiment (score only)")
    arch_default_depth = 4 if args.arch == "mirror" else 3
    if args.dae_depth is None:
        args.dae_depth = arch_default_depth

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1

    from iterative_inference_segm.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from iterative_inference_segm.models import (
        init_fcn8,
        fcn8_apply,
        init_dae,
        dae_apply,
    )
    from iterative_inference_segm.models.dae import DAE_H_CHANNELS
    from iterative_inference_segm.inference.iterative import refinement_scan
    from iterative_inference_segm.data.synthetic import synthetic_batches
    from iterative_inference_segm.data.config_datasets import CAMVID

    compute_dtype = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32
    n_classes = CAMVID.n_classes

    fcn_params = init_fcn8(
        jax.random.PRNGKey(0), n_classes=n_classes, fc_channels=args.fc_channels
    )
    if args.arch == "mirror":
        from iterative_inference_segm.models.dae_mirror import init_mirror_dae

        dae_params = init_mirror_dae(
            jax.random.PRNGKey(1),
            n_classes=n_classes,
            h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
            depth=args.dae_depth,
            **({"widths": tuple(args.dae_widths)} if args.dae_widths else {}),
        )
    else:
        dae_params = init_dae(
            jax.random.PRNGKey(1),
            n_classes=n_classes,
            h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
            depth=args.dae_depth,
            stem_pool=args.dae_stem_pool,
            tail=args.dae_tail,
            **({"widths": tuple(args.dae_widths)} if args.dae_widths else {}),
        )
    if args.engine == "fused" and (args.dae_tail != "sep" or args.dae_stem_pool != 1):
        raise SystemExit("--engine fused requires --dae-tail sep --dae-stem-pool 1")
    if args.engine == "half" and args.dae_stem_pool < 1:
        raise SystemExit("--engine half requires --dae-stem-pool >= 1 "
                         "(1 = half engine, 2 = quarter engine)")
    state_dtype = {
        "bf16": jnp.bfloat16, "f32": jnp.float32, "compute": compute_dtype
    }[args.state_dtype]

    if args.engine == "half":
        # the ONE shared pipeline definition (inference/fused.py) — the same
        # function __graft_entry__.entry() and tools/serve_bench.py measure
        from iterative_inference_segm.inference.fused import flagship_forward_fn

        # the folded per-step tail is a score-mode algebra (fold_half_tail's
        # reassociation has no energy-mode analogue — halfres_refine rejects
        # the combination), so energy runs unfolded
        fold = (args.dae_tail == "full" and not args.no_fold_tail
                and args.mode == "score")
        forward = flagship_forward_fn(
            num_steps=args.steps, depth=args.dae_depth,
            compute_dtype=compute_dtype, state_dtype=state_dtype,
            encoder=args.dae_encoder, mode=args.mode, fold_tail=fold,
        )

        @jax.jit
        def pipeline(fcn_params, dae_params, x):
            _, y_k = forward(fcn_params, dae_params, x)
            return jnp.argmax(y_k, axis=-1)
    elif args.engine == "fused":
        from iterative_inference_segm.inference.fused import fused_refinement_scan
        from iterative_inference_segm.models.dae import (
            dae_core,
            precompute_bottleneck_h,
        )

        @jax.jit
        def pipeline(fcn_params, dae_params, x):
            y0, h = fcn8_apply(
                fcn_params, x, return_features=("pool4",), compute_dtype=compute_dtype,
                probs_dtype=state_dtype,
            )
            sp = args.dae_stem_pool
            bh = precompute_bottleneck_h(
                dae_params, h, depth=args.dae_depth, stem_pool=sp,
                in_hw=(x.shape[1] >> sp, x.shape[2] >> sp),
            )
            core_fn = lambda yp: dae_core(
                dae_params, yp.astype(compute_dtype), bh[2],
                depth=args.dae_depth, stem_pool=sp, bottleneck_h=bh,
                encoder=args.dae_encoder,
            )
            y_k = fused_refinement_scan(
                dae_params, core_fn, y0, eps=0.1, num_steps=args.steps,
                state_dtype=state_dtype,
            )
            return jnp.argmax(y_k, axis=-1)
    else:

        if args.arch == "mirror":
            from iterative_inference_segm.models.dae_mirror import mirror_dae_apply

            def score_fn(dae_params, y, h):
                return mirror_dae_apply(
                    dae_params, y, h, depth=args.dae_depth,
                    compute_dtype=compute_dtype, out_dtype=state_dtype,
                )
        else:

            def score_fn(dae_params, y, h):
                return dae_apply(
                    dae_params, y, h, depth=args.dae_depth,
                    compute_dtype=compute_dtype, out_dtype=state_dtype,
                    encoder=args.dae_encoder,
                )

        @jax.jit
        def pipeline(fcn_params, dae_params, x):
            y0, h = fcn8_apply(
                fcn_params, x, return_features=("pool4",), compute_dtype=compute_dtype,
                probs_dtype=state_dtype,
            )
            dae_fn = lambda y: score_fn(dae_params, y, h)
            y_k = refinement_scan(
                dae_fn, y0.astype(state_dtype), eps=jnp.asarray(0.1, state_dtype),
                num_steps=args.steps, mode=args.mode,
            )
            return jnp.argmax(y_k, axis=-1)

    (images, _), = synthetic_batches(
        cfg=CAMVID,
        batch_size=args.batch,
        num_batches=1,
        height=args.height,
        width=args.width,
        seed=0,
    )
    x = jnp.asarray(images)

    for _ in range(max(args.warmup, 1)):  # the first call compiles
        jax.block_until_ready(pipeline(fcn_params, dae_params, x))

    def timed_call() -> float:
        t0 = time.perf_counter()
        jax.block_until_ready(pipeline(fcn_params, dae_params, x))
        return time.perf_counter() - t0

    times = sorted(timed_call() for _ in range(args.iters))
    median = times[len(times) // 2]
    # non-default configuration markers, so every line is self-describing
    cfg_bits = ""
    if args.fc_channels != 4096:
        cfg_bits += f", fc={args.fc_channels}"
    if args.dae_encoder != "pool":
        cfg_bits += f", enc={args.dae_encoder}"
    if args.dae_stem_pool != 1:
        cfg_bits += f", sp={args.dae_stem_pool}"
    if args.dae_depth != arch_default_depth:
        cfg_bits += f", depth={args.dae_depth}"
    if args.arch != "dae":
        cfg_bits += f", arch={args.arch}"
    if args.mode != "score":
        cfg_bits += f", mode={args.mode}"
    if args.no_fold_tail and args.engine == "half" and args.dae_tail == "full":
        cfg_bits += ", nofold"  # only when the fold would otherwise be active
    if args.state_dtype != "compute":
        cfg_bits += f", carry={args.state_dtype}"
    if args.preset:
        cfg_bits += f", preset={args.preset}"

    result = {
        "metric": f"images/sec/device (FCN-8 + {args.steps}-step DAE refine, "
        f"{args.height}x{args.width}, {args.dtype}, batch={args.batch}, "
        f"engine={args.engine}, tail={args.dae_tail}{cfg_bits})",
        "value": args.batch / median,
        "unit": "images/sec/device",
        "seconds_per_batch": {"median": median, "min": times[0], "max": times[-1]},
        "iters": args.iters,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
