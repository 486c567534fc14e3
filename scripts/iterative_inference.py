#!/usr/bin/env python
"""Iterative inference — entry point mirroring ``[ref: iterative_inference.py]``.

Loads a frozen FCN-8 and a trained DAE, refines the FCN softmax output with K
score/energy gradient steps (one on-chip ``lax.scan``), and reports per-class
IoU / mIoU / accuracy at k=0 (the FCN baseline) and k=K. With ``--search`` it
first grid-searches (eps, K) on the validation split, then evaluates the best
pair on test — the rebuild of ``[ref: iterative_inference_valid.py]``.

Example:
    python scripts/iterative_inference.py --synthetic --tiny --num-steps 5
    python scripts/iterative_inference.py --fcn-npz ... --dae-npz ... \\
        --data-root /data/camvid --search --eps-grid 0.02 0.05 0.1 0.2
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="camvid", choices=["camvid", "em", "polyps"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--packed", default=None,
                   help="directory of <split>.iist files (native C++ input "
                        "runtime); evaluates val/test from the packed file")
    p.add_argument("--wire", default="f32", choices=["f32", "u8"],
                   help="packed-path wire format: 'f32' = host-normalized "
                        "floats; 'u8' = raw bytes to the device + on-device "
                        "normalize (4x fewer bytes across the link)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--fcn-npz", default=None)
    p.add_argument("--fcn-reference-npz", default=None,
                   help="load the FCN from a reference-era Lasagne positional "
                        ".npz (layout conversion automatic) — the one-command "
                        "parity check against reference weights")
    p.add_argument("--fcn-flip-deconvs", action="store_true",
                   help="with --fcn-reference-npz: reverse the spatial taps "
                        "of the transposed-conv kernels (checkpoints saved "
                        "under the flipped/convolution convention). Trained "
                        "deconvs are not symmetric, so first contact runs "
                        "BOTH conventions and keeps the one matching the "
                        "paper's baseline — see PARITY.md step A2")
    p.add_argument("--dae-npz", default=None)
    p.add_argument("--concat-h", nargs="*", default=["pool4"])
    p.add_argument("--dae-depth", type=int, default=4)
    p.add_argument("--dae-stem-pool", type=int, default=0)
    p.add_argument("--dae-tail", choices=["full", "sep"], default="full",
                   help="must match the architecture the DAE npz was trained "
                        "with (train_dae.py --dae-tail)")
    p.add_argument("--dae-widths", nargs="*", type=int, default=None,
                   help="encoder widths; must match the trained DAE npz")
    p.add_argument("--dae-encoder", choices=["pool", "stride"], default="pool",
                   help="encoder style; must match the trained DAE npz")
    p.add_argument("--arch", default="dae", choices=["dae", "mirror", "contextmod"],
                   help="score network: score-fusion DAE, reference-parity "
                        "mirror DAE, or the dilated context module")
    p.add_argument("--dae-tied", action="store_true",
                   help="mirror arch: expect a weight-tied checkpoint")
    p.add_argument("--dae-mirror-npz", default=None,
                   help="load the mirror DAE from a reference-era positional "
                        ".npz (Lasagne get_all_param_values layout; see "
                        "utils.import_weights.import_mirror_dae_npz)")
    p.add_argument("--epsilon", type=float, default=0.1)
    p.add_argument("--num-steps", type=int, default=5)
    p.add_argument("--mode", default="score", choices=["score", "energy"])
    p.add_argument("--engine", default="general", choices=["general", "half"],
                   help="'half' = throughput engine (K pooled-map steps + one "
                        "full-res rectification; requires --dae-stem-pool >= 1 "
                        "— 2 iterates at quarter res; score AND energy modes; "
                        "see ARCHITECTURE.md)")
    p.add_argument("--renorm", default="none", choices=["none", "softmax"])
    p.add_argument("--search", action="store_true", help="grid-search (eps, K) on val first")
    p.add_argument("--eps-grid", nargs="*", type=float, default=[0.02, 0.05, 0.1, 0.2])
    p.add_argument("--k-max", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--devices", default=None,
                   help="shard each eval batch over N devices ('auto' = all): "
                        "the jitted refiner runs SPMD over a 'data' mesh "
                        "(params replicated, XLA partitions the program)")
    p.add_argument("--pp", action="store_true",
                   help="serve through the stage pipeline (parallel/pp.py): "
                        "microbatches stream through per-device stages over "
                        "a 'stage' mesh axis; with --devices N > the stage "
                        "count (divisible) the batch also shards over a "
                        "composed 'data' axis. Works with both engines "
                        "(--engine half pipelines the pooled loop, general "
                        "the reference-semantics full-res loop)")
    p.add_argument("--pp-stages", type=int, choices=[2, 3], default=2,
                   help="pipeline depth: 2 = FCN forward | refinement, "
                        "3 = VGG backbone | FCN-8 head | refinement")
    p.add_argument("--pp-microbatches", type=int, default=2,
                   help="microbatches in flight per batch with --pp "
                        "(batch size must divide by microbatches x DP)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--num-batches", type=int, default=4)
    p.add_argument("--dump-dir", default=None, help="write colorized PNG predictions here")
    p.add_argument("--dump-trajectory", action="store_true",
                   help="with --dump-dir: dump every intermediate step y_0..y_K "
                        "of the first batch (the reference's y_k trajectory dumps)")
    args = p.parse_args(argv)
    if args.wire != "f32" and not args.packed:
        p.error("--wire u8 requires --packed (the wire format is a property "
                "of the packed-path input runtime)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    from iterative_inference_segm.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from iterative_inference_segm.data.config_datasets import DATASET_CONFIGS
    from iterative_inference_segm.data.pipeline import normalize_image
    from iterative_inference_segm.inference import make_refiner, grid_search_eps_k
    from iterative_inference_segm.models import init_fcn8, fcn8_apply
    from iterative_inference_segm.ops.metrics import (
        confusion_matrix,
        metrics_from_confusion,
    )
    from iterative_inference_segm.utils.checkpoint import load_npz

    cfg = DATASET_CONFIGS[args.dataset]
    height = width = None
    fc_channels = 4096
    if args.tiny:
        height, width, fc_channels = 96, 128, 64

    key = jax.random.PRNGKey(args.seed)
    fcn_template = init_fcn8(
        key, n_classes=cfg.n_classes, in_channels=cfg.in_channels, fc_channels=fc_channels
    )
    if args.fcn_reference_npz:
        from iterative_inference_segm.utils.import_weights import import_lasagne_npz

        fcn_params = import_lasagne_npz(
            args.fcn_reference_npz, fcn_template, flip_deconvs=args.fcn_flip_deconvs
        )
    elif args.fcn_npz:
        fcn_params = load_npz(args.fcn_npz, fcn_template)
    else:
        fcn_params = fcn_template
    # arch dispatch (apply / template / per-step kwargs / npz metadata) is
    # centralized in models.registry — one table for all serving surfaces
    from iterative_inference_segm.models.registry import (
        init_score_template,
        score_apply_fn,
        score_kwargs as arch_score_kwargs,
    )

    dae_template = init_score_template(
        args.arch, jax.random.PRNGKey(args.seed + 1), n_classes=cfg.n_classes,
        h_taps=tuple(args.concat_h), depth=args.dae_depth,
        stem_pool=args.dae_stem_pool, tail=args.dae_tail,
        widths=tuple(args.dae_widths) if args.dae_widths else None,
        tied=args.dae_tied,
    )
    score_apply = score_apply_fn(args.arch)
    score_kwargs = arch_score_kwargs(
        args.arch, depth=args.dae_depth, encoder=args.dae_encoder
    )
    if args.dae_mirror_npz:
        if args.arch != "mirror":
            raise SystemExit("--dae-mirror-npz requires --arch mirror")
        from iterative_inference_segm.utils.import_weights import import_mirror_dae_npz

        dae_params = import_mirror_dae_npz(args.dae_mirror_npz, dae_template)
    elif args.dae_npz:
        from iterative_inference_segm.models.registry import expected_meta
        from iterative_inference_segm.utils.checkpoint import check_npz_meta

        # shape-invisible knobs (encoder style) must match the checkpoint's
        # stamped metadata or inference silently degrades (ADVICE r2)
        expect = expected_meta(
            args.arch, depth=args.dae_depth, stem_pool=args.dae_stem_pool,
            tail=args.dae_tail,
            widths=tuple(args.dae_widths) if args.dae_widths else None,
            encoder=args.dae_encoder, tied=args.dae_tied,
        )
        check_npz_meta(args.dae_npz, expect, context=f"--dae-npz {args.dae_npz}")
        dae_params = load_npz(args.dae_npz, dae_template)
    else:
        dae_params = dae_template

    from iterative_inference_segm.parallel.mesh import mesh_from_flag

    # with --pp, --devices sizes the pipeline mesh below; the DP eval path
    # (and its own batch-divisibility rule) does not apply
    mesh = None if args.pp else mesh_from_flag(args.devices, batch_size=args.batch_size)

    pp_mesh = pp_batch_axis = None
    if args.pp:
        from iterative_inference_segm.parallel.mesh import make_mesh

        if args.pp_microbatches < 1:
            raise SystemExit(
                f"--pp-microbatches must be >= 1; got {args.pp_microbatches}"
            )
        avail = jax.devices()
        s = args.pp_stages
        n_pp = (
            len(avail) if args.devices == "auto"
            else int(args.devices) if args.devices else s
        )
        if n_pp < s or n_pp % s:
            raise SystemExit(
                f"--pp with {s} stages needs a device count divisible by {s}; got {n_pp}"
            )
        if n_pp > len(avail):
            raise SystemExit(f"--pp over {n_pp} devices but only {len(avail)} visible")
        if n_pp > s:
            pp_mesh = make_mesh(("data", "stage"), (n_pp // s, s), devices=avail[:n_pp])
            pp_batch_axis = "data"
        else:
            pp_mesh = make_mesh(("stage",), (s,), devices=avail[:s])
        pp_dp = n_pp // s
        if args.batch_size % (args.pp_microbatches * pp_dp):
            raise SystemExit(
                f"--batch-size {args.batch_size} not divisible by "
                f"--pp-microbatches {args.pp_microbatches} x DP width {pp_dp}"
            )

    if args.packed:
        import dataclasses

        from iterative_inference_segm.data.native_loader import NativeDataset

        raw_wire = args.wire == "u8"
        packed_stats = {}

        def packed_batches(split, *, device_normalize=False):
            """u8 wire: uint8 bytes cross the host->device link and a jitted
            ingest normalizes on-chip with the FILE's header statistics (the
            f32 wire's host normalize honors them, so both wires must agree
            even if the file was packed under different stats than the
            runtime --dataset config). Test batches stay host-side u8 —
            the eval loop's put_x normalizes per batch (after the sharded
            device_put on a mesh), so the whole split is never resident in
            HBM at once (ADVICE r3). Only the val split, which --search
            re-iterates per eps, is device-normalized up front."""
            with NativeDataset(os.path.join(args.packed, f"{split}.iist")) as ds:
                file_cfg = dataclasses.replace(cfg, mean=ds.mean, std=ds.std)
                packed_stats[split] = file_cfg
                norm = jax.jit(
                    lambda x: normalize_image(x, file_cfg, input_scale=255.0)
                )
                out = []
                for i, l in ds.batches(args.batch_size, raw=raw_wire):
                    lab = np.asarray(l, np.int32)
                    if raw_wire and device_normalize:
                        i = norm(jnp.asarray(i))
                    out.append((i, lab))
                return out

        # val is only consumed by --search; don't require (or transfer) it
        # otherwise — a pure serving layout may ship test.iist alone
        val_batches = packed_batches("val", device_normalize=True) if args.search else []
        test_batches = packed_batches("test")
    elif args.synthetic or not args.data_root:
        from iterative_inference_segm.data.synthetic import synthetic_batches

        def get_batches(split_seed):
            return [
                (np.asarray(normalize_image(jnp.asarray(i), cfg)), l)
                for i, l in synthetic_batches(
                    cfg=cfg, batch_size=args.batch_size, num_batches=args.num_batches,
                    height=height, width=width, seed=split_seed,
                )
            ]

        val_batches = get_batches(args.seed + 500)
        test_batches = get_batches(args.seed + 900)
    else:
        from iterative_inference_segm.data.camvid import iterate_split
        from iterative_inference_segm.data.loaders import load_dataset_split

        va_i, va_l = load_dataset_split(args.dataset, args.data_root, "val", cfg)
        te_i, te_l = load_dataset_split(args.dataset, args.data_root, "test", cfg)

        def norm_batches(images, labels):
            return [
                (np.asarray(normalize_image(jnp.asarray(i), cfg)), l)
                for i, l in iterate_split(images, labels, batch_size=args.batch_size)
            ]

        val_batches = norm_batches(va_i, va_l)
        test_batches = norm_batches(te_i, te_l)

    if args.engine == "half" and (args.dae_stem_pool < 1 or args.arch != "dae"):
        raise SystemExit("--engine half requires --dae-stem-pool >= 1 "
                         "(2 = quarter engine), --arch dae")
    if args.engine == "half" and args.renorm != "none":
        raise SystemExit(
            "--renorm is a general-engine knob (the pooled engine's update "
            "has no renormalization step); rerun with --engine general"
        )
    if args.engine == "half" and args.dump_trajectory:
        raise SystemExit(
            "--dump-trajectory is a general-engine artifact (full-res y_k "
            "states); the half engine iterates a pooled map — rerun with "
            "--engine general to dump a trajectory"
        )

    compute_dtype = jnp.bfloat16 if args.bf16 else jnp.float32

    eps, num_steps = args.epsilon, args.num_steps
    if args.search:
        if args.engine == "half":
            from iterative_inference_segm.inference.search import grid_search_eps_k_half

            res = grid_search_eps_k_half(
                fcn8_apply, fcn_params, dae_params, val_batches,
                n_classes=cfg.n_classes, eps_grid=args.eps_grid, k_max=args.k_max,
                h_taps=tuple(args.concat_h), depth=args.dae_depth,
                encoder=args.dae_encoder, compute_dtype=compute_dtype,
                mode=args.mode,
            )
        else:
            res = grid_search_eps_k(
                fcn8_apply, score_apply, fcn_params, dae_params, val_batches,
                n_classes=cfg.n_classes, eps_grid=args.eps_grid, k_max=args.k_max,
                h_taps=tuple(args.concat_h), mode=args.mode, renorm=args.renorm,
                dae_kwargs=score_kwargs, compute_dtype=compute_dtype,
            )
        eps, num_steps = res["best_eps"], res["best_k"]
        print(f"val search: best eps={eps} K={num_steps} (val mIoU {res['best_miou']:.4f})")

    # num_steps=0 is honest (search may pick K=0 when the FCN has no
    # headroom): the scan has length 0 and yk == y0 — never report a 1-step
    # result as K=0 (ADVICE r1).
    if args.pp:
        from iterative_inference_segm.parallel.pp import (
            make_pp_flagship,
            merge_microbatches,
            split_microbatches,
        )

        pp_fwd = jax.jit(make_pp_flagship(
            pp_mesh, eps=eps, num_steps=num_steps, h_taps=tuple(args.concat_h),
            depth=args.dae_depth, compute_dtype=compute_dtype,
            encoder=args.dae_encoder, mode=args.mode, engine=args.engine,
            renorm=args.renorm, dae_arch=args.arch, batch_axis=pp_batch_axis,
        ))

        def refine(x):
            x = jnp.asarray(x, jnp.float32)
            if x.shape[0] < args.batch_size:
                # one compiled shape: pad short last batches (the eval loop
                # slices predictions back to the true row count)
                pad = jnp.zeros(
                    (args.batch_size - x.shape[0], *x.shape[1:]), x.dtype
                )
                x = jnp.concatenate([x, pad])
            y0, yk = pp_fwd(
                fcn_params, dae_params,
                split_microbatches(x, args.pp_microbatches),
            )
            return merge_microbatches(y0), merge_microbatches(yk)

        dp_note = (
            f" x {pp_mesh.shape['data']}-wide DP" if pp_batch_axis else ""
        )
        print(
            f"pipeline-parallel serving: {pp_mesh.shape['stage']} stages{dp_note}, "
            f"{args.pp_microbatches} microbatches in flight", flush=True,
        )
    elif args.engine == "half":
        from iterative_inference_segm.inference.fused import make_half_refiner

        refine = make_half_refiner(
            fcn8_apply, fcn_params, dae_params,
            eps=eps, num_steps=num_steps, h_taps=tuple(args.concat_h),
            depth=args.dae_depth, compute_dtype=compute_dtype,
            encoder=args.dae_encoder, mode=args.mode,
        )
    else:
        refine = make_refiner(
            fcn8_apply, score_apply, fcn_params, dae_params,
            eps=eps, num_steps=num_steps, h_taps=tuple(args.concat_h),
            mode=args.mode, renorm=args.renorm, compute_dtype=compute_dtype,
            dae_kwargs=score_kwargs,
        )

    if args.dump_dir and args.dump_trajectory and test_batches:
        from iterative_inference_segm.inference.iterative import refine_with_trajectory
        from iterative_inference_segm.utils.colorize import save_label_png

        images0, _ = test_batches[0]
        x0 = jnp.asarray(images0)
        if args.packed and args.wire == "u8":
            # test batches stay host-side u8 (ADVICE r3) — normalize with the
            # test file's header stats before the trajectory forward
            x0 = normalize_image(x0, packed_stats["test"], input_scale=255.0)

        # params as jit arguments (a closure would bake the weights into the
        # executable as constants)
        @jax.jit
        def traj_fn(fcn_p, dae_p, x):
            y0, h = fcn8_apply(fcn_p, x, return_features=tuple(args.concat_h),
                               compute_dtype=compute_dtype)
            dae_fn = lambda y: score_apply(dae_p, y, h, **score_kwargs)
            return refine_with_trajectory(
                dae_fn, y0, eps=eps, num_steps=num_steps,
                mode=args.mode, renorm=args.renorm,
            )

        traj = np.asarray(
            traj_fn(fcn_params, dae_params, x0).argmax(-1)
        )  # (K+1, B, H, W)
        os.makedirs(args.dump_dir, exist_ok=True)
        for k in range(traj.shape[0]):
            for j in range(traj.shape[1]):
                save_label_png(
                    os.path.join(args.dump_dir, f"traj_{j:02d}_step{k:02d}.png"),
                    traj[k, j], cfg,
                )

    if mesh is not None:
        from iterative_inference_segm.parallel.sharding import batch_sharding

        x_sharding = batch_sharding(mesh, 4)

        def pad_full(im):
            # pad a short LAST batch up to the compiled batch size (one
            # jitted shape; disk splits are rarely divisible) — padded rows
            # are sliced back off the predictions below
            if im.shape[0] < args.batch_size:
                pad = np.zeros((args.batch_size - im.shape[0], *im.shape[1:]), im.dtype)
                im = np.concatenate([im, pad])
            return im

        if args.packed and args.wire == "u8":
            # u8 bytes cross the link sharded; normalization (test-file
            # header stats) runs on-device AFTER the sharded put — never
            # round-trip a device-normalized batch back through the host
            norm_sharded = jax.jit(
                lambda x: normalize_image(
                    x, packed_stats["test"], input_scale=255.0
                )
            )
            put_x = lambda im: norm_sharded(
                jax.device_put(pad_full(np.asarray(im)), x_sharding)
            )
        else:
            put_x = lambda im: jax.device_put(
                pad_full(np.asarray(im, np.float32)), x_sharding
            )

        print(f"eval batches sharded over {mesh.shape['data']} devices", flush=True)
    elif args.packed and args.wire == "u8":
        # single-device u8 wire: bytes cross the link per batch, normalize
        # on-chip with the test file's header stats (batches are host u8)
        norm_ingest = jax.jit(
            lambda x: normalize_image(x, packed_stats["test"], input_scale=255.0)
        )
        put_x = lambda im: norm_ingest(jnp.asarray(im))
    else:
        put_x = jnp.asarray

    cm0 = cmk = None
    for bi, (images, labels) in enumerate(test_batches):
        got = np.asarray(labels).shape[0]
        y0, yk = refine(put_x(images))
        p0 = jnp.argmax(y0, -1)[:got]
        pk = jnp.argmax(yk, -1)[:got]
        labels = jnp.asarray(labels)
        c0 = confusion_matrix(p0, labels, n_classes=cfg.n_classes)
        ck = confusion_matrix(pk, labels, n_classes=cfg.n_classes)
        cm0 = c0 if cm0 is None else cm0 + c0
        cmk = ck if cmk is None else cmk + ck
        if args.dump_dir:
            from iterative_inference_segm.utils.colorize import save_label_png

            os.makedirs(args.dump_dir, exist_ok=True)
            for j in range(np.asarray(pk).shape[0]):
                save_label_png(
                    os.path.join(args.dump_dir, f"b{bi:03d}_{j:02d}_k{num_steps}.png"),
                    np.asarray(pk)[j], cfg,
                )
                save_label_png(
                    os.path.join(args.dump_dir, f"b{bi:03d}_{j:02d}_k0.png"),
                    np.asarray(p0)[j], cfg,
                )

    m0 = metrics_from_confusion(cm0)
    mk = metrics_from_confusion(cmk)
    if args.engine == "half":
        # half-engine K counts pooled-map steps; K=0 still applies the one
        # full-res rectification, so it IS a refinement pass
        refined_label = f"K={num_steps}+rectify (half engine)"
    elif num_steps > 0:
        refined_label = f"step {num_steps} (refined)"
    else:
        refined_label = "step 0 (search chose K=0; no refinement applied)"
    print(f"step 0 (FCN-8 baseline): mIoU {float(m0.mean_iou):.4f} acc {float(m0.pixel_accuracy):.4f}")
    print(f"{refined_label}:     mIoU {float(mk.mean_iou):.4f} acc {float(mk.pixel_accuracy):.4f}")
    print("per-class IoU (k=0 -> k=K):")
    for ci, name in enumerate(cfg.class_names):
        a = float(m0.per_class_iou[ci])
        b = float(mk.per_class_iou[ci])
        print(f"  {name:>14s}: {a:.4f} -> {b:.4f}  ({b - a:+.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
