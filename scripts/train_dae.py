#!/usr/bin/env python
"""Train the conditional DAE — entry point mirroring ``[ref: train_dae.py]``.

The DAE learns to denoise corrupted segmentation maps conditioned on frozen
FCN-8 features. Corruption regime flags mirror the reference: ``--sigma``
(Gaussian-softmax noise), ``--from-fcn`` (natural corruption from frozen FCN
outputs instead of noisy ground truth), ``--concat-h`` (conditioning taps).

Example:
    python scripts/train_dae.py --synthetic --tiny --max-epochs 2
    python scripts/train_dae.py --fcn-npz experiments/.../best_fcn8.npz \\
        --data-root /data/camvid --sigma 1.0 --concat-h pool4
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
                   help="directory of <split>.iist files for the native C++ input runtime")
    p.add_argument("--wire", default="f32", choices=["f32", "u8"],
                   help="packed-path wire format: 'f32' = host-normalized "
                        "floats; 'u8' = raw bytes to the device, normalize "
                        "on the device (4x fewer bytes across the link)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--devices", default=None,
                   help="data-parallel training over N devices ('auto' = all "
                        "visible): batches shard over a 'data' mesh, gradients "
                        "all-reduce across devices (parallel/, SURVEY.md §3.4)")
    p.add_argument("--fcn-npz", default=None, help="frozen FCN-8 weights (flat npz)")
    p.add_argument("--concat-h", nargs="*", default=["pool4"],
                   help="FCN taps to condition on (e.g. pool3 pool4 fc7); empty = unconditional")
    p.add_argument("--sigma", type=float, default=1.0, help="corruption noise level")
    p.add_argument("--from-fcn", action="store_true",
                   help="corrupt from frozen-FCN outputs instead of noisy GT")
    p.add_argument("--gt-mix", type=float, default=None,
                   help="mixed regime: probability of the noisy-GT corruption per batch "
                        "(overrides --from-fcn)")
    p.add_argument("--dae-depth", type=int, default=4)
    p.add_argument("--dae-tail", choices=["full", "sep"], default="full",
                   help="stem_pool=1 tail: dense CxC or separable (fused-engine ready)")
    p.add_argument("--dae-widths", nargs="*", type=int, default=None,
                   help="encoder channel widths (default from models.dae)")
    p.add_argument("--dae-encoder", choices=["pool", "stride"], default="pool",
                   help="encoder style: conv+maxpool (classic) or stride-2 "
                        "convs (fewer passes; same param shapes)")
    p.add_argument("--dae-stem-pool", type=int, default=0,
                   help="pool the input map N times before the encoder (latency opt)")
    p.add_argument("--arch", default="dae", choices=["dae", "mirror", "contextmod"],
                   help="score-network architecture: 'dae' = the score-fusion "
                        "flagship; 'mirror' = the reference-parity conv/pool <-> "
                        "unpool/conv mirror (models/dae_mirror.py); 'contextmod' "
                        "= dilated context module")
    p.add_argument("--dae-tied", action="store_true",
                   help="mirror arch only: tie decoder kernels to the encoder "
                        "(W_dec = W_enc^T, the classic-DAE knob the reference exposes)")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--max-epochs", type=int, default=500)
    p.add_argument("--patience", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--workdir", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--num-train-batches", type=int, default=8)
    p.add_argument("--num-val-batches", type=int, default=2)
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

    from iterative_inference_segm.data.config_datasets import DATASET_CONFIGS
    from iterative_inference_segm.models import init_fcn8
    from iterative_inference_segm.train import TrainConfig, train_dae
    from iterative_inference_segm.utils.checkpoint import load_npz
    from iterative_inference_segm.utils.experiment import build_experiment_name

    cfg = DATASET_CONFIGS[args.dataset]
    height = width = None
    fc_channels = 4096
    if args.tiny:
        import dataclasses

        height, width, fc_channels = 96, 128, 64
        cfg = dataclasses.replace(cfg, train_crop=(64, 64))

    fcn_template = init_fcn8(
        jax.random.PRNGKey(args.seed),
        n_classes=cfg.n_classes,
        in_channels=cfg.in_channels,
        fc_channels=fc_channels,
    )
    fcn_params = load_npz(args.fcn_npz, fcn_template) if args.fcn_npz else fcn_template

    tcfg = TrainConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        max_epochs=args.max_epochs,
        patience=args.patience,
        batch_size=args.batch_size,
        seed=args.seed,
        compute_dtype=jnp.bfloat16 if args.bf16 else jnp.float32,
    )

    raw_wire = args.wire == "u8"
    if args.packed:
        from iterative_inference_segm.data.native_loader import NativeDataset

        train_ds = NativeDataset(os.path.join(args.packed, "train.iist"))
        val_ds = NativeDataset(os.path.join(args.packed, "val.iist"))
        if raw_wire:
            # u8 wire: the jitted step normalizes on-chip — honor the FILE's
            # header statistics, exactly as the f32 wire's host normalize does
            import dataclasses

            cfg = dataclasses.replace(cfg, mean=train_ds.mean, std=train_ds.std)
        epoch_counter = {"n": 0}

        def train_data():
            epoch_counter["n"] += 1
            return train_ds.batches(
                args.batch_size, shuffle=True, seed=args.seed + epoch_counter["n"],
                raw=raw_wire,
            )

        val_data = lambda: val_ds.batches(args.batch_size, raw=raw_wire)
    elif args.synthetic or not args.data_root:
        from iterative_inference_segm.data.synthetic import synthetic_batches

        train_data = lambda: synthetic_batches(
            cfg=cfg, batch_size=args.batch_size, num_batches=args.num_train_batches,
            height=height, width=width, seed=args.seed,
        )
        val_data = lambda: synthetic_batches(
            cfg=cfg, batch_size=args.batch_size, num_batches=args.num_val_batches,
            height=height, width=width, seed=args.seed + 10_000,
        )
    else:
        from iterative_inference_segm.data.camvid import iterate_split
        from iterative_inference_segm.data.loaders import (
            epoch_reshuffled,
            load_dataset_split,
        )

        tr_i, tr_l = load_dataset_split(args.dataset, args.data_root, "train", cfg)
        va_i, va_l = load_dataset_split(args.dataset, args.data_root, "val", cfg)
        # fresh shuffle order every epoch (like the packed path and the
        # reference's dataset_loaders), not one fixed permutation
        train_data = epoch_reshuffled(
            lambda seed: iterate_split(
                tr_i, tr_l, batch_size=args.batch_size, shuffle=True, seed=seed
            ),
            args.seed,
        )
        val_data = lambda: iterate_split(va_i, va_l, batch_size=args.batch_size)

    workdir = args.workdir or os.path.join(
        "experiments",
        build_experiment_name(
            f"dae_{args.dataset}",
            lr=args.learning_rate,
            sigma=args.sigma,
            from_fcn=args.from_fcn,
            h="-".join(args.concat_h) or "none",
            seed=args.seed,
        ),
    )
    from iterative_inference_segm.parallel.mesh import mesh_from_flag

    mesh = mesh_from_flag(args.devices, batch_size=args.batch_size)
    if mesh is not None:
        print(f"[train_dae] data-parallel over {mesh.shape['data']} devices", flush=True)

    result = train_dae(
        fcn_params=fcn_params,
        dataset=cfg,
        mesh=mesh,
        train_data=train_data,
        val_data=val_data,
        tcfg=tcfg,
        h_taps=tuple(args.concat_h),
        sigma=args.sigma,
        from_gt=args.gt_mix if args.gt_mix is not None else (not args.from_fcn),
        dae_depth=args.dae_depth,
        dae_stem_pool=args.dae_stem_pool,
        dae_tail=args.dae_tail,
        dae_widths=tuple(args.dae_widths) if args.dae_widths else None,
        dae_encoder=args.dae_encoder,
        dae_tied=args.dae_tied,
        arch=args.arch,
        workdir=workdir,
        augment=not args.no_augment,
        # f32 packed wire: the native loader normalized on the host;
        # u8 wire (or unpacked sources): normalize on-chip
        normalize=not args.packed or raw_wire,
        input_scale=255.0 if (args.packed and raw_wire) else 1.0,
        epoch_callback=lambda e, h, _p: print(
            f"epoch {e}: train_loss={h['train_loss']:.4f} val_loss={h['val_loss']:.4f} "
            f"val_miou={h['val_miou']:.4f}",
            flush=True,
        ),
    )
    print(
        f"done: best val mIoU {result['best_miou']:.4f} at epoch {result['best_epoch']} "
        f"({result['epochs']} epochs run); checkpoints in {workdir}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
