#!/usr/bin/env python
"""Train FCN-8 — entry point mirroring ``[ref: train_fcn8.py]``'s CLI.

Example:
    python scripts/train_fcn8.py --dataset camvid --synthetic --max-epochs 2 --tiny
    python scripts/train_fcn8.py --dataset camvid --data-root /data/camvid \\
        --learning-rate 1e-3 --weight-decay 1e-4 --patience 25
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="camvid", choices=["camvid", "em", "polyps"])
    p.add_argument("--data-root", default=None, help="dataset directory (CamVid layout)")
    p.add_argument("--packed", default=None,
                   help="directory of <split>.iist files for the native C++ input runtime")
    p.add_argument("--wire", default="f32", choices=["f32", "u8"],
                   help="packed-path wire format: 'f32' = host-normalized "
                        "floats (reference layout); 'u8' = raw bytes to the "
                        "device, normalize there (4x fewer bytes across "
                        "the link, no per-pixel host arithmetic)")
    p.add_argument("--synthetic", action="store_true", help="use the synthetic dataset")
    p.add_argument("--devices", default=None,
                   help="data-parallel training over N devices ('auto' = all "
                        "visible): batches shard over a 'data' mesh, gradients "
                        "all-reduce across devices (parallel/, SURVEY.md §3.4)")
    p.add_argument("--profile-dir", default=None, help="capture a jax.profiler trace of epoch 0")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--max-epochs", type=int, default=500)
    p.add_argument("--patience", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--bf16", action="store_true", help="bf16 conv compute")
    p.add_argument("--workdir", default=None)
    p.add_argument("--load-npz", default=None, help="initialize from a flat .npz export")
    p.add_argument("--load-reference-npz", default=None,
                   help="initialize from a reference-era Lasagne checkpoint "
                        "(positional np.savez of get_all_param_values; OIHW/"
                        "flat-FC/IOHW layouts converted automatically)")
    p.add_argument("--tiny", action="store_true", help="tiny model+images (CI/smoke)")
    p.add_argument("--num-train-batches", type=int, default=8, help="synthetic only")
    p.add_argument("--num-val-batches", type=int, default=2, help="synthetic only")
    args = p.parse_args(argv)
    if args.wire != "f32" and not args.packed:
        p.error("--wire u8 requires --packed (the wire format is a property "
                "of the packed-path input runtime)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    from iterative_inference_segm.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax.numpy as jnp

    from iterative_inference_segm.data.config_datasets import DATASET_CONFIGS
    from iterative_inference_segm.train import TrainConfig, train_fcn8
    from iterative_inference_segm.utils.experiment import build_experiment_name

    cfg = DATASET_CONFIGS[args.dataset]
    height = width = None
    fc_channels = 4096
    if args.tiny:
        import dataclasses

        height, width, fc_channels = 96, 128, 64
        cfg = dataclasses.replace(cfg, train_crop=(64, 64))

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
            f"fcn8_{args.dataset}", lr=args.learning_rate, wd=args.weight_decay, seed=args.seed
        ),
    )
    params = None
    if args.load_npz or args.load_reference_npz:
        from iterative_inference_segm.models import init_fcn8
        import jax

        template = init_fcn8(
            jax.random.PRNGKey(0), n_classes=cfg.n_classes,
            in_channels=cfg.in_channels, fc_channels=fc_channels,
        )
        if args.load_reference_npz:
            from iterative_inference_segm.utils.import_weights import import_lasagne_npz

            params = import_lasagne_npz(args.load_reference_npz, template)
        else:
            from iterative_inference_segm.utils.checkpoint import load_npz

            params = load_npz(args.load_npz, template)

    import contextlib

    from iterative_inference_segm.utils import profiling

    from iterative_inference_segm.parallel.mesh import mesh_from_flag

    mesh = mesh_from_flag(args.devices, batch_size=args.batch_size)
    if mesh is not None:
        print(f"[train_fcn8] data-parallel over {mesh.shape['data']} devices", flush=True)

    trace_cm = (
        profiling.trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    )
    with trace_cm:
        result = train_fcn8(
            dataset=cfg,
            train_data=train_data,
            val_data=val_data,
            tcfg=tcfg,
            fc_channels=fc_channels,
            workdir=workdir,
            augment=not args.no_augment,
            # f32 packed wire: the native loader normalized on the host;
            # u8 wire (or unpacked sources): normalize on-chip
            normalize=not args.packed or raw_wire,
            input_scale=255.0 if (args.packed and raw_wire) else 1.0,
            params=params,
            mesh=mesh,
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
