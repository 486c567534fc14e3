#!/usr/bin/env python
"""End-to-end demonstration on synthetic data: FCN-8 -> DAE -> refinement.

Trains a small FCN-8 on the synthetic structured-scene dataset, trains a
conditional DAE on corrupted ground truth against the frozen FCN, runs the
(eps, K) validation search, and reports test mIoU at k=0 (FCN baseline) vs
the refined k=K — the rebuild's version of the paper's headline experiment
(arXiv:1705.07450 reports +1-2.5 mIoU on CamVid; here the dataset is
synthetic because no real data ships with this environment).

    python scripts/demo_synthetic.py [--epochs-fcn 12] [--epochs-dae 10]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs-fcn", type=int, default=3)
    p.add_argument("--epochs-dae", type=int, default=16)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--fc-channels", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--train-batches", type=int, default=16)
    p.add_argument("--sigma", type=float, default=0.0)
    p.add_argument("--corruption", choices=["natural", "gt", "mix"], default="natural",
                   help="DAE training corruption regime: 'natural' = frozen-FCN "
                        "outputs (the demo default and the paper's best recipe), "
                        "'gt' = sigma-noised one-hot ground truth (the "
                        "distribution-shift control), 'mix' = per-batch blend "
                        "(see --mix-prob). Mirrors [ref: train_dae.py]'s from_gt.")
    p.add_argument("--mix-prob", type=float, default=0.5,
                   help="with --corruption mix: probability a batch uses the GT regime")
    p.add_argument("--arch", choices=["dae", "mirror", "contextmod"], default="dae",
                   help="score network: the conditional DAE, the reference-"
                        "parity mirror DAE (general engine only), or the "
                        "dilated context module (the reference's ablation "
                        "variant; conditions on the input image, general "
                        "engine only)")
    p.add_argument("--dae-tied", action="store_true",
                   help="mirror arch: tie decoder kernels to the encoder")
    p.add_argument("--dae-stem-pool", type=int, default=0)
    p.add_argument("--dae-tail", choices=["full", "sep"], default="full")
    p.add_argument("--dae-depth", type=int, default=4)
    p.add_argument("--dae-widths", nargs="*", type=int, default=None)
    p.add_argument("--dae-encoder", choices=["pool", "stride"], default="pool",
                   help="encoder style: conv+maxpool or stride-2 convs "
                        "(fewer passes; accuracy validated by this demo)")
    p.add_argument("--k-max", type=int, default=8)
    p.add_argument("--eps-grid", nargs="*", type=float, default=[0.05, 0.1, 0.2, 0.4, 0.7, 1.0])
    p.add_argument("--mode", choices=["score", "energy"], default="score",
                   help="refinement update rule (general engine): 'score' = "
                        "direct Alain-Bengio estimate; 'energy' = jax.grad "
                        "through the DAE energy (the reference's T.grad form)")
    p.add_argument("--engine", choices=["general", "half"], default="general",
                   help="refinement engine for search+eval: 'half' = the "
                        "throughput configuration (K pooled-map steps + one "
                        "full-res rectification; requires --dae-stem-pool 1)")
    p.add_argument("--bf16", action="store_true",
                   help="run search AND eval refinement at bf16 compute/state "
                        "(the benched throughput configuration; (eps, K) are "
                        "then selected under the same numerics they run at)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true", help="print one JSON result line")
    args = p.parse_args(argv)
    from iterative_inference_segm.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    # fail invalid combinations BEFORE the (potentially long) training runs
    if args.engine == "half" and args.dae_stem_pool < 1:
        raise SystemExit("--engine half requires --dae-stem-pool >= 1 "
                         "(2 = quarter engine)")
    if args.arch in ("contextmod", "mirror") and args.engine != "general":
        raise SystemExit(f"--arch {args.arch} runs on the general engine only")


    import jax.numpy as jnp

    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.data.synthetic import synthetic_batches
    from iterative_inference_segm.inference import grid_search_eps_k, make_refiner
    from iterative_inference_segm.inference.search import grid_search_eps_k_half
    from iterative_inference_segm.inference.fused import make_half_refiner
    from iterative_inference_segm.models import fcn8_apply
    from iterative_inference_segm.ops.metrics import confusion_matrix, metrics_from_confusion
    from iterative_inference_segm.data.pipeline import normalize_image
    from iterative_inference_segm.train import TrainConfig, train_fcn8, train_dae

    cfg = dataclasses.replace(
        CAMVID, train_crop=(args.height - 16, args.width - 16)
    )
    hw = dict(height=args.height, width=args.width)

    def data(n, seed):
        return list(synthetic_batches(cfg=cfg, batch_size=args.batch_size, num_batches=n, seed=seed, **hw))

    train = data(args.train_batches, args.seed)
    val = data(3, args.seed + 500)
    test = data(4, args.seed + 900)

    print("== training FCN-8 ==", flush=True)
    tcfg = TrainConfig(learning_rate=1e-3, weight_decay=1e-4, max_epochs=args.epochs_fcn, patience=100, seed=args.seed)
    rf = train_fcn8(dataset=cfg, train_data=train, val_data=val, tcfg=tcfg,
                    fc_channels=args.fc_channels,
                    epoch_callback=lambda e, h, _: print(f"  fcn epoch {e}: loss {h['train_loss']:.3f} val mIoU {h['val_miou']:.3f}", flush=True))
    fcn_params = rf["params"]

    h_taps = ("input",) if args.arch == "contextmod" else ("pool4",)
    from_gt: bool | float = {"natural": False, "gt": True}.get(args.corruption, args.mix_prob)
    print(f"== training {args.arch} ({args.corruption} corruption, conditioned on {h_taps[0]}) ==", flush=True)
    tcfg_d = TrainConfig(learning_rate=1e-3, weight_decay=1e-4, max_epochs=args.epochs_dae, patience=100, seed=args.seed)
    rd = train_dae(fcn_params=fcn_params, dataset=cfg, train_data=train, val_data=val,
                   tcfg=tcfg_d, h_taps=h_taps, sigma=args.sigma, from_gt=from_gt,
                   dae_depth=args.dae_depth, dae_stem_pool=args.dae_stem_pool, dae_tail=args.dae_tail,
                   dae_widths=tuple(args.dae_widths) if args.dae_widths else None,
                   dae_encoder=args.dae_encoder, dae_tied=args.dae_tied,
                   arch=args.arch,
                   epoch_callback=lambda e, h, _: print(f"  dae epoch {e}: loss {h['train_loss']:.3f} val mIoU {h['val_miou']:.3f}", flush=True))
    dae_params = rd["params"]

    print("== (eps, K) search on val ==", flush=True)
    def norm(b):
        return [(np.asarray(normalize_image(jnp.asarray(i), cfg)), l) for i, l in b]

    cd = jnp.bfloat16 if args.bf16 else jnp.float32
    if args.engine == "half":
        res = grid_search_eps_k_half(
            fcn8_apply, fcn_params, dae_params, norm(val),
            n_classes=cfg.n_classes, eps_grid=args.eps_grid, k_max=args.k_max,
            h_taps=("pool4",), depth=args.dae_depth, compute_dtype=cd,
            encoder=args.dae_encoder, mode=args.mode,
        )
    else:
        # one dispatch table for apply + per-step kwargs (models.registry) —
        # the compute_dtype forwarding ADVICE r2 caught lives there once
        from iterative_inference_segm.models.registry import (
            score_apply_fn,
            score_kwargs as arch_score_kwargs,
        )

        score_apply = score_apply_fn(args.arch)
        score_kwargs = arch_score_kwargs(
            args.arch, depth=args.dae_depth, encoder=args.dae_encoder
        )
        res = grid_search_eps_k(
            fcn8_apply, score_apply, fcn_params, dae_params, norm(val),
            n_classes=cfg.n_classes, eps_grid=args.eps_grid, k_max=args.k_max,
            h_taps=h_taps, mode=args.mode, dae_kwargs=score_kwargs,
            compute_dtype=cd,
        )
    print(f"  best eps={res['best_eps']} K={res['best_k']} val mIoU {res['best_miou']:.4f}"
          f" (K=0 val mIoU {res['miou'][0, 0]:.4f})", flush=True)

    if args.engine == "half":
        refine = make_half_refiner(
            fcn8_apply, fcn_params, dae_params,
            eps=res["best_eps"], num_steps=res["best_k"], h_taps=("pool4",),
            depth=args.dae_depth, compute_dtype=cd, encoder=args.dae_encoder,
            mode=args.mode,
        )
    else:
        refine = make_refiner(
            fcn8_apply, score_apply, fcn_params, dae_params,
            eps=res["best_eps"], num_steps=res["best_k"], h_taps=h_taps,
            mode=args.mode, compute_dtype=cd, dae_kwargs=score_kwargs,
        )
    cm0 = cmk = None
    for images, labels in norm(test):
        y0, yk = refine(jnp.asarray(images))
        c0 = confusion_matrix(jnp.argmax(y0, -1), jnp.asarray(labels), n_classes=cfg.n_classes)
        ck = confusion_matrix(jnp.argmax(yk, -1), jnp.asarray(labels), n_classes=cfg.n_classes)
        cm0 = c0 if cm0 is None else cm0 + c0
        cmk = ck if cmk is None else cmk + ck
    m0 = metrics_from_confusion(cm0)
    mk = metrics_from_confusion(cmk)
    d = {
        "test_miou_fcn": round(float(m0.mean_iou), 4),
        "test_miou_refined": round(float(mk.mean_iou), 4),
        "delta_miou": round(float(mk.mean_iou - m0.mean_iou), 4),
        "best_eps": res["best_eps"],
        "best_k": res["best_k"],
        "engine": args.engine,
        "mode": args.mode,
        "arch": args.arch,
        "dae_encoder": args.dae_encoder,
    }
    if args.json:
        print(json.dumps(d))
    else:
        print(f"== RESULT == FCN mIoU {d['test_miou_fcn']}  refined mIoU {d['test_miou_refined']}"
              f"  delta {d['delta_miou']:+.4f} (eps={d['best_eps']}, K={d['best_k']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
