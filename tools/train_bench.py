#!/usr/bin/env python
"""Training-path sweep: batch/crop cells and augmentation on/off for both
training workloads (FCN-8 and DAE), CamVid shapes, on one GPU.

Each cell warms its step, then times ``--iters`` chained steps (the params
and optimizer state of step i feed step i+1) ending in
``jax.block_until_ready``, three times, and reports the median. The tool
refuses to run without a GPU.

FLOPs come from XLA's own cost model: the SAME train step is lowered and
compiled for CPU in a subprocess at a small batch and scaled linearly —
convolution/matmul FLOPs are exactly linear in batch; the only
batch-independent term is the optimizer update (<1% of a VGG16 fwd+bwd at
these shapes).

Usage:
    python tools/train_bench.py --batches 32,64,128 --crops 224
    python tools/train_bench.py --donate          # donation A/B, chained
    python tools/train_bench.py --isolate ...     # one subprocess per cell
Prints one JSON line per (workload, batch, crop, augment) cell.

--isolate runs each (batch, crop, augment) cell in its own process, so a
cell that exhausts device memory cannot affect the cells after it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FLOPS_PROBE_BATCH = 4


def build_steps(args, crop, *, augment: bool):
    """(step_fn, state, extra_args) per workload; shared by timing and the
    CPU flops probe so both lower the identical program."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.models import init_fcn8
    from iterative_inference_segm.models.dae import init_dae, DAE_H_CHANNELS
    from iterative_inference_segm.train.loop import TrainConfig, make_optimizer
    from iterative_inference_segm.train.train_fcn8 import make_fcn8_train_step
    from iterative_inference_segm.train.train_dae import make_dae_train_step

    cfg = dataclasses.replace(CAMVID, train_crop=(crop, crop))
    tcfg = TrainConfig(
        learning_rate=1e-3,
        compute_dtype=jnp.bfloat16 if args.dtype == "bf16" else jnp.float32,
        remat=args.remat,
    )
    tx = make_optimizer(tcfg)
    return cfg, tcfg, tx, init_fcn8, init_dae, DAE_H_CHANNELS, \
        make_fcn8_train_step, make_dae_train_step


def make_cells(args, batch, crop, augment):
    """Returns [(label, step_fn, state, extra_args)] for the two workloads.

    With augment=True the step receives full 360x480 frames and crops/flips
    in-graph (the training-loop configuration); with augment=False it
    receives pre-cropped frames — the difference isolates the in-graph
    augmentation + full-frame-normalize cost.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    (cfg, tcfg, tx, init_fcn8, init_dae, DAE_H_CHANNELS,
     make_fcn8_train_step, make_dae_train_step) = build_steps(args, crop, augment=augment)

    h, w = (args.height, args.width) if augment else (crop, crop)
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.random((batch, h, w, 3), np.float32))
    labels = jnp.asarray(rng.integers(0, cfg.n_classes, (batch, h, w)).astype(np.int32))

    cells = []
    fcn_params = init_fcn8(jax.random.PRNGKey(0), n_classes=cfg.n_classes)
    fcn_step, _ = make_fcn8_train_step(cfg, tcfg, tx, augment=augment)
    if args.donate:
        base_step = fcn_step  # bind BEFORE rebinding fcn_step (self-capture)
        fcn_step = jax.jit(
            lambda p, o, x, y, r: base_step(p, o, x, y, r), donate_argnums=(0, 1)
        )
    cells.append((
        "FCN-8", fcn_step, (fcn_params, tx.init(fcn_params)), (images, labels),
    ))

    if not args.donate:  # donation A/B only re-measures the FCN step
        dae_params = init_dae(
            jax.random.PRNGKey(1), n_classes=cfg.n_classes,
            h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3, stem_pool=1,
        )
        dae_step, _ = make_dae_train_step(
            cfg, tcfg, tx, h_taps=("pool4",), sigma=1.0, from_gt=True,
            dae_depth=3, augment=augment,
        )
        cells.append((
            "DAE(stem1,d3)",
            lambda p, o, f, im, lb, r: dae_step(p, o, f, im, lb, r),
            (dae_params, tx.init(dae_params)), (fcn_params, images, labels),
        ))
    return cells


def flops_probe(args):
    """Internal mode: force CPU, compile each cell at FLOPS_PROBE_BATCH,
    print {label: flops} as one JSON line."""
    import jax

    jax.config.update("jax_platforms", "cpu")

    out = {}
    for crop in args.crops:
        for augment in _augment_settings(args):
            for label, step, state, extra in make_cells(args, FLOPS_PROBE_BATCH, crop, augment):
                params, opt_state = state
                lowered = jax.jit(step).lower(
                    params, opt_state, *extra, jax.random.PRNGKey(0)
                )
                fl = lowered.compile().cost_analysis()["flops"]
                out[f"{label}|{crop}|aug={int(augment)}"] = float(fl)
    print("FLOPS_JSON " + json.dumps(out), flush=True)


def _augment_settings(args):
    if args.donate or args.augment == "on":
        return [True]
    if args.augment == "off":
        return [False]
    return [True, False]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batches", type=str, default="32")
    p.add_argument("--crops", type=str, default="224")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--donate", action="store_true",
                   help="A/B buffer donation on the FCN step (chained timing)")
    p.add_argument("--no-flops", action="store_true",
                   help="skip the CPU cost-analysis subprocess (no GFLOP/img)")
    p.add_argument("--augment", choices=["both", "on", "off"], default="both",
                   help="which augmentation settings to sweep (donate forces 'on')")
    p.add_argument("--isolate", action="store_true",
                   help="run each (batch, crop, augment) cell in its own "
                        "subprocess — REQUIRED for sweeps that may OOM (see docstring)")
    p.add_argument("--_flops-probe", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    args.batches = [int(b) for b in args.batches.split(",")]
    args.crops = [int(c) for c in args.crops.split(",")]

    if getattr(args, "_flops_probe"):
        flops_probe(args)
        return

    if args.isolate:
        flops_env = dict(os.environ)
        if not args.no_flops:
            cmd = [sys.executable, os.path.abspath(__file__), "--_flops-probe",
                   "--crops", ",".join(map(str, args.crops)), "--dtype", args.dtype,
                   "--augment", args.augment,
                   "--height", str(args.height), "--width", str(args.width)]
            if args.remat:
                cmd.append("--remat")
            if args.donate:
                cmd.append("--donate")
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
            line = next((l for l in res.stdout.splitlines()
                         if l.startswith("FLOPS_JSON ")), None)
            if line is not None:
                flops_env["TRAIN_BENCH_FLOPS_JSON"] = json.dumps({
                    k: v / FLOPS_PROBE_BATCH
                    for k, v in json.loads(line[len("FLOPS_JSON "):]).items()
                })
        for crop in args.crops:
            for augment in _augment_settings(args):
                for batch in args.batches:
                    cmd = [sys.executable, os.path.abspath(__file__),
                           "--batches", str(batch), "--crops", str(crop),
                           "--augment", "on" if augment else "off",
                           "--iters", str(args.iters), "--dtype", args.dtype,
                           "--height", str(args.height), "--width", str(args.width)]
                    if args.remat:
                        cmd.append("--remat")
                    if args.donate:
                        cmd.append("--donate")
                    if args.no_flops:
                        cmd.append("--no-flops")
                    r = subprocess.run(cmd, timeout=3600, env=flops_env)
                    if r.returncode:
                        print(json.dumps({
                            "metric": f"cell FAILED (crop {crop}, batch={batch}, "
                                      f"augment={augment}, remat={args.remat})",
                            "value": None, "rc": r.returncode,
                        }), flush=True)
        return

    # an --isolate parent computes flops ONCE and hands them down via env
    flops_per_img = json.loads(os.environ.get("TRAIN_BENCH_FLOPS_JSON", "{}"))
    if not flops_per_img and not args.no_flops:
        cmd = [sys.executable, os.path.abspath(__file__), "--_flops-probe",
               "--crops", ",".join(map(str, args.crops)), "--dtype", args.dtype,
               "--augment", args.augment,
               "--height", str(args.height), "--width", str(args.width)]
        if args.remat:
            cmd.append("--remat")
        if args.donate:
            cmd.append("--donate")
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
        line = next((l for l in res.stdout.splitlines() if l.startswith("FLOPS_JSON ")), None)
        if line is None:
            print(f"flops probe failed: {res.stderr[-500:]}", file=sys.stderr)
        else:
            flops_per_img = {
                k: v / FLOPS_PROBE_BATCH for k, v in json.loads(line[len("FLOPS_JSON "):]).items()
            }

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"train_bench.py needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        sys.exit(1)

    from iterative_inference_segm.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    def record(rec):
        rec["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}
        print(json.dumps(rec), flush=True)

    def timed(step_fn, state, extra_args, label, batch, crop, augment):
        params, opt_state = state
        out = step_fn(params, opt_state, *extra_args, jax.random.PRNGKey(0))  # compile
        jax.block_until_ready(out)  # first exec done before the timed region
        # donated buffers invalidate the originals: chain from the outputs
        p_, o_ = (out[0], out[1]) if args.donate else (params, opt_state)
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(args.iters):
                p_, o_, loss = step_fn(p_, o_, *extra_args, jax.random.fold_in(jax.random.PRNGKey(1), i))
            jax.block_until_ready((p_, o_, loss))
            reps.append((time.perf_counter() - t0) / args.iters)
        per = sorted(reps)[1]
        rec = {
            "metric": f"train images/sec/device ({label}, crop {crop}, {args.dtype}, "
                      f"batch={batch}, augment={augment}"
                      + (", donate" if args.donate else "")
                      + (", remat" if args.remat else "") + ")",
            "value": batch / per,
            "unit": "images/sec/device",
            "ms_per_img": 1e3 * per / batch,
        }
        key = f"{label}|{crop}|aug={int(augment)}"
        if key in flops_per_img:
            fl = flops_per_img[key]
            rec["gflops_per_img"] = round(fl / 1e9, 2)
        record(rec)

    for crop in args.crops:
        for augment in _augment_settings(args):
            for batch in args.batches:
                # OOM can fire at input device_put inside make_cells, not
                # just inside the step — cover the whole cell.
                try:
                    for label, step, state, extra in make_cells(args, batch, crop, augment):
                        timed(step, state, extra, label, batch, crop, augment)
                except jax.errors.JaxRuntimeError as e:
                    if "RESOURCE_EXHAUSTED" not in str(e):
                        raise
                    # the memory boundary is itself a measurement: record
                    # it and keep sweeping (remat moves the boundary)
                    record({
                        "metric": f"train OOM (crop {crop}, "
                                  f"{args.dtype}, batch={batch}, "
                                  f"augment={augment}, "
                                  f"remat={args.remat})",
                        "value": None, "unit": "images/sec/device",
                        "oom": True,
                    })


if __name__ == "__main__":
    main()
