#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU, through the user entry points.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the multi-card paths, on four cards

One card, one process, seeded random weights, the flagship at full width
(FCN-8 with fc6/fc7 at 4096, CamVid 360x480, bf16):

  (a) device    the GPU, versions, XLA_FLAGS, compile cache, nvidia-smi
  (b) flagship  a ``Predictor`` (half engine, stem_pool=1/depth-3 DAE,
                batch 128) answers requests of 1, 37 and 128 frames
  (c) reference the compiled programs against the plain references:
                f32 flagship on the GPU vs the host CPU, bf16 vs f32,
                phase-major vs input-dilated deconvolutions, folded vs
                unfolded refinement tail
  (d) training  ``scripts/train_fcn8.py`` then ``scripts/train_dae.py``
                (natural corruption from the frozen FCN) take a few steps;
                their checkpoints are read back

``--four-cards`` runs only what exists across cards, each against one card:
DP training (``train_dae --devices 4``), the ``Predictor`` on a 4-card
'data' mesh and as a 2-stage pipeline, and ``dryrun_multichip(4)``.

Every phase prints one result line. The last line of standard output is
the JSON object ``{"ok": true, "device": {...}}``; it is printed only when
every phase passed. Without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_CLASSES = 11  # CamVid
FC_CHANNELS = 4096
HW = (360, 480)
BATCH = 128
REQUEST_SIZES = (1, 37, 128)
NUM_STEPS = 5
EPS = 0.1

# Tolerances, each with the precision it is stated for.
# f32 at HIGHEST on both sides; only the summation order differs between
# the GPU and the host. A TF32 contraction (10-bit mantissa) shows up near
# 1e-2 on these probability maps.
F32_CARD_VS_HOST_MAX = 1e-3
# bf16 flagship (folded tail) against the f32 reference on the same card:
# the bands of tests/test_precision_parity.py.
BF16_ARGMAX_AGREE_MIN = 0.97
BF16_MEAN_ABS_MAX = 0.02
# f32 at HIGHEST, the same algebra reassociated: relative to the output's
# largest magnitude.
DECONV_REL_MAX = 1e-5
# f32; folded kernels composed at HIGHEST, reassociated sums only.
FOLD_MAX = 1e-4
# Requests answered through one compiled batch must not depend on what
# else fills the batch.
REQUEST_LABEL_AGREE_MIN = 0.999
# Multi-card against one card, bf16 serving: the same program split across
# cards may pick other library algorithms and flip near-tied argmaxes.
MULTI_LABEL_AGREE_MIN = 0.99
MULTI_MEAN_ABS_MAX = 1e-2
# DP training against one card, f32: per-shard loss means averaged by pmean
# weight void pixels per shard, not per batch.
DP_LOSS_REL_MAX = 1e-2


class PhaseFailed(AssertionError):
    pass


def parse_smi_line(line: str) -> dict:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> name and power limit (W)."""
    name, _, limit = line.strip().rpartition(",")
    if not name:
        raise ValueError(f"not a 'name, power.limit' line: {line!r}")
    value = limit.strip().removesuffix("W").strip()
    try:
        watts = float(value)
    except ValueError:
        watts = None  # "[N/A]" on parts that do not report a limit
    return {"name": name.strip(), "power_limit_w": watts}


def query_smi() -> list[str]:
    """One ``name, power.limit`` line per card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return [ln for ln in out.stdout.splitlines() if ln.strip()]


def contract_line(devices) -> str:
    """The last line of a passing run: the first device as JAX reports it."""
    d = devices[0]
    return json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                "count": len(devices)}}
    )


def require_gpu():
    """The first JAX device, which must be a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}")
    return dev


def prob_deviation(a, b) -> dict:
    """Max and mean |a - b| of two probability maps (..., C), and the share
    of pixels whose argmax agrees."""
    import numpy as np

    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    return {
        "max_abs": float(d.max()),
        "mean_abs": float(d.mean()),
        "argmax_agree": float((a.argmax(-1) == b.argmax(-1)).mean()),
    }


def relative_deviation(a, b) -> float:
    """max |a - b| over max |b|."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check(failures: list, name: str, value: float, limit: float, *, at_least=False) -> None:
    ok = value >= limit if at_least else value <= limit
    if not ok:
        rel = ">=" if at_least else "<="
        failures.append(f"{name} = {value!r}, want {rel} {limit!r}")


def _finish(failures: list, result: dict) -> dict:
    if failures:
        raise PhaseFailed("; ".join(failures) + f" | {json.dumps(result)}")
    return result


def _load_script(name: str):
    path = os.path.join(REPO, "scripts", name)
    spec = importlib.util.spec_from_file_location(name.removesuffix(".py"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def init_flagship_params(seed: int, *, fc_channels: int = FC_CHANNELS, dae_widths=None):
    """Seeded FCN-8 + flagship DAE (stem_pool=1, depth 3, pool4-conditioned)."""
    import jax

    from iterative_inference_segm.models import init_dae, init_fcn8
    from iterative_inference_segm.models.dae import DAE_H_CHANNELS

    fcn = init_fcn8(jax.random.PRNGKey(seed), n_classes=N_CLASSES, fc_channels=fc_channels)
    kw = {"widths": tuple(dae_widths)} if dae_widths else {}
    dae = init_dae(
        jax.random.PRNGKey(seed + 1), n_classes=N_CLASSES,
        h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3, stem_pool=1, **kw,
    )
    return fcn, dae


def synthetic_frames(n: int, hw=HW, seed: int = 0):
    """(n, H, W, 3) f32 frames in [0, 1]: the synthetic CamVid-like scenes."""
    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.data.synthetic import synthetic_batches

    (images, _), = synthetic_batches(
        cfg=CAMVID, batch_size=n, num_batches=1, height=hw[0], width=hw[1], seed=seed
    )
    return images


def phase_device(four_cards: bool = False) -> dict:
    import jax
    import jaxlib

    from iterative_inference_segm.utils.compile_cache import configure_compile_cache

    dev = require_gpu()
    want = 4 if four_cards else 1
    if len(jax.devices()) < want:
        raise PhaseFailed(f"need {want} GPUs, JAX sees {len(jax.devices())}")
    smi = query_smi()
    for line in smi:
        print(f"nvidia-smi: {line}", flush=True)
    cards = [parse_smi_line(ln) for ln in smi]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": configure_compile_cache(),
        "cards": cards,
    }


def phase_flagship(*, seed: int = 0, fc_channels: int = FC_CHANNELS, hw=HW,
                   batch: int = BATCH, request_sizes=REQUEST_SIZES,
                   dae_widths=None, timed_iters: int = 5) -> dict:
    """The served flagship: compile, steady device time, mixed-size requests."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from iterative_inference_segm.inference import Predictor

    fcn, dae = init_flagship_params(seed, fc_channels=fc_channels, dae_widths=dae_widths)
    pred = Predictor(
        fcn, dae, engine="half", batch_size=batch, compute_dtype=jnp.bfloat16,
        eps=EPS, num_steps=NUM_STEPS, dae_kwargs={"depth": 3},
    )
    frames = synthetic_frames(max(request_sizes), hw, seed)
    x = jnp.asarray(frames[:batch])

    t0 = time.perf_counter()
    compiled = pred._predict.lower(pred._fcn, pred._dae, x).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    jax.block_until_ready(compiled(pred._fcn, pred._dae, x))  # first run
    times = []
    for _ in range(timed_iters):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(pred._fcn, pred._dae, x))
        times.append(time.perf_counter() - t0)
    device_s = float(np.median(times))

    failures: list = []
    answers = {}
    request_s = {}
    for n in request_sizes:
        t0 = time.perf_counter()
        labels = pred.predict(frames[:n])
        request_s[n] = time.perf_counter() - t0
        if labels.shape != (n, *hw) or labels.dtype != np.int32:
            failures.append(f"request {n}: labels {labels.shape} {labels.dtype}")
        elif labels.min() < 0 or labels.max() >= N_CLASSES:
            failures.append(f"request {n}: labels outside [0, {N_CLASSES})")
        answers[n] = labels
    largest = answers[max(request_sizes)]
    agree = {n: float((answers[n] == largest[:n]).mean()) for n in request_sizes}
    for n, a in agree.items():
        check(failures, f"request {n} vs largest request, label agreement", a,
              REQUEST_LABEL_AGREE_MIN, at_least=True)
    result = {
        "batch": batch, "hw": list(hw), "fc_channels": fc_channels,
        "compile_s": compile_s,
        "device_s_per_batch": {"median": device_s, "min": min(times), "max": max(times)},
        "device_img_per_s": batch / device_s,
        "request_s": {str(k): v for k, v in request_s.items()},
        "request_label_agree": {str(k): v for k, v in agree.items()},
        "memory_analysis": {
            k: getattr(mem, k, None) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
        },
        "peak_bytes_in_use": _peak_bytes(),
    }
    return _finish(failures, result)


def compare_reference(host_device, *, seed: int = 0, fc_channels: int = FC_CHANNELS,
                      hw=HW, n_frames: int = 2, dae_widths=None) -> dict:
    """The flagship function against its plain f32 reference.

    * f32, unfolded, HIGHEST: the default device against ``host_device``;
    * bf16 folded flagship against that f32 reference, both on the default
      device;
    * folded against unfolded tail, f32, on the default device.
    """
    import jax
    import jax.numpy as jnp

    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.data.pipeline import normalize_image
    from iterative_inference_segm.inference.fused import flagship_forward_fn

    fcn, dae = init_flagship_params(seed, fc_channels=fc_channels, dae_widths=dae_widths)
    x = normalize_image(jnp.asarray(synthetic_frames(n_frames, hw, seed + 7)), CAMVID)

    def run(fn, device, *args):
        args = jax.device_put(args, device)
        return jax.device_get(jax.jit(fn)(*args)[1])

    dev = jax.devices()[0]
    ref_fn = flagship_forward_fn(num_steps=NUM_STEPS, eps=EPS, depth=3,
                                 compute_dtype=jnp.float32, fold_tail=False)
    with jax.default_matmul_precision("highest"):
        ref_card = run(ref_fn, dev, fcn, dae, x)
        ref_host = run(ref_fn, host_device, fcn, dae, x)
    bf16_fn = flagship_forward_fn(num_steps=NUM_STEPS, eps=EPS, depth=3,
                                  compute_dtype=jnp.bfloat16)
    bf16_card = run(bf16_fn, dev, fcn, dae, x)
    fold_fn = flagship_forward_fn(num_steps=NUM_STEPS, eps=EPS, depth=3,
                                  compute_dtype=jnp.float32, fold_tail=True)
    unfold_fn = flagship_forward_fn(num_steps=NUM_STEPS, eps=EPS, depth=3,
                                    compute_dtype=jnp.float32, fold_tail=False)
    folded = run(fold_fn, dev, fcn, dae, x)
    unfolded = run(unfold_fn, dev, fcn, dae, x)

    card_host = prob_deviation(ref_card, ref_host)
    bf16 = prob_deviation(bf16_card, ref_card)
    fold = prob_deviation(folded, unfolded)
    failures: list = []
    check(failures, "f32 card vs host max|dp|", card_host["max_abs"], F32_CARD_VS_HOST_MAX)
    check(failures, "bf16 vs f32 argmax agreement", bf16["argmax_agree"],
          BF16_ARGMAX_AGREE_MIN, at_least=True)
    check(failures, "bf16 vs f32 mean|dp|", bf16["mean_abs"], BF16_MEAN_ABS_MAX)
    check(failures, "folded vs unfolded f32 max|dp|", fold["max_abs"], FOLD_MAX)
    result = {"frames": n_frames, "f32_card_vs_host": card_host,
              "bf16_vs_f32": bf16, "folded_vs_unfolded_f32": fold}
    return _finish(failures, result)


def compare_deconv(*, batch: int = BATCH, seed: int = 0, shapes=None) -> dict:
    """``conv_transpose2d_phase`` against ``_conv_transpose2d_dilated`` at
    FCN-8's deconvolution shapes: (stride, input (H, W)) at C=11. The
    defaults are upscore_pool4 (k4 s2 on the /16 map) and upscore8 (k16 s8
    on the /8 map) for a 360x480 input."""
    import jax
    import jax.numpy as jnp

    from iterative_inference_segm.ops.conv import (
        _conv_transpose2d_dilated,
        conv_transpose2d_phase,
    )

    shapes = shapes or ((2, (23, 30)), (8, (45, 60)))
    failures: list = []
    result = {}
    key = jax.random.PRNGKey(seed)
    with jax.default_matmul_precision("highest"):
        for stride, (h, w) in shapes:
            k = 2 * stride
            kx, kw, key = jax.random.split(key, 3)
            x = jax.random.normal(kx, (batch, h, w, N_CLASSES), jnp.float32)
            wt = jax.random.normal(kw, (k, k, N_CLASSES, N_CLASSES), jnp.float32) / k
            fast = jax.jit(lambda a, b, s=stride: conv_transpose2d_phase(a, b, stride=s))(x, wt)
            ref = jax.jit(lambda a, b, s=stride: _conv_transpose2d_dilated(a, b, stride=s))(x, wt)
            rel = relative_deviation(fast, ref)
            name = f"k{k}s{stride}_{h}x{w}"
            result[name] = {"out": list(fast.shape), "rel_max": rel}
            check(failures, f"deconv {name} rel max", rel, DECONV_REL_MAX)
    return _finish(failures, result)


def phase_reference(**kw) -> dict:
    import jax

    deconv_kw = {k: kw.pop(k) for k in ("batch", "shapes") if k in kw}
    out = {"pipeline": None, "deconv": None}
    errors = []
    for name, fn in (("pipeline", lambda: compare_reference(jax.devices("cpu")[0], **kw)),
                     ("deconv", lambda: compare_deconv(**deconv_kw))):
        try:
            out[name] = fn()
        except PhaseFailed as e:
            errors.append(f"{name}: {e}")
    if errors:
        raise PhaseFailed(" || ".join(errors))
    return out


def _leaf_max_abs_diff(a, b) -> float:
    import jax
    import numpy as np

    return max(
        float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


def _adam_count(opt_state) -> int:
    import jax
    import numpy as np

    counts = {int(np.asarray(leaf)) for leaf in jax.tree.leaves(opt_state)
              if np.issubdtype(np.asarray(leaf).dtype, np.integer) and np.ndim(leaf) == 0}
    if len(counts) != 1:
        raise PhaseFailed(f"expected one optimizer step count, found {counts}")
    return counts.pop()


def _check_run(failures, workdir, template, init, *, steps, best_name, label) -> dict:
    """Losses finite, checkpoint round trip, parameters moved."""
    import math

    from iterative_inference_segm.train.loop import TrainConfig, make_optimizer
    from iterative_inference_segm.utils.checkpoint import (
        latest_step,
        load_npz,
        restore_checkpoint,
    )
    from iterative_inference_segm.utils.experiment import MetricLogger

    hist = MetricLogger(workdir).read()
    if not hist:
        raise PhaseFailed(f"{label}: no metrics in {workdir}")
    losses = {k: hist[-1][k] for k in ("train_loss", "val_loss")}
    for k, v in losses.items():
        if not math.isfinite(v):
            failures.append(f"{label} {k} = {v}")
    ckpt = os.path.join(workdir, "ckpt")
    step = latest_step(ckpt)
    opt_template = make_optimizer(TrainConfig()).init(template)
    state = restore_checkpoint(ckpt, step, {"params": template, "opt_state": opt_template})
    best = load_npz(os.path.join(workdir, best_name), template)
    roundtrip = _leaf_max_abs_diff(state["params"], best)
    moved = _leaf_max_abs_diff(state["params"], init)
    count = _adam_count(state["opt_state"])
    if roundtrip != 0.0:
        failures.append(f"{label}: checkpoint params differ from {best_name} by {roundtrip}")
    if not moved > 0.0:
        failures.append(f"{label}: parameters did not move from their init")
    if count != steps:
        failures.append(f"{label}: optimizer count {count}, want {steps}")
    return {**losses, "ckpt_step": step, "optimizer_steps": count,
            "max_param_change": moved, "ckpt_vs_best_npz": roundtrip}


def phase_train(workdir: str, *, seed: int = 0, tiny: bool = False,
                train_batches: int = 3) -> dict:
    """train_fcn8 then train_dae (natural corruption) through their CLIs."""
    import jax

    from iterative_inference_segm.data.config_datasets import CAMVID
    from iterative_inference_segm.models import init_fcn8
    from iterative_inference_segm.models.registry import init_score_template

    fc = 64 if tiny else FC_CHANNELS  # --tiny's width in the scripts
    common = ["--synthetic", "--bf16", "--max-epochs", "1",
              "--num-train-batches", str(train_batches), "--num-val-batches", "1",
              "--seed", str(seed)] + (["--tiny"] if tiny else [])
    fcn_dir = os.path.join(workdir, "fcn8")
    dae_dir = os.path.join(workdir, "dae")
    # the trainers' own init: PRNGKey(seed) split once, the second half inits
    init_key = jax.random.split(jax.random.PRNGKey(seed))[1]
    failures: list = []

    t0 = time.perf_counter()
    rc = _load_script("train_fcn8.py").main(
        common + ["--dataset", "camvid", "--workdir", fcn_dir])
    fcn_s = time.perf_counter() - t0
    if rc not in (0, None):
        raise PhaseFailed(f"train_fcn8 exited {rc}")
    fcn_t = init_fcn8(jax.random.PRNGKey(0), n_classes=N_CLASSES, fc_channels=fc)
    fcn_init = init_fcn8(init_key, n_classes=N_CLASSES, fc_channels=fc)
    fcn_res = _check_run(failures, fcn_dir, fcn_t, fcn_init, steps=train_batches,
                         best_name="best_fcn8.npz", label="train_fcn8")

    t0 = time.perf_counter()
    rc = _load_script("train_dae.py").main(
        common + ["--from-fcn", "--fcn-npz", os.path.join(fcn_dir, "best_fcn8.npz"),
                  "--dae-depth", "3", "--dae-stem-pool", "1", "--workdir", dae_dir])
    dae_s = time.perf_counter() - t0
    if rc not in (0, None):
        raise PhaseFailed(f"train_dae exited {rc}")
    dae_kw = dict(n_classes=N_CLASSES, h_taps=("pool4",), depth=3, stem_pool=1)
    dae_t = init_score_template("dae", jax.random.PRNGKey(0), **dae_kw)
    dae_init = init_score_template("dae", init_key, **dae_kw)
    dae_res = _check_run(failures, dae_dir, dae_t, dae_init, steps=train_batches,
                         best_name="best_dae.npz", label="train_dae")
    result = {
        "crop": list(CAMVID.train_crop), "fc_channels": fc,
        "train_fcn8": {**fcn_res, "wall_s": fcn_s},
        "train_dae": {**dae_res, "wall_s": dae_s},
        "peak_bytes_in_use": _peak_bytes(),
    }
    return _finish(failures, result)


def _final_losses(workdir: str) -> dict:
    from iterative_inference_segm.utils.experiment import MetricLogger

    rec = MetricLogger(workdir).read()[-1]
    return {k: rec[k] for k in ("train_loss", "val_loss")}


def phase_four_dp_train(workdir: str, *, seed: int = 0, tiny: bool = False) -> dict:
    """train_dae data-parallel over 4 cards against the same global batch on
    one. No augmentation and sigma=0, so both see identical inputs; f32."""
    argv = ["--synthetic", "--max-epochs", "1", "--batch-size", "8",
            "--num-train-batches", "2", "--num-val-batches", "1", "--no-augment",
            "--from-fcn", "--sigma", "0", "--dae-depth", "3", "--dae-stem-pool", "1",
            "--seed", str(seed)] + (["--tiny"] if tiny else [])
    script = _load_script("train_dae.py")
    out = {}
    for name, extra in (("one_card", []), ("four_cards", ["--devices", "4"])):
        wd = os.path.join(workdir, name)
        t0 = time.perf_counter()
        rc = script.main(argv + extra + ["--workdir", wd])
        if rc not in (0, None):
            raise PhaseFailed(f"train_dae {name} exited {rc}")
        out[name] = {**_final_losses(wd), "wall_s": time.perf_counter() - t0}
    failures: list = []
    for k in ("train_loss", "val_loss"):
        a, b = out["four_cards"][k], out["one_card"][k]
        rel = abs(a - b) / max(abs(b), 1e-12)
        out[f"{k}_rel_diff"] = rel
        check(failures, f"DP {k} rel diff", rel, DP_LOSS_REL_MAX)
    return _finish(failures, out)


def phase_four_predictor(*, seed: int = 0, fc_channels: int = FC_CHANNELS, hw=HW,
                         batch: int = 32, dae_widths=None) -> dict:
    """The flagship Predictor on a 4-card 'data' mesh and as a 2-stage
    pipeline, each against the same Predictor on one card."""
    import jax
    import jax.numpy as jnp

    from iterative_inference_segm.inference import Predictor
    from iterative_inference_segm.parallel.mesh import make_mesh

    fcn, dae = init_flagship_params(seed, fc_channels=fc_channels, dae_widths=dae_widths)
    frames = synthetic_frames(batch, hw, seed)
    kw = dict(engine="half", batch_size=batch, compute_dtype=jnp.bfloat16,
              eps=EPS, num_steps=NUM_STEPS, dae_kwargs={"depth": 3})
    devs = jax.devices()[:4]
    one = Predictor(fcn, dae, **kw).predict(frames, return_probs=True)
    dp = Predictor(fcn, dae, mesh=make_mesh(("data",), devices=devs), **kw)
    pp = Predictor(fcn, dae, pp_mesh=make_mesh(("stage",), (2,), devices=devs[:2]),
                   pp_microbatches=2, **kw)
    failures: list = []
    result = {"batch": batch}
    for name, p in (("dp4", dp), ("pp2", pp)):
        labels, probs = p.predict(frames, return_probs=True)
        dev = prob_deviation(probs, one[1])
        dev["label_agree"] = float((labels == one[0]).mean())
        result[name] = dev
        check(failures, f"{name} label agreement", dev["label_agree"],
              MULTI_LABEL_AGREE_MIN, at_least=True)
        check(failures, f"{name} mean|dp|", dev["mean_abs"], MULTI_MEAN_ABS_MAX)
    return _finish(failures, result)


def phase_four_dryrun() -> dict:
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
    return {"dryrun_multichip": 4}


def run_phase(name: str, fn, failed: list):
    t0 = time.perf_counter()
    try:
        result = fn()
    except Exception as e:  # report every phase; the exit code carries the failure
        traceback.print_exc()
        failed.append(name)
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s: "
              f"{type(e).__name__}: {e}", flush=True)
        return None
    print(f"[{name}] ok {time.perf_counter() - t0:.1f}s {json.dumps(result)}", flush=True)
    return result


def _allow_host_backend() -> None:
    # phase (c) compares against the host CPU backend; keep it available
    # beside the GPU when JAX_PLATFORMS names platforms explicitly
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-card paths, on four cards")
    args = p.parse_args(argv)
    _allow_host_backend()
    import jax

    try:
        require_gpu()
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    failed: list = []
    device = run_phase("device", lambda: phase_device(args.four_cards), failed)
    if device is None:
        return 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        if args.four_cards:
            run_phase("four_dp_train", lambda: phase_four_dp_train(td), failed)
            run_phase("four_predictor", phase_four_predictor, failed)
            run_phase("four_dryrun", phase_four_dryrun, failed)
        else:
            run_phase("flagship", phase_flagship, failed)
            run_phase("reference", phase_reference, failed)
            run_phase("train", lambda: phase_train(td), failed)
    if failed:
        print(f"FAILED phases: {failed}", flush=True)
        return 1
    for card in device["cards"]:
        print(f"card: {card['name']}, power limit {card['power_limit_w']} W", flush=True)
    print(contract_line(jax.devices()[:4] if args.four_cards else jax.devices()[:1]),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
