"""DAE (conditional score network) training workload.

Rebuild of ``[ref: train_dae.py]`` (SURVEY.md §4.2): the DAE learns to map
corrupted segmentation maps back to the clean ground truth, conditioned on
frozen FCN-8 features. Two switchable corruption regimes, exactly as the
reference exposes via its ``noise`` / ``from_gt`` flags:

* ``from_gt=True``  : input = softmax(one_hot(y_gt) + sigma*N(0,1))
                      (GaussianNoiseLayerSoftmax corruption),
* ``from_gt=False`` : input = frozen-FCN softmax output ("natural" corruption),
                      optionally with additional Gaussian-softmax noise,
* ``from_gt=p`` (float): per-batch mix of the two regimes with probability
  ``p`` of the noisy-GT source — the reference's third option.

Loss: void-masked crossentropy of the DAE output vs the clean ground truth.
The frozen FCN-8 forward (producing both h and y_hat) runs inside the same
jitted program — one XLA executable per step, no host round-trips.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable

import jax
import jax.numpy as jnp

from iterative_inference_segm.data.config_datasets import DatasetConfig, CAMVID
from iterative_inference_segm.data.pipeline import normalize_image, random_crop_and_flip
from iterative_inference_segm.models.fcn8 import fcn8_apply
from iterative_inference_segm.ops.corruption import corrupt_onehot, corrupt_probs
from iterative_inference_segm.ops.losses import crossentropy_probs
from iterative_inference_segm.ops.metrics import confusion_matrix, metrics_from_confusion
from iterative_inference_segm.train.loop import TrainConfig, EarlyStopper, make_optimizer
from iterative_inference_segm.utils.checkpoint import save_npz
from iterative_inference_segm.utils.experiment import MetricLogger


def make_dae_train_step(
    cfg: DatasetConfig,
    tcfg: TrainConfig,
    tx,
    *,
    h_taps: tuple[str, ...],
    sigma: float,
    from_gt: bool | float,
    augment: bool = True,
    normalize: bool = True,
    input_scale: float = 1.0,
    dae_depth: int = 4,
    dae_encoder: str = "pool",
    arch: str = "dae",
    mesh=None,
):
    """Jitted DAE train/eval steps with the frozen FCN inside the program.

    ``mesh``: a 'data'-axis Mesh makes both steps data-parallel via
    ``shard_map`` (batches sharded, params + frozen FCN replicated, per-device
    rng fold-in, grad/loss pmean, confusion-matrix psum) — the same pattern
    as ``make_fcn8_train_step``.

    The frozen FCN params are an explicit argument (not a closure) so they
    are runtime inputs — closing over them would bake ~500MB of VGG weights
    into the executable as constants.

    ``from_gt`` selects the corruption source (``[ref: train_dae.py]``
    supports noisy ground truth, frozen-FCN outputs, or a mix): True/False
    pick one regime; a float in (0, 1) mixes them — each batch draws the
    noisy-GT regime with that probability.
    """
    p_gt = float(from_gt)
    if not 0.0 <= p_gt <= 1.0:
        raise ValueError(f"from_gt must be bool or in [0,1], got {from_gt}")

    def gt_corrupted(labels, rng):
        return corrupt_onehot(labels, rng, n_classes=cfg.n_classes, sigma=sigma)

    def fcn_corrupted(probs, rng):
        return corrupt_probs(probs, rng, sigma=sigma) if sigma > 0 else probs

    def corrupted_input(labels, probs, rng):
        if p_gt >= 1.0:
            return gt_corrupted(labels, rng)
        if p_gt <= 0.0:
            return fcn_corrupted(probs, rng)
        # mixed regime: per-batch coin flip (both branches are cheap relative
        # to the train step; jnp.where keeps the program branch-free)
        mix_rng, noise_rng = jax.random.split(rng)
        take_gt = jax.random.bernoulli(mix_rng, p_gt)
        return jnp.where(
            take_gt, gt_corrupted(labels, noise_rng), fcn_corrupted(probs, noise_rng)
        )

    # arch dispatch is one table (models.registry): normalized apply + the
    # kwargs this arch accepts, with compute_dtype bound to the train config
    from iterative_inference_segm.models.registry import (
        score_apply_fn,
        score_kwargs,
    )

    arch_apply = score_apply_fn(arch)  # validates the arch name
    arch_kw = score_kwargs(arch, depth=dae_depth, encoder=dae_encoder)
    raw_apply = lambda p, y, hh: arch_apply(
        p, y, hh, compute_dtype=tcfg.compute_dtype, **arch_kw
    )

    apply_fn = jax.checkpoint(raw_apply) if tcfg.remat else raw_apply

    def loss_fn(dae_params, y_tilde, h, labels):
        recon = apply_fn(dae_params, y_tilde, h)
        return crossentropy_probs(recon, labels, n_classes=cfg.n_classes), recon

    axis = "data"

    def train_core(dae_params, opt_state, fcn_params, images, labels, rng, *, dp: bool):
        if dp:
            # decorrelate per-device randomness (crops, corruption noise)
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        aug_rng, noise_rng = jax.random.split(rng)
        labels = labels.astype(jnp.int32)  # no-op unless on the u8 wire
        if normalize:
            images = normalize_image(images, cfg, input_scale=input_scale)
        if augment:
            images, labels = random_crop_and_flip(aug_rng, images, labels, crop=cfg.train_crop)
        probs, h = fcn8_apply(
            fcn_params, images, return_features=h_taps, compute_dtype=tcfg.compute_dtype
        )
        y_tilde = corrupted_input(labels, probs, noise_rng)
        y_tilde = jax.lax.stop_gradient(y_tilde)
        h = jax.tree.map(jax.lax.stop_gradient, h)
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            dae_params, y_tilde, h, labels
        )
        if dp:
            loss = jax.lax.pmean(loss, axis)
            grads = jax.lax.pmean(grads, axis)
        updates, opt_state = tx.update(grads, opt_state, dae_params)
        dae_params = jax.tree.map(lambda p, u: p + u, dae_params, updates)
        return dae_params, opt_state, loss

    def eval_core(dae_params, fcn_params, images, labels, rng, *, dp: bool):
        if dp:
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        labels = labels.astype(jnp.int32)
        if normalize:
            images = normalize_image(images, cfg, input_scale=input_scale)
        probs, h = fcn8_apply(
            fcn_params, images, return_features=h_taps, compute_dtype=tcfg.compute_dtype
        )
        y_tilde = corrupted_input(labels, probs, rng)
        loss, recon = loss_fn(dae_params, y_tilde, h, labels)
        pred = jnp.argmax(recon, axis=-1)
        cm = confusion_matrix(pred, labels, n_classes=cfg.n_classes)
        if dp:
            cm = jax.lax.psum(cm, axis)
            loss = jax.lax.pmean(loss, axis)
        return cm, loss

    if mesh is None:
        train_step = jax.jit(
            lambda d, o, f, x, y, r: train_core(d, o, f, x, y, r, dp=False)
        )
        eval_step = jax.jit(lambda d, f, x, y, r: eval_core(d, f, x, y, r, dp=False))
    else:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        rep, sh = P(), P(axis)
        train_step = jax.jit(
            shard_map(
                lambda d, o, f, x, y, r: train_core(d, o, f, x, y, r, dp=True),
                mesh=mesh,
                in_specs=(rep, rep, rep, sh, sh, rep),
                out_specs=(rep, rep, rep),
                check_vma=False,
            )
        )
        eval_step = jax.jit(
            shard_map(
                lambda d, f, x, y, r: eval_core(d, f, x, y, r, dp=True),
                mesh=mesh,
                in_specs=(rep, rep, sh, sh, rep),
                out_specs=(rep, rep),
                check_vma=False,
            )
        )

    return train_step, eval_step


def train_dae(
    *,
    fcn_params,
    dataset: DatasetConfig = CAMVID,
    train_data: Iterable | None = None,
    val_data: Iterable | None = None,
    tcfg: TrainConfig | None = None,
    h_taps: tuple[str, ...] = ("pool4",),
    sigma: float = 1.0,
    from_gt: bool | float = True,
    dae_depth: int = 4,
    dae_stem_pool: int = 0,
    dae_tail: str = "full",
    dae_widths: tuple[int, ...] | None = None,
    dae_encoder: str = "pool",
    dae_tied: bool = False,
    arch: str = "dae",
    workdir: str | None = None,
    augment: bool = True,
    normalize: bool = True,
    input_scale: float = 1.0,
    dae_params=None,
    resume: bool = True,
    checkpoint_every: int = 1,
    mesh=None,
    epoch_callback: Callable | None = None,
) -> dict:
    """Train the conditional DAE against a frozen FCN-8.

    Mirrors the reference CLI knobs: ``h_taps`` = concat_h, ``sigma`` = noise
    level, ``from_gt`` selects the corruption regime. ``mesh``: train
    data-parallel over the mesh's 'data' axis (see ``make_dae_train_step``).
    """
    tcfg = tcfg or TrainConfig()
    key = jax.random.PRNGKey(tcfg.seed)
    if dae_params is None:
        from iterative_inference_segm.models.registry import init_score_template

        key, init_key = jax.random.split(key)
        dae_params = init_score_template(
            arch, init_key, n_classes=dataset.n_classes, h_taps=tuple(h_taps),
            depth=dae_depth, stem_pool=dae_stem_pool, tail=dae_tail,
            widths=dae_widths, tied=dae_tied,
        )
    tx = make_optimizer(tcfg)
    opt_state = tx.init(dae_params)
    train_step, eval_step = make_dae_train_step(
        dataset,
        tcfg,
        tx,
        h_taps=h_taps,
        sigma=sigma,
        from_gt=from_gt,
        augment=augment,
        normalize=normalize,
        input_scale=input_scale,
        dae_depth=dae_depth,
        dae_encoder=dae_encoder,
        arch=arch,
        mesh=mesh,
    )

    if mesh is not None:
        from iterative_inference_segm.parallel.sharding import (
            padded_batch_putter,
            replicate,
        )

        dae_params = replicate(mesh, dae_params)
        opt_state = replicate(mesh, opt_state)
        fcn_params = replicate(mesh, fcn_params)
        # pads short last batches (zero images + void labels — exact, the
        # DAE loss masks void and one-hot of void is all-zeros) so disk
        # splits with a non-divisible tail neither crash nor recompile
        put_batch = padded_batch_putter(mesh, void_label=dataset.void_label)
    else:
        put_batch = lambda x, y: (jnp.asarray(x), jnp.asarray(y))

    def batches(src):
        return src() if callable(src) else iter(src)

    # Architecture metadata stamped into best_dae.npz: shape-invisible knobs
    # (notably encoder='pool'|'stride') would otherwise load silently under
    # the wrong flag and serve degraded predictions (ADVICE r2).
    from iterative_inference_segm.models.registry import checkpoint_meta

    ckpt_meta = checkpoint_meta(
        arch, h_taps=tuple(h_taps), depth=dae_depth, stem_pool=dae_stem_pool,
        tail=dae_tail, widths=dae_widths, encoder=dae_encoder, tied=dae_tied,
    )

    logger = MetricLogger(workdir) if workdir else None
    stopper = EarlyStopper(tcfg.patience)
    best_params = dae_params
    history = []
    start_epoch = 0

    if workdir and resume:
        from iterative_inference_segm.utils.checkpoint import (
            latest_step,
            load_npz,
            restore_checkpoint,
        )

        ckpt_dir = Path(workdir) / "ckpt"
        step = latest_step(ckpt_dir)
        if step is not None:
            state = restore_checkpoint(
                ckpt_dir, step, {"params": dae_params, "opt_state": opt_state}
            )
            dae_params, opt_state = state["params"], state["opt_state"]
            history = [h for h in logger.read() if h["step"] <= step] if logger else []
            for h in history:
                stopper.update(h["step"], h.get("val_miou", -float("inf")))
            start_epoch = step + 1
            # True best params may predate the latest checkpoint (VERDICT r1
            # weak #5): restore them from best_*.npz, not the resumed params.
            best_npz = Path(workdir) / "best_dae.npz"
            best_params = load_npz(best_npz, dae_params) if best_npz.exists() else dae_params

    import time as _time

    for epoch in range(start_epoch, tcfg.max_epochs):
        t_epoch = _time.perf_counter()
        losses = []
        n_images = 0
        for images, labels in batches(train_data):
            key, step_key = jax.random.split(key)
            xb, yb = put_batch(images, labels)
            dae_params, opt_state, loss = train_step(
                dae_params, opt_state, fcn_params, xb, yb, step_key
            )
            losses.append(loss)
            n_images += int(jnp.shape(images)[0])
        # the host fetch waits for every step before timing — see train_fcn8
        train_loss = float(jnp.mean(jnp.stack(losses)))
        epoch_seconds = _time.perf_counter() - t_epoch

        cm_total = None
        val_losses = []
        for i, (images, labels) in enumerate(batches(val_data)):
            xb, yb = put_batch(images, labels)
            cm, vloss = eval_step(
                dae_params, fcn_params, xb, yb, jax.random.fold_in(key, i)
            )
            cm_total = cm if cm_total is None else cm_total + cm
            val_losses.append(vloss)
        m = metrics_from_confusion(cm_total)
        val_miou = float(m.mean_iou)
        val_loss = float(jnp.mean(jnp.stack(val_losses)))
        history.append(
            {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
             "val_miou": val_miou, "epoch_seconds": round(epoch_seconds, 3),
             "train_images_per_sec": round(n_images / max(epoch_seconds, 1e-9), 2)}
        )
        if logger:
            logger.log(epoch, **history[-1])
        if epoch_callback:
            epoch_callback(epoch, history[-1], dae_params)

        if stopper.update(epoch, val_miou):
            best_params = dae_params
            if workdir:
                save_npz(
                    Path(workdir) / "best_dae.npz",
                    jax.device_get(best_params),
                    meta=ckpt_meta,
                )
        if workdir and checkpoint_every and epoch % checkpoint_every == 0:
            from iterative_inference_segm.utils.checkpoint import save_checkpoint

            # async: serialization overlaps the next epoch (SURVEY §6);
            # device_get above made private host copies, so this is safe.
            save_checkpoint(
                Path(workdir) / "ckpt", epoch,
                {"params": jax.device_get(dae_params), "opt_state": jax.device_get(opt_state)},
                wait=False,
            )
        if stopper.should_stop:
            break

    if workdir:
        from iterative_inference_segm.utils.checkpoint import wait_for_checkpoints

        wait_for_checkpoints()

    return {
        "params": best_params,
        "best_miou": stopper.best,
        "best_epoch": stopper.best_epoch,
        "history": history,
        "epochs": len(history),
    }
