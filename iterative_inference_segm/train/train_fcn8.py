"""FCN-8 training workload.

Rebuild of ``[ref: train_fcn8.py]`` (SURVEY.md §4.1): data iterators ->
void-masked crossentropy + weight decay -> Adam -> epoch loop with train/val
metrics -> early stopping on val jaccard -> best-checkpoint save.

The train step (augmentation included) is ONE jitted program; with a mesh
+ batch sharding the same step runs data-parallel and XLA emits the
gradient all-reduce (see parallel/).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable

import jax
import jax.numpy as jnp

from iterative_inference_segm.data.config_datasets import DatasetConfig, CAMVID
from iterative_inference_segm.data.pipeline import normalize_image, random_crop_and_flip
from iterative_inference_segm.models.fcn8 import init_fcn8, fcn8_apply
from iterative_inference_segm.ops.losses import masked_crossentropy
from iterative_inference_segm.ops.metrics import confusion_matrix, metrics_from_confusion
from iterative_inference_segm.train.loop import TrainConfig, EarlyStopper, make_optimizer
from iterative_inference_segm.utils.checkpoint import save_npz
from iterative_inference_segm.utils.experiment import MetricLogger


def make_fcn8_train_step(
    cfg: DatasetConfig,
    tcfg: TrainConfig,
    tx,
    *,
    augment: bool = True,
    normalize: bool = True,
    input_scale: float = 1.0,
    fc_channels: int = 4096,
    mesh=None,
):
    """Build the jitted train step: (params, opt_state, batch, rng) -> ...

    Augmentation (random crop + flip + normalize) runs inside the same
    program — the host only supplies raw uint8/float batches.
    ``input_scale=255.0`` with ``normalize=True`` is the u8 wire mode
    (``NativeDataset.batches(raw=True)``): raw bytes cross the host->device
    link and this step normalizes/casts on-chip.

    ``mesh``: a ``jax.sharding.Mesh`` with a 'data' axis makes both steps
    data-parallel via ``shard_map`` — batches shard over the axis, params
    replicate, per-device rng decorrelates (fold-in of the axis index, the
    ``parallel/dp.py`` pattern), and gradients/losses pmean (an XLA
    all-reduce) before the identical optimizer update on every
    device. The batch size must divide the axis size.
    """

    from iterative_inference_segm.models.fcn8 import fcn8_logits

    logits_fn = fcn8_logits
    if tcfg.remat:
        logits_fn = jax.checkpoint(
            lambda p, x, rng: fcn8_logits(
                p, x, dropout_rng=rng, compute_dtype=tcfg.compute_dtype
            )
        )

    def loss_fn(params, images, labels, rng):
        logits_rng, _ = jax.random.split(rng)
        if tcfg.remat:
            logits = logits_fn(params, images, logits_rng)
        else:
            logits = fcn8_logits(
                params, images, dropout_rng=logits_rng, compute_dtype=tcfg.compute_dtype
            )
        loss = masked_crossentropy(logits, labels, n_classes=cfg.n_classes)
        return loss, logits

    axis = "data"

    def train_core(params, opt_state, images, labels, rng, *, dp: bool):
        if dp:
            # decorrelate per-device randomness (augmentation crops, dropout)
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        aug_rng, drop_rng = jax.random.split(rng)
        labels = labels.astype(jnp.int32)  # no-op unless on the u8 wire
        if normalize:
            images = normalize_image(images, cfg, input_scale=input_scale)
        if augment:
            images, labels = random_crop_and_flip(
                aug_rng, images, labels, crop=cfg.train_crop
            )
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, images, labels, drop_rng
        )
        if dp:
            loss = jax.lax.pmean(loss, axis)
            grads = jax.lax.pmean(grads, axis)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    def eval_core(params, images, labels, *, dp: bool):
        labels = labels.astype(jnp.int32)
        if normalize:
            images = normalize_image(images, cfg, input_scale=input_scale)
        probs, _ = fcn8_apply(params, images, compute_dtype=tcfg.compute_dtype)
        pred = jnp.argmax(probs, axis=-1)
        cm = confusion_matrix(pred, labels, n_classes=cfg.n_classes)
        loss = masked_crossentropy(jnp.log(jnp.clip(probs, 1e-7, 1.0)), labels, n_classes=cfg.n_classes)
        if dp:
            cm = jax.lax.psum(cm, axis)  # confusion counts SUM across shards
            loss = jax.lax.pmean(loss, axis)
        return cm, loss

    if mesh is None:
        train_step = jax.jit(lambda p, o, x, y, r: train_core(p, o, x, y, r, dp=False))
        eval_step = jax.jit(lambda p, x, y: eval_core(p, x, y, dp=False))
    else:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        rep, sh = P(), P(axis)
        train_step = jax.jit(
            shard_map(
                lambda p, o, x, y, r: train_core(p, o, x, y, r, dp=True),
                mesh=mesh,
                in_specs=(rep, rep, sh, sh, rep),
                out_specs=(rep, rep, rep),
                check_vma=False,
            )
        )
        eval_step = jax.jit(
            shard_map(
                lambda p, x, y: eval_core(p, x, y, dp=True),
                mesh=mesh,
                in_specs=(rep, sh, sh),
                out_specs=(rep, rep),
                check_vma=False,
            )
        )

    return train_step, eval_step


def train_fcn8(
    *,
    dataset: DatasetConfig = CAMVID,
    train_data: Iterable | None = None,
    val_data: Iterable | None = None,
    tcfg: TrainConfig | None = None,
    fc_channels: int = 4096,
    workdir: str | None = None,
    augment: bool = True,
    normalize: bool = True,
    input_scale: float = 1.0,
    params=None,
    resume: bool = True,
    checkpoint_every: int = 1,
    mesh=None,
    epoch_callback: Callable | None = None,
) -> dict:
    """Train FCN-8; returns {'params', 'best_miou', 'history', 'epochs'}.

    ``mesh``: a ``jax.sharding.Mesh`` with a 'data' axis trains data-parallel
    (see ``make_fcn8_train_step``); params/opt_state are placed replicated
    and every batch is sharded over the axis before each step.

    Set ``normalize=False`` when batches are already normalized (e.g. the
    native packed-dataset loader's f32 wire applies mean/std on the host);
    set ``input_scale=255.0`` for the u8 wire mode (raw bytes + on-chip
    normalize — ``NativeDataset.batches(raw=True)``).

    With a ``workdir``, (params, opt_state) are checkpointed every
    ``checkpoint_every`` epochs and a killed run auto-restores from the
    latest checkpoint + saved history on restart (``resume=True``) — the
    rebuild of the reference's error-history + best-params resume scaffold
    (``[ref: train_fcn8.py]``, SURVEY.md §6).

    ``train_data``/``val_data`` are callables returning fresh batch iterators
    (epochs re-iterate), or lists of (images, labels) batches.
    """
    tcfg = tcfg or TrainConfig()
    key = jax.random.PRNGKey(tcfg.seed)
    if params is None:
        key, init_key = jax.random.split(key)
        params = init_fcn8(
            init_key,
            n_classes=dataset.n_classes,
            in_channels=dataset.in_channels,
            fc_channels=fc_channels,
        )
    tx = make_optimizer(tcfg)
    opt_state = tx.init(params)
    train_step, eval_step = make_fcn8_train_step(
        dataset, tcfg, tx, augment=augment, normalize=normalize,
        input_scale=input_scale, fc_channels=fc_channels, mesh=mesh,
    )

    if mesh is not None:
        from iterative_inference_segm.parallel.sharding import (
            padded_batch_putter,
            replicate,
        )

        params = replicate(mesh, params)
        opt_state = replicate(mesh, opt_state)
        # pads short last batches (zero images + void labels — exact, both
        # loss and confusion mask void) so disk splits with a non-divisible
        # tail neither crash the sharded device_put nor recompile
        put_batch = padded_batch_putter(mesh, void_label=dataset.void_label)
    else:
        put_batch = lambda x, y: (jnp.asarray(x), jnp.asarray(y))

    def batches(src):
        return src() if callable(src) else iter(src)

    logger = MetricLogger(workdir) if workdir else None
    stopper = EarlyStopper(tcfg.patience)
    best_params = params
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
                ckpt_dir, step, {"params": params, "opt_state": opt_state}
            )
            params, opt_state = state["params"], state["opt_state"]
            history = [h for h in logger.read() if h["step"] <= step] if logger else []
            for h in history:
                stopper.update(h["step"], h.get("val_miou", -float("inf")))
            start_epoch = step + 1
            # True best params may predate the latest checkpoint (VERDICT r1
            # weak #5): restore them from best_*.npz, not the resumed params.
            best_npz = Path(workdir) / "best_fcn8.npz"
            best_params = load_npz(best_npz, params) if best_npz.exists() else params

    import time as _time

    for epoch in range(start_epoch, tcfg.max_epochs):
        t_epoch = _time.perf_counter()
        losses = []
        n_images = 0
        for images, labels in batches(train_data):
            key, step_key = jax.random.split(key)
            xb, yb = put_batch(images, labels)
            params, opt_state, loss = train_step(params, opt_state, xb, yb, step_key)
            losses.append(loss)
            n_images += int(jnp.shape(images)[0])
        # the host fetch of the mean loss waits for every step, so the
        # epoch time below covers the device work
        train_loss = float(jnp.mean(jnp.stack(losses)))
        epoch_seconds = _time.perf_counter() - t_epoch

        cm_total = None
        val_losses = []
        for images, labels in batches(val_data):
            xb, yb = put_batch(images, labels)
            cm, vloss = eval_step(params, xb, yb)
            cm_total = cm if cm_total is None else cm_total + cm
            val_losses.append(vloss)
        m = metrics_from_confusion(cm_total)
        val_miou = float(m.mean_iou)
        val_acc = float(m.pixel_accuracy)
        val_loss = float(jnp.mean(jnp.stack(val_losses)))
        history.append(
            {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
             "val_miou": val_miou, "val_acc": val_acc,
             "epoch_seconds": round(epoch_seconds, 3),
             "train_images_per_sec": round(n_images / max(epoch_seconds, 1e-9), 2)}
        )
        if logger:
            logger.log(epoch, **history[-1])
        if epoch_callback:
            epoch_callback(epoch, history[-1], params)

        if stopper.update(epoch, val_miou):
            best_params = params
            if workdir:
                save_npz(
                    Path(workdir) / "best_fcn8.npz",
                    jax.device_get(best_params),
                    meta={"arch": "fcn8", "fc_channels": fc_channels},
                )
        if workdir and checkpoint_every and epoch % checkpoint_every == 0:
            from iterative_inference_segm.utils.checkpoint import save_checkpoint

            # async: serialization overlaps the next epoch (SURVEY §6);
            # device_get above made private host copies, so this is safe.
            save_checkpoint(
                Path(workdir) / "ckpt", epoch,
                {"params": jax.device_get(params), "opt_state": jax.device_get(opt_state)},
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
