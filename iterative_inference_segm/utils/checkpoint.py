"""Checkpointing: training-state snapshots and flat-npz weight exports.

The reference checkpoints with ``np.savez(lasagne.layers.get_all_param_values)``
and resumes from the best-val `.npz` (``[ref: train_fcn8.py]``, SURVEY.md §6).
Rebuild: one format, npz. ``save_checkpoint`` writes any pytree (params and
optimizer state) to ``<directory>/<step>/state.npz``, optionally on a
background thread; ``save_npz``/``load_npz`` are the flat name->array bridge
used for best-params exports and reference-era weights.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


# Flat-npz entries under this prefix carry ARCHITECTURE metadata, not
# weights. Motivation (ADVICE r2): knobs like the DAE encoder style
# ('pool' vs 'stride') change NO param shapes, so loading a checkpoint with
# the wrong flag succeeds silently and serves degraded predictions. The
# trainers stamp these keys; loaders validate them when the caller declares
# what it expects.
_META_PREFIX = "__meta__/"


def _meta_to_npz(meta: dict) -> dict:
    out = {}
    for k, v in meta.items():
        if isinstance(v, (tuple, list)):
            v = np.asarray(v)
        out[_META_PREFIX + k] = np.asarray(v)
    return out


def _npz_value_to_py(arr: np.ndarray):
    arr = np.asarray(arr)
    if arr.ndim == 0:
        v = arr[()]
        if isinstance(v, (np.str_, str)):
            return str(v)
        if isinstance(v, (np.bool_, bool)):
            return bool(v)
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        return v
    if np.issubdtype(arr.dtype, np.integer):
        return tuple(int(x) for x in arr)
    return tuple(arr.tolist())


def read_npz_meta(path: str | os.PathLike) -> dict:
    """Architecture metadata stored in a flat-npz checkpoint ({} if none —
    e.g. a pre-round-3 export)."""
    data = np.load(path)
    return {
        k[len(_META_PREFIX):]: _npz_value_to_py(data[k])
        for k in data.files
        if k.startswith(_META_PREFIX)
    }


def check_npz_meta(path: str | os.PathLike, expect: dict, *, context: str = "") -> None:
    """Validate declared architecture flags against a checkpoint's stamped
    metadata. Mismatches raise; keys the checkpoint never stamped warn once
    (old exports are accepted but unverifiable)."""
    stored = read_npz_meta(path)
    missing = [k for k in expect if k not in stored]
    bad = {
        k: (stored[k], expect[k])
        for k in expect
        if k in stored and _normalize_meta(stored[k]) != _normalize_meta(expect[k])
    }
    if bad:
        detail = ", ".join(
            f"{k}: checkpoint={s!r} vs requested={e!r}" for k, (s, e) in bad.items()
        )
        raise ValueError(
            f"{context or path}: architecture flags do not match the checkpoint's "
            f"stamped metadata ({detail}). These knobs change no param shapes, so "
            "loading would succeed silently and serve degraded predictions — "
            "pass the flags the checkpoint was trained with."
        )
    if missing:
        import warnings

        warnings.warn(
            f"{context or path}: checkpoint carries no metadata for "
            f"{sorted(missing)}; cannot verify the declared architecture "
            "(old export?). Proceeding unchecked.",
            stacklevel=2,
        )


def _normalize_meta(v):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return v


def save_npz(path: str | os.PathLike, params, *, meta: dict | None = None) -> None:
    """Flat `name/subname -> array` npz export (reference-compatible spirit).

    ``meta`` (optional) stamps architecture metadata under ``__meta__/`` keys
    (strings/numbers/bools/int tuples) — see ``check_npz_meta``.
    """
    flat = _flatten(params)
    if meta:
        overlap = set(flat) & set(_meta_to_npz(meta))
        if overlap:
            raise ValueError(f"meta keys collide with param keys: {sorted(overlap)}")
        flat.update(_meta_to_npz(meta))
    np.savez(path, **flat)


def load_npz(path: str | os.PathLike, template) -> object:
    """Load a flat npz into the structure of ``template`` (keys must match).

    ``__meta__/`` entries are metadata, not weights — read them with
    ``read_npz_meta`` / validate with ``check_npz_meta``.
    """
    data = np.load(path)
    flat = {k: data[k] for k in data.files if not k.startswith(_META_PREFIX)}

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            vals = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            return type(tree)(vals)
        key = prefix[:-1]
        if key not in flat:
            raise KeyError(f"npz missing parameter {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(np.shape(tree)):
            raise ValueError(f"shape mismatch for {key!r}: {arr.shape} vs {np.shape(tree)}")
        return jnp.asarray(arr, dtype=jnp.asarray(tree).dtype)

    return rebuild(template)


_STATE_FILE = "state.npz"
# One writer thread: background saves commit in submission order.
_WRITER = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
_PENDING: list[concurrent.futures.Future] = []
_PENDING_LOCK = threading.Lock()


def _step_dir(directory: str | os.PathLike, step: int) -> Path:
    return Path(directory).absolute() / str(step)


def _host_leaves(state) -> dict[str, np.ndarray]:
    """``keystr(path) -> host array`` for every leaf of ``state``. Dtypes numpy
    cannot store natively (bfloat16) are widened to float32, which is exact;
    restore casts back to the template's dtype."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        arr = np.asarray(leaf)
        if arr.dtype.isbuiltin != 1:  # ml_dtypes extensions, e.g. bfloat16
            arr = arr.astype(np.float32)
        out[jax.tree_util.keystr(path)] = arr
    return out


def _write_state(final: Path, leaves: dict[str, np.ndarray]) -> None:
    # write beside the target, then rename: a reader never sees a partial step
    partial = final.parent / f".{final.name}.partial"
    shutil.rmtree(partial, ignore_errors=True)
    partial.mkdir(parents=True)
    with open(partial / _STATE_FILE, "wb") as f:
        np.savez(f, **leaves)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.rename(partial, final)


def save_checkpoint(directory: str | os.PathLike, step: int, state, *, wait: bool = True) -> None:
    """Checkpoint an arbitrary pytree at ``directory/step`` (overwriting).

    The leaves are copied to host memory before this returns, so the caller
    may donate or mutate its arrays afterwards. ``wait=False`` moves the
    file write to a background thread so checkpoint I/O overlaps the next
    training epoch — the SURVEY §6 plan. Pending saves are flushed by
    ``wait_for_checkpoints`` and before any restore.
    """
    final = _step_dir(directory, step)
    leaves = _host_leaves(state)
    if wait:
        _write_state(final, leaves)
        return
    fut = _WRITER.submit(_write_state, final, leaves)
    with _PENDING_LOCK:
        _PENDING.append(fut)


def wait_for_checkpoints() -> None:
    """Block until every backgrounded ``save_checkpoint`` has committed;
    re-raise the first error a background save hit."""
    with _PENDING_LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    for fut in pending:
        fut.result()


def _read_state(directory: str | os.PathLike, step: int, template, place):
    """Load ``directory/step`` into ``template``'s structure; ``place(arr,
    template_leaf, path)`` puts each leaf where it belongs."""
    wait_for_checkpoints()  # never read past a still-writing save
    path = _step_dir(directory, step) / _STATE_FILE
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    with np.load(path) as data:
        for kpath, t in flat:
            key = jax.tree_util.keystr(kpath)
            if key not in data.files:
                raise KeyError(f"{path}: checkpoint has no leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(np.shape(t)):
                raise ValueError(
                    f"{path}: shape mismatch for {key!r}: {arr.shape} vs {np.shape(t)}"
                )
            leaves.append(place(arr.astype(jnp.result_type(t)), t, kpath))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def restore_checkpoint(directory: str | os.PathLike, step: int, template):
    """Restore ``directory/step`` into ``template``'s structure and dtypes. A
    template leaf that is a ``jax.Array`` gets its value on the same
    sharding; any other leaf comes back as a default-placed array."""

    def place(arr, t, _):
        sharding = getattr(t, "sharding", None)
        return jax.device_put(arr, sharding) if sharding is not None else jnp.asarray(arr)

    return _read_state(directory, step, template, place)


def restore_checkpoint_sharded(
    directory: str | os.PathLike, step: int, template, shardings
):
    """Restore a checkpoint directly INTO a device-mesh layout.

    ``shardings`` is a pytree of ``jax.sharding.Sharding`` matching
    ``template``'s structure (e.g. ``parallel.tp.tp_shardings`` for the
    fc6/fc7 TP layout, or all-replicated on a DP mesh). Each leaf is read on
    the host and placed with ``jax.device_put`` on its sharding, so the save
    topology and the restore topology are independent: a single-card
    training run restores onto a TP mesh and vice versa (tested in
    tests/test_checkpoint.py).
    """
    by_path = {
        jax.tree_util.keystr(p): s
        for p, s in jax.tree_util.tree_flatten_with_path(
            shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding)
        )[0]
    }
    return _read_state(
        directory, step, template,
        lambda arr, _, kpath: jax.device_put(arr, by_path[jax.tree_util.keystr(kpath)]),
    )


def latest_step(directory: str | os.PathLike) -> int | None:
    """Highest numbered checkpoint subdirectory, or None."""
    d = Path(directory)
    if not d.is_dir():
        return None
    steps = [int(p.name) for p in d.iterdir() if p.is_dir() and p.name.isdigit()]
    return max(steps) if steps else None
