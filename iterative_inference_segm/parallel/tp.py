"""Tensor parallelism for the FCN-8 classifier head (fc6/fc7).

The reference is single-GPU (SURVEY.md §3.4) so this axis is a rebuild
extension, like SP. It targets the one place in the model family where TP
pays: the VGG classifier pair fc6 (7x7x512xF) + fc7 (1x1xFxF), which
at the parity width F=4096 holds ~96% of the model's parameters (fc6 alone
is 411 MB in f32) and ~29% of its FLOPs. The convolutional backbone and the
small class-channel tail stay replicated — their kernels are tiny and TP
would only add collectives.

Layout is the classic column->row pair expressed as GSPMD shardings rather
than hand-written collectives:

  * fc6 kernel sharded on OUTPUT channels over the model axis
    (P(None, None, None, 'model')), bias likewise — each device computes a
    contiguous slice of the fc6 activation, so the activation itself is
    channel-sharded and the fc6->relu->dropout chain runs fully locally.
  * fc7 kernel sharded on INPUT channels (P(None, None, 'model', None)) —
    each device contracts its local activation slice, and XLA inserts the
    one all-reduce for the partial sums. fc7's bias and everything
    after (score_fr, skips, deconvs) are replicated.

No shard_map and no manual psum: annotate the params (`tp_shardings` +
`jax.device_put`), jit the untouched `fcn8_apply`, and GSPMD propagates the
channel sharding through relu/dropout and places the collective. The same
annotated params feed the training step — optax moments inherit the leaf
shardings, so the optimizer state for the two big kernels is sharded too
(tested in tests/test_tp.py).

Compose with DP/SP by building the mesh with both axes, e.g.
``make_mesh(('data', 'model'), (n // 2, 2))`` and batch-sharding inputs
over 'data' as usual (`sharding.batch_sharding`).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# params[name] for these keys is {'w': (kh, kw, cin, cout), 'b': (cout,)}
_COL_PARALLEL = ("fc6",)  # shard w on cout + b
_ROW_PARALLEL = ("fc7",)  # shard w on cin; b replicated (added post-reduce)


def tp_shardings(params: dict, mesh: Mesh, *, model_axis: str = "model") -> dict:
    """NamedSharding pytree for FCN-8 params: fc6 column-, fc7 row-parallel.

    Every other leaf is replicated. The fc width must divide the model-axis
    size (validated here rather than at trace time for a readable error).
    """
    axis_size = mesh.shape[model_axis]
    fc = params["fc6"]["w"].shape[-1]
    if fc % axis_size:
        raise ValueError(
            f"fc_channels {fc} not divisible by mesh axis '{model_axis}' size {axis_size}"
        )
    repl = NamedSharding(mesh, P())
    out = jax.tree.map(lambda _: repl, params)
    for name in _COL_PARALLEL:
        out[name] = {
            "w": NamedSharding(mesh, P(None, None, None, model_axis)),
            "b": NamedSharding(mesh, P(model_axis)),
        }
    for name in _ROW_PARALLEL:
        out[name] = {
            "w": NamedSharding(mesh, P(None, None, model_axis, None)),
            "b": repl,
        }
    return out


def shard_params_tp(params: dict, mesh: Mesh, *, model_axis: str = "model") -> dict:
    """Device_put the FCN-8 params with the fc6/fc7 TP layout."""
    return jax.tree.map(
        jax.device_put, params, tp_shardings(params, mesh, model_axis=model_axis)
    )
