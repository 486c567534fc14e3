"""Import reference-era weights (Caffe/torch OIHW layouts) into this framework.

The reference initializes FCN-8 from Caffe-converted VGG16 ``.npz`` files
(``[ref: models/fcn8.py]`` load_weights, SURVEY.md §6 'pretrained VGG/FCN
init loaded from converted Caffe .npz'). Those store conv weights as
(out, in, kh, kw) [OIHW] and fully-connected fc6/fc7 as flat matrices; this
framework is NHWC/HWIO. These converters make any such checkpoint loadable,
so parity against reference weights can be checked bit-for-bit whenever a
real checkpoint is available.
"""

from __future__ import annotations

import numpy as np

# canonical VGG16 conv layer order (matches models/fcn8._VGG)
VGG16_CONV_NAMES = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
)


def oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    """(out, in, kh, kw) -> (kh, kw, in, out)."""
    if w.ndim != 4:
        raise ValueError(f"expected 4-D OIHW weight, got shape {w.shape}")
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def fc_to_conv_hwio(w: np.ndarray, kh: int, kw: int, cin: int) -> np.ndarray:
    """Flat FC matrix (out, cin*kh*kw) in Caffe C,H,W flattening order ->
    (kh, kw, cin, out) conv weight (the fc6-as-conv conversion)."""
    out = w.shape[0]
    if w.ndim != 2 or w.shape[1] != cin * kh * kw:
        raise ValueError(f"expected ({out}, {cin * kh * kw}) FC weight, got {w.shape}")
    w = w.reshape(out, cin, kh, kw)  # O, I, H, W (Caffe flattening)
    return oihw_to_hwio(w)


def fc_to_conv1x1_hwio(w: np.ndarray) -> np.ndarray:
    """Flat FC matrix (out, cin) -> (1, 1, cin, out) conv weight (fc7)."""
    if w.ndim != 2:
        raise ValueError(f"expected 2-D FC weight, got shape {w.shape}")
    return np.ascontiguousarray(w.T[None, None, :, :])


def deconv_iohw_to_hwio(w: np.ndarray, *, flip: bool = False) -> np.ndarray:
    """Reference transposed-conv weight (in, out, kh, kw) -> (kh, kw, in, out).

    Lasagne's ``TransposedConv2DLayer`` stores W as (num_input_channels,
    num_filters, rows, cols) [ref: models/fcn8.py upscore layers]. Our
    ``conv_transpose2d`` consumes (kh, kw, cin, cout) and computes the
    input-dilated cross-correlation. ``flip=True`` additionally reverses the
    spatial taps for checkpoints saved under the convolution (flipped)
    convention — a no-op for the symmetric bilinear kernels FCN-8 actually
    uses, but exposed so first contact with a real checkpoint can settle the
    convention with one flag instead of a code change.
    """
    if w.ndim != 4:
        raise ValueError(f"expected 4-D IOHW deconv weight, got shape {w.shape}")
    if flip:
        w = w[:, :, ::-1, ::-1]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


# FCN-8 head layers: name -> kind ('conv' OIHW / 'deconv' IOHW, no bias)
FCN8_HEAD_LAYERS = {
    "score_fr": "conv",
    "score_pool4": "conv",
    "score_pool3": "conv",
    "upscore2": "deconv",
    "upscore_pool4": "deconv",
    "upscore8": "deconv",
}


def import_vgg16_oihw(weights: dict, params: dict, *, strict: bool = False) -> dict:
    """Overlay OIHW-layout VGG16 conv weights onto an init_fcn8 pytree.

    ``weights`` maps layer name -> {'w': OIHW array, 'b': (out,) array}
    (or tuples). Layers absent from ``weights`` keep their initialization —
    matching the reference behavior where score/upsampling layers are
    freshly initialized and only the VGG stack is pretrained.
    """
    import jax.numpy as jnp

    out = dict(params)
    for name in VGG16_CONV_NAMES:
        if name not in weights:
            if strict:
                raise KeyError(f"missing pretrained layer {name!r}")
            continue
        entry = weights[name]
        w, b = (entry["w"], entry["b"]) if isinstance(entry, dict) else entry
        w = oihw_to_hwio(np.asarray(w))
        b = np.asarray(b)
        if w.shape != tuple(params[name]["w"].shape):
            raise ValueError(
                f"{name}: converted shape {w.shape} != model shape {tuple(params[name]['w'].shape)}"
            )
        out[name] = {
            "w": jnp.asarray(w, dtype=params[name]["w"].dtype),
            "b": jnp.asarray(b, dtype=params[name]["b"].dtype),
        }
    return out


def import_fcn8_reference(
    weights: dict,
    params: dict,
    *,
    strict: bool = False,
    flip_deconvs: bool = False,
) -> dict:
    """Overlay a COMPLETE reference-era FCN-8 checkpoint onto an init_fcn8 tree.

    Extends ``import_vgg16_oihw`` (VGG conv stack) with every remaining layer
    of ``[ref: models/fcn8.py]``'s ``buildFCN8``, so a full reference
    checkpoint loads in one call — the one-command 0.3-IoU parity check
    (BASELINE.json:5) the day real weights appear:

    * ``fc6``: accepts (out, 512*7*7) flat FC (Caffe fc6 converted to conv via
      ``fc_to_conv_hwio``) OR already-conv OIHW (out, 512, 7, 7).
    * ``fc7``: accepts (out, in) flat FC OR OIHW (out, in, 1, 1).
    * ``score_fr`` / ``score_pool4`` / ``score_pool3``: OIHW 1x1 convs.
    * ``upscore2`` / ``upscore_pool4`` / ``upscore8``: IOHW transposed convs
      (Lasagne layout), no bias; ``flip_deconvs`` selects the tap convention
      (irrelevant for symmetric bilinear kernels).

    Layers absent from ``weights`` keep their initialization unless
    ``strict`` (the reference itself supports partial loads — VGG-only
    pretraining with fresh heads).
    """
    import jax.numpy as jnp

    out = import_vgg16_oihw(weights, params, strict=False)
    missing = [n for n in VGG16_CONV_NAMES if n not in weights]

    def unpack(entry):
        return (entry["w"], entry.get("b")) if isinstance(entry, dict) else (
            entry if isinstance(entry, np.ndarray) else entry[0],
            None if isinstance(entry, np.ndarray) or len(entry) < 2 else entry[1],
        )

    def place(name, w, b):
        tmpl = params[name]
        if tuple(w.shape) != tuple(tmpl["w"].shape):
            raise ValueError(
                f"{name}: converted shape {w.shape} != model shape {tuple(tmpl['w'].shape)}"
            )
        new = {"w": jnp.asarray(w, dtype=tmpl["w"].dtype)}
        if "b" in tmpl:
            if b is None:
                b = np.zeros(tmpl["b"].shape, np.float32)
            new["b"] = jnp.asarray(b, dtype=tmpl["b"].dtype)
        out[name] = new

    for name in ("fc6", "fc7"):
        if name not in weights:
            missing.append(name)
            continue
        w, b = unpack(weights[name])
        w = np.asarray(w)
        if w.ndim == 2:
            if name == "fc6":
                kh, kw, cin, _ = params["fc6"]["w"].shape
                w = fc_to_conv_hwio(w, int(kh), int(kw), int(cin))
            else:
                w = fc_to_conv1x1_hwio(w)
        else:
            w = oihw_to_hwio(w)
        place(name, w, b)

    for name, kind in FCN8_HEAD_LAYERS.items():
        if name not in weights:
            missing.append(name)
            continue
        w, b = unpack(weights[name])
        w = np.asarray(w)
        if kind == "deconv":
            w = deconv_iohw_to_hwio(w, flip=flip_deconvs)
        else:
            w = oihw_to_hwio(w)
        place(name, w, b)

    if strict and missing:
        raise KeyError(f"missing pretrained layers: {sorted(missing)}")
    return out


# Canonical FCN-8 layer sequence in the reference's build order
# (``[ref: models/fcn8.py]`` buildFCN8 constructs the Lasagne graph in this
# order, and ``lasagne.layers.get_all_param_values`` returns params in build
# order). Entries: (name, kind) with kind in conv/fc/deconv.
FCN8_LASAGNE_ORDER = (
    *((n, "conv") for n in VGG16_CONV_NAMES),
    ("fc6", "fc"),
    ("fc7", "fc"),
    ("score_fr", "conv"),
    ("upscore2", "deconv"),
    ("score_pool4", "conv"),
    ("upscore_pool4", "deconv"),
    ("score_pool3", "conv"),
    ("upscore8", "deconv"),
)


def group_lasagne_arrays(arrays, params: dict) -> dict:
    """Group a positional Lasagne param list into the named-weights dict
    ``import_fcn8_reference`` consumes.

    The reference checkpoints with ``np.savez(*get_all_param_values(net))``
    — a POSITIONAL list (arr_0..arr_N), not named entries. Assignment here
    is shape-driven: walk ``FCN8_LASAGNE_ORDER`` and greedily consume
    arrays whose shape matches the expected layer (w in OIHW/flat-FC/IOHW
    form, optionally followed by its (out,) bias; deconvs carry no bias).
    Shape matching makes the import robust to layers the checkpoint lacks
    (partial checkpoints skip ahead); equal-shape layers (e.g. conv3_2 vs
    conv3_3) resolve by order, which Lasagne's build order guarantees.
    """
    arrays = [np.asarray(a) for a in arrays]
    out: dict = {}
    i = 0

    def expected_w_shapes(name: str, kind: str) -> list[tuple[int, ...]]:
        kh, kw, cin, cout = (int(d) for d in params[name]["w"].shape)
        if kind == "conv":
            return [(cout, cin, kh, kw)]
        if kind == "fc":
            # flat FC or already-converted conv form
            return [(cout, cin * kh * kw), (cout, cin, kh, kw)]
        return [(cin, cout, kh, kw)]  # deconv IOHW

    for name, kind in FCN8_LASAGNE_ORDER:
        if i >= len(arrays):
            break
        shapes = expected_w_shapes(name, kind)
        if tuple(arrays[i].shape) not in shapes:
            continue  # layer absent from this checkpoint
        w = arrays[i]
        i += 1
        entry = {"w": w}
        if kind != "deconv":
            cout = int(params[name]["w"].shape[3])
            if i < len(arrays) and arrays[i].shape == (cout,):
                entry["b"] = arrays[i]
                i += 1
        out[name] = entry
    if i != len(arrays):
        raise ValueError(
            f"could not place {len(arrays) - i} trailing arrays "
            f"(next shape {arrays[i].shape}); checkpoint order does not match "
            "the FCN-8 build sequence"
        )
    return out


def import_lasagne_npz(path, params: dict, *, strict: bool = False, flip_deconvs: bool = False) -> dict:
    """Load a reference-era positional ``.npz`` (np.savez of
    ``get_all_param_values``) straight into an ``init_fcn8`` pytree."""
    data = np.load(path)
    # np.savez positional keys are arr_0..arr_N; sort numerically
    keys = sorted(data.files, key=lambda k: int(k.split("_")[-1]) if k.split("_")[-1].isdigit() else 10**9)
    arrays = [data[k] for k in keys]
    named = group_lasagne_arrays(arrays, params)
    return import_fcn8_reference(named, params, strict=strict, flip_deconvs=flip_deconvs)


def group_mirror_dae_arrays(arrays, params: dict) -> dict:
    """Group a positional Lasagne param list into a mirror-DAE pytree overlay.

    Assumed build order (``[ref: models/DAE_h.py]`` ``buildDAE`` — the
    reference mount is empty, so this is the natural Lasagne build order
    for the SURVEY.md §3.1 topology and must be re-verified at first
    contact, see models/dae_mirror.py provenance note):

        enc1.W (OIHW), enc1.b, ..., encD.W, encD.b,        # encoder, shallow->deep
        decD.[W,] decD.b, ..., dec1.[W,] dec1.b,           # decoder, deep->shallow
        out.W, out.b                                       # 1x1 head

    Tied checkpoints (``get_all_param_values`` skips tied Ws — Lasagne
    expressions are not params) carry decoder BIASES only; whether the
    checkpoint is tied is inferred from the template
    (``models.dae_mirror.mirror_tied_of``). Kernels are Lasagne OIHW and
    converted to this framework's HWIO.
    """
    from iterative_inference_segm.models.dae_mirror import mirror_depth_of, mirror_tied_of

    arrays = [np.asarray(a) for a in arrays]
    depth = mirror_depth_of(params)
    tied = mirror_tied_of(params)

    order: list[tuple[str, bool]] = []  # (layer name, has kernel)
    order += [(f"enc{i + 1}", True) for i in range(depth)]
    if "mid" in params:  # bottleneck conditioning conv (untied, built after the encoder)
        order += [("mid", True)]
    order += [(f"dec{i + 1}", not tied) for i in reversed(range(depth))]
    order += [("out", True)]

    out: dict = {}
    i = 0
    for name, has_w in order:
        entry = {}
        tmpl = params[name]
        if has_w:
            kh, kw, cin, cout = (int(d) for d in tmpl["w"].shape)
            want = (cout, cin, kh, kw)
            if i >= len(arrays) or tuple(arrays[i].shape) != want:
                got = tuple(arrays[i].shape) if i < len(arrays) else "end-of-list"
                raise ValueError(
                    f"mirror-DAE import: {name}.W expected OIHW {want}, got {got} "
                    f"at position {i} — checkpoint order does not match the "
                    "assumed buildDAE sequence (see group_mirror_dae_arrays)"
                )
            entry["w"] = oihw_to_hwio(arrays[i])
            i += 1
        bshape = tuple(int(d) for d in tmpl["b"].shape)
        if i >= len(arrays) or tuple(arrays[i].shape) != bshape:
            got = tuple(arrays[i].shape) if i < len(arrays) else "end-of-list"
            raise ValueError(
                f"mirror-DAE import: {name}.b expected {bshape}, got {got}"
            )
        entry["b"] = arrays[i]
        i += 1
        out[name] = entry
    if i != len(arrays):
        raise ValueError(
            f"mirror-DAE import: {len(arrays) - i} trailing arrays left over "
            f"(next shape {arrays[i].shape}) — checkpoint does not match the "
            f"{'tied' if tied else 'untied'} depth-{depth} template"
        )
    return out


def import_mirror_dae_npz(path, params: dict) -> dict:
    """Load a reference-era positional mirror-DAE ``.npz`` into an
    ``init_mirror_dae`` pytree (layout conversion automatic). The template's
    tied/untied structure selects which checkpoint format is expected."""
    import jax.numpy as jnp

    data = np.load(path)
    keys = sorted(
        data.files,
        key=lambda k: int(k.split("_")[-1]) if k.split("_")[-1].isdigit() else 10**9,
    )
    named = group_mirror_dae_arrays([data[k] for k in keys], params)
    out = dict(params)
    for name, entry in named.items():
        tmpl = params[name]
        new = {"b": jnp.asarray(entry["b"], dtype=tmpl["b"].dtype)}
        if "w" in entry:
            if tuple(entry["w"].shape) != tuple(tmpl["w"].shape):
                raise ValueError(
                    f"{name}: converted shape {entry['w'].shape} != model shape "
                    f"{tuple(tmpl['w'].shape)}"
                )
            new["w"] = jnp.asarray(entry["w"], dtype=tmpl["w"].dtype)
        out[name] = new
    return out
