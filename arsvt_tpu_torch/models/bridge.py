"""Bridge between the JAX classifier and detector pytrees and the port's
parameters.

The JAX classifier tree (``arsvt_tpu/models/classifier.py::
init_image_classifier``) is ``{"backbone": ..., "classifier": ...}``, the
detector tree (``arsvt_tpu/models/detector.py::init_detector``)
``{"backbone": ..., "detr": ..., "triplet_proj": ...}``; both stack the
encoder and decoder blocks on a leading depth axis. The port holds the
same keys with the blocks as a list of per-layer dicts; the patch kernel
stays (p·p·C, D) in (p, p, C) row-major order. Leaves cross as numpy
arrays, so neither side imports the other.

The int8 trees of ``arsvt_tpu/models/quantized.py``
(``quantize_image_classifier``, ``quantize_detector``) cross the same way:
each of the backbone's five quantized kernels is {"q": int8 (..., in,
out), "scale": fp32 (..., out)} on both sides, so both packages can run
the same int8 weights. `quantized_classifier_from_jax` and
`quantized_detector_from_jax` bring them in; `to_jax_params` and
`detector_to_jax_params` take any tree of the port's layout back, int8
ones included.
"""

from __future__ import annotations

import numpy as np
import torch

from arsvt_tpu_torch.core.dtypes import tree_map
from arsvt_tpu_torch.models.detector import DetectorConfig
from arsvt_tpu_torch.models.vit import BackboneConfig


def _ln(d, *lead):
    return {"scale": (*lead, d), "bias": (*lead, d)}


def _linear(fan_in, fan_out, *lead):
    return {"kernel": (*lead, fan_in, fan_out), "bias": (*lead, fan_out)}


def _backbone_shapes(cfg: BackboneConfig) -> dict:
    d, depth, m = cfg.embed_dim, cfg.depth, cfg.mlp_dim
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_channels
    backbone = {
        "patch_embed": _linear(patch_dim, d),
        "cls_token": (1, 1, d),
        "pos_embed": (1, cfg.seq_len, d),
        "blocks": {
            "ln1": _ln(d, depth),
            "attn": {"qkv": _linear(d, 3 * d, depth),
                     "proj": _linear(d, d, depth)},
            "ln2": _ln(d, depth),
            "mlp": {"fc1": _linear(d, m, depth),
                    "fc2": _linear(m, d, depth)},
        },
        "ln_f": _ln(d),
    }
    if cfg.distilled:
        backbone["dist_token"] = (1, 1, d)
    return backbone


def jax_layout_shapes(cfg: BackboneConfig, num_classes: int) -> dict:
    """The shape of every leaf of the JAX classifier tree for `cfg`."""
    d = cfg.embed_dim
    classifier = {"head": _linear(d, num_classes)}
    if cfg.distilled:
        classifier["head_dist"] = _linear(d, num_classes)
    return {"backbone": _backbone_shapes(cfg), "classifier": classifier}


def jax_detector_layout_shapes(cfg: DetectorConfig) -> dict:
    """The shape of every leaf of the JAX detector tree for `cfg`."""
    d, h = cfg.backbone.embed_dim, cfg.head
    depth = h.depth
    detr = {
        "queries": (h.num_queries, d),
        "blocks": {
            "ln_self": _ln(d, depth),
            "self_attn": {"qkv": _linear(d, 3 * d, depth),
                          "proj": _linear(d, d, depth)},
            "ln_cross_q": _ln(d, depth),
            "ln_cross_kv": _ln(d, depth),
            "cross_attn": {"q": _linear(d, d, depth),
                           "kv": _linear(d, 2 * d, depth),
                           "proj": _linear(d, d, depth)},
            "ln_mlp": _ln(d, depth),
            "mlp": {"fc1": _linear(d, h.ffn_dim, depth),
                    "fc2": _linear(h.ffn_dim, d, depth)},
        },
        "ln_f": _ln(d),
        "class_head": _linear(d, h.num_classes + 1),
        "bbox_head": _linear(d, 4),
    }
    return {"backbone": _backbone_shapes(cfg.backbone), "detr": detr,
            "triplet_proj": _linear(d, cfg.triplet_dim)}


# the backbone's kernels that quantize_backbone turns into {"q", "scale"}
_QUANTIZED_KERNELS = (("patch_embed",), ("blocks", "attn", "qkv"),
                      ("blocks", "attn", "proj"), ("blocks", "mlp", "fc1"),
                      ("blocks", "mlp", "fc2"))


def _quantized_backbone_shapes(cfg: BackboneConfig) -> dict:
    spec = _backbone_shapes(cfg)
    for path in _QUANTIZED_KERNELS:
        node = spec
        for key in path:
            node = node[key]
        shape = node["kernel"]
        node["kernel"] = {"q": shape, "scale": (*shape[:-2], shape[-1])}
    return spec


def _check_tree(tree, spec, path: str = "") -> None:
    if isinstance(spec, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{path or 'params'}: expected a dict, got "
                             f"{type(tree).__name__}")
        if set(tree) != set(spec):
            raise ValueError(
                f"{path or 'params'}: keys {sorted(tree)} do not match the "
                f"config's {sorted(spec)}")
        for k in spec:
            _check_tree(tree[k], spec[k], f"{path}/{k}")
        return
    shape = tuple(np.shape(tree))
    if shape != tuple(spec):
        raise ValueError(f"{path}: shape {shape} does not match the "
                         f"config's {tuple(spec)}")


def from_jax_params(tree: dict, cfg: BackboneConfig, *,
                    device="cpu") -> dict:
    """JAX classifier pytree (numpy leaves) -> the port's parameter tree.

    Refuses a tree whose keys or shapes do not match `cfg`; the number of
    classes is read from the head kernel.
    """
    _check_tree(tree, jax_layout_shapes(cfg, _num_classes(tree)))
    return _unstack_blocks(tree, cfg, device)


def _num_classes(tree: dict) -> int:
    try:
        return np.shape(tree["classifier"]["head"]["kernel"])[1]
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError("params lack classifier/head/kernel") from e


def _unstack(stacked: dict, depth: int) -> list[dict]:
    return [tree_map(lambda t, i=i: t[i].clone(), stacked)
            for i in range(depth)]


def _unstack_blocks(tree: dict, cfg: BackboneConfig, device) -> dict:
    port = tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)
    port["backbone"]["blocks"] = _unstack(port["backbone"]["blocks"],
                                          cfg.depth)
    return port


def to_jax_params(params: dict) -> dict:
    """The port's parameter tree -> the JAX layout with numpy leaves
    (blocks stacked on a leading depth axis)."""
    out = tree_map(lambda t: t.detach().cpu().numpy(), params)
    out["backbone"]["blocks"] = _stack(out["backbone"]["blocks"])
    return out


def detector_from_jax_params(tree: dict, cfg: DetectorConfig, *,
                             device="cpu") -> dict:
    """JAX detector pytree (numpy leaves) -> the port's parameter tree.
    Refuses a tree whose keys or shapes do not match `cfg`."""
    _check_tree(tree, jax_detector_layout_shapes(cfg))
    port = _unstack_blocks(tree, cfg.backbone, device)
    port["detr"]["blocks"] = _unstack(port["detr"]["blocks"], cfg.head.depth)
    return port


def detector_to_jax_params(params: dict) -> dict:
    """The port's detector parameters -> the JAX layout with numpy leaves
    (encoder and decoder blocks stacked on a leading depth axis)."""
    out = to_jax_params(params)
    out["detr"]["blocks"] = _stack(out["detr"]["blocks"])
    return out


def quantized_classifier_from_jax(tree: dict, cfg: BackboneConfig, *,
                                  device="cpu") -> dict:
    """JAX's ``quantize_image_classifier`` pytree (numpy leaves: int8 q,
    fp32 scale) -> the port's quantized tree
    (``models/quantized.py::quantize_image_classifier``'s layout). Refuses
    a tree whose keys or shapes do not match `cfg`."""
    spec = jax_layout_shapes(cfg, _num_classes(tree))
    spec["backbone"] = _quantized_backbone_shapes(cfg)
    _check_tree(tree, spec)
    return _unstack_blocks(tree, cfg, device)


def quantized_detector_from_jax(tree: dict, cfg: DetectorConfig, *,
                                device="cpu") -> dict:
    """JAX's ``quantize_detector`` pytree (numpy leaves) -> the port's
    quantized detector tree. Refuses a tree whose keys or shapes do not
    match `cfg`."""
    spec = jax_detector_layout_shapes(cfg)
    spec["backbone"] = _quantized_backbone_shapes(cfg.backbone)
    _check_tree(tree, spec)
    port = _unstack_blocks(tree, cfg.backbone, device)
    port["detr"]["blocks"] = _unstack(port["detr"]["blocks"], cfg.head.depth)
    return port


def _stack(layers: list[dict]) -> dict:
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return np.stack(layers)


# The optimizer state crosses as a plain dict of numpy leaves: the JAX side
# reads it out of the optax chain (``arsvt_tpu.train.optim._find_state`` for
# ``ScaleByAdamState`` and ``ScaleByScheduleState``, plus the
# inject_hyperparams state's ``count`` and ``hyperparams["lr_scale"]``);
# this module imports no optax.
OPT_STATE_KEYS = ("count", "lr_scale", "adam_count", "mu", "nu",
                  "schedule_count")


def _opt_scalars(state: dict) -> dict:
    if set(state) != set(OPT_STATE_KEYS):
        raise ValueError(f"optimizer state keys {sorted(state)} are not "
                         f"{sorted(OPT_STATE_KEYS)}")
    out = {k: int(np.asarray(state[k])) for k in
           ("count", "adam_count", "schedule_count")}
    out["lr_scale"] = float(np.float32(np.asarray(state["lr_scale"])))
    return out


def opt_state_from_jax(state: dict, cfg: BackboneConfig, *,
                       device="cpu") -> dict:
    """{count, lr_scale, adam_count, mu, nu, schedule_count} with numpy
    leaves (mu and nu in the JAX classifier layout) -> the port's optimizer
    state (``train/optim.py::init_opt_state``'s layout)."""
    out = _opt_scalars(state)
    for k in ("mu", "nu"):
        num_classes = np.shape(state[k]["classifier"]["head"]["kernel"])[1]
        _check_tree(state[k], jax_layout_shapes(cfg, num_classes), k)
        out[k] = _unstack_blocks(state[k], cfg, device)
    return out


def _opt_state_to_jax(state: dict, tree_to_jax) -> dict:
    out = {k: np.asarray(state[k], np.int32) for k in
           ("count", "adam_count", "schedule_count")}
    out["lr_scale"] = np.asarray(state["lr_scale"], np.float32)
    for k in ("mu", "nu"):
        out[k] = tree_to_jax(state[k])
    return out


def opt_state_to_jax(state: dict) -> dict:
    """The port's optimizer state -> the plain dict with numpy leaves (mu
    and nu with the blocks stacked on a leading depth axis)."""
    return _opt_state_to_jax(state, to_jax_params)


def detector_opt_state_from_jax(state: dict, cfg: DetectorConfig, *,
                                device="cpu") -> dict:
    """The detector's counterpart of `opt_state_from_jax`: mu and nu in
    the JAX detector layout (`jax_detector_layout_shapes`)."""
    out = _opt_scalars(state)
    for k in ("mu", "nu"):
        out[k] = detector_from_jax_params(state[k], cfg, device=device)
    return out


def detector_opt_state_to_jax(state: dict) -> dict:
    """The port's detector optimizer state -> the plain dict with numpy
    leaves (encoder and decoder blocks stacked)."""
    return _opt_state_to_jax(state, detector_to_jax_params)
