"""Pretrained-weight conversion: HuggingFace / timm ViT state dicts and the
reference repo's detector ``.pth`` -> the port's parameter tree
(counterpart of ``arsvt_tpu/models/convert.py``).

Point it at a local ``pytorch_model.bin`` / ``.safetensors`` state dict
(HF ``ViTModel`` / ``ViTForImageClassification`` naming) or a timm ViT
state dict and get back an `init_backbone`-shaped tree: the JAX tree's
keys with the blocks as a list of per-layer dicts.

Layout notes:
  * torch Linear weights are (out, in) -> transposed to (in, out);
  * HF keeps separate q/k/v projections -> concatenated, in that order,
    into the fused (D, 3D) kernel; timm already stores a fused qkv;
  * the patch conv (D, C, p, p) -> the flattened (p*p*C, D) matmul kernel
    in (kh, kw, c) order, matching ``ops/patch_embed.py::extract_patches``.

Run as ``python -m arsvt_tpu_torch.models.convert --torch-state FILE
--checkpoint-dir DIR`` to write a step-0 training checkpoint of the port
(``train/checkpoint.py``) that the train CLI resumes, the eval CLI and the
server serve, and distillation reads as its teacher.
"""

from __future__ import annotations

import numpy as np
import torch

from arsvt_tpu_torch.models.vit import BackboneConfig


def _t(w):  # torch (out, in) -> (in, out)
    return np.asarray(w).T


def _conv_to_matmul(w):
    # (D, C, p, p) -> (p, p, C, D) -> (p*p*C, D)
    w = np.asarray(w)
    d = w.shape[0]
    return w.transpose(2, 3, 1, 0).reshape(-1, d)


def _tensor(a) -> torch.Tensor:
    # a copy: the state dict's arrays may be read-only or views
    return torch.tensor(np.ascontiguousarray(a))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return _tensor(tree)


def detect_source(state: dict) -> str:
    keys = set(state)
    if any(".attention.attention.query.weight" in k for k in keys):
        return "hf"
    if any(k.endswith("attn.qkv.weight") for k in keys):
        return "timm"
    raise ValueError("unrecognised ViT state-dict naming")


def _strip_prefix(state: dict) -> dict:
    # HF checkpoints may carry a top-level "vit." (ViTForImageClassification)
    if any(k.startswith("vit.") for k in state):
        return {k[len("vit."):]: v for k, v in state.items()
                if k.startswith("vit.")}
    return state


def from_pretrained_state(state: dict, cfg: BackboneConfig) -> dict:
    """Convert a torch state dict (numpy-convertible values) to the port's
    backbone params.

    LayerNorm eps is a config, not a weight: converted weights should run
    with the source model's value (`cfg.ln_eps`: timm ViT 1e-6, HF ViT
    layer_norm_eps, typically 1e-12; the default is torch's 1e-5).
    """
    state = {k: np.asarray(v) for k, v in state.items()}
    source = detect_source(_strip_prefix(state))
    if source == "hf":
        return _from_hf(_strip_prefix(state), cfg)
    return _from_timm(state, cfg)


def _vit_block(ln1, qkv_w, qkv_b, proj, ln2, fc1, fc2) -> dict:
    """One encoder layer in the port's layout from torch-layout pieces:
    LayerNorms as (weight, bias), Linears as (weight (out, in), bias)."""
    def linear(w, b):
        return {"kernel": _t(w), "bias": b}

    return {
        "ln1": {"scale": ln1[0], "bias": ln1[1]},
        "attn": {"qkv": {"kernel": qkv_w, "bias": qkv_b},
                 "proj": linear(*proj)},
        "ln2": {"scale": ln2[0], "bias": ln2[1]},
        "mlp": {"fc1": linear(*fc1), "fc2": linear(*fc2)},
    }


def _from_hf(s: dict, cfg: BackboneConfig) -> dict:
    layers = []
    for i in range(cfg.depth):
        p = f"encoder.layer.{i}."

        def pair(name):
            return s[p + name + ".weight"], s[p + name + ".bias"]

        qkv = [f"attention.attention.{n}" for n in ("query", "key", "value")]
        layers.append(_vit_block(
            pair("layernorm_before"),
            np.concatenate([_t(s[p + n + ".weight"]) for n in qkv], axis=1),
            np.concatenate([s[p + n + ".bias"] for n in qkv]),
            pair("attention.output.dense"), pair("layernorm_after"),
            pair("intermediate.dense"), pair("output.dense")))
    params = _tensors({
        "patch_embed": {
            "kernel": _conv_to_matmul(
                s["embeddings.patch_embeddings.projection.weight"]),
            "bias": s["embeddings.patch_embeddings.projection.bias"],
        },
        "cls_token": s["embeddings.cls_token"],
        "pos_embed": s["embeddings.position_embeddings"],
        "ln_f": {"scale": s["layernorm.weight"],
                 "bias": s["layernorm.bias"]},
    })
    params["blocks"] = [_tensors(layer) for layer in layers]
    _check_shapes(params, cfg)
    return params


def _from_timm(s: dict, cfg: BackboneConfig) -> dict:
    layers = []
    for i in range(cfg.depth):
        p = f"blocks.{i}."

        def pair(name):
            return s[p + name + ".weight"], s[p + name + ".bias"]

        layers.append(_vit_block(
            pair("norm1"), _t(s[p + "attn.qkv.weight"]),
            s[p + "attn.qkv.bias"], pair("attn.proj"), pair("norm2"),
            pair("mlp.fc1"), pair("mlp.fc2")))
    params = _tensors({
        "patch_embed": {
            "kernel": _conv_to_matmul(s["patch_embed.proj.weight"]),
            "bias": s["patch_embed.proj.bias"],
        },
        "cls_token": s["cls_token"],
        "pos_embed": s["pos_embed"],
        "ln_f": {"scale": s["norm.weight"], "bias": s["norm.bias"]},
    })
    params["blocks"] = [_tensors(layer) for layer in layers]
    if "dist_token" in s:
        params["dist_token"] = _tensor(s["dist_token"])
    _check_shapes(params, cfg)
    return params


def _check_shapes(params: dict, cfg: BackboneConfig):
    d = cfg.embed_dim
    blocks = params["blocks"]
    k = (len(blocks), *blocks[0]["attn"]["qkv"]["kernel"].shape)
    if k != (cfg.depth, d, 3 * d):
        raise ValueError(
            f"converted qkv kernel {k} does not match config "
            f"({cfg.depth}, {d}, {3 * d}) — wrong preset for this checkpoint?"
        )
    pe = params["pos_embed"]
    if pe.shape[1] != cfg.seq_len:
        raise ValueError(
            f"pos_embed length {pe.shape[1]} != config seq_len "
            f"{cfg.seq_len} (image_size/patch_size mismatch)"
        )


def _unwrap(state: dict) -> dict:
    # The reference wraps weights as {'model_state_dict': ..., 'epoch':
    # int, 'optimizer_state_dict': ..., ...}; HF/timm use 'state_dict' or
    # a bare dict
    for key in ("model_state_dict", "state_dict"):
        if key in state and isinstance(state[key], dict):
            return state[key]
    return state


def load_torch_state(path: str) -> dict:
    """Load a .bin/.pt (``torch.load(weights_only=True)``) or .safetensors
    file to a dict of numpy arrays, unwrapping ``model_state_dict`` /
    ``state_dict`` and skipping non-tensor metadata (epoch, val_loss)."""
    if path.endswith(".safetensors"):
        # imported here: only this format needs the package
        from safetensors.numpy import load_file

        return dict(load_file(path))
    state = _unwrap(torch.load(path, map_location="cpu", weights_only=True))
    return {k: v.numpy() for k, v in state.items()
            if isinstance(v, torch.Tensor)}


# ------------------------------------------------- reference .pth detectors


def from_reference_detector_state(state: dict, det_cfg) -> dict:
    """Convert the ``model_state_dict`` of the reference repo's
    ``DeiTObjectDetector`` into the port's detector tree.

    The backbone converts exactly (pre-LN blocks, CLS + DIST tokens, fused
    qkv on both sides). The DETR decoder converts approximately, exactly as
    JAX's does: the reference runs torch's post-LN
    ``nn.TransformerDecoderLayer`` and has no cross-attention KV norm
    (``ln_cross_kv`` gets an identity init, ``ln_f`` ones and zeros), and
    its box head was trained on raw-sigmoid corners where ours is cxcywh:
    expect to fine-tune after conversion.
    """
    # unwrap the checkpoint envelope before np.asarray: asarray on a
    # nested dict gives a useless 0-d object array
    state = _unwrap(state)
    state = {k: np.asarray(v) for k, v in state.items()
             if hasattr(v, "shape") or hasattr(v, "__array__")}
    bb_cfg = det_cfg.backbone
    s = {k[len("backbone."):]: v for k, v in state.items()
         if k.startswith("backbone.")}

    layers = []
    for i in range(bb_cfg.depth):
        p = f"transformer_blocks.{i}."

        def pair(name):
            return s[p + name + ".weight"], s[p + name + ".bias"]

        layers.append(_vit_block(
            pair("layer_norm1"), _t(s[p + "attention.qkv.weight"]),
            s[p + "attention.qkv.bias"], pair("attention.projection"),
            pair("layer_norm2"), pair("mlp.linear1"), pair("mlp.linear2")))
    backbone = _tensors({
        "patch_embed": {
            "kernel": _conv_to_matmul(s["patch_embedding.projection.weight"]),
            "bias": s["patch_embedding.projection.bias"],
        },
        "cls_token": s["cls_token"],
        "dist_token": s["dist_token"],
        "pos_embed": s["position_embedding"],
        "ln_f": {"scale": s["layer_norm.weight"],
                 "bias": s["layer_norm.bias"]},
    })
    backbone["blocks"] = [_tensors(layer) for layer in layers]
    _check_shapes(backbone, bb_cfg)

    # decoder: approximate structural transfer (see the docstring)
    d = bb_cfg.embed_dim
    dec_layers = []
    for i in range(det_cfg.head.depth):
        p = f"detection_head.decoder.layers.{i}."

        def ln(name):
            return {"scale": state[p + name + ".weight"],
                    "bias": state[p + name + ".bias"]}

        def linear(name):
            return {"kernel": _t(state[p + name + ".weight"]),
                    "bias": state[p + name + ".bias"]}

        x_w = state[p + "multihead_attn.in_proj_weight"]   # (3D, D)
        x_b = state[p + "multihead_attn.in_proj_bias"]
        dec_layers.append(_tensors({
            "ln_self": ln("norm1"),
            "self_attn": {
                "qkv": {"kernel": _t(state[p + "self_attn.in_proj_weight"]),
                        "bias": state[p + "self_attn.in_proj_bias"]},
                "proj": linear("self_attn.out_proj"),
            },
            "ln_cross_q": ln("norm2"),
            # the reference has no KV norm: identity init
            "ln_cross_kv": {"scale": np.ones(d, np.float32),
                            "bias": np.zeros(d, np.float32)},
            "cross_attn": {
                "q": {"kernel": _t(x_w[:d]), "bias": x_b[:d]},
                "kv": {"kernel": _t(x_w[d:]), "bias": x_b[d:]},
                "proj": linear("multihead_attn.out_proj"),
            },
            "ln_mlp": ln("norm3"),
            "mlp": {"fc1": linear("linear1"), "fc2": linear("linear2")},
        }))
    detr = _tensors({
        "queries": state["detection_head.object_queries"],
        "ln_f": {"scale": np.ones(d, np.float32),
                 "bias": np.zeros(d, np.float32)},
        "class_head": {
            "kernel": _t(state["detection_head.class_head.weight"]),
            "bias": state["detection_head.class_head.bias"],
        },
        "bbox_head": {
            "kernel": _t(state["detection_head.bbox_head.weight"]),
            "bias": state["detection_head.bbox_head.bias"],
        },
    })
    detr["blocks"] = dec_layers
    out = {"backbone": backbone, "detr": detr}
    if "triplet_projection.weight" in state:
        out["triplet_proj"] = _tensors({
            "kernel": _t(state["triplet_projection.weight"]),
            "bias": state["triplet_projection.bias"],
        })
    return out


# ------------------------------------------------------------------- CLI


def _cast_like(init, new, path: str, train_preset: str):
    """`new` in `init`'s structure, each tensor in init's dtype and on its
    device. Every imported leaf must have the target preset's shape: a
    silent mismatch (a reference num_queries imported into another preset,
    a --num-classes override disagreeing with the source head) would write
    a corrupt step-0 checkpoint that fails only at its first restore."""
    if isinstance(init, dict):
        if not isinstance(new, dict) or set(init) != set(new):
            raise ValueError(
                f"imported tree at {path or '/'} has keys "
                f"{sorted(new) if isinstance(new, dict) else type(new)}, the "
                f"{train_preset!r} preset expects {sorted(init)}")
        # sorted, as JAX walks a dict: the first mismatch named is JAX's
        out = {k: _cast_like(init[k], new[k], f"{path}/{k}", train_preset)
               for k in sorted(init)}
        return {k: out[k] for k in init}
    if isinstance(init, list):
        if not isinstance(new, list) or len(new) != len(init):
            raise ValueError(
                f"imported tree at {path} has "
                f"{len(new) if isinstance(new, list) else type(new)} "
                f"entries, the {train_preset!r} preset expects {len(init)}")
        return [_cast_like(a, b, f"{path}/{i}", train_preset)
                for i, (a, b) in enumerate(zip(init, new))]
    if tuple(new.shape) != tuple(init.shape):
        raise ValueError(
            f"imported leaf {path.lstrip('/')!r} has shape "
            f"{tuple(new.shape)}, the {train_preset!r} preset expects "
            f"{tuple(init.shape)} — source checkpoint and target preset "
            f"disagree")
    return new.to(dtype=init.dtype, device=init.device)


def import_torch_checkpoint(torch_state_path: str, checkpoint_dir: str, *,
                            train_preset: str = "vit_base_finetune",
                            source: str = "auto",
                            overrides: dict | None = None,
                            device=None) -> dict:
    """torch weights file -> a step-0 training checkpoint of the port.

    Point it at an HF/timm ViT state dict (or a checkpoint saved by the
    reference's own training script) and get a checkpoint directory every
    other surface reads: `train.cli --resume` fine-tunes from it, the eval
    CLI and the server serve it, distillation takes it as its teacher.
    Weights land in the fp32 master slots; the optimizer state starts
    fresh. An imported classifier's head stays zero (fine-tune).

    `source="reference"` forces the reference DeiTObjectDetector layout
    (its backbone.* keys are timm-like); "auto" handles HF/timm classifier
    backbones. `device` None means the card (raising without one), as the
    `Trainer` that builds the state.
    """
    from arsvt_tpu_torch.train.config import (
        TRAIN_PRESETS,
        resolve_backbone,
        resolve_detector,
    )
    from arsvt_tpu_torch.train.trainer import Trainer

    cfg = TRAIN_PRESETS[train_preset].with_overrides(
        checkpoint_dir=checkpoint_dir, **(overrides or {})
    )
    state_dict = load_torch_state(torch_state_path)

    is_reference = any(k.startswith("detection_head.") for k in state_dict)
    # LayerNorm eps is a config, not a weight: imported backbones run with
    # their source's value (torch's 1e-5 is right only for reference
    # checkpoints); an explicit ln_eps override wins
    if not cfg.ln_eps and not is_reference:
        detected = (detect_source(_strip_prefix(state_dict))
                    if source == "auto" else source)
        if detected == "hf":
            cfg = cfg.with_overrides(ln_eps=1e-12)   # HF ViT layer_norm_eps
        elif detected == "timm":
            cfg = cfg.with_overrides(ln_eps=1e-6)    # timm ViT default

    trainer = Trainer(cfg, device=device)
    state = trainer.init_state()
    params = state["params"]

    if source not in ("auto", "hf", "timm", "reference"):
        raise ValueError(f"unknown source {source!r}")
    if is_reference and source in ("hf", "timm"):
        raise ValueError(
            f"{torch_state_path} contains detection_head.* keys — it is a "
            f"checkpoint from the reference repo, not a {source} ViT; use "
            f"--source reference (or auto)"
        )
    if source == "reference" or (source == "auto" and is_reference):
        if cfg.task != "detect":
            raise ValueError(
                f"{torch_state_path} is a reference detector checkpoint; "
                f"use a detect train preset (got task={cfg.task!r})"
            )
        converted = from_reference_detector_state(
            state_dict, resolve_detector(cfg))
        imported = sorted(converted)
    else:
        bb_cfg = resolve_backbone(cfg)
        try:
            if source == "hf":
                converted = {"backbone": _from_hf(_strip_prefix(state_dict),
                                                  bb_cfg)}
            elif source == "timm":
                converted = {"backbone": _from_timm(state_dict, bb_cfg)}
            else:
                converted = {"backbone": from_pretrained_state(
                    state_dict, bb_cfg)}
        except KeyError as e:
            raise ValueError(
                f"{torch_state_path} does not match the "
                f"{'forced ' if source != 'auto' else ''}{source} ViT "
                f"layout (missing key {e}); try --source auto"
            ) from e
        imported = ["backbone"]  # the head stays fresh: fine-tune

    for key, tree in converted.items():
        if key not in params:
            raise KeyError(
                f"converted component {key!r} not in {sorted(params)} — "
                f"preset/task mismatch"
            )
        params[key] = _cast_like(params[key], tree, "", train_preset)

    trainer.ckpt.save(0, state)
    return {
        "checkpoint_dir": checkpoint_dir,
        "train_preset": train_preset,
        "task": cfg.task,
        "imported": imported,
        "source_keys": len(state_dict),
    }


def main(argv=None):
    import argparse
    import json

    from arsvt_tpu_torch.core.devices import platform_device
    from arsvt_tpu_torch.train.config import TRAIN_PRESETS

    p = argparse.ArgumentParser(
        description="Import torch ViT weights (HF / timm / the reference "
                    "repo's .pth) as an arsvt_tpu_torch training "
                    "checkpoint. Runs on the card; ARSVT_PLATFORM=cpu "
                    "selects the CPU."
    )
    p.add_argument("--torch-state", required=True,
                   help=".pth/.bin (torch.save) or .safetensors file")
    p.add_argument("--checkpoint-dir", required=True,
                   help="output checkpoint directory")
    p.add_argument("--train-preset", default="vit_base_finetune",
                   choices=sorted(TRAIN_PRESETS))
    p.add_argument("--source", default="auto",
                   choices=("auto", "hf", "timm", "reference"))
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--ln-eps", type=float, default=None,
                   help="LayerNorm eps for the imported weights (default: "
                        "auto — timm 1e-6 / HF 1e-12 / reference 1e-5)")
    args = p.parse_args(argv)
    overrides = {}
    if args.num_classes is not None:
        overrides["num_classes"] = args.num_classes
    if args.ln_eps is not None:
        overrides["ln_eps"] = args.ln_eps
    manifest = import_torch_checkpoint(
        args.torch_state, args.checkpoint_dir,
        train_preset=args.train_preset, source=args.source,
        overrides=overrides or None, device=platform_device(),
    )
    print(json.dumps(manifest))
    return manifest


if __name__ == "__main__":
    main()
