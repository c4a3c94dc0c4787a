"""Load a vitcap_tpu JAX param tree into the port's ViTCAP module, and
turn the port's tensors (parameters, gradients, Adam moments) back into
the JAX package's flattened tree.

The param tree (nested dicts and lists of numpy arrays) is flattened to
'/'-joined paths, each path is named as in the reference's torch state dict
('module.bert.encoder.blocks.0.attn.qkv.weight') and its array is put in
the torch layout (dense (out, in), conv OIHW).  The port's modules carry
exactly those names without the leading 'module.', and its kernels read the
(out, in) layout directly, so the layout is converted once here and never
per call.  This is numpy only: the port keeps its own copy of the naming
rules of vitcap_tpu/solver/checkpoint_bridge.py and imports nothing of the
JAX package.

The reverse direction (torch_name_to_jax_path, state_to_jax_tensors,
unflatten_params) inverts the same rules: the msgpack snapshots
(solver/checkpointing.py) write the port's weights and Adam moments in
the JAX package's tree with it, and tests hold the port's gradients and
optimizer state against the JAX package's leaf by leaf.

A reference-named torch state dict (a `.pt` checkpoint of the reference,
or params_to_torch_state_dict's output) loads into the port's ViTCAP
through load_torch_state_dict and load_params_from_torch, with the
reference loader's tolerance: names resolve by dot-suffix, so 'module.'
prefixes do not matter, and tensors of another shape are skipped and
reported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

_LEAF_MAP = {
    "scale": "weight",      # LayerNorm scale
    "kernel": "weight",     # Dense / Conv kernel (transposed)
}


def flatten_params(params: Params, prefix: str = "") -> Dict[str, Any]:
    """{'a': {'b': [x, y]}} -> {'a/b/0': x, 'a/b/1': y}."""
    out: Dict[str, Any] = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = params
    return out


def _dense_leaf(torch_parts: List[str], leaf: str) -> Tuple[str, str]:
    torch_parts = torch_parts + [_LEAF_MAP.get(leaf, leaf)]
    return ".".join(torch_parts), "linear_t" if leaf == "kernel" else "none"


def jax_path_to_torch_name(path: str) -> Tuple[str, str]:
    """A flattened param path -> (torch name, transform), transform in
    {'linear_t', 'conv_hwio_to_oihw', 'none'}."""
    parts = path.split("/")
    leaf = parts[-1]

    if parts[0] == "image_encoder":
        # flat image encoder <- the reference's 'image_encoder.module.' ViT
        torch_parts = ["image_encoder", "module"]
        if parts[1] == "patch_proj":
            name = ".".join(torch_parts + ["patch_embed", "proj",
                                           _LEAF_MAP.get(leaf, leaf)])
            return name, ("conv_hwio_to_oihw" if leaf == "kernel"
                          else "none")
        return ".".join(torch_parts + [parts[1]]), "none"  # cls/pos_embed

    if parts[0] == "encoder":
        # bert.encoder.{blocks,tag_blocks}.N....
        return _dense_leaf(["bert", "encoder", parts[1], parts[2]]
                           + parts[3:-1], leaf)

    if parts[0] in ("embeddings", "extra_embeddings"):
        if parts[1] in ("word_embeddings", "position_embeddings",
                        "token_type_embeddings"):
            # embedding matrices keep the (num, dim) layout
            return ".".join(["bert", parts[0], parts[1], "weight"]), "none"
        return _dense_leaf(["bert", parts[0]] + parts[1:-1], leaf)

    if parts[0] in ("pooler", "caption_pooler", "decoder"):
        return _dense_leaf(["bert", parts[0]] + parts[1:-1], leaf)

    if parts[0] in ("tag_logit", "cls"):
        head = ["bert", "tag_logit"] if parts[0] == "tag_logit" else ["cls"]
        if parts[1] == "decoder":
            if leaf == "bias":
                return ".".join(head + ["predictions", "bias"]), "none"
            return (".".join(head + ["predictions", "decoder", "weight"]),
                    "linear_t")
        return _dense_leaf(head + ["predictions"] + parts[1:-1], leaf)

    raise KeyError(f"no torch mapping for param path {path!r}")


def _apply_transform(arr, transform: str):
    """JAX layout -> torch layout: dense (in, out) -> (out, in); conv HWIO
    -> OIHW.  A numpy array comes back contiguous, a tensor as a view."""
    if isinstance(arr, torch.Tensor):
        if transform == "linear_t":
            return arr.t()
        if transform == "conv_hwio_to_oihw":
            return arr.permute(3, 2, 0, 1)
        return arr
    if transform == "linear_t":
        return np.ascontiguousarray(arr.T)
    if transform == "conv_hwio_to_oihw":
        return np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
    return arr


def params_to_torch_state_dict(params: Params) -> Dict[str, Any]:
    """The param tree as a reference-named torch state dict ('module.'
    prefix on everything but the image encoder).  Tensor leaves (a msgpack
    snapshot's) stay tensors, in the torch layout as views."""
    out: Dict[str, Any] = {}
    for path, arr in flatten_params(params).items():
        torch_name, transform = jax_path_to_torch_name(path)
        prefix = "" if torch_name.startswith("image_encoder") else "module."
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        out[prefix + torch_name] = _apply_transform(arr, transform)
    return out


def port_state_dict(params: Params) -> Dict[str, Any]:
    """params_to_torch_state_dict under the port's names (no 'module.')."""
    return {(n[len("module."):] if n.startswith("module.") else n): a
            for n, a in params_to_torch_state_dict(params).items()}


def load_jax_params(model: torch.nn.Module, params_np: Dict[str, Any]
                    ) -> torch.nn.Module:
    """Strictly load `params_np` (the JAX param tree with numpy leaves) into
    `model`, in place; returns the model with gradients off (training turns
    them on: solver.train_step.init_train_state)."""
    sd = {name: torch.from_numpy(np.array(arr, dtype=np.float32))
          for name, arr in port_state_dict(params_np).items()}
    model.load_state_dict(sd, strict=True)
    return model.requires_grad_(False)


_JAX_LEAF = {"weight": "kernel"}     # a 2-D weight; 1-D weights are 'scale'


def torch_name_to_jax_path(name: str, ndim: int) -> Tuple[str, str]:
    """A port parameter name (no 'module.' prefix) and its rank -> (the
    flattened JAX path, the torch -> JAX transform: 'linear_t',
    'conv_oihw_to_hwio' or 'none').  Inverts jax_path_to_torch_name."""
    parts = name.split(".")
    leaf = parts[-1]

    def dense(jparts):
        if leaf == "weight":
            return ("/".join(jparts + ["kernel" if ndim == 2 else "scale"]),
                    "linear_t" if ndim == 2 else "none")
        return "/".join(jparts + [leaf]), "none"

    if parts[0] == "image_encoder":
        if parts[2] == "patch_embed":
            if leaf == "weight":
                return "image_encoder/patch_proj/kernel", "conv_oihw_to_hwio"
            return "image_encoder/patch_proj/" + leaf, "none"
        return "image_encoder/" + parts[2], "none"
    if parts[0] == "cls" or parts[1] == "tag_logit":
        head = "cls" if parts[0] == "cls" else "tag_logit"
        rest = parts[2:] if parts[0] == "cls" else parts[3:]
        if rest == ["bias"]:
            return head + "/decoder/bias", "none"
        if rest[0] == "decoder":
            return head + "/decoder/kernel", "linear_t"
        return dense([head] + rest[:-1])
    body = parts[1:]                                   # drop 'bert'
    if body[0] in ("embeddings", "extra_embeddings") and body[1] in (
            "word_embeddings", "position_embeddings",
            "token_type_embeddings"):
        return "/".join(body[:2]), "none"
    return dense(body[:-1])


def state_to_jax_tensors(tensors: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """{port parameter name: tensor} (parameters, or gradients or Adam
    moments keyed by parameter name) -> the JAX package's flattened tree
    {path: f32 tensor in the JAX layout, a view where it is transposed},
    on the tensors' devices."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in tensors.items():
        path, transform = torch_name_to_jax_path(name, t.dim())
        a = t.detach().float()
        if transform == "linear_t":
            a = a.t()
        elif transform == "conv_oihw_to_hwio":
            a = a.permute(2, 3, 1, 0)
        out[path] = a
    return out


def state_to_jax_flat(tensors: Dict[str, torch.Tensor]
                      ) -> Dict[str, np.ndarray]:
    """state_to_jax_tensors as contiguous numpy arrays on the host."""
    return {p: t.cpu().contiguous().numpy()
            for p, t in state_to_jax_tensors(tensors).items()}


def unflatten_params(flat: Dict[str, Any]) -> Params:
    """{'a/b/0': x, 'a/b/1': y} -> {'a': {'b': [x, y]}}: the inverse of
    flatten_params, a level whose keys are 0..n-1 a list (the JAX
    package's block lists)."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and sorted(out) == sorted(str(i) for i in range(len(out))):
            return [out[str(i)] for i in range(len(out))]
        return out
    return lists(tree)


# ---------------------------------------------------------------------------
# reference-named torch state dicts (.pt) -> the port's ViTCAP
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pt` checkpoint -> {name: CPU tensor}: the
    {'model': state_dict, ...} container is unwrapped, a bare state dict
    is taken as it is; entries that are no tensors are dropped.  Read with
    weights_only=True: tensors and plain containers only, no pickled code."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if (isinstance(ckpt, dict) and "model" in ckpt
                           and isinstance(ckpt["model"], dict)) else ckpt
    return {k: v.detach() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def _suffix_match(target: str, keys: List[str]) -> str | None:
    """The first state-dict key that equals `target` or ends in '.' +
    target (DDP and wrapper prefixes vary)."""
    return next((k for k in keys if k == target or k.endswith("." + target)),
                None)


def load_params_from_torch(model: torch.nn.Module, sd: Dict[str, Any],
                           strict: bool = False
                           ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """Fill `model`'s parameters, in place, from a reference-named state
    dict (tensors or numpy arrays in the torch layout): each parameter
    takes the key that ends in its name (_suffix_match); a key whose shape
    differs is skipped.  Returns (model, report): 'matched' [(name, key)],
    'missing' [(name, name)], 'shape_mismatch' [(name, key, key shape,
    parameter shape)] and 'unused' (the keys no parameter took).
    strict=True raises ValueError on anything missing or mismatched."""
    keys = list(sd.keys())
    report: Dict[str, Any] = {"matched": [], "missing": [],
                              "shape_mismatch": [], "unused": set(keys)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            src_key = _suffix_match(name, keys)
            if src_key is None:
                report["missing"].append((name, name))
                continue
            src = torch.as_tensor(sd[src_key])
            report["unused"].discard(src_key)
            if tuple(src.shape) != tuple(p.shape):
                report["shape_mismatch"].append(
                    (name, src_key, tuple(src.shape), tuple(p.shape)))
                continue
            p.copy_(src)
            report["matched"].append((name, src_key))
    if strict and (report["missing"] or report["shape_mismatch"]):
        raise ValueError(f"strict load failed: missing {report['missing']}, "
                         f"shape mismatch {report['shape_mismatch']}")
    return model, report


def convert_vit_cls_state_dict_to_caption(sd: Dict[str, Any]
                                          ) -> Dict[str, Any]:
    """Re-key a classification-pretrained ViT state dict into the caption
    checkpoint's names: transformer blocks under 'module.bert.encoder.',
    the rest (patch embed, cls token, pos embed) under
    'image_encoder.module.'; leading 'module.' prefixes are dropped first."""
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        while k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("blocks."):
            out["module.bert.encoder." + k] = v
        else:
            out["image_encoder.module." + k] = v
    return out
