"""Weights carried across from the JAX package: a flax variable tree (of
numpy arrays) -> the reference state_dict, which the port's modules load
with ``load_state_dict(strict=True)``.

The inverse of ``craft_tpu.utils.torch_convert`` (reference checkpoint ->
flax), with its own copy of the flax-path -> reference-key mapping:
  flax conv kernel [kh, kw, I, O]   -> torch Conv2d [O, I, kh, kw]
  flax dense kernel [I, O]          -> torch Linear [O, I]
  [M, F(in), F(out)] einsum kernel  -> grouped Conv1d [M*F, F, 1]
  BatchNorm batch_stats mean/var    -> running_mean/running_var (+ a zero
                                       num_batches_tracked)
and the tied Q/K projection duplicated under ``setrans.key.*`` (the
reference registers the shared module twice, setrans.py:470-478).  A
private f1 transformer (--f1 private) maps as any module; under --f1
shared the tree has ``f2_trans`` alone, and ``FlowModel`` fills its
``f1_trans.*`` entries from those at load, as the reference lists the one
module under both names.

Since the port's modules use the reference key names, a reference ``.pth``
checkpoint loads straight into them (``load_reference_checkpoint``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_GRU_MAP = {"convz_h": "convz1", "convr_h": "convr1", "convq_h": "convq1",
            "convz_v": "convz2", "convr_v": "convr2", "convq_v": "convq2"}


def flax_path_to_torch(col: str, path: Tuple[str, ...]) -> Tuple[str, str]:
    """A flax variable path -> (reference state_dict key, transform tag)."""
    toks = [t for t in path if t not in ("Conv_0", "Dense_0")]
    leaf, toks = toks[-1], toks[:-1]
    out = []
    for t in toks:
        m = re.fullmatch(r"layer(\d)_(\d)", t)
        if m:
            out.append(f"layer{m.group(1)}.{m.group(2)}")
        elif t.startswith("BatchNorm_") or t.startswith("GroupNorm_"):
            idx = int(t.split("_")[1])
            if not any(x.startswith("layer") for x in out) or idx == 0:
                out.append("norm1")
            elif idx == 1:
                out.append("norm2")
            else:
                out.append("downsample.1")
        elif t in _GRU_MAP and out and out[-1] == "gru":
            out.append(_GRU_MAP[t])
        elif t in ("conv1", "conv2") and out and out[-1] == "mask":
            out[-1] = "mask.0" if t == "conv1" else "mask.2"
        elif t == "downsample":
            out.append("downsample.0")
        else:
            out.append(t)

    if col == "batch_stats":
        torch_leaf, tag = {"mean": "running_mean",
                           "var": "running_var"}[leaf], "copy"
    elif leaf == "kernel":
        torch_leaf, tag = "weight", "kernel"
    elif leaf == "scale":
        torch_leaf, tag = "weight", "copy"
    elif leaf in ("rel_height", "rel_width"):
        torch_leaf, tag = leaf + ".weight", "copy"
    elif leaf == "output_kernel":
        torch_leaf, tag = "group_linear.weight", "group_conv1d"
    elif leaf == "output_bias":
        torch_leaf, tag = "group_linear.bias", "group_bias"
    else:
        torch_leaf, tag = leaf, "copy"
    return ".".join(out + [torch_leaf]), tag


def _to_torch_layout(value: np.ndarray, tag: str) -> np.ndarray:
    if tag == "kernel":
        if value.ndim == 4:    # HWIO -> OIHW
            return value.transpose(3, 2, 0, 1)
        if value.ndim == 2:    # [I, O] -> [O, I]
            return value.T
        if value.ndim == 3:    # [k, I, O] -> [O, I, k]
            return value.transpose(2, 1, 0)
    elif tag == "group_conv1d":  # [M, F(in), F(out)] -> [M*F(out), F(in), 1]
        M, F, _ = value.shape
        return value.transpose(0, 2, 1).reshape(M * F, F)[:, :, None]
    elif tag == "group_bias":    # [M, F] -> [M*F]
        return value.reshape(-1)
    return value


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} flax tree of arrays -> the
    reference state_dict (fp32 tensors).  Other collections are ignored."""
    sd = {}
    for col in ("params", "batch_stats"):
        for path, value in _flatten(tree.get(col, {})):
            key, tag = flax_path_to_torch(col, path)
            arr = _to_torch_layout(np.asarray(value, dtype=np.float32), tag)
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    # A query projection without its own key projection is the tied one.
    tied = {key[:-len("query.weight")] for key in sd
            if re.fullmatch(r"(.*\.)?query\.weight", key)
            and key[:-len("query.weight")] + "key.weight" not in sd}
    for key in list(sd):
        m = re.fullmatch(r"((?:.*\.)?)query\.(weight|bias)", key)
        if m and m.group(1) in tied:
            sd[f"{m.group(1)}key.{m.group(2)}"] = sd[key]
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long)
    return sd


def strip_prefixes(state: Mapping) -> Dict:
    """Unwrap {'model': ...} and strip DataParallel 'module.' prefixes (as
    ``craft_tpu.utils.torch_convert.strip_prefixes``)."""
    if "model" in state and isinstance(state["model"], Mapping):
        state = state["model"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def load_reference_checkpoint(path, model: torch.nn.Module,
                              strict: bool = False):
    """Load a reference checkpoint (a bare state_dict, or {'model': ...},
    keys with or without 'module.') into `model`, as the reference's
    ``load_state_dict(strict=False)`` (evaluate.py:72-98).  Non-tensor
    entries are dropped.  Returns the (missing, unexpected) key lists and
    prints a warning when either is non-empty."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    state = {k: v for k, v in strip_prefixes(raw).items()
             if isinstance(v, torch.Tensor)}
    result = model.load_state_dict(state, strict=strict)
    missing, unexpected = list(result.missing_keys), \
        list(result.unexpected_keys)
    if missing or unexpected:
        print(f"WARNING: {path}: {len(missing)} parameters missing from the "
              f"checkpoint (left as initialised), {len(unexpected)} "
              f"checkpoint entries unused (strict=False, the reference's "
              f"load_state_dict(strict=False))")
    return missing, unexpected


def unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """{'a/b/c': array} -> nested {'a': {'b': {'c': array}}}."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_oracle_npz(path):
    """The oracle snapshot (flattened 'a/b/c' layout plus __img1, __img2,
    __want): returns (img1, img2, want, flax tree), NHWC numpy."""
    data = dict(np.load(path))
    img1, img2, want = data.pop("__img1"), data.pop("__img2"), \
        data.pop("__want")
    return img1, img2, want, unflatten(data)
