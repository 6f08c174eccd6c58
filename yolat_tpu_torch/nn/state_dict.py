"""Reference state dicts: JAX variables -> reference names, `.pth` loading.

Counterpart of `yolat_tpu/train/import_reference.py` (`strip_module_prefix`
:36-41, `_export_mlp`/`_export_linear`/`export_state_dict` :138-201,
`load_reference_state_dict` :234-251). The port's modules carry the
reference SparseCADGCN's names, so these state dicts load with
`load_state_dict(strict=True)`. The reference ships no YOLaT++ model, so
`export_state_dict_pp` maps the JAX module's flat tree
(`yolat_tpu/nn/yolat_pp.py`; `AttrEdgeGP2_{i}` at the top, not under
`cls_net`) onto the names of `nn.yolat_pp.YOLaTPlusPlus`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from yolat_tpu_torch.config import PP_GATES


def strip_module_prefix(sd: Mapping) -> dict:
    """Drop DataParallel's 'module.' prefixes (ckpt_util.py:52-64)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _export_mlp(params: Mapping, stats: Mapping, prefix: str) -> dict:
    """A flax MLP subtree (dense_k / bn_k) -> the reference's flat
    Sequential keys: Lin at one index, then BN and the activation, which
    holds no tensors but takes an index (torch_nn.py:50-71)."""
    out: dict = {}
    n_stage = sum(1 for k in params if k.startswith("dense_"))
    idx = 0
    for k in range(n_stage):
        d = params[f"dense_{k}"]
        out.update(_export_linear(d, f"{prefix}.{idx}"))
        idx += 1
        if f"bn_{k}" in params:
            b, st = params[f"bn_{k}"], stats[f"bn_{k}"]
            out[f"{prefix}.{idx}.weight"] = np.asarray(b["scale"])
            out[f"{prefix}.{idx}.bias"] = np.asarray(b["bias"])
            out[f"{prefix}.{idx}.running_mean"] = np.asarray(st["mean"])
            out[f"{prefix}.{idx}.running_var"] = np.asarray(st["var"])
            out[f"{prefix}.{idx}.num_batches_tracked"] = np.zeros((), np.int64)
            idx += 2
    return out


def _export_linear(p: Mapping, prefix: str) -> dict:
    out = {f"{prefix}.weight": np.asarray(p["kernel"]).T.copy()}
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
    return out


def export_state_dict(variables: Mapping, n_blocks: int = 2) -> dict:
    """JAX flax variables ({'params', 'batch_stats'}, numpy leaves) -> the
    reference's state dict (numpy leaves)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict = {}
    cls_p, cls_s = params["cls_net"], stats.get("cls_net", {})
    for i in range(n_blocks):
        name = f"AttrEdgeGP2_{i}"
        ref = ("cls_net.head.gconv" if i == 0
               else f"cls_net.backbone.{i - 1}.body.gconv")
        p, s = cls_p[name], cls_s.get(name, {})
        out.update(_export_mlp(p["nn"], s.get("nn", {}), f"{ref}.nn"))
        out.update(_export_linear(p["lin_r"], f"{ref}.lin_r"))
        out.update(_export_mlp(p["mlp_node"], s.get("mlp_node", {}),
                               f"{ref}.mlp_node"))
    for name in ("fusion_block", "fusion_block_super"):
        out.update(_export_mlp(cls_p[name], cls_s.get(name, {}),
                               f"cls_net.{name}"))
    k = 0
    while f"pred_{k}" in params:
        out.update(_export_mlp(params[f"pred_{k}"], stats.get(f"pred_{k}", {}),
                               f"prediction_cls.{k}"))
        k += 1
    return out


PP_MLPS = ("fusion_block", "fusion_block_super", "point_pe_mlp", "curve_mlp",
           "super_edge_mlp", "super_fact_mlp", "super_node_mlp")


def export_state_dict_pp(variables: Mapping, n_blocks: int = 2) -> dict:
    """JAX flax variables of a YOLaTPlusPlus ({'params', 'batch_stats'},
    numpy leaves) -> the state dict of `nn.yolat_pp.YOLaTPlusPlus` (numpy
    leaves). A checkpoint holds `super_edge_mlp` or `super_fact_mlp`;
    whichever is there comes through. The running statistics of every
    MLP and the four gates come with the weights (a train step starts from
    them), and a `fusion_block` trained through the fused pool head has
    the MLP's own tree (dense_0 + bn_0)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict = {}
    for i in range(n_blocks):
        name, ref = f"AttrEdgeGP2_{i}", f"convs.{i}"
        p, s = params[name], stats.get(name, {})
        out.update(_export_mlp(p["nn"], s.get("nn", {}), f"{ref}.nn"))
        out.update(_export_linear(p["lin_r"], f"{ref}.lin_r"))
        out.update(_export_mlp(p["mlp_node"], s.get("mlp_node", {}),
                               f"{ref}.mlp_node"))
    for name in PP_MLPS:
        if name in params:
            out.update(_export_mlp(params[name], stats.get(name, {}), name))
    k = 0
    while f"pred_{k}" in params:
        out.update(_export_mlp(params[f"pred_{k}"], stats.get(f"pred_{k}", {}),
                               f"prediction_cls.{k}"))
        k += 1
    for g in PP_GATES:
        out[g] = np.asarray(params[g], np.float32).reshape(())
    return out


def load_reference_state_dict(path: str) -> dict:
    """A reference `.pth` ({'state_dict': ...}, {'model_state_dict': ...}
    or a bare state dict) -> its numpy state dict, prefixes stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in ("state_dict", "model_state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
          else np.asarray(v) for k, v in obj.items()
          if hasattr(v, "shape") or np.isscalar(v)}
    return strip_module_prefix(sd)
