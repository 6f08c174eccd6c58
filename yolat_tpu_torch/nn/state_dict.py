"""Reference state dicts: JAX variables -> reference names, `.pth` loading.

Counterpart of `yolat_tpu/train/import_reference.py` (`strip_module_prefix`
:36-41, `_export_mlp`/`_export_linear`/`export_state_dict` :138-201,
`load_reference_state_dict` :234-251). The port's modules carry the
reference SparseCADGCN's names, so these state dicts load with
`load_state_dict(strict=True)`. The reference ships no YOLaT++ model, so
`export_state_dict_pp` maps the JAX module's flat tree
(`yolat_tpu/nn/yolat_pp.py`; `AttrEdgeGP2_{i}` at the top, not under
`cls_net`) onto the names of `nn.yolat_pp.YOLaTPlusPlus`.

The twelve other convs (`nn.conv.CONV_NAMES`): their flax trees
(`AttrEdgeConv_{i}`, `AttrEdgeGP_{i}`, `AttrEdgeConvCF_{i}/mlp_0..7`,
`EdgeConv_{i}`, `MRConv_{i}`, `GCNConv_{i}/{lin,bn}`, `GINConv_{i}/{eps,nn}`,
`SAGEConv_{i}/{weight,nn,bias}`, `GATConv_{i}/{lin,a_src,a_dst,bias,bn}`,
`GENConv_{i}/{aggr/t,mlp}`) go under the reference's prefixes
`cls_net.head.gconv.*` and `cls_net.backbone.{i}.body.gconv.*` with the
flax names; MLPs take the reference Sequential's indices (Linear, then the
norm and the activation where there is one), so an MLP without a norm puts
its Linear layers at 2k, and one without either at k. The reference's
own key names for these convs (PyG's `att_src`, `lin_l`, ...) were not
available to check these against: a reference `.pth` of one of them may
need its keys renamed before it loads.

`load_flax_module` loads the flax tree of a dynamic-graph block
(`nn/dynamic.py`: the conv under flax's auto-name `<FLAX_CONV>_<i>`
becomes `gconv`, or `gconvs.<i>` in ResBlockMultiEdge), of a module of
the dense library (`nn/dense_graph.py`: `body`, `gconv`, `nn` as in flax,
BasicConv's `dense_<i>` / `bn_<i>` at the Sequential's indices) or of
`SumEmbedding` (`emb_<i>/embedding`) into the port's module.
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


def _export_mlp(params: Mapping, stats: Mapping, prefix: str,
                act: bool = True) -> dict:
    """A flax MLP subtree (dense_k, bn_k / ln_k) -> the reference's flat
    Sequential keys: Lin at one index, then the norm and the activation
    (`act`), each taking an index where it is there; the activation holds
    no tensors (torch_nn.py:50-71)."""
    out: dict = {}
    n_stage = sum(1 for k in params if k.startswith("dense_"))
    idx = 0
    for k in range(n_stage):
        d = params[f"dense_{k}"]
        out.update(_export_linear(d, f"{prefix}.{idx}"))
        idx += 1
        if f"bn_{k}" in params:
            out.update(_export_bn(params[f"bn_{k}"], stats[f"bn_{k}"],
                                  f"{prefix}.{idx}"))
            idx += 1
        elif f"ln_{k}" in params:
            ln = params[f"ln_{k}"]
            out[f"{prefix}.{idx}.weight"] = np.asarray(ln["scale"])
            out[f"{prefix}.{idx}.bias"] = np.asarray(ln["bias"])
            idx += 1
        if act:
            idx += 1
    return out


def _export_linear(p: Mapping, prefix: str) -> dict:
    out = {f"{prefix}.weight": np.asarray(p["kernel"]).T.copy()}
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
    return out


def _export_bn(p: Mapping, st: Mapping, prefix: str) -> dict:
    return {f"{prefix}.weight": np.asarray(p["scale"]),
            f"{prefix}.bias": np.asarray(p["bias"]),
            f"{prefix}.running_mean": np.asarray(st["mean"]),
            f"{prefix}.running_var": np.asarray(st["var"]),
            f"{prefix}.num_batches_tracked": np.zeros((), np.int64)}


# the flax module name of each conv of the registry
FLAX_CONV = {"attr_edge_gp2": "AttrEdgeGP2", "attr_edge": "AttrEdgeConv",
             "multilayer_edge": "AttrEdgeConv", "attr_edge_gp": "AttrEdgeGP",
             "attr_edge_cf": "AttrEdgeConvCF", "edge": "EdgeConv",
             "mr": "MRConv", "gcn": "GCNConv", "gin": "GINConv",
             "sage": "SAGEConv", "rsage": "SAGEConv", "gat": "GATConv",
             "gen": "GENConv"}


def _export_conv(conv: str, p: Mapping, s: Mapping, ref: str,
                 act: bool) -> dict:
    """One conv's flax subtree -> its keys under `ref`. The MLPs of gp2 and
    gen are ReLU whatever act says."""
    out: dict = {}
    mlp_act = True if conv in ("attr_edge_gp2", "gen") else act
    # gp2 in the order the JAX export writes its keys
    order = (("nn", "lin_r", "mlp_node") if conv == "attr_edge_gp2"
             else sorted(p))
    for name in order:
        v = p[name]
        key = f"{ref}.{name}"
        if isinstance(v, Mapping) and "dense_0" in v:
            out.update(_export_mlp(v, s.get(name, {}), key, mlp_act))
        elif isinstance(v, Mapping) and "kernel" in v:
            if conv in ("sage", "rsage") and name == "weight":
                # SAGE's weight is a [C_in, C_out] parameter, as the kernel
                out[key] = np.asarray(v["kernel"])
            else:
                out.update(_export_linear(v, key))
        elif isinstance(v, Mapping) and name == "bn":
            out.update(_export_bn(v, s[name], key))
        elif isinstance(v, Mapping):  # GENConv's aggr / msg_norm
            out.update({f"{key}.{k}": np.asarray(a, np.float32)
                        for k, a in v.items()})
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def export_state_dict(variables: Mapping, n_blocks: int = 2,
                      conv: str = "attr_edge_gp2", act="relu") -> dict:
    """JAX flax variables ({'params', 'batch_stats'}, numpy leaves) of a
    SparseCADGCN with `conv` and `act` -> the reference's state dict
    (numpy leaves)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    has_act = act is not None and str(act).lower() != "none"
    out: dict = {}
    cls_p, cls_s = params["cls_net"], stats.get("cls_net", {})
    for i in range(n_blocks):
        name = f"{FLAX_CONV[conv]}_{i}"
        ref = ("cls_net.head.gconv" if i == 0
               else f"cls_net.backbone.{i - 1}.body.gconv")
        out.update(_export_conv(conv, cls_p[name], cls_s.get(name, {}), ref,
                                has_act))
    for name in ("fusion_block", "fusion_block_super"):
        out.update(_export_mlp(cls_p[name], cls_s.get(name, {}),
                               f"cls_net.{name}", has_act))
    k = 0
    while f"pred_{k}" in params:
        last = f"pred_{k + 1}" not in params
        out.update(_export_mlp(params[f"pred_{k}"], stats.get(f"pred_{k}", {}),
                               f"prediction_cls.{k}", has_act and not last))
        k += 1
    return out


PP_MLPS = ("fusion_block", "fusion_block_super", "point_pe_mlp", "curve_mlp",
           "super_edge_mlp", "super_fact_mlp", "super_node_mlp")


def export_state_dict_pp(variables: Mapping, n_blocks: int = 2,
                         act="relu") -> dict:
    """JAX flax variables of a YOLaTPlusPlus ({'params', 'batch_stats'},
    numpy leaves) with `act` -> the state dict of
    `nn.yolat_pp.YOLaTPlusPlus` (numpy leaves). A checkpoint holds
    `super_edge_mlp` or `super_fact_mlp`; whichever is there comes
    through. The running statistics of every MLP and the four gates come
    with the weights (a train step starts from them), and a `fusion_block`
    trained through the fused pool head has the MLP's own tree (dense_0 +
    bn_0). The hierarchy, fusion and head MLPs take the model's act and
    norm (under --act none their Sequential indices close up; `ln_k` is a
    LayerNorm's weight and bias); the gp2 convs' MLPs stay ReLU and
    BatchNorm."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    has_act = _has_act(act)
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
            out.update(_export_mlp(params[name], stats.get(name, {}), name,
                                   has_act))
    k = 0
    while f"pred_{k}" in params:
        last = f"pred_{k + 1}" not in params
        out.update(_export_mlp(params[f"pred_{k}"], stats.get(f"pred_{k}", {}),
                               f"prediction_cls.{k}", has_act and not last))
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


def _join(prefix: str, name) -> str:
    return f"{prefix}.{name}" if prefix else str(name)


def _has_act(act) -> bool:
    return act is not None and str(act).lower() != "none"


def export_module(module, params: Mapping, stats: Mapping,
                  prefix: str = "") -> dict:
    """The flax subtree (params, batch_stats) of one port module of
    `nn/dynamic.py` (the blocks), `nn/dense_graph.py` or `SumEmbedding`
    -> its state dict under `prefix` (numpy leaves)."""
    from yolat_tpu_torch.nn import dense_graph, dynamic
    from yolat_tpu_torch.nn.layers import SumEmbedding

    if isinstance(module, SumEmbedding):
        return {_join(prefix, f"emb_{i}.weight"):
                np.asarray(params[f"emb_{i}"]["embedding"])
                for i in range(module.n_features)}
    if isinstance(module, dense_graph.BasicConv):
        return _export_mlp(params, stats, prefix, module.has_act)
    convs = ()
    if isinstance(module, (dynamic.DynConv, dynamic.ResGraphBlock,
                           dynamic.DenseGraphBlock)):
        convs = ((0, "gconv"),)
    elif isinstance(module, dynamic.ResBlockMultiEdge):
        convs = tuple((i, f"gconvs.{i}") for i in range(len(module.gconvs)))
    if convs:
        out: dict = {}
        for i, key in convs:
            name = f"{FLAX_CONV[module.conv]}_{i}"
            out.update(_export_conv(module.conv, params[name],
                                    stats.get(name, {}), _join(prefix, key),
                                    _has_act(module.act)))
        return out
    # the rest carry flax's names on their children (body, gconv, nn)
    out = {}
    for name, child in module.named_children():
        out.update(export_module(child, params[name], stats.get(name, {}),
                                 _join(prefix, name)))
    return out


def load_flax_module(module, variables: Mapping):
    """Load flax variables ({'params', 'batch_stats'}, numpy leaves) of a
    dynamic-graph block, a dense-library module or SumEmbedding into the
    port's `module` (strict); returns it."""
    sd = export_module(module, variables["params"],
                       variables.get("batch_stats", {}))
    module.load_state_dict({k: torch.from_numpy(np.array(v, copy=True))
                            for k, v in sd.items()}, strict=True)
    return module
