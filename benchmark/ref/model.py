"""The plain reference of the trained detectors: YOLaT (the canonical
`centernet3cc_rpn_gp_iter2` stack on the `attr_edge_gp2` conv) and YOLaT++
on its per-edge clique level, in train mode, with their loss and the Adam
step.

Plain PyTorch on the real rows of a batch alone: no padding, no plans, no
kernels, no graphs. Gathers are indexing, sums are `index_add`, the
per-proposal max is `scatter_reduce`, BatchNorm takes its statistics over
every row it is given (all real), and every product runs in float32 with
TF32 off, unless `precision` says otherwise (`Ops`): "bf16" rounds every
tensor the program's bf16 step holds in bf16 to bf16, forward and back (a
plain witness of what that precision alone does), and "fp8" rounds the
same tensors to float8, e4m3 forward and e5m2 back with one scale per
tensor: the control, one step below the configurations' bf16.

The equations are those of the YOLaT paper's released model
(microsoft/YOLaT-VectorGraphicsRecognition, cad_recognition/
architecture3cc_rpn_gp_iter2.py, torch_vertex.py:288-341) and of YOLaT++
(TPAMI 2024) as the program documents them; the parameter names are the
reference checkpoint's, so one dict of weights loads into both sides.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FUSION = 1024
N_FREQS = 4
BN_EPS = 1e-5
PP_ARCHS = ("yolat_pp", "yolat++", "hierarchical")
PP_GATES = ("gate_point", "gate_curve", "gate_prim", "gate_super")


def is_pp(cfg: dict) -> bool:
    return cfg["arch"] in PP_ARCHS


def check_config(cfg: dict) -> None:
    """What this reference computes: ReLU and BatchNorm MLPs, the
    attr_edge_gp2 conv, softmax, no dropout, no edge dropout, and for
    YOLaT++ the per-edge clique level."""
    want = {"conv": "attr_edge_gp2", "act": "relu", "norm": "batch",
            "classifier": "softmax", "dropout": 0.0, "drop_edge": 0.0,
            "optimizer": "adam", "do_mixup": 0.0, "iou_aware_loss": False,
            "pos_class_weight": 1.0}
    for k, v in want.items():
        if cfg.get(k, v) != v:
            raise ValueError(f"the reference computes {k}={v!r}, not "
                             f"{cfg[k]!r}")
    if is_pp(cfg) and cfg.get("pp_factored_prim", False):
        raise ValueError("the reference computes YOLaT++'s per-edge level")


# --- parameters ----------------------------------------------------------

def _mlp_specs(prefix: str, channels, bare: bool = False) -> list:
    """(name, shape, kind) of an MLP laid out as the reference's flat
    Sequential: Linear at 3k and BatchNorm at 3k + 1, or Linear at k bare."""
    out = []
    for k in range(len(channels) - 1):
        i = k if bare else 3 * k
        ci, co = channels[k], channels[k + 1]
        out += [(f"{prefix}.{i}.weight", (co, ci), "w"),
                (f"{prefix}.{i}.bias", (co,), "b")]
        if not bare:
            out += [(f"{prefix}.{i + 1}.weight", (co,), "bn_w"),
                    (f"{prefix}.{i + 1}.bias", (co,), "bn_b")]
    return out


def conv_prefixes(cfg: dict) -> list:
    if is_pp(cfg):
        return [f"convs.{i}" for i in range(cfg["n_blocks"])]
    return (["cls_net.head.gconv"]
            + [f"cls_net.backbone.{i}.body.gconv"
               for i in range(cfg["n_blocks"] - 1)])


def param_specs(cfg: dict) -> list:
    """Every trainable leaf of the detector: (name, shape, kind), kind one
    of w (a Linear weight), b, bn_w, bn_b, gate."""
    c, nbo = cfg["n_filters"], cfg["n_blocks_out"]
    out = []
    for i, pre in enumerate(conv_prefixes(cfg)):
        cin = cfg["in_channels"] if i == 0 else c
        out += _mlp_specs(f"{pre}.nn", [2 * cin + 4, c, c])
        out += [(f"{pre}.lin_r.weight", (c, cin), "w"),
                (f"{pre}.lin_r.bias", (c,), "b")]
        out += _mlp_specs(f"{pre}.mlp_node", [cin, c])
    head = "" if is_pp(cfg) else "cls_net."
    out += _mlp_specs(f"{head}fusion_block", [c * nbo, FUSION])
    out += _mlp_specs(f"{head}fusion_block_super", [c * nbo, FUSION])
    out += _mlp_specs("prediction_cls.0", [2 * (c * nbo + FUSION), 512])
    out += _mlp_specs("prediction_cls.1", [512, 256])
    out += _mlp_specs("prediction_cls.2", [256, cfg["n_classes"]], bare=True)
    if is_pp(cfg):
        nf = 4 * N_FREQS
        out += _mlp_specs("point_pe_mlp", [nf, c])
        out += _mlp_specs("curve_mlp", [4 + 2 * c, c])
        out += _mlp_specs("super_edge_mlp", [2 * c + 4, c])
        out += _mlp_specs("super_node_mlp", [nf + 2 * c, 512])
        out += [(g, (), "gate") for g in PP_GATES]
    return out


def products(cfg: dict) -> list:
    """(population, ci, co, input_is_data) of every Linear in one forward:
    the rows it runs over are the batch's real edges, nodes, proposals or
    super edges; a product whose input is data (the first conv's, the
    point level's Fourier features) needs no input gradient."""
    pops = {"nn": "edges", "lin_r": "nodes", "mlp_node": "nodes",
            "fusion_block": "nodes", "fusion_block_super": "proposals",
            "prediction_cls": "proposals", "point_pe_mlp": "nodes",
            "curve_mlp": "edges", "super_edge_mlp": "super_edges",
            "super_node_mlp": "proposals"}
    first = conv_prefixes(cfg)[0]
    out = []
    for name, shape, kind in param_specs(cfg):
        if kind != "w":
            continue
        parts = name.split(".")
        key = next(p for p in parts if p in pops)
        data_in = ((name.startswith(first + ".") and name.endswith(
            (".nn.0.weight", ".lin_r.weight", ".mlp_node.0.weight")))
            or name == "point_pe_mlp.0.weight")
        out.append((pops[key], shape[1], shape[0], data_in))
    return out


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> dict:
    """The starting weights from `seed`, made on `device` in one draw:
    Kaiming-normal Linear weights (fan in, ReLU gain), Linear biases
    0.02 N(0, 1), BatchNorm scales 1 + 0.2 N(0, 1) and shifts 0.1 N(0, 1),
    YOLaT++'s gates 0.4 + 0.1 N(0, 1), so that every level of the model
    reaches the loss from the first step. float32 master weights."""
    specs = param_specs(cfg)
    sizes = [math.prod(s) for _, s, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(specs, sizes):
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "w":
            t = z * math.sqrt(2.0 / shape[1])
        elif kind == "b":
            t = 0.02 * z
        elif kind == "bn_w":
            t = 1.0 + 0.2 * z
        elif kind == "bn_b":
            t = 0.1 * z
        else:
            t = 0.4 + 0.1 * z
        out[name] = t.contiguous()
    return out


# --- the forward -----------------------------------------------------------

def _scaled(t, dtype, top: float):
    """t rounded to a float8 type with one scale (its largest magnitude at
    the type's largest finite value)."""
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


FORMATS = {
    # (forward rounding, backward rounding) of every tensor the program
    # holds in its compute type
    "bf16": (lambda t: t.to(torch.bfloat16).to(t.dtype),
             lambda t: t.to(torch.bfloat16).to(t.dtype)),
    # fp8 training's usual pair: e4m3 forward, e5m2 for the gradients
    "fp8": (lambda t: _scaled(t, torch.float8_e4m3fn, 448.0),
            lambda t: _scaled(t, torch.float8_e5m2, 57344.0)),
}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fmt):
        ctx.fmt = fmt
        return FORMATS[fmt][0](t)

    @staticmethod
    def backward(ctx, g):
        return FORMATS[ctx.fmt][1](g), None


class Ops:
    """The products and the layers, at one precision. Under "bf16" or
    "fp8", `r` rounds a tensor (and its gradient on the way back) where
    the program's bf16 step holds it in its compute type: the batch's float
    fields, every product's operands and output, BatchNorm's output (its
    statistics stay float32), each segment mean and each sum of
    features."""

    def __init__(self, params: dict, precision: str = "f32"):
        if precision not in ("f32",) + tuple(FORMATS):
            raise ValueError(precision)
        self.p, self.fmt = params, None if precision == "f32" else precision

    def r(self, t):
        return t if self.fmt is None else _Round.apply(t, self.fmt)

    def linear(self, x, name: str):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        return self.r(F.linear(self.r(x), self.r(w), self.r(b)))

    def bn(self, x, name: str):
        mean = x.mean(dim=0)
        var = ((x - mean) ** 2).mean(dim=0)
        return self.r((x - mean) / torch.sqrt(var + BN_EPS)
                      * self.p[f"{name}.weight"] + self.p[f"{name}.bias"])

    def mlp(self, x, prefix: str, n_stages: int, bare: bool = False):
        for k in range(n_stages):
            if bare:
                x = self.linear(x, f"{prefix}.{k}")
            else:
                x = self.linear(x, f"{prefix}.{3 * k}")
                x = torch.relu(self.bn(x, f"{prefix}.{3 * k + 1}"))
        return x

    def gate(self, name: str):
        return self.r(self.p[name])


def seg_sum(v, seg, n: int):
    return torch.zeros((n,) + v.shape[1:], dtype=v.dtype,
                       device=v.device).index_add(0, seg, v)


def seg_mean(v, seg, n: int):
    cnt = torch.bincount(seg, minlength=n).to(v.dtype).clamp(min=1.0)
    return seg_sum(v, seg, n) / cnt[:, None]


def seg_max(v, seg, n: int):
    out = torch.zeros((n, v.shape[1]), dtype=v.dtype, device=v.device)
    return out.scatter_reduce(0, seg[:, None].expand_as(v), v, "amax",
                              include_self=False)


def fourier(pos, n_freqs: int = N_FREQS):
    freqs = torch.pow(2.0, torch.arange(n_freqs, dtype=pos.dtype,
                                        device=pos.device)) * math.pi
    ang = pos[:, :, None] * freqs[None, None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)],
                     dim=-1).reshape(pos.shape[0], -1)


def _conv(ops: Ops, pre: str, f, s, b: dict):
    """attr_edge_gp2: the message MLP on [x_i || x_j - x_i || e_attr] over
    every edge (j, i), its mean per target node, plus lin_r; and the node
    stream through mlp_node."""
    src, dst, n = b["src"], b["dst"], f.shape[0]
    xi, xj = f[dst], f[src]
    msg = ops.mlp(torch.cat([xi, ops.r(xj - xi), b["e_attr"]], dim=1),
                  f"{pre}.nn", 2)
    return (ops.r(ops.r(seg_mean(msg, dst, n)) + ops.linear(f, f"{pre}.lin_r")),
            ops.mlp(s, f"{pre}.mlp_node", 1))


def forward(cfg: dict, ops: Ops, b: dict):
    """Logits [P, n_classes] of a plain batch (`ref.data.plain_batch`,
    positions already augmented)."""
    b = {**b, **{k: ops.r(b[k]) for k in ("pos", "e_attr", "e_attr_super")
                 if k in b}}
    pos, prop, n_prop = b["pos"], b["prop"], b["n_prop"]
    n = pos.shape[0]
    x = torch.cat([pos.new_zeros(n, 3), pos], dim=1)
    pp = is_pp(cfg)
    f, s = x, x
    feats, feats_super = [], []
    for i, pre in enumerate(conv_prefixes(cfg)):
        f, s = _conv(ops, pre, f, s, b)
        if pp and i == 0:
            pe = ops.mlp(ops.r(fourier(pos)), "point_pe_mlp", 1)
            f = ops.r(f + ops.r(ops.gate("gate_point") * pe))
        feats.append(f)
        feats_super.append(s)
    if pp:
        src, dst = b["src"], b["dst"]
        last = feats[-1]
        tok = ops.mlp(torch.cat([b["e_attr"], last[src], last[dst]], dim=1),
                      "curve_mlp", 1)
        curve = ops.r(ops.r(seg_mean(tok, dst, n))
                      + ops.r(seg_mean(tok, src, n)))
        ssrc, sdst = b["super_src"], b["super_dst"]
        si, sj = last[sdst], last[ssrc]
        stok = ops.mlp(torch.cat([si, ops.r(sj - si), b["e_attr_super"]],
                                 dim=1), "super_edge_mlp", 1)
        prim = ops.r(seg_mean(stok, sdst, n))
        feats[-1] = ops.r(ops.r(last + ops.r(ops.gate("gate_curve") * curve))
                          + ops.r(ops.gate("gate_prim") * prim))
    lo = cfg["n_blocks"] - cfg["n_blocks_out"]
    cat = torch.cat(feats[lo:], dim=1)
    head = "" if pp else "cls_net."
    fusion = ops.mlp(cat, f"{head}fusion_block", 1)
    pooled = seg_max(torch.cat([fusion, cat], dim=1), prop, n_prop)
    pooled_super = ops.r(seg_mean(torch.cat(feats_super[lo:], dim=1), prop,
                                  n_prop))
    out_super = torch.cat([ops.mlp(pooled_super, f"{head}fusion_block_super",
                                   1), pooled_super], dim=1)
    h = ops.mlp(torch.cat([pooled, out_super], dim=1), "prediction_cls.0", 1)
    if pp:
        centroid = ops.r(seg_mean(pos, prop, n_prop))
        member = ops.r(seg_mean(feats[-1], prop, n_prop))
        sup = torch.cat([ops.r(fourier(centroid)), member,
                         member[b["root_slot"]]], dim=1)
        h = ops.r(h + ops.r(ops.gate("gate_super")
                            * ops.mlp(sup, "super_node_mlp", 1)))
    h = ops.mlp(h, "prediction_cls.1", 1)
    return ops.mlp(h, "prediction_cls.2", 1, bare=True)


def loss_fn(logits, labels):
    """The mean cross entropy over the batch's proposals."""
    return F.cross_entropy(logits.float(), labels)


# --- the optimizer -------------------------------------------------------------

class Adam:
    """torch.optim.Adam's update with coupled L2 weight decay, written out:
    g += wd p; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, params: dict, lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.p, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Apply one update; returns the gradients as the update read them
        (weight decay added)."""
        self.t += 1
        seen = {}
        for k, p in self.p.items():
            g = grads[k] + self.wd * p
            seen[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mh = self.m[k] / (1 - self.b1 ** self.t)
            vh = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))
        return seen


def train_steps(cfg: dict, weights: dict, batches: list,
                precision: str = "f32", fault=None) -> dict:
    """Run len(batches) train steps from `weights` -> {'losses': [float],
    'grad1': {name: first gradient as Adam read it}, 'grad_last': {name:
    the last step's gradient as Adam read it}, 'params': {name: tensor
    after the last step}}. `fault` plants a fault for the control
    readings: 'half_batch', the loss over the first half of the images'
    proposals only; 'stale_grad', the last step's update fed the step
    before's gradient (a replay that reads a stale gradient buffer)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    opt = Adam(params, cfg["lr"], cfg["weight_decay"])
    losses, grad1, prev = [], None, None
    for b in batches:
        ops = Ops(params, precision)
        logits = forward(cfg, ops, b)
        if fault == "half_batch":
            keep = b["prop_img"] < (b["n_slots"] // 2)
            loss = loss_fn(logits[keep], b["labels"][keep])
        else:
            loss = loss_fn(logits, b["labels"])
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(names, grads)}
        if (fault == "stale_grad" and prev is not None
                and len(losses) == len(batches) - 1):
            grads = prev
        prev = grads
        seen = opt.step(grads)
        if grad1 is None:
            grad1 = {k: v.detach().clone() for k, v in seen.items()}
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1, "grad_last": seen,
            "params": {k: v.detach() for k, v in params.items()}}
