"""ResNet50 v1 in plain PyTorch, fp32: the benchmark's reference of the
``resnet50`` configuration, and the weights both sides are given.

He et al., arXiv:1512.03385, in the layout of the paper's Table 1 (Keras'
ResNet50): a 7x7/2 stem convolution with bias, BN, ReLU and a 3x3/2 max
pool; four stages of (3, 4, 6, 3) bottlenecks of 1x1, 3x3 and 1x1 (x4)
convolutions, each followed by BN, the first block of a stage with a 1x1
shortcut convolution and BN, the stride (2 from the second stage on) on the
block's first 1x1 and on the shortcut; ReLU after the residual add; global
average pool and a 1000-way dense layer with bias.

* Padding is XLA's SAME (a total of ``max((ceil(h/s) - 1) * s + k - h,
  0)``, half of it before), the max pool pads with -inf.  Keras pads the
  stem with ZeroPadding2D(3) and a VALID convolution instead; the port
  follows the paper's JAX model, so this does too.
* BN is inference BN with its statistics, eps 1e-3.
* Images are (B, H, W, C); the forward computes in NCHW with plain
  (contiguous OIHW) weights, the program in channels_last.

Parameters are ``{node: {"w", "b"} | {"gamma", "beta", "mean", "var"}}``
under the port's node names, conv weights OIHW (held channels_last, as
the program serves them), the dense weight (in, out).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .numerics import Ops
from .. import arith

INPUT = "__input__"
BN_EPS = 1e-3
Layer = Tuple  # (kind, name, inputs, attrs)


def layers(model: Dict) -> List[Layer]:
    """The network as ``(kind, name, inputs, attrs)`` in order; ``model``
    is the configuration's ``model`` object."""
    out: List[Layer] = []

    def conv(name, x, filters, k, stride, bias=False):
        out.append(("conv", name, [x], {"filters": filters, "k": k,
                                        "stride": stride, "bias": bias}))
        return name

    def bn(name, x):
        out.append(("bn", name, [x], {}))
        return name

    def relu(name, x):
        out.append(("relu", name, [x], {}))
        return name

    x = conv("stem_conv", INPUT, 64, 7, 2, bias=True)
    x = relu("stem_relu", bn("stem_bn", x))
    out.append(("maxpool", "stem_pool", [x], {"k": 3, "stride": 2}))
    x = "stem_pool"
    filters = 64
    for si, n in enumerate(model["blocks"]):
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            p = f"s{si}b{bi}"
            sc = x
            if bi == 0:
                sc = bn(f"{p}_scbn", conv(f"{p}_scconv", x, filters * 4, 1,
                                          stride))
            y = relu(f"{p}_a_relu", bn(f"{p}_a_bn", conv(
                f"{p}_a_conv", x, filters, 1, stride)))
            y = relu(f"{p}_b_relu", bn(f"{p}_b_bn", conv(
                f"{p}_b_conv", y, filters, 3, 1)))
            y = bn(f"{p}_c_bn", conv(f"{p}_c_conv", y, filters * 4, 1, 1))
            out.append(("add", f"{p}_add", [sc, y], {}))
            x = relu(f"{p}_out", f"{p}_add")
        filters *= 2
    out.append(("gap", "avg_pool", [x], {}))
    out.append(("dense", "predictions", ["avg_pool"],
                {"units": model["classes"], "bias": True}))
    return out


def shapes(model: Dict) -> Dict[str, Tuple[int, ...]]:
    """Each node's per-image output shape, (h, w, c) or (c,)."""
    sh: Dict[str, Tuple[int, ...]] = {INPUT: tuple(model["input_shape"])}
    for kind, name, ins, a in layers(model):
        src = sh[ins[0]]
        if kind in ("conv", "maxpool"):
            h, w, c = src
            s = a["stride"]
            sh[name] = (-(-h // s), -(-w // s),
                        a["filters"] if kind == "conv" else c)
        elif kind == "gap":
            sh[name] = (src[2],)
        elif kind == "dense":
            sh[name] = (a["units"],)
        else:
            sh[name] = src
    return sh


def macs_per_image(model: Dict) -> Dict[str, int]:
    """Multiply-accumulates of each convolution and the dense layer for one
    image."""
    sh = shapes(model)
    out = {}
    for kind, name, ins, a in layers(model):
        if kind == "conv":
            ho, wo, co = sh[name]
            out[name] = ho * wo * co * sh[ins[0]][2] * a["k"] ** 2
        elif kind == "dense":
            out[name] = sh[ins[0]][0] * a["units"]
    return out


def conv_costs(model: Dict, images: int) -> List[Tuple[int, int]]:
    """(FLOPs, bytes) of each convolution call over ``images`` images."""
    sh = shapes(model)
    costs = []
    for kind, name, ins, a in layers(model):
        if kind == "conv":
            h, w, c = sh[ins[0]]
            f, b, _ = arith.conv_cost(images, h, w, c, a["filters"], a["k"],
                                      a["stride"])
            costs.append((f, b))
    return costs


def model_flops_per_image(model: Dict) -> int:
    """2 flops a multiply-accumulate of the convolutions and the dense
    layer (BN, ReLU, the adds and the pools are left out)."""
    return 2 * sum(macs_per_image(model).values())


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def _seed(seed: int, tag: int) -> int:
    return (int(seed) * 0x9E3779B1 + tag * 1_000_003) % (2 ** 63)


def make_params(model: Dict, seed: int, device) -> Dict[str, Dict]:
    """Random fp32 weights from ``seed``, made on ``device`` in four
    calls: every conv and dense weight from one normal draw (scaled by
    fan-in ** -0.5), the biases, BN's gamma, beta and mean from a second
    (1 + 0.1 n, 0.1 n, 0.1 n; biases 0.1 n), BN's variance from a uniform
    one (0.5 to 1.5)."""
    device = torch.device(device)
    sh = shapes(model)
    ls = layers(model)
    weights, small, bns = [], [], []
    for kind, name, ins, a in ls:
        if kind == "conv":
            cin = sh[ins[0]][2]
            weights.append((name, (a["filters"], a["k"], a["k"], cin)))
            if a["bias"]:
                small.append((name, "b", a["filters"]))
        elif kind == "dense":
            weights.append((name, (sh[ins[0]][0], a["units"])))
            small.append((name, "b", a["units"]))
        elif kind == "bn":
            bns.append((name, sh[name][2]))
    gen = torch.Generator(device).manual_seed(_seed(seed, 1))
    n_w = sum(math.prod(s) for _, s in weights)
    n_s = sum(n for *_, n in small) + 3 * sum(c for _, c in bns)
    flat = torch.randn(n_w, generator=gen, device=device)
    rest = torch.randn(n_s, generator=gen, device=device) * 0.1
    var = torch.rand(sum(c for _, c in bns), generator=gen,
                     device=device) + 0.5
    params: Dict[str, Dict] = {}
    off = 0
    for name, s in weights:
        n = math.prod(s)
        part = flat[off:off + n]
        off += n
        if len(s) == 4:
            o, kh, kw, i = s
            # OHWI storage viewed OIHW: channels_last, as served
            leaf = part.view(o, kh, kw, i).mul_(
                (kh * kw * i) ** -0.5).permute(0, 3, 1, 2)
        else:
            leaf = part.view(s).mul_(s[0] ** -0.5)
        params[name] = {"w": leaf}
    off = 0
    for name, key, n in small:
        params[name][key] = rest[off:off + n]
        off += n
    voff = 0
    for name, c in bns:
        g, b, m = (rest[off + j * c: off + (j + 1) * c] for j in range(3))
        off += 3 * c
        params[name] = {"gamma": g + 1.0, "beta": b, "mean": m,
                        "var": var[voff:voff + c]}
        voff += c
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _same(size: int, k: int, s: int) -> Tuple[int, int]:
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def forward(model: Dict, params: Dict, images: torch.Tensor,
            precision: str = "fp32") -> torch.Tensor:
    """(B, H, W, C) fp32 images -> (B, classes) fp32 outputs."""
    ops = Ops(precision)
    net = layers(model)
    last = {i: name for _, name, ins, _ in net for i in ins}
    acts = {INPUT: images.permute(0, 3, 1, 2).contiguous()}
    for kind, name, ins, a in net:
        x = acts[ins[0]]
        p = params.get(name, {})
        if kind in ("conv", "maxpool"):
            h, w = x.shape[2], x.shape[3]
            (pt, pb), (pl, pr) = (_same(h, a["k"], a["stride"]),
                                  _same(w, a["k"], a["stride"]))
            if kind == "conv":
                x = F.pad(x, (pl, pr, pt, pb))
                y = ops.conv(x, p["w"].contiguous(), p.get("b"),
                             a["stride"])
            else:
                x = F.pad(x, (pl, pr, pt, pb), value=-math.inf)
                y = F.max_pool2d(x, a["k"], a["stride"])
        elif kind == "bn":
            c = (1, -1, 1, 1)
            y = ((x - p["mean"].view(c)) / torch.sqrt(p["var"].view(c)
                                                      + BN_EPS)
                 * p["gamma"].view(c) + p["beta"].view(c))
        elif kind == "relu":
            y = torch.clamp_min(x, 0.0)
        elif kind == "add":
            y = x + acts[ins[1]]
        elif kind == "gap":
            y = x.mean(dim=(2, 3))
        elif kind == "dense":
            y = ops.mm(x, p["w"]) + p["b"]
        else:
            raise ValueError(f"layer kind {kind!r}")
        acts[name] = y
        for i in ins:       # free what no later layer reads
            if last[i] == name:
                acts.pop(i, None)
    return acts[net[-1][1]]


def forward_rows(model: Dict, params: Dict, images: torch.Tensor,
                 rows: int, precision: str = "fp32") -> torch.Tensor:
    """:func:`forward` in blocks of ``rows`` images."""
    return torch.cat([forward(model, params, images[i:i + rows], precision)
                      for i in range(0, images.shape[0], rows)])


def check_names(model: Dict, names: Sequence[str]) -> None:
    """Raise unless ``names`` are this network's nodes, in order."""
    mine = [name for _, name, _, _ in layers(model)]
    if list(names) != mine:
        raise ValueError("the program's ResNet50 nodes differ from the "
                         "reference's")
