"""MobileNetV2 in plain PyTorch, fp32: the benchmark's reference of the
``mobilenetv2`` configuration, and the weights both sides are given.

Sandler et al., "MobileNetV2: Inverted Residuals and Linear Bottlenecks",
arXiv:1801.04381, Table 2, in Keras' layout (the paper's Table 1): a 3x3/2
stem convolution to 32 channels, BN, ReLU6; the bottlenecks (t, c, n, s)
of the configuration's ``blocks``, each a 1x1 expansion to t times the
channels with BN and ReLU6 (none where t = 1), a 3x3 depthwise convolution
(stride s on a group's first block) with BN and ReLU6, a 1x1 linear
projection to c with BN and no activation, and a residual add where the
stride is 1 and the widths match; a 1x1 convolution to 1280 with BN and
ReLU6; global average pool and a 1000-way dense layer with bias.  No
convolution has a bias.

* Padding is XLA's SAME (a total of ``max((ceil(h/s) - 1) * s + k - h,
  0)``, half of it before).  On the even inputs every strided convolution
  here meets, that is Keras' ``correct_pad`` (one row and column after).
* BN is inference BN with its statistics, eps 1e-3.
* Node names are the port's (``cnn.REAL_CNNS["MobileNetV2"]``), which
  numbers the BN and ReLU6 nodes it does not name in the order it makes
  them, so that :func:`check_names` holds.
* The weights are random from the seed (no trained checkpoint), and BN's
  draws are set so that the ReLU6 ceiling clips: a BN followed by a ReLU6
  gets beta ``4 + 0.1 n`` where ResNet50's draws give ``0.1 n``, which
  puts about 3% (the stem) to 43% of each ReLU6's inputs above 6 on
  standard normal images (:func:`forward`'s ``clipped``; a CPU test holds
  every ReLU6 at 1% or more).  With ResNet50's draws at most 1e-6 of them
  clip, and a ReLU6 that became a ReLU would pass the comparison.  A
  shift leaves each layer's gain as it was; a gamma of 3 (1 + 0.1 n)
  clips as much but makes the network so sensitive that fp32 and fp64
  forwards differ by 3e-3 of the output.
* Images are (B, H, W, C); the forward computes in NCHW with plain
  (contiguous OIHW) weights, the program in channels_last.

Parameters are ``{node: {"w"} | {"w", "b"} | {"gamma", "beta", "mean",
"var"}}`` under the port's node names, conv weights OIHW (a depthwise one
(C, 1, 3, 3); held channels_last, as the program serves them), the dense
weight (in, out).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .numerics import Ops
from .. import arith

INPUT = "__input__"
BN_EPS = 1e-3
RELU6_BETA = 4.0            # added to BN's beta before a ReLU6 (see above)
Layer = Tuple  # (kind, name, inputs, attrs)


def layers(model: Dict) -> List[Layer]:
    """The network as ``(kind, name, inputs, attrs)`` in order; ``model``
    is the configuration's ``model`` object."""
    out: List[Layer] = []
    n = [0]

    def uniq(prefix):
        n[0] += 1
        return f"{prefix}_{n[0]}"

    def conv(name, x, filters, k, stride, groups=1):
        out.append(("conv", name, [x], {"filters": filters, "k": k,
                                        "stride": stride, "groups": groups}))
        return name

    def bn(x, relu6=True):
        name = uniq("bn")
        out.append(("bn", name, [x], {"relu6": relu6}))
        if not relu6:
            return name
        y = uniq("relu6")
        out.append(("relu6", y, [name], {}))
        return y

    x = bn(conv("stem", INPUT, model["stem_channels"], 3, 2))
    cin, bi = model["stem_channels"], 0
    for t, c, reps, s in model["blocks"]:
        for i in range(reps):
            stride = s if i == 0 else 1
            p = f"ir{bi}"
            y = x
            if t != 1:
                y = bn(conv(f"{p}_exp", y, cin * t, 1, 1))
            width = cin * t
            y = bn(conv(f"{p}_dw", y, width, 3, stride, groups=width))
            y = bn(conv(f"{p}_proj", y, c, 1, 1), relu6=False)
            if stride == 1 and cin == c:
                out.append(("add", f"{p}_add", [x, y], {}))
                y = f"{p}_add"
            x, cin = y, c
            bi += 1
    x = bn(conv("head_conv", x, model["head_channels"], 1, 1))
    out.append(("gap", "avg_pool", [x], {}))
    out.append(("dense", "predictions", ["avg_pool"],
                {"units": model["classes"], "bias": True}))
    return out


def shapes(model: Dict) -> Dict[str, Tuple[int, ...]]:
    """Each node's per-image output shape, (h, w, c) or (c,)."""
    sh: Dict[str, Tuple[int, ...]] = {INPUT: tuple(model["input_shape"])}
    for kind, name, ins, a in layers(model):
        src = sh[ins[0]]
        if kind == "conv":
            h, w, _ = src
            s = a["stride"]
            sh[name] = (-(-h // s), -(-w // s), a["filters"])
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
            out[name] = ho * wo * co * (sh[ins[0]][2] // a["groups"]
                                        ) * a["k"] ** 2
        elif kind == "dense":
            out[name] = sh[ins[0]][0] * a["units"]
    return out


def _conv_costs(model: Dict, images: int, depthwise_only: bool
                ) -> List[Tuple[int, int]]:
    sh = shapes(model)
    costs = []
    for kind, name, ins, a in layers(model):
        if kind == "conv" and (a["groups"] > 1 or not depthwise_only):
            h, w, c = sh[ins[0]]
            f, b, _ = arith.conv_cost(images, h, w, c, a["filters"], a["k"],
                                      a["stride"], groups=a["groups"])
            costs.append((f, b))
    return costs


def conv_costs(model: Dict, images: int) -> List[Tuple[int, int]]:
    """(FLOPs, bytes) of each convolution call over ``images`` images, the
    depthwise ones counted with their groups."""
    return _conv_costs(model, images, False)


def dwconv_costs(model: Dict, images: int) -> List[Tuple[int, int]]:
    """(FLOPs, bytes) of each depthwise convolution call over ``images``
    images."""
    return _conv_costs(model, images, True)


def model_flops_per_image(model: Dict) -> int:
    """2 flops a multiply-accumulate of the convolutions and the dense
    layer (BN, ReLU6, the adds and the pool are left out)."""
    return 2 * sum(macs_per_image(model).values())


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def _seed(seed: int, tag: int) -> int:
    return (int(seed) * 0x9E3779B1 + tag * 1_000_003) % (2 ** 63)


def make_params(model: Dict, seed: int, device) -> Dict[str, Dict]:
    """Random fp32 weights from ``seed``, made on ``device`` in four
    calls: every conv and dense weight from one normal draw (scaled by
    fan-in ** -0.5), the dense bias and BN's gamma, beta and mean from a
    second (biases 0.1 n; gamma 1 + 0.1 n; beta 0.1 n, plus
    ``RELU6_BETA`` before a ReLU6; mean 0.1 n), BN's variance from a
    uniform one (0.5 to 1.5)."""
    device = torch.device(device)
    sh = shapes(model)
    weights, small, bns = [], [], []
    for kind, name, ins, a in layers(model):
        if kind == "conv":
            cin = sh[ins[0]][2] // a["groups"]
            weights.append((name, (a["filters"], a["k"], a["k"], cin)))
        elif kind == "dense":
            weights.append((name, (sh[ins[0]][0], a["units"])))
            small.append((name, a["units"]))
        elif kind == "bn":
            bns.append((name, sh[name][2], a["relu6"]))
    gen = torch.Generator(device).manual_seed(_seed(seed, 1))
    n_w = sum(math.prod(s) for _, s in weights)
    n_s = sum(n for _, n in small) + 3 * sum(c for _, c, _ in bns)
    flat = torch.randn(n_w, generator=gen, device=device)
    rest = torch.randn(n_s, generator=gen, device=device) * 0.1
    var = torch.rand(sum(c for _, c, _ in bns), generator=gen,
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
    for name, n in small:
        params[name]["b"] = rest[off:off + n]
        off += n
    voff = 0
    for name, c, relu6 in bns:
        g, b, m = (rest[off + j * c: off + (j + 1) * c] for j in range(3))
        off += 3 * c
        params[name] = {"gamma": g + 1.0,
                        "beta": b + RELU6_BETA if relu6 else b, "mean": m,
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
            precision: str = "fp32",
            clipped: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """(B, H, W, C) fp32 images -> (B, classes) fp32 outputs.  With
    ``clipped``, each ReLU6's share of inputs above 6 is put in it under
    the node's name."""
    ops = Ops(precision)
    net = layers(model)
    last = {i: name for _, name, ins, _ in net for i in ins}
    acts = {INPUT: images.permute(0, 3, 1, 2).contiguous()}
    for kind, name, ins, a in net:
        x = acts[ins[0]]
        p = params.get(name, {})
        if kind == "conv":
            h, w = x.shape[2], x.shape[3]
            (pt, pb), (pl, pr) = (_same(h, a["k"], a["stride"]),
                                  _same(w, a["k"], a["stride"]))
            x = F.pad(x, (pl, pr, pt, pb))
            # Ops.conv takes no groups: the same product, grouped
            y = F.conv2d(ops._in(x), ops._in(p["w"].contiguous()), None,
                         stride=a["stride"], groups=a["groups"])
        elif kind == "bn":
            c = (1, -1, 1, 1)
            y = ((x - p["mean"].view(c)) / torch.sqrt(p["var"].view(c)
                                                      + BN_EPS)
                 * p["gamma"].view(c) + p["beta"].view(c))
        elif kind == "relu6":
            if clipped is not None:
                clipped[name] = float((x > 6.0).float().mean())
            y = torch.clamp(x, 0.0, 6.0)
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
        raise ValueError("the program's MobileNetV2 nodes differ from the "
                         "reference's")
