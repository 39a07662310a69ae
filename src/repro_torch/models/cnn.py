"""The paper's CNN model zoo: ``repro/models/cnn.py`` line for line, its
builders declared against this package's :class:`Builder`.

* :func:`synthetic_cnn` — the parametric family of §3.1 (L=5 conv layers,
  3×3 kernels, stride 1, zero padding, 64×64×3 inputs, f ∈ [32, 1152]).
* Real-world CNNs of Table 1, built layer-by-layer so that parameter/MAC
  totals track the paper's Table 1 and the DAG depth structure (branches,
  concats, residuals) matches the real topologies — this is what the
  depth-based segmentation (paper §6.1.1) operates on.

All builders return a :class:`~repro_torch.models.layers.GraphModel`; call
``.to_layer_graph()`` for the segmentation view and ``.init/.apply`` to run
real PyTorch forwards (used by the pipelined-executor correctness tests).

NASNetMobile is a *structural approximation* (same depth scale / param count
ballpark, simplified cell wiring) — flagged here; it is not
used in the paper's Table 5/7 experiments.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from .layers import Builder, GraphModel

IMAGENET_CLASSES = 1000


# ---------------------------------------------------------------------------
# Synthetic family (paper §3.1)
# ---------------------------------------------------------------------------
def synthetic_cnn(f: int, L: int = 5, hw: int = 64, cin: int = 3,
                  kernel: int = 3) -> GraphModel:
    """#params(f) = Fw*Fh*f*(C + f*(L-1)) — exactly the paper's formula."""
    b = Builder(f"synthetic_f{f}", (hw, hw), cin)
    x = Builder.INPUT if False else b.model.INPUT
    for i in range(L):
        x = b.conv(x, f, kernel, stride=1, padding="same", use_bias=False,
                   name=f"conv{i}")
    return b.build()


def synthetic_family(f_values: Sequence[int]) -> List[GraphModel]:
    return [synthetic_cnn(f) for f in f_values]


# ---------------------------------------------------------------------------
# ResNet v1 / v2 (He et al.; Keras variants)
# ---------------------------------------------------------------------------
_RESNET_BLOCKS = {"50": (3, 4, 6, 3), "101": (3, 4, 23, 3), "152": (3, 8, 36, 3)}


def resnet(depth: str = "50", v2: bool = False,
           classes: int = IMAGENET_CLASSES) -> GraphModel:
    blocks = _RESNET_BLOCKS[depth]
    name = f"ResNet{depth}{'V2' if v2 else ''}"
    b = Builder(name, (224, 224), 3)
    x = b.model.INPUT
    x = b.conv(x, 64, 7, stride=2, padding="same", use_bias=not v2,
               name="stem_conv")
    if not v2:
        x = b.bn(x, "stem_bn")
        x = b.act(x, "relu", "stem_relu")
    x = b.pool(x, "max", 3, 2, "same", "stem_pool")

    filters = 64
    for si, n in enumerate(blocks):
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            pfx = f"s{si}b{bi}"
            if v2:
                # pre-activation bottleneck
                pre = b.bn(x, f"{pfx}_prebn")
                pre = b.act(pre, "relu", f"{pfx}_prerelu")
                if bi == 0:
                    sc = b.conv(pre, filters * 4, 1, stride, "same",
                                use_bias=True, name=f"{pfx}_scconv")
                else:
                    sc = x
                y = b.conv(pre, filters, 1, 1, "same", use_bias=False,
                           name=f"{pfx}_c1")
                y = b.bn(y, f"{pfx}_bn1"); y = b.act(y, "relu", f"{pfx}_r1")
                y = b.conv(y, filters, 3, stride, "same", use_bias=False,
                           name=f"{pfx}_c2")
                y = b.bn(y, f"{pfx}_bn2"); y = b.act(y, "relu", f"{pfx}_r2")
                y = b.conv(y, filters * 4, 1, 1, "same", use_bias=True,
                           name=f"{pfx}_c3")
                x = b.add([sc, y], f"{pfx}_add")
            else:
                if bi == 0:
                    sc = b.conv(x, filters * 4, 1, stride, "same",
                                use_bias=False, name=f"{pfx}_scconv")
                    sc = b.bn(sc, f"{pfx}_scbn")
                else:
                    sc = x
                y = b.conv_bn(x, filters, 1, stride, "same", "relu", f"{pfx}_a")
                y = b.conv_bn(y, filters, 3, 1, "same", "relu", f"{pfx}_b")
                y = b.conv(y, filters * 4, 1, 1, "same", use_bias=False,
                           name=f"{pfx}_c_conv")
                y = b.bn(y, f"{pfx}_c_bn")
                x = b.add([sc, y], f"{pfx}_add")
                x = b.act(x, "relu", f"{pfx}_out")
        filters *= 2
    if v2:
        x = b.bn(x, "post_bn")
        x = b.act(x, "relu", "post_relu")
    x = b.gap(x, "avg_pool")
    b.dense(x, classes, name="predictions")
    return b.build()


# ---------------------------------------------------------------------------
# DenseNet (Huang et al.)
# ---------------------------------------------------------------------------
_DENSENET_BLOCKS = {"121": (6, 12, 24, 16), "169": (6, 12, 32, 32),
                    "201": (6, 12, 48, 32)}


def densenet(depth: str = "121", growth: int = 32,
             classes: int = IMAGENET_CLASSES) -> GraphModel:
    blocks = _DENSENET_BLOCKS[depth]
    b = Builder(f"DenseNet{depth}", (224, 224), 3)
    x = b.conv(b.model.INPUT, 64, 7, 2, "same", use_bias=False, name="stem_conv")
    x = b.bn(x, "stem_bn"); x = b.act(x, "relu", "stem_relu")
    x = b.pool(x, "max", 3, 2, "same", "stem_pool")
    ch = 64
    for si, n in enumerate(blocks):
        for bi in range(n):
            pfx = f"d{si}b{bi}"
            y = b.bn(x, f"{pfx}_bn1"); y = b.act(y, "relu", f"{pfx}_r1")
            y = b.conv(y, 4 * growth, 1, 1, "same", use_bias=False,
                       name=f"{pfx}_c1")
            y = b.bn(y, f"{pfx}_bn2"); y = b.act(y, "relu", f"{pfx}_r2")
            y = b.conv(y, growth, 3, 1, "same", use_bias=False,
                       name=f"{pfx}_c2")
            x = b.concat([x, y], f"{pfx}_cat")
            ch += growth
        if si < len(blocks) - 1:
            pfx = f"t{si}"
            ch = ch // 2
            x = b.bn(x, f"{pfx}_bn"); x = b.act(x, "relu", f"{pfx}_r")
            x = b.conv(x, ch, 1, 1, "same", use_bias=False, name=f"{pfx}_c")
            x = b.pool(x, "avg", 2, 2, "same", f"{pfx}_pool")
    x = b.bn(x, "post_bn"); x = b.act(x, "relu", "post_relu")
    x = b.gap(x, "avg_pool")
    b.dense(x, classes, name="predictions")
    return b.build()


# ---------------------------------------------------------------------------
# MobileNet v1 / v2 (Howard et al.; Sandler et al.)
# ---------------------------------------------------------------------------
def mobilenet(classes: int = IMAGENET_CLASSES) -> GraphModel:
    b = Builder("MobileNet", (224, 224), 3)
    x = b.conv(b.model.INPUT, 32, 3, 2, "same", use_bias=False, name="stem")
    x = b.bn(x); x = b.act(x, "relu6")
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]
    for i, (f, s) in enumerate(cfg):
        x = b.dwconv(x, 3, s, "same", use_bias=False, name=f"dw{i}")
        x = b.bn(x); x = b.act(x, "relu6")
        x = b.conv(x, f, 1, 1, "same", use_bias=False, name=f"pw{i}")
        x = b.bn(x); x = b.act(x, "relu6")
    x = b.gap(x, "avg_pool")
    b.dense(x, classes, name="predictions")
    return b.build()


def mobilenet_v2(classes: int = IMAGENET_CLASSES) -> GraphModel:
    b = Builder("MobileNetV2", (224, 224), 3)
    x = b.conv(b.model.INPUT, 32, 3, 2, "same", use_bias=False, name="stem")
    x = b.bn(x); x = b.act(x, "relu6")
    # (expansion t, channels, repeats, stride)
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    cin = 32
    bi = 0
    for t, c, n, s in cfg:
        for i in range(n):
            stride = s if i == 0 else 1
            pfx = f"ir{bi}"
            inp = x
            y = x
            if t != 1:
                y = b.conv(y, cin * t, 1, 1, "same", use_bias=False,
                           name=f"{pfx}_exp")
                y = b.bn(y); y = b.act(y, "relu6")
            y = b.dwconv(y, 3, stride, "same", use_bias=False, name=f"{pfx}_dw")
            y = b.bn(y); y = b.act(y, "relu6")
            y = b.conv(y, c, 1, 1, "same", use_bias=False, name=f"{pfx}_proj")
            y = b.bn(y)
            if stride == 1 and cin == c:
                x = b.add([inp, y], f"{pfx}_add")
            else:
                x = y
            cin = c
            bi += 1
    x = b.conv(x, 1280, 1, 1, "same", use_bias=False, name="head_conv")
    x = b.bn(x); x = b.act(x, "relu6")
    x = b.gap(x, "avg_pool")
    b.dense(x, classes, name="predictions")
    return b.build()


# ---------------------------------------------------------------------------
# EfficientNet-Lite B0..B4 (fixed stem/head, no SE, ReLU6)
# ---------------------------------------------------------------------------
_EFFLITE = {  # (width_mult, depth_mult, resolution)
    "B0": (1.0, 1.0, 224), "B1": (1.0, 1.1, 240), "B2": (1.1, 1.2, 260),
    "B3": (1.2, 1.4, 280), "B4": (1.4, 1.8, 300),
}
_EFF_BLOCKS = [  # (expand t, channels, repeats, stride, kernel)
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3),
]


def _round_filters(f: int, mult: float, divisor: int = 8) -> int:
    f = f * mult
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new < 0.9 * f:
        new += divisor
    return int(new)


def efficientnet_lite(variant: str = "B0",
                      classes: int = IMAGENET_CLASSES) -> GraphModel:
    wm, dm, res = _EFFLITE[variant]
    b = Builder(f"EfficientNetLite{variant}", (res, res), 3)
    x = b.conv(b.model.INPUT, 32, 3, 2, "same", use_bias=False, name="stem")
    x = b.bn(x); x = b.act(x, "relu6")
    cin = 32
    bi = 0
    n_stages = len(_EFF_BLOCKS)
    for si, (t, c, n, s, k) in enumerate(_EFF_BLOCKS):
        c = _round_filters(c, wm)
        # Lite: repeats of first and last stage are NOT depth-scaled
        reps = n if si in (0, n_stages - 1) else int(math.ceil(n * dm))
        for i in range(reps):
            stride = s if i == 0 else 1
            pfx = f"mb{bi}"
            inp = x
            y = x
            if t != 1:
                y = b.conv(y, cin * t, 1, 1, "same", use_bias=False,
                           name=f"{pfx}_exp")
                y = b.bn(y); y = b.act(y, "relu6")
            y = b.dwconv(y, k, stride, "same", use_bias=False, name=f"{pfx}_dw")
            y = b.bn(y); y = b.act(y, "relu6")
            y = b.conv(y, c, 1, 1, "same", use_bias=False, name=f"{pfx}_proj")
            y = b.bn(y)
            if stride == 1 and cin == c:
                x = b.add([inp, y], f"{pfx}_add")
            else:
                x = y
            cin = c
            bi += 1
    x = b.conv(x, 1280, 1, 1, "same", use_bias=False, name="head_conv")
    x = b.bn(x); x = b.act(x, "relu6")
    x = b.gap(x, "avg_pool")
    b.dense(x, classes, name="predictions")
    return b.build()


# ---------------------------------------------------------------------------
# Xception (Chollet)
# ---------------------------------------------------------------------------
def _sepconv_bn(b: Builder, x: str, filters: int, prefix: str,
                act_before: bool = False, kernel: int = 3) -> str:
    if act_before:
        x = b.act(x, "relu", f"{prefix}_prerelu")
    x = b.dwconv(x, kernel, 1, "same", use_bias=False, name=f"{prefix}_dw")
    x = b.conv(x, filters, 1, 1, "same", use_bias=False, name=f"{prefix}_pw")
    x = b.bn(x, f"{prefix}_bn")
    return x


def xception(classes: int = IMAGENET_CLASSES) -> GraphModel:
    b = Builder("Xception", (299, 299), 3)
    x = b.conv_bn(b.model.INPUT, 32, 3, 2, "valid", "relu", "stem1")
    x = b.conv_bn(x, 64, 3, 1, "valid", "relu", "stem2")
    # entry flow residual modules
    for i, f in enumerate([128, 256, 728]):
        pfx = f"entry{i}"
        sc = b.conv(x, f, 1, 2, "same", use_bias=False, name=f"{pfx}_sc")
        sc = b.bn(sc, f"{pfx}_scbn")
        y = _sepconv_bn(b, x, f, f"{pfx}_s1", act_before=(i > 0))
        y = b.act(y, "relu", f"{pfx}_r")
        y = _sepconv_bn(b, y, f, f"{pfx}_s2")
        y = b.pool(y, "max", 3, 2, "same", f"{pfx}_pool")
        x = b.add([sc, y], f"{pfx}_add")
    # middle flow
    for i in range(8):
        pfx = f"mid{i}"
        y = x
        for j in range(3):
            y = _sepconv_bn(b, y, 728, f"{pfx}_s{j}", act_before=True)
        x = b.add([x, y], f"{pfx}_add")
    # exit flow
    sc = b.conv(x, 1024, 1, 2, "same", use_bias=False, name="exit_sc")
    sc = b.bn(sc, "exit_scbn")
    y = _sepconv_bn(b, x, 728, "exit_s1", act_before=True)
    y = _sepconv_bn(b, y, 1024, "exit_s2", act_before=True)
    y = b.pool(y, "max", 3, 2, "same", "exit_pool")
    x = b.add([sc, y], "exit_add")
    x = _sepconv_bn(b, x, 1536, "exit_s3")
    x = b.act(x, "relu", "exit_r3")
    x = _sepconv_bn(b, x, 2048, "exit_s4")
    x = b.act(x, "relu", "exit_r4")
    x = b.gap(x, "avg_pool")
    b.dense(x, classes, name="predictions")
    return b.build()


# ---------------------------------------------------------------------------
# Inception V3 (Szegedy et al.; Keras topology)
# ---------------------------------------------------------------------------
def inception_v3(classes: int = IMAGENET_CLASSES) -> GraphModel:
    b = Builder("InceptionV3", (299, 299), 3)
    x = b.conv_bn(b.model.INPUT, 32, 3, 2, "valid", "relu", "stem1")
    x = b.conv_bn(x, 32, 3, 1, "valid", "relu", "stem2")
    x = b.conv_bn(x, 64, 3, 1, "same", "relu", "stem3")
    x = b.pool(x, "max", 3, 2, "valid", "stem_pool1")
    x = b.conv_bn(x, 80, 1, 1, "valid", "relu", "stem4")
    x = b.conv_bn(x, 192, 3, 1, "valid", "relu", "stem5")
    x = b.pool(x, "max", 3, 2, "valid", "stem_pool2")

    def block_a(x: str, pool_f: int, pfx: str) -> str:
        b1 = b.conv_bn(x, 64, 1, 1, "same", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, 48, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, 64, 5, 1, "same", "relu", f"{pfx}_b2b")
        b3 = b.conv_bn(x, 64, 1, 1, "same", "relu", f"{pfx}_b3a")
        b3 = b.conv_bn(b3, 96, 3, 1, "same", "relu", f"{pfx}_b3b")
        b3 = b.conv_bn(b3, 96, 3, 1, "same", "relu", f"{pfx}_b3c")
        b4 = b.pool(x, "avg", 3, 1, "same", f"{pfx}_b4p")
        b4 = b.conv_bn(b4, pool_f, 1, 1, "same", "relu", f"{pfx}_b4")
        return b.concat([b1, b2, b3, b4], f"{pfx}_cat")

    def reduction_a(x: str, pfx: str) -> str:
        b1 = b.conv_bn(x, 384, 3, 2, "valid", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, 64, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, 96, 3, 1, "same", "relu", f"{pfx}_b2b")
        b2 = b.conv_bn(b2, 96, 3, 2, "valid", "relu", f"{pfx}_b2c")
        b3 = b.pool(x, "max", 3, 2, "valid", f"{pfx}_pool")
        return b.concat([b1, b2, b3], f"{pfx}_cat")

    def block_b(x: str, c7: int, pfx: str) -> str:
        b1 = b.conv_bn(x, 192, 1, 1, "same", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, c7, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, c7, (1, 7), 1, "same", "relu", f"{pfx}_b2b")
        b2 = b.conv_bn(b2, 192, (7, 1), 1, "same", "relu", f"{pfx}_b2c")
        b3 = b.conv_bn(x, c7, 1, 1, "same", "relu", f"{pfx}_b3a")
        b3 = b.conv_bn(b3, c7, (7, 1), 1, "same", "relu", f"{pfx}_b3b")
        b3 = b.conv_bn(b3, c7, (1, 7), 1, "same", "relu", f"{pfx}_b3c")
        b3 = b.conv_bn(b3, c7, (7, 1), 1, "same", "relu", f"{pfx}_b3d")
        b3 = b.conv_bn(b3, 192, (1, 7), 1, "same", "relu", f"{pfx}_b3e")
        b4 = b.pool(x, "avg", 3, 1, "same", f"{pfx}_b4p")
        b4 = b.conv_bn(b4, 192, 1, 1, "same", "relu", f"{pfx}_b4")
        return b.concat([b1, b2, b3, b4], f"{pfx}_cat")

    def reduction_b(x: str, pfx: str) -> str:
        b1 = b.conv_bn(x, 192, 1, 1, "same", "relu", f"{pfx}_b1a")
        b1 = b.conv_bn(b1, 320, 3, 2, "valid", "relu", f"{pfx}_b1b")
        b2 = b.conv_bn(x, 192, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, 192, (1, 7), 1, "same", "relu", f"{pfx}_b2b")
        b2 = b.conv_bn(b2, 192, (7, 1), 1, "same", "relu", f"{pfx}_b2c")
        b2 = b.conv_bn(b2, 192, 3, 2, "valid", "relu", f"{pfx}_b2d")
        b3 = b.pool(x, "max", 3, 2, "valid", f"{pfx}_pool")
        return b.concat([b1, b2, b3], f"{pfx}_cat")

    def block_c(x: str, pfx: str) -> str:
        b1 = b.conv_bn(x, 320, 1, 1, "same", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, 384, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2a = b.conv_bn(b2, 384, (1, 3), 1, "same", "relu", f"{pfx}_b2b")
        b2b = b.conv_bn(b2, 384, (3, 1), 1, "same", "relu", f"{pfx}_b2c")
        b3 = b.conv_bn(x, 448, 1, 1, "same", "relu", f"{pfx}_b3a")
        b3 = b.conv_bn(b3, 384, 3, 1, "same", "relu", f"{pfx}_b3b")
        b3a = b.conv_bn(b3, 384, (1, 3), 1, "same", "relu", f"{pfx}_b3c")
        b3b = b.conv_bn(b3, 384, (3, 1), 1, "same", "relu", f"{pfx}_b3d")
        b4 = b.pool(x, "avg", 3, 1, "same", f"{pfx}_b4p")
        b4 = b.conv_bn(b4, 192, 1, 1, "same", "relu", f"{pfx}_b4")
        return b.concat([b1, b2a, b2b, b3a, b3b, b4], f"{pfx}_cat")

    x = block_a(x, 32, "a0")
    x = block_a(x, 64, "a1")
    x = block_a(x, 64, "a2")
    x = reduction_a(x, "ra")
    for i, c7 in enumerate([128, 160, 160, 192]):
        x = block_b(x, c7, f"b{i}")
    x = reduction_b(x, "rb")
    x = block_c(x, "c0")
    x = block_c(x, "c1")
    x = b.gap(x, "avg_pool")
    b.dense(x, classes, name="predictions")
    return b.build()


# ---------------------------------------------------------------------------
# Inception V4 and Inception-ResNet V2 (Szegedy et al. 2016)
# ---------------------------------------------------------------------------
def _inc_v4_stem(b: Builder) -> str:
    x = b.conv_bn(b.model.INPUT, 32, 3, 2, "valid", "relu", "stem1")
    x = b.conv_bn(x, 32, 3, 1, "valid", "relu", "stem2")
    x = b.conv_bn(x, 64, 3, 1, "same", "relu", "stem3")
    p1 = b.pool(x, "max", 3, 2, "valid", "stem_p1")
    p2 = b.conv_bn(x, 96, 3, 2, "valid", "relu", "stem_c1")
    x = b.concat([p1, p2], "stem_cat1")
    q1 = b.conv_bn(x, 64, 1, 1, "same", "relu", "stem_q1a")
    q1 = b.conv_bn(q1, 96, 3, 1, "valid", "relu", "stem_q1b")
    q2 = b.conv_bn(x, 64, 1, 1, "same", "relu", "stem_q2a")
    q2 = b.conv_bn(q2, 64, (1, 7), 1, "same", "relu", "stem_q2b")
    q2 = b.conv_bn(q2, 64, (7, 1), 1, "same", "relu", "stem_q2c")
    q2 = b.conv_bn(q2, 96, 3, 1, "valid", "relu", "stem_q2d")
    x = b.concat([q1, q2], "stem_cat2")
    r1 = b.conv_bn(x, 192, 3, 2, "valid", "relu", "stem_r1")
    r2 = b.pool(x, "max", 3, 2, "valid", "stem_r2")
    return b.concat([r1, r2], "stem_cat3")


def inception_v4(classes: int = IMAGENET_CLASSES) -> GraphModel:
    b = Builder("InceptionV4", (299, 299), 3)
    x = _inc_v4_stem(b)

    def block_a(x: str, pfx: str) -> str:
        b1 = b.conv_bn(x, 96, 1, 1, "same", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, 64, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, 96, 3, 1, "same", "relu", f"{pfx}_b2b")
        b3 = b.conv_bn(x, 64, 1, 1, "same", "relu", f"{pfx}_b3a")
        b3 = b.conv_bn(b3, 96, 3, 1, "same", "relu", f"{pfx}_b3b")
        b3 = b.conv_bn(b3, 96, 3, 1, "same", "relu", f"{pfx}_b3c")
        b4 = b.pool(x, "avg", 3, 1, "same", f"{pfx}_b4p")
        b4 = b.conv_bn(b4, 96, 1, 1, "same", "relu", f"{pfx}_b4")
        return b.concat([b1, b2, b3, b4], f"{pfx}_cat")

    def reduction_a(x: str, pfx: str) -> str:
        b1 = b.conv_bn(x, 384, 3, 2, "valid", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, 192, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, 224, 3, 1, "same", "relu", f"{pfx}_b2b")
        b2 = b.conv_bn(b2, 256, 3, 2, "valid", "relu", f"{pfx}_b2c")
        b3 = b.pool(x, "max", 3, 2, "valid", f"{pfx}_pool")
        return b.concat([b1, b2, b3], f"{pfx}_cat")

    def block_b(x: str, pfx: str) -> str:
        b1 = b.conv_bn(x, 384, 1, 1, "same", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, 192, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, 224, (1, 7), 1, "same", "relu", f"{pfx}_b2b")
        b2 = b.conv_bn(b2, 256, (7, 1), 1, "same", "relu", f"{pfx}_b2c")
        b3 = b.conv_bn(x, 192, 1, 1, "same", "relu", f"{pfx}_b3a")
        b3 = b.conv_bn(b3, 192, (7, 1), 1, "same", "relu", f"{pfx}_b3b")
        b3 = b.conv_bn(b3, 224, (1, 7), 1, "same", "relu", f"{pfx}_b3c")
        b3 = b.conv_bn(b3, 224, (7, 1), 1, "same", "relu", f"{pfx}_b3d")
        b3 = b.conv_bn(b3, 256, (1, 7), 1, "same", "relu", f"{pfx}_b3e")
        b4 = b.pool(x, "avg", 3, 1, "same", f"{pfx}_b4p")
        b4 = b.conv_bn(b4, 128, 1, 1, "same", "relu", f"{pfx}_b4")
        return b.concat([b1, b2, b3, b4], f"{pfx}_cat")

    def reduction_b(x: str, pfx: str) -> str:
        b1 = b.conv_bn(x, 192, 1, 1, "same", "relu", f"{pfx}_b1a")
        b1 = b.conv_bn(b1, 192, 3, 2, "valid", "relu", f"{pfx}_b1b")
        b2 = b.conv_bn(x, 256, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, 256, (1, 7), 1, "same", "relu", f"{pfx}_b2b")
        b2 = b.conv_bn(b2, 320, (7, 1), 1, "same", "relu", f"{pfx}_b2c")
        b2 = b.conv_bn(b2, 320, 3, 2, "valid", "relu", f"{pfx}_b2d")
        b3 = b.pool(x, "max", 3, 2, "valid", f"{pfx}_pool")
        return b.concat([b1, b2, b3], f"{pfx}_cat")

    def block_c(x: str, pfx: str) -> str:
        b1 = b.conv_bn(x, 256, 1, 1, "same", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, 384, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2a = b.conv_bn(b2, 256, (1, 3), 1, "same", "relu", f"{pfx}_b2b")
        b2b = b.conv_bn(b2, 256, (3, 1), 1, "same", "relu", f"{pfx}_b2c")
        b3 = b.conv_bn(x, 384, 1, 1, "same", "relu", f"{pfx}_b3a")
        b3 = b.conv_bn(b3, 448, (3, 1), 1, "same", "relu", f"{pfx}_b3b")
        b3 = b.conv_bn(b3, 512, (1, 3), 1, "same", "relu", f"{pfx}_b3c")
        b3a = b.conv_bn(b3, 256, (1, 3), 1, "same", "relu", f"{pfx}_b3d")
        b3b = b.conv_bn(b3, 256, (3, 1), 1, "same", "relu", f"{pfx}_b3e")
        b4 = b.pool(x, "avg", 3, 1, "same", f"{pfx}_b4p")
        b4 = b.conv_bn(b4, 256, 1, 1, "same", "relu", f"{pfx}_b4")
        return b.concat([b1, b2a, b2b, b3a, b3b, b4], f"{pfx}_cat")

    for i in range(4):
        x = block_a(x, f"a{i}")
    x = reduction_a(x, "ra")
    for i in range(7):
        x = block_b(x, f"b{i}")
    x = reduction_b(x, "rb")
    for i in range(3):
        x = block_c(x, f"c{i}")
    x = b.gap(x, "avg_pool")
    b.dense(x, classes, name="predictions")
    return b.build()


def inception_resnet_v2(classes: int = IMAGENET_CLASSES) -> GraphModel:
    b = Builder("InceptionResNetV2", (299, 299), 3)
    # Keras stem (simpler than pure V4 stem)
    x = b.conv_bn(b.model.INPUT, 32, 3, 2, "valid", "relu", "stem1")
    x = b.conv_bn(x, 32, 3, 1, "valid", "relu", "stem2")
    x = b.conv_bn(x, 64, 3, 1, "same", "relu", "stem3")
    x = b.pool(x, "max", 3, 2, "valid", "stem_p1")
    x = b.conv_bn(x, 80, 1, 1, "valid", "relu", "stem4")
    x = b.conv_bn(x, 192, 3, 1, "valid", "relu", "stem5")
    x = b.pool(x, "max", 3, 2, "valid", "stem_p2")
    # mixed_5b (Inception-A)
    b1 = b.conv_bn(x, 96, 1, 1, "same", "relu", "m5b_b1")
    b2 = b.conv_bn(x, 48, 1, 1, "same", "relu", "m5b_b2a")
    b2 = b.conv_bn(b2, 64, 5, 1, "same", "relu", "m5b_b2b")
    b3 = b.conv_bn(x, 64, 1, 1, "same", "relu", "m5b_b3a")
    b3 = b.conv_bn(b3, 96, 3, 1, "same", "relu", "m5b_b3b")
    b3 = b.conv_bn(b3, 96, 3, 1, "same", "relu", "m5b_b3c")
    b4 = b.pool(x, "avg", 3, 1, "same", "m5b_b4p")
    b4 = b.conv_bn(b4, 64, 1, 1, "same", "relu", "m5b_b4")
    x = b.concat([b1, b2, b3, b4], "m5b_cat")  # 320ch

    def block35(x: str, pfx: str) -> str:        # Inception-ResNet-A
        b1 = b.conv_bn(x, 32, 1, 1, "same", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, 32, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, 32, 3, 1, "same", "relu", f"{pfx}_b2b")
        b3 = b.conv_bn(x, 32, 1, 1, "same", "relu", f"{pfx}_b3a")
        b3 = b.conv_bn(b3, 48, 3, 1, "same", "relu", f"{pfx}_b3b")
        b3 = b.conv_bn(b3, 64, 3, 1, "same", "relu", f"{pfx}_b3c")
        cat = b.concat([b1, b2, b3], f"{pfx}_cat")
        up = b.conv(cat, 320, 1, 1, "same", use_bias=True, name=f"{pfx}_up")
        y = b.add([x, up], f"{pfx}_add")
        return b.act(y, "relu", f"{pfx}_relu")

    for i in range(10):
        x = block35(x, f"b35_{i}")
    # reduction-A -> 1088ch
    r1 = b.conv_bn(x, 384, 3, 2, "valid", "relu", "redA_b1")
    r2 = b.conv_bn(x, 256, 1, 1, "same", "relu", "redA_b2a")
    r2 = b.conv_bn(r2, 256, 3, 1, "same", "relu", "redA_b2b")
    r2 = b.conv_bn(r2, 384, 3, 2, "valid", "relu", "redA_b2c")
    r3 = b.pool(x, "max", 3, 2, "valid", "redA_pool")
    x = b.concat([r1, r2, r3], "redA_cat")

    def block17(x: str, pfx: str) -> str:        # Inception-ResNet-B
        b1 = b.conv_bn(x, 192, 1, 1, "same", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, 128, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, 160, (1, 7), 1, "same", "relu", f"{pfx}_b2b")
        b2 = b.conv_bn(b2, 192, (7, 1), 1, "same", "relu", f"{pfx}_b2c")
        cat = b.concat([b1, b2], f"{pfx}_cat")
        up = b.conv(cat, 1088, 1, 1, "same", use_bias=True, name=f"{pfx}_up")
        y = b.add([x, up], f"{pfx}_add")
        return b.act(y, "relu", f"{pfx}_relu")

    for i in range(20):
        x = block17(x, f"b17_{i}")
    # reduction-B -> 2080ch
    r1 = b.conv_bn(x, 256, 1, 1, "same", "relu", "redB_b1a")
    r1 = b.conv_bn(r1, 384, 3, 2, "valid", "relu", "redB_b1b")
    r2 = b.conv_bn(x, 256, 1, 1, "same", "relu", "redB_b2a")
    r2 = b.conv_bn(r2, 288, 3, 2, "valid", "relu", "redB_b2b")
    r3 = b.conv_bn(x, 256, 1, 1, "same", "relu", "redB_b3a")
    r3 = b.conv_bn(r3, 288, 3, 1, "same", "relu", "redB_b3b")
    r3 = b.conv_bn(r3, 320, 3, 2, "valid", "relu", "redB_b3c")
    r4 = b.pool(x, "max", 3, 2, "valid", "redB_pool")
    x = b.concat([r1, r2, r3, r4], "redB_cat")

    def block8(x: str, pfx: str, relu: bool = True) -> str:  # Inception-ResNet-C
        b1 = b.conv_bn(x, 192, 1, 1, "same", "relu", f"{pfx}_b1")
        b2 = b.conv_bn(x, 192, 1, 1, "same", "relu", f"{pfx}_b2a")
        b2 = b.conv_bn(b2, 224, (1, 3), 1, "same", "relu", f"{pfx}_b2b")
        b2 = b.conv_bn(b2, 256, (3, 1), 1, "same", "relu", f"{pfx}_b2c")
        cat = b.concat([b1, b2], f"{pfx}_cat")
        up = b.conv(cat, 2080, 1, 1, "same", use_bias=True, name=f"{pfx}_up")
        y = b.add([x, up], f"{pfx}_add")
        return b.act(y, "relu", f"{pfx}_relu") if relu else y

    for i in range(9):
        x = block8(x, f"b8_{i}")
    x = block8(x, "b8_9", relu=False)
    x = b.conv_bn(x, 1536, 1, 1, "same", "relu", "conv_7b")
    x = b.gap(x, "avg_pool")
    b.dense(x, classes, name="predictions")
    return b.build()


# ---------------------------------------------------------------------------
# NASNetMobile — STRUCTURAL APPROXIMATION (flagged; see module docstring)
# ---------------------------------------------------------------------------
def nasnet_mobile_approx(classes: int = IMAGENET_CLASSES) -> GraphModel:
    b = Builder("NASNetMobile~approx", (224, 224), 3)
    x = b.conv_bn(b.model.INPUT, 32, 3, 2, "valid", "relu", "stem")

    def sep_block(x: str, f: int, k: int, s: int, pfx: str) -> str:
        y = b.act(x, "relu", f"{pfx}_r1")
        y = b.dwconv(y, k, s, "same", use_bias=False, name=f"{pfx}_dw1")
        y = b.conv(y, f, 1, 1, "same", use_bias=False, name=f"{pfx}_pw1")
        y = b.bn(y, f"{pfx}_bn1")
        y = b.act(y, "relu", f"{pfx}_r2")
        y = b.dwconv(y, k, 1, "same", use_bias=False, name=f"{pfx}_dw2")
        y = b.conv(y, f, 1, 1, "same", use_bias=False, name=f"{pfx}_pw2")
        return b.bn(y, f"{pfx}_bn2")

    def cell(x: str, f: int, reduce_: bool, pfx: str) -> str:
        s = 2 if reduce_ else 1
        a1 = sep_block(x, f, 3, s, f"{pfx}_a1")
        a2 = sep_block(x, f, 5, s, f"{pfx}_a2")
        a3 = (b.pool(x, "avg", 3, s, "same", f"{pfx}_p")
              if True else x)
        a3 = b.conv(a3, f, 1, 1, "same", use_bias=False, name=f"{pfx}_pc")
        a3 = b.bn(a3, f"{pfx}_pbn")
        y = b.add([a1, a2, a3], f"{pfx}_add")
        return y

    f = 44
    x = cell(x, f, True, "r0")
    for stage in range(3):
        # NASNetMobile concentrates parameters at the last (7x7) stage; the
        # approximation mirrors that with extra low-resolution cells.
        n_cells = 4 if stage < 2 else 21
        for i in range(n_cells):
            x = cell(x, f, False, f"s{stage}c{i}")
        if stage < 2:
            f *= 2
            x = cell(x, f, True, f"red{stage}")
    x = b.conv_bn(x, 1056, 1, 1, "same", "relu", "head")
    x = b.gap(x, "avg_pool")
    b.dense(x, classes, name="predictions")
    return b.build()


# ---------------------------------------------------------------------------
# Registry (paper Table 1)
# ---------------------------------------------------------------------------
REAL_CNNS = {
    "Xception": xception,
    "ResNet50": lambda: resnet("50", v2=False),
    "ResNet50V2": lambda: resnet("50", v2=True),
    "ResNet101": lambda: resnet("101", v2=False),
    "ResNet101V2": lambda: resnet("101", v2=True),
    "ResNet152": lambda: resnet("152", v2=False),
    "ResNet152V2": lambda: resnet("152", v2=True),
    "InceptionV3": inception_v3,
    "InceptionV4": inception_v4,
    "MobileNet": mobilenet,
    "MobileNetV2": mobilenet_v2,
    "InceptionResNetV2": inception_resnet_v2,
    "DenseNet121": lambda: densenet("121"),
    "DenseNet169": lambda: densenet("169"),
    "DenseNet201": lambda: densenet("201"),
    "NASNetMobile": nasnet_mobile_approx,
    "EfficientNetLiteB0": lambda: efficientnet_lite("B0"),
    "EfficientNetLiteB1": lambda: efficientnet_lite("B1"),
    "EfficientNetLiteB2": lambda: efficientnet_lite("B2"),
    "EfficientNetLiteB3": lambda: efficientnet_lite("B3"),
    "EfficientNetLiteB4": lambda: efficientnet_lite("B4"),
}

# Paper Table 1 reference values (params M, MACs M) for validation.
TABLE1 = {
    "Xception": (22.9, 8363), "ResNet50": (25.6, 3864),
    "ResNet50V2": (25.6, 3486), "ResNet101": (44.7, 7579),
    "ResNet101V2": (44.7, 7200), "ResNet152": (60.4, 11294),
    "ResNet152V2": (60.4, 10915), "InceptionV3": (23.9, 5725),
    "InceptionV4": (43.0, 12276), "MobileNet": (4.3, 568),
    "MobileNetV2": (3.5, 300), "InceptionResNetV2": (55.9, 13171),
    "DenseNet121": (8.1, 2835), "DenseNet169": (14.3, 3361),
    "DenseNet201": (20.2, 4292), "NASNetMobile": (5.3, 568),
    "EfficientNetLiteB0": (4.7, 385), "EfficientNetLiteB1": (5.4, 600),
    "EfficientNetLiteB2": (6.1, 859), "EfficientNetLiteB3": (8.2, 1383),
    "EfficientNetLiteB4": (13.0, 2553),
}
