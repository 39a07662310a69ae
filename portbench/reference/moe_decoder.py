"""The mixture-of-experts decoder of the ``phi35moe-42b`` configuration in
plain PyTorch, fp32: the benchmark's reference, and the weights both sides
are given.

A decoder block, as the configuration states it (its ``assumed`` list
says where that departs from the published Phi-3.5-MoE):

    h = x + attn(rms(x, ln1)) ;  out = h + moe(rms(h, ln2))

* ``rms(x, s) = x / sqrt(mean(x^2) + 1e-6) * (1 + s)``.
* attention: q, k, v, o projections without bias, RoPE of theta
  ``rope_theta`` rotating dims [0, D/2) against [D/2, D) at positions
  0..S-1, causal softmax of q k^T / sqrt(D) in fp32, query head h reading
  key/value head h // (Hq / Hkv).
* moe: an fp32 router, softmax over the experts, the top-k of them with
  their probabilities renormalised (sum + 1e-9); tokens routed in
  contiguous groups of ``moe_group`` tokens of a row, an expert taking at
  most ``cap = min(int(capacity_factor * g * k / E) + 1, g)`` of a group's
  tokens in token order and dropping the rest (GShard); each kept token
  gets ``gate * wd(silu(x wg) * (x wu))`` of each of its experts.
* the embedding's rows in, the final rms norm and an untied head out.

Weights are made here from the seed, one block at a time, in the served
type (bf16, the router fp32), with a ``torch.Generator`` of their own for
each block, so either side can make any block again on its own.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from .numerics import Ops

RMS_EPS = 1e-6


def _seed(seed: int, tag: int) -> int:
    return (int(seed) * 0x9E3779B1 + tag * 1_000_003) % (2 ** 63)


def _norm_rows(m: Dict, device, gen, n: int) -> List[torch.Tensor]:
    """``n`` zero-centred norm scales, 0.1 n, bf16."""
    s = torch.randn((n, m["d_model"]), generator=gen, device=device)
    return list((s * 0.1).to(torch.bfloat16))


def _leaves(m: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of a block's bf16 matrices, in draw order."""
    d, hd, e, f = m["d_model"], m["head_dim"], m["n_experts"], m["d_ff"]
    qd, kvd = m["n_heads"] * hd, m["n_kv_heads"] * hd
    return [("attn.wq", (d, qd), d ** -0.5), ("attn.wk", (d, kvd), d ** -0.5),
            ("attn.wv", (d, kvd), d ** -0.5), ("attn.wo", (qd, d), qd ** -0.5),
            ("mlp.wg", (e, d, f), d ** -0.5), ("mlp.wu", (e, d, f), d ** -0.5),
            ("mlp.wd", (e, f, d), f ** -0.5)]


def make_block(m: Dict, seed: int, layer: int, device) -> Dict:
    """Block ``layer``'s weights in the port's tree (``ln1``, ``attn``,
    ``ln2``, ``mlp``), made on ``device``: every bf16 matrix from one
    normal draw, scaled by fan-in ** -0.5; the fp32 router the same; the
    norm scales 0.1 n."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(_seed(seed, 100 + layer))
    leaves = _leaves(m)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in leaves),
                       generator=gen, device=device)
    off = 0
    for _, s, scale in leaves:
        n = math.prod(s)
        flat[off:off + n].mul_(scale)
        off += n
    flat = flat.to(torch.bfloat16)
    tree: Dict = {"attn": {}, "mlp": {}}
    off = 0
    for path, s, _ in leaves:
        group, key = path.split(".")
        n = math.prod(s)
        tree[group][key] = flat[off:off + n].view(s)
        off += n
    router = torch.randn((m["d_model"], m["n_experts"]), generator=gen,
                         device=device) * m["d_model"] ** -0.5
    tree["mlp"]["router"] = router
    ln1, ln2 = _norm_rows(m, device, gen, 2)
    tree["ln1"], tree["ln2"] = {"scale": ln1}, {"scale": ln2}
    return tree


def make_outer(m: Dict, seed: int, device) -> Dict:
    """The embedding (0.02 n), the final norm and the head (d ** -0.5 n),
    bf16, made on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(_seed(seed, 1))
    v, d = m["vocab"], m["d_model"]
    embed = (torch.randn((v, d), generator=gen, device=device) * 0.02
             ).to(torch.bfloat16)
    head = (torch.randn((d, v), generator=gen, device=device) * d ** -0.5
            ).to(torch.bfloat16)
    (scale,) = _norm_rows(m, device, gen, 1)
    return {"embed": embed, "final_norm": {"scale": scale}, "head": head}


def cast(tree, dtype: torch.dtype = torch.float32):
    """``tree`` (dicts and lists of tensors) with every leaf in ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = (x * x).mean(dim=-1, keepdim=True)
    return x / torch.sqrt(var + RMS_EPS) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=x.dtype,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=x.dtype, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attention(m: Dict, p: Dict, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    bsz, s, d = x.shape
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = rope(ops.mm(x, p["wq"]).view(bsz, s, hq, hd), m["rope_theta"])
    k = rope(ops.mm(x, p["wk"]).view(bsz, s, hkv, hd), m["rope_theta"])
    v = ops.mm(x, p["wv"]).view(bsz, s, hkv, hd)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    out = torch.empty((bsz, s, hq, hd), dtype=x.dtype, device=x.device)
    group = hq // hkv
    for r in range(bsz):
        qr = q[r].transpose(0, 1)                        # (hq, s, hd)
        kr = k[r].transpose(0, 1).repeat_interleave(group, dim=0)
        vr = v[r].transpose(0, 1).repeat_interleave(group, dim=0)
        scores = ops.mm(qr, kr.transpose(1, 2)) * hd ** -0.5
        probs = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
        out[r] = ops.mm(probs, vr).transpose(0, 1)
    return ops.mm(out.reshape(bsz, s, hq * hd), p["wo"])


def moe(m: Dict, p: Dict, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    bsz, s, d = x.shape
    e, k = m["n_experts"], m["top_k"]
    g = min(m["moe_group"], s)
    if s % g:
        raise ValueError(f"sequence {s} is not a multiple of the group {g}")
    xg = x.reshape(-1, g, d)
    cap = min(int(m["capacity_factor"] * g * k / e) + 1, g)
    probs = torch.softmax(ops.mm(xg, p["router"]), dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)                 # (G, g, k)
    vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    out = torch.zeros_like(xg)
    for ex in range(e):
        chosen = idx == ex
        routed = chosen.any(-1)                              # (G, g)
        pos = torch.cumsum(routed.int(), dim=1) - 1
        gi, ti = torch.nonzero(routed & (pos < cap), as_tuple=True)
        if gi.numel() == 0:
            continue
        xe = xg[gi, ti]
        h = F.silu(ops.mm(xe, p["wg"][ex])) * ops.mm(xe, p["wu"][ex])
        gate = (vals * chosen)[gi, ti].sum(-1, keepdim=True)
        out[gi, ti] += gate * ops.mm(h, p["wd"][ex])
    return out.reshape(bsz, s, d)


def block(m: Dict, p: Dict, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    x = x + attention(m, p["attn"], rms(x, p["ln1"]["scale"]), ops)
    return x + moe(m, p["mlp"], rms(x, p["ln2"]["scale"]), ops)


def hidden(m: Dict, seed: int, outer: Dict, tokens: torch.Tensor, device,
           precision: str = "fp32") -> torch.Tensor:
    """(B, S) tokens -> the final-normed (B, S, D) hidden states,
    every block made again from the seed on ``device`` and run there, one
    at a time (``outer``: :func:`make_outer`'s)."""
    ops = Ops(precision)
    x = outer["embed"].to(ops.dtype)[tokens.to(device)]
    for layer in range(m["n_layers"]):
        x = block(m, cast(make_block(m, seed, layer, device), ops.dtype), x,
                  ops)
    return rms(x, outer["final_norm"]["scale"].to(ops.dtype))


def logits_rows(m: Dict, seed: int, tokens: torch.Tensor, device,
                precision: str = "fp32") -> Iterator[torch.Tensor]:
    """The (S, V) logits of each row of ``tokens``, one row at a time
    (float64 in ``fp64``, else float32)."""
    ops = Ops(precision)
    outer = make_outer(m, seed, device)
    h = hidden(m, seed, outer, tokens, device, precision)
    head = outer["head"].to(ops.dtype)
    del outer
    for r in range(h.shape[0]):
        yield ops.mm(h[r], head)
