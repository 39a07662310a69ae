"""The LM config and the attention decoder families, in PyTorch.

Ported from ``repro/models/lm.py``: the same :class:`LMConfig` (``dtype`` is
a :class:`torch.dtype`) and the forward of the dense, moe and vlm families
(embed, RMS or layer norm, q/k/v projections with optional bias and
qk-norm, half-split RoPE or qwen2-vl's M-RoPE, GQA attention, a swiglu,
geglu, relu^2 or gelu MLP or the grouped GShard mixture of experts, final
norm, tied or untied unembedding; vlm prepends patch embeddings).  The
attention and MLP blocks also serve the hybrid family's local-attention
layers (:mod:`repro_torch.models.rglru`); the ssm family is
:mod:`repro_torch.models.rwkv6`, the encdec family
:mod:`repro_torch.models.whisper`.  Parameters are a plain dict mirroring the
JAX tree, except that ``blocks`` is a list with one dict per layer (the JAX
tree stacks them along a leading axis); weights are laid out ``(in, out)``
as there.

Every layer's attention is a CUDA kernel: over a sequence the flash kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`) in
``(B, H, S, D)``, the model's ``(B, S, H, D)`` projections passed as
transposed views, which the kernel reads through their strides; for one
decode token against a KV cache the flash-decode kernel
(:func:`repro_torch.kernels.flash_decode.flash_decode`), the ``(B, T, Hkv,
D)`` caches passed the same way.  Caches are written in place (the JAX
module returns updated copies).  The mixture of experts is plain
``torch.einsum`` products, as the reference's are outside any kernel.

Training: :func:`lm_loss` and :func:`moe_aux_loss` are the reference's
losses; with ``cfg.remat`` :func:`forward_hidden` recomputes each block in
the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``), and attention differentiates through the
flash-attention kernel's backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_decode import flash_decode
from . import attention as A

Params = Dict[str, Any]
KVRows = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                   # dense | moe | vlm | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    mlp_kind: str = "swiglu"      # swiglu | geglu | relu2 | gelu
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False
    norm: str = "rms"             # rms | layer
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 512
    # --- hybrid (recurrentgemma / griffin) ---
    attn_every: int = 0
    local_window: int = 2048
    conv_width: int = 4
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 1500
    # --- vlm (qwen2-vl) ---
    mrope_sections: Tuple[int, ...] = ()
    n_patches: int = 0
    # --- rwkv ---
    rwkv_head_dim: int = 64
    # --- numerics / memory ---
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    q_chunk: int = 1024
    seq_shard_acts: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def validate(self) -> "LMConfig":
        assert self.n_heads % max(1, self.n_kv_heads) == 0, "GQA group size"
        if self.family == "moe":
            assert self.n_experts > 0 and 0 < self.top_k <= self.n_experts
        if self.family == "vlm":
            assert self.mrope_sections and sum(self.mrope_sections) == self.hd // 2
        if self.family == "hybrid":
            assert self.attn_every >= 2
        return self


# the families of this module (the reference's ``_ATTN_FAMILIES``)
ATTN_FAMILIES = ("dense", "moe", "vlm")
PORTED_FAMILIES = ATTN_FAMILIES + ("ssm", "hybrid", "encdec")


def require_ported(cfg: LMConfig, families=None) -> None:
    """Raise for an LM family this package does not run (every family of
    the reference runs); ``families`` (a family or a tuple of them): also
    raise unless ``cfg`` is of one."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"(the {'/'.join(PORTED_FAMILIES)} families are)")
    if isinstance(families, str):
        families = (families,)
    if families is not None and cfg.family not in families:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} runs through "
                         f"repro_torch.models.api, not the module of "
                         f"{'/'.join(families)}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _dense_init(shape, dtype, device, generator, scale: Optional[float] = None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, dtype=torch.float32, device=device,
                    generator=generator)
    return (w * s).to(dtype)


def attn_params(cfg: LMConfig, dtype, device, generator) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    attn = {"wq": _dense_init((d, qd), dtype, device, generator),
            "wk": _dense_init((d, kvd), dtype, device, generator),
            "wv": _dense_init((d, kvd), dtype, device, generator),
            "wo": _dense_init((qd, d), dtype, device, generator)}
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros(qd, dtype=dtype, device=device)
        attn["bk"] = torch.zeros(kvd, dtype=dtype, device=device)
        attn["bv"] = torch.zeros(kvd, dtype=dtype, device=device)
    if cfg.qk_norm:
        attn["q_norm"] = torch.zeros(cfg.hd, dtype=dtype, device=device)
        attn["k_norm"] = torch.zeros(cfg.hd, dtype=dtype, device=device)
    return attn


def mlp_params(cfg: LMConfig, dtype, device, generator) -> Params:
    """The moe family's fp32 router and (E, d, f) / (E, f, d) expert
    stacks; else a gated MLP's wg, wu, wd or an ungated one's wu, wd."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family == "moe":
        e = cfg.n_experts
        return {"router": _dense_init((d, e), torch.float32, device,
                                      generator),
                "wg": _dense_init((e, d, f), dtype, device, generator),
                "wu": _dense_init((e, d, f), dtype, device, generator),
                "wd": _dense_init((e, f, d), dtype, device, generator)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"wg": _dense_init((d, f), dtype, device, generator),
                "wu": _dense_init((d, f), dtype, device, generator),
                "wd": _dense_init((f, d), dtype, device, generator)}
    return {"wu": _dense_init((d, f), dtype, device, generator),
            "wd": _dense_init((f, d), dtype, device, generator)}


def norm_params(cfg: LMConfig, dtype, device) -> Params:
    d = cfg.d_model
    if cfg.norm == "layer":
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    return {"scale": torch.zeros(d, dtype=dtype, device=device)}


def block_params(cfg: LMConfig, dtype, device, generator) -> Params:
    """One attention + MLP block."""
    return {"ln1": norm_params(cfg, dtype, device),
            "attn": attn_params(cfg, dtype, device, generator),
            "ln2": norm_params(cfg, dtype, device),
            "mlp": mlp_params(cfg, dtype, device, generator)}


def init_params(cfg: LMConfig, device: torch.device,
                generator: Optional[torch.Generator] = None,
                keep_on: Optional[torch.device] = None) -> Params:
    """Random parameters with the reference's shapes, dtypes and init
    scales (not its numbers: the generators differ).  ``generator`` must
    live on ``device``; ``device="meta"`` gives shapes without storage.
    ``keep_on``: each piece (the embedding, a block, the head) moves there
    once it is made, so that a model no card holds is made on the card a
    block at a time and kept on the host, with the numbers it has when
    made on ``device``."""
    require_ported(cfg, ATTN_FAMILIES)
    dtype = cfg.dtype

    def keep(tree: Params) -> Params:
        if keep_on is None:
            return tree
        if isinstance(tree, dict):
            return {k: keep(v) for k, v in tree.items()}
        return tree.to(keep_on)

    params: Params = {
        "embed": keep(_dense_init((cfg.vocab, cfg.d_model), dtype, device,
                                  generator, scale=0.02)),
        "blocks": [keep(block_params(cfg, dtype, device, generator))
                   for _ in range(cfg.n_layers)],
        "final_norm": keep(norm_params(cfg, dtype, device)),
    }
    if not cfg.tie_embeddings:
        params["head"] = keep(_dense_init((cfg.d_model, cfg.vocab), dtype,
                                          device, generator))
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _norm(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layer":
        return A.layer_norm(x, p["scale"], p["bias"])
    return A.rms_norm(x, p["scale"])


def _qkv(cfg: LMConfig, p: Params, x: torch.Tensor):
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = A.rms_norm(q, p["q_norm"])
        k = A.rms_norm(k, p["k_norm"])
    return q, k, v


def _rope_qk(cfg: LMConfig, q: torch.Tensor, k: torch.Tensor,
             positions: torch.Tensor):
    """RoPE, or for vlm M-RoPE over (3, ..., S) positions."""
    if cfg.family == "vlm":
        return (A.apply_mrope(q, positions, cfg.mrope_sections,
                              cfg.rope_theta),
                A.apply_mrope(k, positions, cfg.mrope_sections,
                              cfg.rope_theta))
    return (A.apply_rope(q, positions, cfg.rope_theta),
            A.apply_rope(k, positions, cfg.rope_theta))


def attn_block(cfg: LMConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor,
               cache_rows: Optional[KVRows] = None,
               window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence causal attention (prefill).  One kernel call covers
    both of the reference's branches (``s <= q_chunk``: full attention,
    else query-chunked): they compute the same function.

    ``cache_rows``: ``(B, T, Hkv, D)`` K and V caches (a decode slot's
    ``(1, T, Hkv, D)``), whose first S rows take the post-RoPE k/v in
    place.
    ``window`` (a local-attention layer): the kernel masks keys at or
    before ``qpos - window``, the reference's ``full_attention`` mask."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions)
    if cache_rows is not None:
        cache_rows[0][:, :s].copy_(k)
        cache_rows[1][:, :s].copy_(v)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True, window=window)
    return out.transpose(1, 2).reshape(b, s, cfg.q_dim) @ p["wo"]


def attn_block_decode(cfg: LMConfig, p: Params, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      cache_len, positions: torch.Tensor,
                      write: Optional[Tuple] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode.

    x: (B, 1, d_model); caches (B, T, Hkv, D), written in place: the new
    post-RoPE k/v go to ``cache[write]`` from batch rows ``write[0]``
    (``(slice(None), n - 1)`` for a whole batch at one position, or
    ``(rows, positions)`` index tensors for the decode engine's active
    slots).  ``cache_len``: an int or a (B,) int32 tensor on the caches'
    device; ``positions``: (B, 1) or (1, 1) RoPE positions ((3, B, 1) or
    (3, 1, 1) for vlm).

    ``window`` (a local-attention layer; ``cache_len`` an int, ``write``
    unused): the reference's ring cache of T = min(max_len, window) rows.
    The new token goes to slot (len - 1) mod T and attention covers
    min(len, T) rows; softmax over a set of keys does not depend on their
    order and RoPE is applied before the write, so flash-decode over those
    rows computes the ring exactly.  A caller-built linear cache of T rows
    above the window takes the new token at (len - 1) mod T, as the
    reference does, and attends positions [len - window, len), the
    reference's ``decode_attention(window=)`` mask: flash-decode reads
    that contiguous run of rows as a view."""
    b = x.shape[0]
    lo = 0                                          # first row attended
    if window is not None:
        t = k_cache.shape[1]
        write = (slice(None), (cache_len - 1) % t)
        if t > window:
            lo = min(max(cache_len - window, 0), t)
        cache_len = min(cache_len, t) - lo
    q, k, v = _qkv(cfg, p, x)                       # S == 1
    q, k = _rope_qk(cfg, q, k, positions)
    k_cache[write] = k[write[0], 0]
    v_cache[write] = v[write[0], 0]
    out = flash_decode(q[:, 0], k_cache[:, lo:].transpose(1, 2),
                       v_cache[:, lo:].transpose(1, 2), cache_len)
    return out.reshape(b, 1, cfg.q_dim) @ p["wo"]


def mlp_block(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The moe family's :func:`moe_block`; else swiglu, geglu, relu^2
    (``square(relu(x wu))``) or gelu, the GELUs JAX's default
    tanh-approximate one."""
    if cfg.family == "moe":
        return moe_block(cfg, p, x)
    kind = cfg.mlp_kind
    if kind == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    elif kind == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wu"])
    elif kind == "relu2":
        h = torch.square(F.relu(x @ p["wu"]))
    else:
        h = F.gelu(x @ p["wu"], approximate="tanh")
    return h @ p["wd"]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes, by comparison with
    ``arange(n)``: ``F.one_hot``'s values, in the same ops on every
    device (on the CPU ``F.one_hot`` reads the indices' range on the host,
    on the card it scatters, on ``meta`` it compares), so a step's counted
    ops (``launch/op_analysis.py``) are the card's."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_block(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The reference's grouped GShard dense dispatch: tokens route within
    contiguous groups of ``moe_group`` tokens (S a multiple of the group),
    each expert taking at most ``cap`` tokens of a group in order; a token
    past an expert's capacity is dropped there.  Router, softmax, top-k,
    the gate renormalisation and the dispatch product in fp32; the expert
    products in the model dtype."""
    bb, ss, d = x.shape
    g = min(cfg.moe_group, ss)
    assert ss % g == 0, (ss, g)
    x = x.reshape(bb * (ss // g), g, d)
    s = x.shape[1]
    e, k = cfg.n_experts, cfg.top_k
    cap = min(int(cfg.capacity_factor * s * k / e) + 1, s)

    probs = torch.softmax(x.float() @ p["router"], dim=-1)   # (B,S,E)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)       # (B,S,k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # one-hot dispatch with capacity: position of each token within its
    # expert, the top-k choices folded into one (B,S,E) weight
    onehot = _one_hot(gate_idx, e)                           # (B,S,k,E)
    combine_w = torch.einsum("bske,bsk->bse", onehot, gate_vals)
    assign = onehot.amax(dim=2)                              # (B,S,E) 0/1
    pos_in_expert = torch.cumsum(assign, dim=1) * assign - 1
    keep = (pos_in_expert >= 0) & (pos_in_expert < cap)
    slot = pos_in_expert.clamp(0, cap - 1).long()
    dispatch = _one_hot(slot, cap) * keep[..., None]         # (B,S,E,C)
    combine = dispatch * combine_w[..., None]

    xt = torch.einsum("bsec,bsd->ebcd", dispatch, x.float()).to(x.dtype)
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xt, p["wg"])) * \
        torch.einsum("ebcd,edf->ebcf", xt, p["wu"])
    y = torch.einsum("ebcf,efd->ebcd", h, p["wd"])            # (E,B,C,D)
    out = torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), y)
    return out.reshape(bb, ss, d)


def moe_aux_loss(cfg: LMConfig, logits: torch.Tensor,
                 gate_idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: ``E * sum_e me_e ce_e``
    of the router's mean probability ``me`` and the share of top-k choices
    ``ce`` of each expert (the reference's, which no train step adds)."""
    e = cfg.n_experts
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.reshape(-1, e).mean(0)
    ce = F.one_hot(gate_idx.reshape(-1).long(), e).float().mean(0)
    return e * torch.sum(me * ce)


def block(cfg: LMConfig, bp: Params, x: torch.Tensor,
          positions: torch.Tensor,
          cache_rows: Optional[KVRows] = None) -> torch.Tensor:
    x = x + attn_block(cfg, bp["attn"], _norm(cfg, bp["ln1"], x),
                       positions, cache_rows)
    return x + mlp_block(cfg, bp["mlp"], _norm(cfg, bp["ln2"], x))


def block_decode(cfg: LMConfig, bp: Params, x: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len,
                 positions: torch.Tensor, write: Tuple) -> torch.Tensor:
    """One decoder block of one decode step; see :func:`attn_block_decode`."""
    x = x + attn_block_decode(cfg, bp["attn"], _norm(cfg, bp["ln1"], x),
                              k_cache, v_cache, cache_len, positions, write)
    return x + mlp_block(cfg, bp["mlp"], _norm(cfg, bp["ln2"], x))


def embed_tokens(cfg: LMConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    embed = params["embed"]
    return embed[tokens.to(embed.device)]


def unembed(cfg: LMConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = _norm(cfg, params["final_norm"], x)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x @ w).float()


def positions_for(cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """Default positions of a (B, S, D) activation: (1, S), or for vlm
    the (3, B, S) broadcast of the same (every stream the index)."""
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    if cfg.family == "vlm":
        return pos[None].expand(3, x.shape[0], x.shape[1])
    return pos


def forward_hidden(cfg: LMConfig, params: Params,
                   batch: Dict[str, torch.Tensor],
                   cache: Optional[Params] = None) -> torch.Tensor:
    """Post-block hidden states (B, S, d_model): pair with
    :func:`unembed`.  vlm: ``batch["embeds"]`` (B, P, d_model), when
    given, goes before the token embeddings; ``batch["positions"]``, when
    given, replaces :func:`positions_for`.  ``cache`` (:func:`init_cache`'s,
    of B rows): every layer's post-RoPE K/V go into its rows [0, S), in
    place.

    With ``cfg.remat``, while autograd records the blocks (grad mode on
    and the hidden state requiring grad, as it does once the embedding or
    any weight before the block does), each block runs under
    :func:`torch.utils.checkpoint.checkpoint` (non-reentrant), as the
    reference's ``jax.checkpoint``: only its input is kept, and the
    backward recomputes its forward, attention kernel included."""
    require_ported(cfg, ATTN_FAMILIES)
    x = embed_tokens(cfg, params, batch["tokens"])
    if cfg.family == "vlm" and "embeds" in batch:
        x = torch.cat([batch["embeds"].to(x.device, x.dtype), x], dim=1)
    positions = (batch["positions"].to(x.device) if "positions" in batch
                 else positions_for(cfg, x))
    for i, bp in enumerate(params["blocks"]):
        if (cache is None and cfg.remat and torch.is_grad_enabled()
                and x.requires_grad):
            x = checkpoint(block, cfg, bp, x, positions, use_reentrant=False)
            continue
        rows = None if cache is None else (cache["k"][i], cache["v"][i])
        x = block(cfg, bp, x, positions, rows)
    return x


def forward(cfg: LMConfig, params: Params, batch: Dict[str, torch.Tensor],
            last_token_only: bool = False) -> torch.Tensor:
    """Full-sequence forward -> fp32 logits (B, S, V), or (B, 1, V) with
    ``last_token_only`` (the prefill serving path).

    batch["tokens"]: (B, S) integer tokens; for vlm batch["embeds"] (B, P,
    d_model) is prepended and positions are (3, B, P + S)."""
    x = forward_hidden(cfg, params, batch)
    if last_token_only:
        x = x[:, -1:]
    return unembed(cfg, params, x)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32; labels (B, S) integers; ``mask``
    (B, S) weights the tokens (the mean over its sum, at least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------
def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: torch.device) -> Params:
    """Zero K/V caches (n_layers, B, T, Hkv, D) in the model dtype, and the
    valid length 0."""
    require_ported(cfg, ATTN_FAMILIES)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "len": 0}


def prefill(cfg: LMConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache: Params, last_token_only: bool = False
            ) -> Tuple[torch.Tensor, Params]:
    """A prompt batch (as :func:`forward`'s) into an empty cache: the
    forward's fp32 logits, and the cache with the prompt's K/V in its rows
    [0, S) of every layer (in place) and its length S.  Decode steps then
    continue at position S."""
    if cache["len"] != 0:
        raise ValueError(f"prefill fills an empty cache; this one holds "
                         f"{cache['len']} positions")
    x = forward_hidden(cfg, params, batch, cache)
    n = x.shape[1]
    if last_token_only:
        x = x[:, -1:]
    return unembed(cfg, params, x), {**cache, "len": n}


def forward_decode(cfg: LMConfig, params: Params, tokens: torch.Tensor,
                   cache: Params) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> fp32 logits (B, 1, V) and the cache
    with its length advanced; the K/V tensors are updated in place.  The
    new token's position is the cache length (for vlm on all three M-RoPE
    streams, as the reference's)."""
    require_ported(cfg, ATTN_FAMILIES)
    x = embed_tokens(cfg, params, tokens)
    n = cache["len"] + 1
    pos = torch.full((1, 1), n - 1, device=x.device)
    if cfg.family == "vlm":
        pos = pos[None].expand(3, 1, 1)
    write = (slice(None), n - 1)
    for i, bp in enumerate(params["blocks"]):
        x = block_decode(cfg, bp, x, cache["k"][i], cache["v"][i], n, pos,
                         write)
    return unembed(cfg, params, x), {**cache, "len": n}
