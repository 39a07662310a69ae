"""The LM config and the dense decoder family, in PyTorch.

Ported from ``repro/models/lm.py``: the same :class:`LMConfig` (``dtype`` is
a :class:`torch.dtype`) and the dense forward (embed, RMS norm, q/k/v
projections with qk-norm, half-split RoPE, GQA attention, swiglu or geglu
MLP, final norm, tied or untied unembedding).  The attention and MLP
blocks also serve the hybrid family's local-attention layers
(:mod:`repro_torch.models.rglru`); the ssm family is
:mod:`repro_torch.models.rwkv6`.  Parameters are a plain dict
mirroring the JAX tree, except that ``blocks`` is a list with one dict per
layer (the JAX tree stacks them along a leading axis); weights are laid out
``(in, out)`` as there.

Every layer's attention is a CUDA kernel: over a sequence the flash kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`) in
``(B, H, S, D)``, the model's ``(B, S, H, D)`` projections passed as
transposed views, which the kernel reads through their strides; for one
decode token against a KV cache the flash-decode kernel
(:func:`repro_torch.kernels.flash_decode.flash_decode`), the ``(B, T, Hkv,
D)`` caches passed the same way.  Caches are written in place (the JAX
module returns updated copies).  The moe, vlm and encdec families, QKV
bias, layer norm and the ungated MLPs are not ported and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def require_ported(cfg: LMConfig, family: Optional[str] = None) -> None:
    """Raise for the parts of the LM families this package does not run;
    ``family``: also raise unless ``cfg`` is of that family."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (the {'/'.join(PORTED_FAMILIES)} families are); moe/vlm "
            f"are the LM-families slice, encdec the encoder-decoder slice")
    if family is not None and cfg.family != family:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} runs through "
                         f"repro_torch.models.api, not the {family!r} "
                         f"module")
    if cfg.family != "ssm" and (cfg.qkv_bias or cfg.norm != "rms" or
                                cfg.mlp_kind not in ("swiglu", "geglu")):
        raise NotImplementedError(
            f"{cfg.name}: qkv_bias={cfg.qkv_bias}, mlp_kind={cfg.mlp_kind!r}, "
            f"norm={cfg.norm!r}: only the swiglu/geglu, rms, no-bias "
            f"attention blocks are ported to repro_torch")


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
    if cfg.qk_norm:
        attn["q_norm"] = torch.zeros(cfg.hd, dtype=dtype, device=device)
        attn["k_norm"] = torch.zeros(cfg.hd, dtype=dtype, device=device)
    return attn


def mlp_params(cfg: LMConfig, dtype, device, generator) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": _dense_init((d, f), dtype, device, generator),
            "wu": _dense_init((d, f), dtype, device, generator),
            "wd": _dense_init((f, d), dtype, device, generator)}


def block_params(cfg: LMConfig, dtype, device, generator) -> Params:
    """One attention + MLP block (RMS-normed)."""
    d = cfg.d_model
    return {"ln1": {"scale": torch.zeros(d, dtype=dtype, device=device)},
            "attn": attn_params(cfg, dtype, device, generator),
            "ln2": {"scale": torch.zeros(d, dtype=dtype, device=device)},
            "mlp": mlp_params(cfg, dtype, device, generator)}


def init_params(cfg: LMConfig, device: torch.device,
                generator: Optional[torch.Generator] = None) -> Params:
    """Random parameters with the reference's shapes, dtypes and init
    scales (not its numbers: the generators differ).  ``generator`` must
    live on ``device``; ``device="meta"`` gives shapes without storage."""
    require_ported(cfg, "dense")
    dtype = cfg.dtype
    params: Params = {
        "embed": _dense_init((cfg.vocab, cfg.d_model), dtype, device,
                             generator, scale=0.02),
        "blocks": [block_params(cfg, dtype, device, generator)
                   for _ in range(cfg.n_layers)],
        "final_norm": {"scale": torch.zeros(cfg.d_model, dtype=dtype,
                                            device=device)},
    }
    if not cfg.tie_embeddings:
        params["head"] = _dense_init((cfg.d_model, cfg.vocab), dtype, device,
                                     generator)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _qkv(cfg: LMConfig, p: Params, x: torch.Tensor):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = A.rms_norm(q, p["q_norm"])
        k = A.rms_norm(k, p["k_norm"])
    return q, k, v


def attn_block(cfg: LMConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor,
               cache_rows: Optional[KVRows] = None,
               window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence causal attention (prefill).  One kernel call covers
    both of the reference's branches (``s <= q_chunk``: full attention,
    else query-chunked): they compute the same function.

    ``cache_rows`` (one sequence, B = 1): a decode slot's ``(T, Hkv, D)``
    K and V caches, whose first S rows take the post-RoPE k/v in place.
    ``window`` (a local-attention layer): the kernel masks keys at or
    before ``qpos - window``, the reference's ``full_attention`` mask."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q = A.apply_rope(q, positions, cfg.rope_theta)
    k = A.apply_rope(k, positions, cfg.rope_theta)
    if cache_rows is not None:
        cache_rows[0][:s].copy_(k[0])
        cache_rows[1][:s].copy_(v[0])
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
    device; ``positions``: (B, 1) or (1, 1) RoPE positions.

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
    q = A.apply_rope(q, positions, cfg.rope_theta)
    k = A.apply_rope(k, positions, cfg.rope_theta)
    k_cache[write] = k[write[0], 0]
    v_cache[write] = v[write[0], 0]
    out = flash_decode(q[:, 0], k_cache[:, lo:].transpose(1, 2),
                       v_cache[:, lo:].transpose(1, 2), cache_len)
    return out.reshape(b, 1, cfg.q_dim) @ p["wo"]


def mlp_block(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP: swiglu, or geglu with JAX's default tanh-approximate
    GELU."""
    if cfg.mlp_kind == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh")
    else:
        h = F.silu(x @ p["wg"])
    return (h * (x @ p["wu"])) @ p["wd"]


def block(cfg: LMConfig, bp: Params, x: torch.Tensor,
          positions: torch.Tensor,
          cache_rows: Optional[KVRows] = None) -> torch.Tensor:
    x = x + attn_block(cfg, bp["attn"], A.rms_norm(x, bp["ln1"]["scale"]),
                       positions, cache_rows)
    return x + mlp_block(cfg, bp["mlp"], A.rms_norm(x, bp["ln2"]["scale"]))


def block_decode(cfg: LMConfig, bp: Params, x: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len,
                 positions: torch.Tensor, write: Tuple) -> torch.Tensor:
    """One decoder block of one decode step; see :func:`attn_block_decode`."""
    x = x + attn_block_decode(cfg, bp["attn"],
                              A.rms_norm(x, bp["ln1"]["scale"]), k_cache,
                              v_cache, cache_len, positions, write)
    return x + mlp_block(cfg, bp["mlp"], A.rms_norm(x, bp["ln2"]["scale"]))


def embed_tokens(cfg: LMConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    embed = params["embed"]
    return embed[tokens.to(embed.device)]


def unembed(cfg: LMConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = A.rms_norm(x, params["final_norm"]["scale"])
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x @ w).float()


def positions_for(x: torch.Tensor) -> torch.Tensor:
    """Default positions (1, S) of a (B, S, D) activation."""
    return torch.arange(x.shape[1], device=x.device)[None, :]


def forward_hidden(cfg: LMConfig, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Post-block hidden states (B, S, d_model): pair with
    :func:`unembed`."""
    require_ported(cfg, "dense")
    x = embed_tokens(cfg, params, batch["tokens"])
    positions = positions_for(x)
    for bp in params["blocks"]:
        x = block(cfg, bp, x, positions)
    return x


def forward(cfg: LMConfig, params: Params, batch: Dict[str, torch.Tensor],
            last_token_only: bool = False) -> torch.Tensor:
    """Full-sequence forward -> fp32 logits (B, S, V), or (B, 1, V) with
    ``last_token_only`` (the prefill serving path).

    batch["tokens"]: (B, S) integer tokens."""
    x = forward_hidden(cfg, params, batch)
    if last_token_only:
        x = x[:, -1:]
    return unembed(cfg, params, x)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------
def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: torch.device) -> Params:
    """Zero K/V caches (n_layers, B, T, Hkv, D) in the model dtype, and the
    valid length 0."""
    require_ported(cfg, "dense")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "len": 0}


def forward_decode(cfg: LMConfig, params: Params, tokens: torch.Tensor,
                   cache: Params) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> fp32 logits (B, 1, V) and the cache
    with its length advanced; the K/V tensors are updated in place."""
    require_ported(cfg, "dense")
    x = embed_tokens(cfg, params, tokens)
    n = cache["len"] + 1
    pos = torch.full((1, 1), n - 1, device=x.device)
    write = (slice(None), n - 1)
    for i, bp in enumerate(params["blocks"]):
        x = block_decode(cfg, bp, x, cache["k"][i], cache["v"][i], n, pos,
                         write)
    return unembed(cfg, params, x), {**cache, "len": n}
