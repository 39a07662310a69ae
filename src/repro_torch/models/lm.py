"""The LM config and the dense decoder family, in PyTorch.

Ported from ``repro/models/lm.py``: the same :class:`LMConfig` (``dtype`` is
a :class:`torch.dtype`) and the dense forward (embed, RMS norm, q/k/v
projections with qk-norm, half-split RoPE, GQA attention, swiglu MLP,
final norm, tied or untied unembedding).  Parameters are a plain dict
mirroring the JAX tree, except that ``blocks`` is a list with one dict per
layer (the JAX tree stacks them along a leading axis); weights are laid out
``(in, out)`` as there.

Every layer's attention is the CUDA flash kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`) in
``(B, H, S, D)``: the model's ``(B, S, H, D)`` projections are passed as
transposed views, which the kernel reads through their strides.  Only the
dense family with swiglu MLP and no QKV bias is ported; other families and
options raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from . import attention as A

Params = Dict[str, Any]


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


def require_ported(cfg: LMConfig) -> None:
    """Raise for the parts of the LM family this package does not run."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (the dense family is); moe/vlm are the LM-families slice, "
            f"hybrid/ssm/encdec the recurrent and encoder-decoder slice")
    if cfg.qkv_bias or cfg.mlp_kind != "swiglu" or cfg.norm != "rms":
        raise NotImplementedError(
            f"{cfg.name}: qkv_bias={cfg.qkv_bias}, mlp_kind={cfg.mlp_kind!r}, "
            f"norm={cfg.norm!r}: only the dense swiglu / rms / no-bias "
            f"blocks are ported to repro_torch")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _dense_init(shape, dtype, device, generator, scale: Optional[float] = None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, dtype=torch.float32, device=device,
                    generator=generator)
    return (w * s).to(dtype)


def _block_params(cfg: LMConfig, dtype, device, generator) -> Params:
    d, qd, kvd, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    attn = {"wq": _dense_init((d, qd), dtype, device, generator),
            "wk": _dense_init((d, kvd), dtype, device, generator),
            "wv": _dense_init((d, kvd), dtype, device, generator),
            "wo": _dense_init((qd, d), dtype, device, generator)}
    if cfg.qk_norm:
        attn["q_norm"] = torch.zeros(cfg.hd, dtype=dtype, device=device)
        attn["k_norm"] = torch.zeros(cfg.hd, dtype=dtype, device=device)
    return {"ln1": {"scale": torch.zeros(d, dtype=dtype, device=device)},
            "attn": attn,
            "ln2": {"scale": torch.zeros(d, dtype=dtype, device=device)},
            "mlp": {"wg": _dense_init((d, f), dtype, device, generator),
                    "wu": _dense_init((d, f), dtype, device, generator),
                    "wd": _dense_init((f, d), dtype, device, generator)}}


def init_params(cfg: LMConfig, device: torch.device,
                generator: Optional[torch.Generator] = None) -> Params:
    """Random parameters with the reference's shapes, dtypes and init
    scales (not its numbers: the generators differ).  ``generator`` must
    live on ``device``; ``device="meta"`` gives shapes without storage."""
    require_ported(cfg)
    dtype = cfg.dtype
    params: Params = {
        "embed": _dense_init((cfg.vocab, cfg.d_model), dtype, device,
                             generator, scale=0.02),
        "blocks": [_block_params(cfg, dtype, device, generator)
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
               positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention (prefill).  One kernel call covers
    both of the reference's branches (``s <= q_chunk``: full attention,
    else query-chunked): they compute the same function."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q = A.apply_rope(q, positions, cfg.rope_theta)
    k = A.apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True)
    return out.transpose(1, 2).reshape(b, s, cfg.q_dim) @ p["wo"]


def mlp_block(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def block(cfg: LMConfig, bp: Params, x: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    x = x + attn_block(cfg, bp["attn"], A.rms_norm(x, bp["ln1"]["scale"]),
                       positions)
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


def forward(cfg: LMConfig, params: Params, batch: Dict[str, torch.Tensor],
            last_token_only: bool = False) -> torch.Tensor:
    """Full-sequence forward -> fp32 logits (B, S, V), or (B, 1, V) with
    ``last_token_only`` (the prefill serving path).

    batch["tokens"]: (B, S) integer tokens."""
    require_ported(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
    positions = positions_for(x)
    for bp in params["blocks"]:
        x = block(cfg, bp, x, positions)
    if last_token_only:
        x = x[:, -1:]
    return unembed(cfg, params, x)
