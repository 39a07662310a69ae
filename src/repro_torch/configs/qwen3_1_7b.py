"""qwen3-1.7b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from ..models.lm import LMConfig
from .common import shrink

ARCH_ID = "qwen3-1.7b"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, family="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=6144, vocab=151936, head_dim=128,
        qk_norm=True, mlp_kind="swiglu", rope_theta=1_000_000.0,
        tie_embeddings=True,
    ).validate()


def smoke_config() -> LMConfig:
    return shrink(config(), n_kv_heads=2)
