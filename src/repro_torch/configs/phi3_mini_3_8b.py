"""phi3-mini-3.8b [dense] — RoPE SwiGLU, MHA (kv == heads).  [arXiv:2404.14219]"""
from ..models.lm import LMConfig
from .common import shrink

ARCH_ID = "phi3-mini-3.8b"
SKIP_SHAPES = {"long_500k": "pure full-attention arch; 512k dense KV cache "
                            "is out of scope per assignment (see DESIGN.md §6)"}


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064, head_dim=96,
        mlp_kind="swiglu", rope_theta=10_000.0,
    ).validate()


def smoke_config() -> LMConfig:
    return shrink(config(), n_kv_heads=4)
