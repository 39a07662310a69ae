"""qwen2.5-14b [dense] — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from ..models.lm import LMConfig
from .common import shrink

ARCH_ID = "qwen2.5-14b"
SKIP_SHAPES = {"long_500k": "pure full-attention arch; 512k dense KV cache "
                            "is out of scope per assignment (see DESIGN.md §6)"}


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab=152064, head_dim=128,
        qkv_bias=True, mlp_kind="swiglu", rope_theta=1_000_000.0,
    ).validate()


def smoke_config() -> LMConfig:
    return shrink(config(), n_kv_heads=2)
