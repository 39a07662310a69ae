"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from ..models.lm import LMConfig
from .common import shrink

ARCH_ID = "phi3.5-moe-42b-a6.6b"
SKIP_SHAPES = {"long_500k": "full-attention arch (MoE FFN does not change "
                            "the KV cache); skipped per assignment "
                            "(see DESIGN.md §6)"}


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab=32064, head_dim=128,
        mlp_kind="swiglu", rope_theta=10_000.0,
        n_experts=16, top_k=2,
    ).validate()


def smoke_config() -> LMConfig:
    return shrink(config(), n_experts=4, top_k=2)
