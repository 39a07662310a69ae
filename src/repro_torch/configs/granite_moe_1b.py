"""granite-moe-1b-a400m [moe] — 32 experts top-8, tiny per-expert FFN.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from ..models.lm import LMConfig
from .common import shrink

ARCH_ID = "granite-moe-1b-a400m"
SKIP_SHAPES = {"long_500k": "full-attention arch (MoE FFN does not change "
                            "the KV cache); skipped per assignment "
                            "(see DESIGN.md §6)"}


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab=49155, head_dim=64,
        mlp_kind="swiglu", rope_theta=10_000.0,
        n_experts=32, top_k=8, tie_embeddings=True,
    ).validate()


def smoke_config() -> LMConfig:
    return shrink(config(), n_experts=8, top_k=2)
