"""recurrentgemma-9b [hybrid] -- RG-LRU + local attention, 1:2 pattern
(layer i % 3 == 2 is windowed attention, window 2048, MQA).
[arXiv:2402.19427]"""
from ..models.lm import LMConfig
from .common import shrink

ARCH_ID = "recurrentgemma-9b"
SKIP_SHAPES = {}            # RG-LRU state + 2048-window cache: long_500k OK


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab=256000, head_dim=256,
        mlp_kind="geglu", rope_theta=10_000.0,
        attn_every=3, local_window=2048, conv_width=4,
        tie_embeddings=True,
    ).validate()


def smoke_config() -> LMConfig:
    return shrink(config())
