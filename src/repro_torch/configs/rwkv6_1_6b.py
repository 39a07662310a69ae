"""rwkv6-1.6b [ssm] "Finch" -- attention-free, data-dependent decay,
constant-size WKV state.  [arXiv:2404.05892]"""
from ..models.lm import LMConfig
from .common import shrink

ARCH_ID = "rwkv6-1.6b"
SKIP_SHAPES = {}            # O(1) state decode: long_500k OK


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab=65536, head_dim=64, rwkv_head_dim=64,
        mlp_kind="relu2", norm="layer",
    ).validate()


def smoke_config() -> LMConfig:
    return shrink(config())
