"""minitron-4b [dense] — pruned nemotron: squared-ReLU MLP (non-gated),
huge 256k vocab.  [arXiv:2407.14679; hf]"""
from ..models.lm import LMConfig
from .common import shrink

ARCH_ID = "minitron-4b"
SKIP_SHAPES = {"long_500k": "pure full-attention arch; 512k dense KV cache "
                            "is out of scope per assignment (see DESIGN.md §6)"}


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=9216, vocab=256000, head_dim=128,
        mlp_kind="relu2", rope_theta=10_000.0,
    ).validate()


def smoke_config() -> LMConfig:
    return shrink(config(), n_kv_heads=2)
