"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (vision frontend is a STUB:
the batch carries precomputed patch embeddings).  [arXiv:2409.12191; hf]"""
from ..models.lm import LMConfig
from .common import shrink

ARCH_ID = "qwen2-vl-72b"
SKIP_SHAPES = {"long_500k": "pure full-attention arch; 512k dense KV cache "
                            "(~336 GiB) is out of scope per assignment "
                            "(see DESIGN.md §6)"}


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128,
        qkv_bias=True, mlp_kind="swiglu", rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),       # temporal/h/w slots (sum = hd/2)
        n_patches=1024,                    # stub vision tokens per prompt
    ).validate()


def smoke_config() -> LMConfig:
    return shrink(config(), n_kv_heads=2)
