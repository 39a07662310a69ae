"""whisper-tiny [audio] -- encoder-decoder backbone; the conv audio frontend
is a stub (the caller supplies precomputed frame embeddings).
[arXiv:2212.04356]"""
from ..models.lm import LMConfig
from .common import shrink

ARCH_ID = "whisper-tiny"
SKIP_SHAPES = {"long_500k": "full-attention enc-dec; 512k decoder cache is "
                            "out of scope per assignment (see DESIGN.md §6)"}


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, family="encdec",
        n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab=51865, head_dim=64,
        mlp_kind="gelu", norm="layer", n_frames=1500, tie_embeddings=True,
    ).validate()


def smoke_config() -> LMConfig:
    return shrink(config())
