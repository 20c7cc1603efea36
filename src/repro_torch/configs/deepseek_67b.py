"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch [arXiv:2401.02954]."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    cite="arXiv:2401.02954",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="dense"),), repeat=95),),
)

CONFIG_LONG = CONFIG.replace(
    name="deepseek-67b-swa",
    segments=(SegmentSpec(body=(BlockSpec(mixer="swa", ffn="dense"),), repeat=95),),
    sliding_window=8192,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-67b-smoke",
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
        segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="dense"),), repeat=2),),
    )
