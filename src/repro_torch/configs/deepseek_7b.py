"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954]."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    cite="arXiv:2401.02954",
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="dense"),), repeat=30),),
)

CONFIG_LONG = CONFIG.replace(
    name="deepseek-7b-swa",
    segments=(SegmentSpec(body=(BlockSpec(mixer="swa", ffn="dense"),), repeat=30),),
    sliding_window=8192,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-7b-smoke",
        d_model=256, num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512,
        segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="dense"),), repeat=2),),
    )
