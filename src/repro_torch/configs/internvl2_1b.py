"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2 backbone; the ViT frontend is a STUB
per the brief: ``input_specs`` provides 256 precomputed patch embeddings
(B, 256, 1024) consumed through a trainable projector
[arXiv:2404.16821]. Vocab padded 151655 → 151680."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    cite="arXiv:2404.16821",
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    num_vision_tokens=256,
    segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="dense"),), repeat=24),),
)

CONFIG_LONG = CONFIG.replace(
    name="internvl2-1b-swa",
    segments=(SegmentSpec(body=(BlockSpec(mixer="swa", ffn="dense"),), repeat=24),),
    sliding_window=8192,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="internvl2-smoke",
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
        num_vision_tokens=8,
        segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="dense"),), repeat=2),),
    )
