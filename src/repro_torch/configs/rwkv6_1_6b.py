"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    cite="arXiv:2404.05892",
    d_model=2048,
    num_heads=32,         # rwkv heads = d_model / rwkv_head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    tie_embeddings=False,  # rwkv uses separate head
    segments=(SegmentSpec(body=(BlockSpec(mixer="rwkv6", ffn="rwkv_cmix"),), repeat=24),),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="rwkv6-smoke",
        d_model=256, num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512,
        segments=(SegmentSpec(body=(BlockSpec(mixer="rwkv6", ffn="rwkv_cmix"),), repeat=2),),
    )
