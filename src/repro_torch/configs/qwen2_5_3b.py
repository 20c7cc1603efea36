"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias [hf:Qwen/Qwen2.5-3B]."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    cite="hf:Qwen/Qwen2.5-3B",
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="dense"),), repeat=36),),
)

# long-context variant: sliding-window attention (window 8192) so the
# 524k-decode shape is sub-quadratic-friendly for this dense arch.
CONFIG_LONG = CONFIG.replace(
    name="qwen2.5-3b-swa",
    segments=(SegmentSpec(body=(BlockSpec(mixer="swa", ffn="dense"),), repeat=36),),
    sliding_window=8192,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2.5-3b-smoke",
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
        segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="dense"),), repeat=2),),
    )
