"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    cite="hf:databricks/dbrx-base",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    top_k=4,
    segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="moe"),), repeat=40),),
)

CONFIG_LONG = CONFIG.replace(
    name="dbrx-132b-swa",
    segments=(SegmentSpec(body=(BlockSpec(mixer="swa", ffn="moe"),), repeat=40),),
    sliding_window=8192,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="dbrx-smoke",
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
        num_experts=4, top_k=2,
        segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="moe"),), repeat=2),),
    )
