"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]. 56 heads are not divisible by the
16-way model axis; the sharding solver replicates the head dim (documented
divisibility fallback)."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    cite="hf:Snowflake/snowflake-arctic-base",
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    top_k=2,
    moe_dense_residual=True,
    segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="moe"),), repeat=35),),
)

CONFIG_LONG = CONFIG.replace(
    name="arctic-480b-swa",
    segments=(SegmentSpec(body=(BlockSpec(mixer="swa", ffn="moe"),), repeat=35),),
    sliding_window=8192,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="arctic-smoke",
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
        num_experts=4, top_k=2,
        segments=(SegmentSpec(body=(BlockSpec(mixer="attn", ffn="moe"),), repeat=2),),
    )
