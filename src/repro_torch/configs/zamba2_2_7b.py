"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560, shared attention
block (32H, weight-tied) applied every 6 layers, d_ff=10240 vocab=32000,
ssm_state=64 [arXiv:2411.15242]."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    cite="arXiv:2411.15242",
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    segments=(
        SegmentSpec(
            body=tuple(BlockSpec(mixer="mamba2", ffn="none") for _ in range(6)),
            repeat=9,
            shared_attn=True,
        ),
    ),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-smoke",
        d_model=256, num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512,
        vocab_size=512, ssm_state=16,
        segments=(
            SegmentSpec(
                body=tuple(BlockSpec(mixer="mamba2", ffn="none") for _ in range(2)),
                repeat=1,
                shared_attn=True,
            ),
        ),
    )
