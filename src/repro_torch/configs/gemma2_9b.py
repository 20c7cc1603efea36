"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating attention, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec

_BODY = (
    BlockSpec(mixer="swa", ffn="dense", sliding_window=4096),  # local layer
    BlockSpec(mixer="attn", ffn="dense"),                      # global layer
)

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    cite="arXiv:2408.00118",
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    segments=(SegmentSpec(body=_BODY, repeat=21),),
)

# long_500k: native local layers already sub-quadratic; make the global
# layers sliding-window (8192) as the documented long-context variant.
CONFIG_LONG = CONFIG.replace(
    name="gemma2-9b-swa",
    segments=(
        SegmentSpec(
            body=(
                BlockSpec(mixer="swa", ffn="dense", sliding_window=4096),
                BlockSpec(mixer="swa", ffn="dense", sliding_window=8192),
            ),
            repeat=21,
        ),
    ),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-9b-smoke",
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
        vocab_size=512,
        segments=(SegmentSpec(body=_BODY, repeat=1),),
    )
