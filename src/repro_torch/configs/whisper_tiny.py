"""whisper-tiny [audio]: 4L encoder + 4L decoder, d_model=384 6H
d_ff=1536 vocab=51865 — encoder-decoder; mel/conv frontend is a STUB per
the brief: ``input_specs`` provides precomputed frame embeddings
(B, 1500, 384) [arXiv:2212.04356]. Vocab padded 51865 → 51968 so the
model axis shards. long_500k is SKIPPED for this arch (enc-dec, 448-pos
decoder; see DESIGN.md)."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    cite="arXiv:2212.04356",
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=4,
    encoder_seq=1500,
    tie_embeddings=True,
    segments=(SegmentSpec(body=(BlockSpec(mixer="cross_attn_block", ffn="dense"),), repeat=4),),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-smoke",
        d_model=128, num_heads=2, num_kv_heads=2, d_ff=256, vocab_size=512,
        encoder_layers=2, encoder_seq=64,
        segments=(SegmentSpec(body=(BlockSpec(mixer="cross_attn_block", ffn="dense"),), repeat=2),),
    )
