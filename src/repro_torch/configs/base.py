"""Configuration system.

Three layers of config:

- :class:`ModelConfig` — architecture description, expressive enough to cover
  every assigned family (dense GQA, MoE, SSM/RWKV6, Mamba2 hybrid,
  encoder-decoder audio, VLM backbone). A model is a sequence of *segments*;
  each segment is a homogeneous stack of blocks executed with
  ``lax.scan`` (weights stacked on a leading ``layers`` axis), which keeps
  HLO size O(1) in depth — essential for the 95-layer dry-runs.
- :class:`TrainConfig` / :class:`ServeConfig` — step parameters.
- :class:`SEBSConfig` — the paper's schedule parameters (b₁, ρ, stage
  compute budgets C₁, γ, optimizer family), see ``repro_torch.core``.
- :class:`MeshConfig` — logical→physical axis rules.

Configs are plain frozen dataclasses: hashable (usable as jit static args)
and serializable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Optional, Tuple

# ---------------------------------------------------------------------------
# Block / segment description
# ---------------------------------------------------------------------------

VISION_EMBED_DIM = 1024  # InternViT output width (stubbed VLM frontend)

MixerKind = Literal["attn", "swa", "mamba2", "rwkv6", "cross_attn_block"]
FFNKind = Literal["dense", "moe", "none", "rwkv_cmix"]


@dataclass(frozen=True)
class BlockSpec:
    """One block = token mixer + FFN. A segment body is a tuple of these."""

    mixer: MixerKind = "attn"
    ffn: FFNKind = "dense"
    # attention-block-only overrides
    sliding_window: Optional[int] = None  # for mixer == "swa"


@dataclass(frozen=True)
class SegmentSpec:
    """``repeat`` iterations of the ``body`` block tuple, scanned.

    ``shared_attn`` (zamba2): a weight-tied full transformer block applied
    at the *start* of every scan iteration, with its weights stored once
    (outside the scanned stack).
    """

    body: Tuple[BlockSpec, ...]
    repeat: int
    shared_attn: bool = False

    @property
    def num_layers(self) -> int:
        return self.repeat * len(self.body)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    cite: str  # provenance: paper / model card

    # transformer core
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: Optional[int] = None  # default: d_model // num_heads
    d_ff: int = 2048
    vocab_size: int = 32000
    vocab_pad_multiple: int = 128  # pad vocab so `model` axis shards cleanly
    segments: Tuple[SegmentSpec, ...] = ()

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_logit_softcap: Optional[float] = None  # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    sliding_window: int = 4096  # window used by "swa" mixers
    attn_chunk: Optional[int] = 1024  # flash-style query chunking for the
    #   pure-JAX path: memory O(S·chunk) instead of O(S²). None → dense
    #   (used by the roofline cost compiles, where while-loop bodies would
    #   be undercounted by XLA cost analysis).

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel w/ MoE
    router_aux_weight: float = 0.01
    moe_capacity_factor: float = 1.25  # per-expert buffer slack (GShard)

    # SSM (mamba2)
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4

    # RWKV6
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: 30 s of audio → 1500 frames post-conv

    # VLM backbone (internvl2): stubbed vision frontend
    num_vision_tokens: int = 0

    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    use_flash_kernel: bool = False  # Pallas path (TPU target; interpret on CPU)
    decode_kernel: str = "xla"  # paged serve attention/sampler: "xla" (gather
    #   + einsum) or "pallas" (kernels/paged_decode; interpret on CPU)
    remat: bool = True
    remat_policy: str = "nothing_saveable"  # see models/blocks.py REMAT_POLICIES
    tp_reduce_scatter: bool = False  # constrain mixer/FFN outputs to the
    #   sequence-parallel sharding so GSPMD emits reduce-scatter (1× wire)
    #   instead of all-reduce (2× wire) at tensor-parallel boundaries
    #   (§Perf hillclimb iteration)
    scan_layers: bool = True  # lax.scan over layers (False → unrolled python
    #   loop; used by the roofline extrapolation compiles, where while-loop
    #   bodies would otherwise be counted once by XLA cost analysis)

    # -- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.segments)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_attention_free(self) -> bool:
        mixers = {b.mixer for s in self.segments for b in s.body}
        return not ({"attn", "swa"} & mixers) and not any(
            s.shared_attn for s in self.segments
        )

    @property
    def supports_long_context(self) -> bool:
        """True if decode cost/state is sub-quadratic-friendly (no unlimited
        full-attention KV growth): SSM, hybrid, or sliding-window variants."""
        for s in self.segments:
            if s.shared_attn:
                continue  # zamba2's shared block is treated as global-but-sparse-in-depth
            for b in s.body:
                if b.mixer == "attn":
                    return False
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (for MODEL_FLOPS roofline term) --------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        d, dff, hd = self.d_model, self.d_ff, self.resolved_head_dim
        q = self.num_heads * hd
        kv = self.num_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d  # q,k,v,o projections
        if self.qkv_bias:
            attn += q + 2 * kv
        dense_ffn = 3 * d * dff  # swiglu
        moe_ffn = self.num_experts * 3 * d * dff + d * self.num_experts
        active_moe = self.top_k * 3 * d * dff + d * self.num_experts
        d_in = self.ssm_expand * d
        nh_ssm = max(d_in // self.ssm_head_dim, 1)
        mamba = (
            d * (2 * d_in + 2 * self.ssm_state + nh_ssm)  # in_proj(x,z), B,C, dt
            + d_in * self.ssm_conv_width
            + d_in * d  # out proj
            + 2 * nh_ssm  # A, D
        )
        rwkv = 4 * d * d + 2 * d * d + d * dff + dff * d + 6 * d  # tmix(r,k,v,g,w,o approx) + cmix

        total = 0
        active = 0
        for seg in self.segments:
            for rep in range(seg.repeat):
                if seg.shared_attn and rep == 0:
                    total += attn + dense_ffn  # tied weights counted once
                for b in seg.body:
                    if seg.shared_attn:
                        active += attn + dense_ffn  # executed every group
                    if b.mixer in ("attn", "swa", "cross_attn_block"):
                        t = attn * (2 if b.mixer == "cross_attn_block" else 1)
                    elif b.mixer == "mamba2":
                        t = mamba
                    elif b.mixer == "rwkv6":
                        t = rwkv
                    else:
                        t = 0
                    total += t
                    active += t
                    if b.ffn == "dense":
                        total += dense_ffn
                        active += dense_ffn
                    elif b.ffn == "moe":
                        total += moe_ffn
                        active += active_moe
                        if self.moe_dense_residual:
                            total += dense_ffn
                            active += dense_ffn
        emb = self.padded_vocab * d
        total += emb + (0 if self.tie_embeddings else emb)
        active += emb + (0 if self.tie_embeddings else emb)
        if self.is_encoder_decoder:
            enc = self.encoder_layers * (attn + dense_ffn)
            total += enc
            active += enc
        return {"total": int(total), "active": int(active)}


# ---------------------------------------------------------------------------
# Mesh / distribution config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """Production mesh description. ``batch_axes`` shard the global batch;
    ``model_axes`` shard weights/heads/experts/vocab."""

    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")
    batch_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @classmethod
    def single_pod(cls) -> "MeshConfig":
        return cls()

    @classmethod
    def multi_pod(cls) -> "MeshConfig":
        return cls(
            shape=(2, 16, 16),
            axis_names=("pod", "data", "model"),
            batch_axes=("pod", "data"),
            model_axes=("model",),
        )

    @classmethod
    def host_local(cls, n: int = 1) -> "MeshConfig":
        """CPU test mesh."""
        return cls(shape=(n, 1), axis_names=("data", "model"), batch_axes=("data",))


# ---------------------------------------------------------------------------
# Train / serve step configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    microbatch: Optional[int] = None  # per-update microbatch for accumulation
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    accum_mode: Literal["psum_each", "deferred"] = "deferred"
    z_loss: float = 0.0
    optimizer: str = "momentum"  # key into repro_torch.optim registry
    momentum: float = 0.9
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 32
    cache_len: int = 32768
    prefill: bool = False  # True → prefill_step, False → decode serve_step


# ---------------------------------------------------------------------------
# SEBS schedule config (the paper's contribution)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SEBSConfig:
    """Stagewise Enlargement of Batch Size (Alg. 1).

    Stage ``s`` (0-indexed): batch ``b_s = b1 * rho**s``, stage compute
    budget (in samples) ``C_s = C1 * rho**s``, learning rate constant,
    proximal coefficient ``gamma`` anchored at the stage initialization.
    """

    b1: int = 128
    C1: int = 128 * 400  # samples in the first stage
    rho: float = 4.0
    num_stages: int = 3
    gamma: float = 1e4  # paper's CIFAR value; inf → plain SGD
    eta: float = 0.5  # constant learning rate across stages
    optimizer: Literal["psgd", "msgd", "adagrad"] = "psgd"
    beta: float = 0.9  # momentum for msgd
    reset_momentum: bool = True  # paper resets momentum each stage
    adagrad_delta: float = 1.0
    adagrad_nu: float = 1.0  # paper uses nu=1 (Lemma 8)
