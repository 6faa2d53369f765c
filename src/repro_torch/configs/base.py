"""Configuration system (a framework-free copy of the JAX package's).

Two kinds of configs:
  * ``ModelConfig`` — architecture definition (one per assigned arch in
    ``repro_torch.configs.<id>``). A single unified decoder stack covers the dense /
    MoE / hybrid / SSM / VLM / audio families via the per-layer pattern fields.
  * ``ShapeConfig`` — the assigned input-shape cells (train_4k, prefill_32k,
    decode_32k, long_500k).

Every arch module exposes ``CONFIG`` (full size, dry-run only) and ``smoke()``
(reduced same-family config that runs a real step on CPU).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 0              # routed experts (0 = no MoE anywhere)
    n_shared: int = 0              # always-on shared experts (DeepSeek style)
    top_k: int = 1
    d_ff: int = 0                  # per-expert hidden dim (0 -> model d_ff)
    every: int = 1                 # MoE layer every `every` layers (jamba: 2)
    first_dense: int = 0           # leading dense layers (deepseek: 1)
    capacity_factor: float = 1.25  # token-dropping capacity factor
    router_jitter: float = 0.0
    # dispatch formulation: "grouped" keeps the scatter/gather local to each
    # batch row (GSPMD-friendly: the expert redistribution lowers to an
    # all-to-all); "global" is the naive whole-batch scatter that GSPMD can
    # only partition by full rematerialization (kept for the §Perf ablation)
    dispatch: str = "grouped"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 256
    qk_norm: bool = False
    attn_kind: str = "gqa"         # gqa | mla | none
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    # hybrid (jamba): attention mixer every `attn_every` layers (at offset
    # `attn_offset` within each period); all other mixers are Mamba blocks.
    attn_every: int = 0            # 0 -> attention everywhere (none if ssm)
    attn_offset: int = 0
    # modality frontend ("" | "vit_stub" | "encodec_stub")
    frontend: str = ""
    n_codebooks: int = 1           # audio: EnCodec codebooks, emb summed
    n_patches: int = 256           # vlm: stub image patch embs per sample
    # numerics / memory policy
    dtype: str = "bfloat16"        # activation/param dtype for full configs
    # dtype of the materialized attention score/prob buffers in the blocked
    # softmax (running max/denominator stay f32).  Kept f32 by default: the
    # bf16 variant was REFUTED by measurement (§Perf qwen3 iteration A —
    # extra converts break producer-consumer fusion and add traffic).
    score_dtype: str = "float32"
    remat_policy: str = "nothing"  # nothing | dots | everything(=no remat)
    # two-level (sqrt-L) remat: the layer stack runs as scan(groups) x
    # scan(blocks) with the OUTER body checkpointed, so only group-boundary
    # activations are saved.  0 = auto (largest divisor <= sqrt(n_blocks));
    # 1 = flat single-level scan (the §Perf ablation baseline).
    remat_groups: int = 0
    # whether blocks inside a group are ALSO checkpointed ("full": 3rd
    # forward pass per block during its segment's backward, minimal memory)
    # or not ("none": 2 passes, transient segment internals in memory)
    remat_inner: str = "full"
    attn_chunk: int = 2048         # kv-block size for chunked attention
    scan_chunk: int = 128          # mamba chunked-scan inner length
    use_pallas: bool = False       # TPU target: Pallas kernels for attn / scan
    # decode runs the block stack UNROLLED with per-block (unstacked) caches:
    # donation then aliases every cache in place, removing the scan-carry
    # double-buffer copies that dominate decode traffic (§Perf jamba
    # long_500k iteration).  Scan is kept for train/prefill (compile size).
    decode_unroll: bool = True
    # per-arch grad-accumulation override for train cells (0 = shape default);
    # activation-heavy archs (jamba's mamba scan buffers) need more.
    accum_override: int = 0
    # serve cells: also spread parameters over the data axis (2D weight
    # sharding).  Required when params_bf16 / model_axis exceeds HBM
    # (dbrx-132b: 16.5 GiB resident under TP-16 alone).
    serve_2d_weights: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm.dt_rank or -(-self.d_model // 16)

    @property
    def moe_d_ff(self) -> int:
        return self.moe.d_ff or self.d_ff

    def mixer_kind(self, layer_idx: int) -> str:
        """'attn' | 'mamba' for layer `layer_idx`."""
        if self.attn_kind == "none":
            return "mamba"
        if self.attn_every <= 1:
            return "attn"
        return ("attn" if layer_idx % self.attn_every == self.attn_offset
                else "mamba")

    def mlp_kind(self, layer_idx: int) -> str:
        """'dense' | 'moe' for layer `layer_idx`."""
        if self.moe.n_routed == 0 or layer_idx < self.moe.first_dense:
            return "dense"
        phase = (layer_idx - self.moe.first_dense) % self.moe.every
        return "moe" if phase == 0 else "dense"

    @property
    def is_recurrent(self) -> bool:
        """True if the arch has any SSM layers (sub-quadratic decode)."""
        return self.family in ("ssm", "hybrid")

    # Super-block period for scan-over-layers: the stack is a scan over
    # n_layers // period identical blocks of `period` layers.
    @property
    def block_period(self) -> int:
        p = 1
        if self.attn_every > 1:
            p = self.attn_every
        if self.moe.n_routed and self.moe.every > 1:
            import math
            p = p * self.moe.every // math.gcd(p, self.moe.every)
        return p

    def validate(self) -> None:
        body = self.n_layers - self.moe.first_dense
        assert body % self.block_period == 0, (
            f"{self.name}: {body} body layers not divisible by period "
            f"{self.block_period}")
        if self.attn_kind == "gqa":
            assert self.n_heads % self.n_kv_heads == 0


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode
    accum_steps: int = 1          # grad-accumulation microbatch count (train)


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train", accum_steps=8)
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Assigned shape cells for an arch. ``long_500k`` needs sub-quadratic
    attention: run for SSM/hybrid archs, skip for pure full-attention archs
    (skip recorded in DESIGN.md / EXPERIMENTS.md)."""
    cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.is_recurrent:
        cells.append(LONG_500K)
    return tuple(cells)


# ---------------------------------------------------------------------------
# Reduced ("smoke") config helper
# ---------------------------------------------------------------------------


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving reduction for CPU smoke tests."""
    period = cfg.block_period
    small = dict(
        n_layers=max(period, 2) + cfg.moe.first_dense,
        d_model=64,
        n_heads=4,
        n_kv_heads=(min(cfg.n_kv_heads, 2)
                    if cfg.n_kv_heads < cfg.n_heads else 4),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        score_dtype="float32",
        attn_chunk=64,
        scan_chunk=16,
    )
    if cfg.moe.n_routed:
        # capacity_factor = E makes C >= T*k: no token dropping at smoke scale,
        # so cached decode exactly matches the full forward in tests.
        small["moe"] = replace(cfg.moe, n_routed=4,
                               n_shared=min(cfg.moe.n_shared, 1),
                               top_k=2, d_ff=64, capacity_factor=4.0)
    if cfg.family in ("ssm", "hybrid"):
        small["ssm"] = replace(cfg.ssm, d_state=8)
    if cfg.attn_kind == "mla":
        small["mla"] = MLAConfig(kv_lora_rank=32, rope_head_dim=8,
                                 nope_head_dim=16, v_head_dim=16)
        small["head_dim"] = 0
    small.update(overrides)
    out = replace(cfg, **small)
    out.validate()
    return out


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=4, kind="train")
