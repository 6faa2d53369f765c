"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336;
Mamba+attn 1:7 interleave (1 attention layer per 8), MoE 16e top-2 every
other layer.  [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, reduce_config

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    attn_every=8,            # 1:7 attn:mamba
    attn_offset=4,           # attention at layer 4 of each period (jamba)
    moe=MoEConfig(n_routed=16, n_shared=0, top_k=2, d_ff=14336, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    rope_theta=10_000.0,
    # mamba chunked-scan buffers are activation-heavy: halve the microbatch
    # (16 is the max: global batch 256 / data*pod shards) and tighten the
    # scan/attention chunk sizes; spread prefill weights over data
    accum_override=16,
    scan_chunk=64,
    attn_chunk=1024,
    serve_2d_weights=True,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG, attn_every=4, attn_offset=2, n_layers=4)


def _check():
    CONFIG.validate()
