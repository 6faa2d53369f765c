"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert)
vocab=100352; 16 experts top-4 fine-grained.  [hf:databricks/dbrx-base;
unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduce_config

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    moe=MoEConfig(n_routed=16, n_shared=0, top_k=4, d_ff=10752, every=1),
    rope_theta=500_000.0,
    # 132B bf16 exceeds HBM under TP-16 alone: spread weights over the data
    # axis for serving too (see configs/base.py)
    serve_2d_weights=True,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG)
