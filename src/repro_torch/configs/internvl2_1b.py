"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; InternViT frontend is a STUB (precomputed patch embeddings),
backbone = Qwen2-0.5B-like decoder.  [arXiv:2404.16821; hf]

Sharding note: 14 heads and 151655 vocab do not divide the 16-way model
axis — the resolver's divisibility fallback replicates heads and shards
d_ff / d_model instead (see parallel/sharding.py).
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    frontend="vit_stub",
    n_patches=256,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG, n_heads=2, n_kv_heads=1, n_patches=8)
