"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) head_dim=128
d_ff=25600 vocab=151936, qk_norm.  [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG)
