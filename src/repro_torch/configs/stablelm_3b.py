"""stablelm-3b [dense] — 32L d_model=2560 32H (kv=32, i.e. MHA) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b family; unverified]"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG, n_kv_heads=4)
