"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048; decoder-only over EnCodec tokens (4 codebooks, embeddings
summed, all codebooks predicted per step); frontend STUB per assignment.
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="encodec_stub",
    n_codebooks=4,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG, n_kv_heads=4, n_codebooks=2)
