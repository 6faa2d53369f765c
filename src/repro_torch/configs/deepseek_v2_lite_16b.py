"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 (expert dim)
vocab=102400; MLA kv_lora=512; MoE 64 routed top-6 + 2 shared; first layer
dense.  [arXiv:2405.04434; hf]

Note (DESIGN.md §8): the assignment string pins "MoE 64e top-6"; the HF card
has 160 routed. We follow the assignment string (64 routed) and keep the MLA
dims from the note.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, reduce_config

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,              # dense (first) layer ffn dim
    vocab_size=102400,
    attn_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff=1408,
                  every=1, first_dense=1),
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG, d_ff=128)
