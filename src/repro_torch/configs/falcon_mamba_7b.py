"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16, mamba1 arch.  [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduce_config

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,                  # mamba blocks have no separate MLP
    vocab_size=65024,
    attn_kind="none",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)


def smoke() -> ModelConfig:
    return reduce_config(CONFIG, n_heads=1, n_kv_heads=1, d_ff=0, head_dim=0)
