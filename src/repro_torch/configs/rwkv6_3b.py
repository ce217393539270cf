"""rwkv6-3b [ssm] "Finch": attention-free, data-dependent decay WKV6,
chunked/block-parallel formulation. heads = d_model/64. [arXiv:2404.05892]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv=40, d_ff=8960, vocab=65536,
    head_dim=64, pattern=("rwkv",),
    notes="sub-quadratic: O(1) recurrent state; runs long_500k",
)

SMOKE = ModelConfig(
    arch_id="rwkv6-3b-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=224, vocab=512,
    head_dim=16, pattern=("rwkv",),
)
