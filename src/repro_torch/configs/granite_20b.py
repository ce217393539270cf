"""granite-20b [dense]: llama-arch code model, MQA (kv=1).
[arXiv:2405.04324; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_ff=24576, vocab=49152,
    pattern=("attn",), rope_theta=1e4,
)

SMOKE = ModelConfig(
    arch_id="granite-20b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv=1, d_ff=128, vocab=512,
    pattern=("attn",),
)
