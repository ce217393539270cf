"""smollm-360m [dense]: llama-arch small, GQA kv=5.
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv=5, d_ff=2560, vocab=49152,
    pattern=("attn",), rope_theta=1e4,
)

SMOKE = ModelConfig(
    arch_id="smollm-360m-smoke", family="dense",
    n_layers=3, d_model=60, n_heads=3, n_kv=1, d_ff=160, vocab=512,
    pattern=("attn",),
)
