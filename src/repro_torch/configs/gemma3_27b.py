"""gemma3-27b [dense]: 5 local (sliding 1024) : 1 global pattern, 128k
context. 62 layers = 10 groups of 6 + 2 trailing local.
[hf:google/gemma-3-1b-pt; unverified]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv=16, d_ff=21504, vocab=262144,
    head_dim=168, window=1024,
    pattern=("local", "local", "local", "local", "local", "attn"),
    rope_theta=1e6,
    notes="long_500k SKIPPED: every 6th layer is full global attention -> "
          "unbounded KV at 524288; not sub-quadratic (see DESIGN.md)",
)

SMOKE = ModelConfig(
    arch_id="gemma3-27b-smoke", family="dense",
    n_layers=8, d_model=48, n_heads=4, n_kv=2, d_ff=96, vocab=512,
    head_dim=12, window=16,
    pattern=("local", "local", "local", "local", "local", "attn"),
)
