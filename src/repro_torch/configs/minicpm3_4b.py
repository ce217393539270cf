"""minicpm3-4b [dense]: MLA (multi-head latent attention) with q_lora 768 /
kv_lora 256, rope 32 + nope 64 head split. [hf:openbmb/MiniCPM3-4B; hf]"""
from ..models.attention import MLADims
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv=40, d_ff=6400, vocab=73448,
    pattern=("attn",),
    mla=MLADims(q_lora=768, kv_lora=256, rope_dim=32, nope_dim=64, v_dim=64),
    rope_theta=1e4,
    notes="decode uses the absorbed MLA form: cache = compressed c_kv+k_rope",
)

SMOKE = ModelConfig(
    arch_id="minicpm3-4b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=512,
    pattern=("attn",),
    mla=MLADims(q_lora=32, kv_lora=16, rope_dim=8, nope_dim=16, v_dim=16),
)
