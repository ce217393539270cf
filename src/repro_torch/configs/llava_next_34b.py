"""llava-next-34b [vlm]: mistral-style decoder backbone, anyres vision
frontend STUBBED (input_specs feeds precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480, vocab=64000,
    pattern=("attn",), rope_theta=1e6,
    frontend="vision", n_vis_tokens=576, d_frontend=1152,
    notes="anyres tiling stub: 576 base-image patch embeddings prepended",
)

SMOKE = ModelConfig(
    arch_id="llava-next-34b-smoke", family="vlm",
    n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=512,
    pattern=("attn",), frontend="vision", n_vis_tokens=8, d_frontend=24,
)
