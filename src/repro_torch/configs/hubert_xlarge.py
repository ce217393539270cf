"""hubert-xlarge [audio]: encoder-only bidirectional transformer (w2v2
arch); frame-embedding frontend STUBBED; masked prediction over 504
codebook targets. decode shapes SKIPPED (no autoregressive step exists).
[arXiv:2106.07447; unverified]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv=16, d_ff=5120, vocab=504,
    pattern=("attn",), encoder_only=True,
    frontend="audio", d_frontend=512,
    notes="vocab 504 padded to 512; encoder-only -> no decode cells",
)

SMOKE = ModelConfig(
    arch_id="hubert-xlarge-smoke", family="audio",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=56,
    pattern=("attn",), encoder_only=True, frontend="audio", d_frontend=24,
)
