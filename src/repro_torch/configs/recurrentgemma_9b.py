"""recurrentgemma-9b [hybrid]: (rec, rec, local-attn) pattern; RG-LRU via
associative scan + conv1d(4); MQA local attention window 2048.
38 layers = 12 groups of 3 + 2 trailing rec. [arXiv:2402.19427; unverified]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288, vocab=256000,
    head_dim=256, window=2048, d_rnn=4096,
    pattern=("rec", "rec", "local"),
    notes="sub-quadratic: RG-LRU state + bounded local window; runs long_500k",
)

SMOKE = ModelConfig(
    arch_id="recurrentgemma-9b-smoke", family="hybrid",
    n_layers=5, d_model=48, n_heads=4, n_kv=1, d_ff=96, vocab=512,
    head_dim=12, window=16, d_rnn=48,
    pattern=("rec", "rec", "local"),
)
