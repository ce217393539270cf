"""deepseek-moe-16b [moe]: 2 shared + 64 routed top-6 fine-grained experts
(d_expert 1408); layer 0 is a dense MLP (d_ff 10944). [arXiv:2401.06066]"""
from ..models.moe import MoEDims
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=102400,
    pattern=("attn",), first_dense=1, d_ff_dense=10944,
    moe=MoEDims(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    arch_id="deepseek-moe-16b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=48, vocab=512,
    pattern=("attn",), first_dense=1, d_ff_dense=128,
    moe=MoEDims(n_experts=8, top_k=2, d_expert=48, n_shared=1, capacity_factor=8.0),
)
