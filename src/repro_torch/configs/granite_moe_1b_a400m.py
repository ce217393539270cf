"""granite-moe-1b-a400m [moe]: 32 experts top-8, fine-grained d_expert 512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from ..models.moe import MoEDims
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512, vocab=49155,
    pattern=("attn",),
    moe=MoEDims(n_experts=32, top_k=8, d_expert=512, n_shared=0),
    notes="vocab 49155 padded to 49280 for the 16-way vocab shard",
)

SMOKE = ModelConfig(
    arch_id="granite-moe-1b-a400m-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=32, vocab=515,
    pattern=("attn",),
    moe=MoEDims(n_experts=8, top_k=2, d_expert=32, n_shared=0, capacity_factor=8.0),
)
