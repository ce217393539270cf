"""Architecture registry: --arch <id> resolves here.

Each module exports CONFIG (the exact assigned configuration) and SMOKE
(a reduced same-family twin used by CPU smoke tests)."""
from . import (
    deepseek_moe_16b,
    gemma3_27b,
    granite_20b,
    granite_moe_1b_a400m,
    hubert_xlarge,
    llava_next_34b,
    minicpm3_4b,
    recurrentgemma_9b,
    rwkv6_3b,
    smollm_360m,
)
from .shapes import SHAPES, SMOKE_SHAPES, Shape

__all__ = [
    "SHAPES", "SMOKE_SHAPES", "Shape", "ARCH_IDS", "get_config",
    "cell_is_skipped",
]

_MODULES = {
    "llava-next-34b": llava_next_34b,
    "rwkv6-3b": rwkv6_3b,
    "smollm-360m": smollm_360m,
    "gemma3-27b": gemma3_27b,
    "minicpm3-4b": minicpm3_4b,
    "granite-20b": granite_20b,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "deepseek-moe-16b": deepseek_moe_16b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "hubert-xlarge": hubert_xlarge,
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False):
    mod = _MODULES[arch_id]
    return mod.SMOKE if smoke else mod.CONFIG


# (arch, shape) skips mandated by the pool rules
SUBQUADRATIC = {"rwkv6-3b", "recurrentgemma-9b"}
ENCODER_ONLY = {"hubert-xlarge"}


def cell_is_skipped(arch_id: str, shape_name: str) -> str | None:
    """Returns a skip reason or None if the (arch, shape) cell runs."""
    if arch_id in ENCODER_ONLY and shape_name in ("decode_32k", "long_500k"):
        return "encoder-only: no autoregressive decode step"
    if shape_name == "long_500k" and arch_id not in SUBQUADRATIC:
        return "full-attention arch: 500k decode requires sub-quadratic attention"
    return None
