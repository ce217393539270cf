"""The assigned input-shape set. Every LM arch pairs with all four shapes
(minus documented skips): train_4k lowers train_step; prefill_32k lowers
prefill_step; decode_32k / long_500k lower serve_step (one new token against
a KV cache of seq_len)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# smoke-test (reduced) twins used by tests: same code paths, tiny sizes
SMOKE_SHAPES = {
    "train_4k": Shape("train_4k", 64, 4, "train"),
    "prefill_32k": Shape("prefill_32k", 96, 2, "prefill"),
    "decode_32k": Shape("decode_32k", 96, 2, "decode"),
    "long_500k": Shape("long_500k", 128, 1, "decode"),
}
