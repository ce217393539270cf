"""PAA + SAX summarization of data series.

The paper's substrate: every series of length ``n`` is summarized by
Piecewise Aggregate Approximation (PAA) into ``w`` segment means, then each
segment mean is quantized into a 2**c-ary SAX symbol using breakpoints that
equi-partition the standard normal distribution (the iSAX convention).

All functions are pure numpy: the index structures summarize on the host.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np


def _ndtri(p: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (Acklam's rational approximation, ~1e-9
    relative error — ample for SAX breakpoints). Pure numpy so breakpoint
    tables stay concrete host arrays."""
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    p = np.asarray(p, dtype=np.float64)
    x = np.empty_like(p)
    plow, phigh = 0.02425, 1 - 0.02425
    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)
    if lo.any():
        q = np.sqrt(-2 * np.log(p[lo]))
        x[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        )
    if hi.any():
        q = np.sqrt(-2 * np.log(1 - p[hi]))
        x[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        )
    if mid.any():
        q = p[mid] - 0.5
        r = q * q
        x[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
            ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
        )
    return x


@dataclasses.dataclass(frozen=True)
class SummarizationConfig:
    """Configuration of the PAA/SAX summarization.

    series_len: length n of each data series (must be divisible by n_segments)
    n_segments: number of PAA segments w
    card_bits:  bits per SAX symbol c (cardinality 2**c)
    znorm:      z-normalize each series before summarizing (iSAX convention)
    """

    series_len: int = 256
    n_segments: int = 16
    card_bits: int = 8
    znorm: bool = False

    def __post_init__(self):
        if self.series_len % self.n_segments != 0:
            raise ValueError(
                f"series_len {self.series_len} not divisible by n_segments {self.n_segments}"
            )
        if not (1 <= self.card_bits <= 8):
            raise ValueError("card_bits must be in [1, 8]")

    @property
    def cardinality(self) -> int:
        return 1 << self.card_bits

    @property
    def segment_len(self) -> int:
        return self.series_len // self.n_segments

    @property
    def key_bits(self) -> int:
        return self.n_segments * self.card_bits

    @property
    def key_words(self) -> int:
        """Number of uint32 words per sortable key."""
        return (self.key_bits + 31) // 32


@functools.lru_cache(maxsize=32)
def breakpoints(card_bits: int) -> np.ndarray:
    """The 2**c - 1 breakpoints equi-partitioning N(0, 1).

    Symbol s covers the region [bp[s-1], bp[s]) with bp[-1] = -inf and
    bp[2**c - 1] = +inf.
    """
    card = 1 << card_bits
    qs = np.arange(1, card) / card
    return _ndtri(qs).astype(np.float32)


def znormalize(x: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    mu = x.mean(axis=-1, keepdims=True)
    sd = x.std(axis=-1, keepdims=True)
    return (x - mu) / (sd + eps)


def paa(x: np.ndarray, cfg: SummarizationConfig) -> np.ndarray:
    """PAA segment means. x: (..., n) -> (..., w)."""
    if cfg.znorm:
        x = znormalize(x)
    shape = x.shape[:-1] + (cfg.n_segments, cfg.segment_len)
    return x.reshape(shape).mean(axis=-1)


def sax_from_paa(p: np.ndarray, cfg: SummarizationConfig) -> np.ndarray:
    """Quantize PAA values into SAX symbols in [0, 2**c). p: (..., w)."""
    bps = breakpoints(cfg.card_bits)
    return np.searchsorted(bps, p, side="right").astype(np.int32)


def sax(x: np.ndarray, cfg: SummarizationConfig) -> np.ndarray:
    """Full pipeline: series (..., n) -> SAX symbols (..., w)."""
    return sax_from_paa(paa(x, cfg), cfg)


def sax_region(sym: np.ndarray, cfg: SummarizationConfig):
    """Region [lb, ub] per SAX symbol. sym: (..., w) int -> (lb, ub) float32.

    Uses +-1e30 instead of inf so downstream squared arithmetic stays finite
    after the max(0, .) clamp.
    """
    bps = breakpoints(cfg.card_bits)
    big = np.float32(1e30)
    lo = np.concatenate([[-big], bps]).astype(np.float32)
    hi = np.concatenate([bps, [big]]).astype(np.float32)
    return lo[sym], hi[sym]
