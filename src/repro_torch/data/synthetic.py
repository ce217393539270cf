"""Synthetic data generators.

Data-series generators mirror the paper's demo datasets: random-walk series
("synthetic" in the GUI), astronomy-like periodic mixtures (scenario 1) and
seismic burst streams a la IRIS (scenario 2). Token/feature generators feed
the LM training substrate.
"""
from __future__ import annotations

import numpy as np


def random_walk(n: int, length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, length)).astype(np.float32).cumsum(axis=1)


def astronomy(n: int, length: int, seed: int = 0) -> np.ndarray:
    """Periodic light-curve-like mixtures: sinusoids + transient dips/bursts."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length, dtype=np.float32)
    freq = rng.uniform(1, 12, (n, 1)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, (n, 1)).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    base = amp * np.sin(2 * np.pi * freq * t[None, :] + phase)
    # transient events (supernova-like rise/decay) on ~20% of series
    has_event = rng.random(n) < 0.2
    c = rng.uniform(0.2, 0.8, (n, 1)).astype(np.float32)
    wdt = rng.uniform(0.02, 0.1, (n, 1)).astype(np.float32)
    ev = 3.0 * np.exp(-np.square(t[None, :] - c) / (2 * wdt ** 2))
    base = base + has_event[:, None] * ev
    return (base + 0.1 * rng.standard_normal((n, length))).astype(np.float32)


def seismic(n: int, length: int, seed: int = 0, quake_frac: float = 0.1) -> np.ndarray:
    """Seismic-like streams: low noise floor with rare high-energy bursts
    (exponentially decaying oscillation — the 'earthquake' pattern)."""
    rng = np.random.default_rng(seed)
    t = np.arange(length, dtype=np.float32)
    noise = 0.05 * rng.standard_normal((n, length)).astype(np.float32)
    is_q = rng.random(n) < quake_frac
    onset = rng.integers(0, max(1, length // 2), n)
    f = rng.uniform(0.05, 0.25, (n, 1)).astype(np.float32)
    decay = rng.uniform(0.01, 0.05, (n, 1)).astype(np.float32)
    rel = t[None, :] - onset[:, None]
    burst = np.where(
        rel >= 0,
        np.exp(-decay * np.maximum(rel, 0)) * np.sin(2 * np.pi * f * np.maximum(rel, 0)),
        0.0,
    ).astype(np.float32)
    return noise + is_q[:, None] * burst


def token_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int) -> np.ndarray:
    """Zipfian token ids — heavy-tailed like natural text."""
    z = rng.zipf(1.3, size=(batch, seq))
    return np.minimum(z - 1, vocab - 1).astype(np.int32)
