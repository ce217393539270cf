"""Inputs made from the seed, on the device.

A frozen torch copy of ``repro_torch.data.synthetic.seismic``: a low noise
floor with rare exponentially decaying bursts (scenario 2 of Coconut Palm,
after IRIS seismic traces), each series then z-normalized as the data series
collections it stands in for are (iSAX, the Hydra benchmark). Every row stream is cut into fixed chunks and
each chunk is drawn by its own generator, seeded from (seed, stream label,
chunk number), so a row's values depend on the seed and its position only:
the program's feed and the reference regenerate the same rows in any order.
"""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch


def subseed(seed: int, label: str, index: int) -> int:
    """A 63-bit generator seed for one chunk of one labelled stream."""
    words = np.random.SeedSequence(
        [int(seed) % (1 << 64), zlib.crc32(label.encode()), int(index)]
    ).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def seismic(n: int, length: int, gen: torch.Generator, device,
            quake_frac: float = 0.1) -> torch.Tensor:
    """(n, length) float32 seismic-like series drawn from ``gen``, each
    z-normalized (mean 0, population standard deviation 1)."""
    t = torch.arange(length, dtype=torch.float32, device=device)
    noise = 0.05 * torch.randn((n, length), generator=gen, device=device)
    is_q = torch.rand((n,), generator=gen, device=device) < quake_frac
    onset = torch.randint(0, max(1, length // 2), (n,), generator=gen,
                          device=device)
    f = 0.05 + 0.2 * torch.rand((n, 1), generator=gen, device=device)
    decay = 0.01 + 0.04 * torch.rand((n, 1), generator=gen, device=device)
    rel = t[None, :] - onset[:, None].to(torch.float32)
    relc = rel.clamp_min(0.0)
    burst = torch.exp(-decay * relc) * torch.sin(2 * math.pi * f * relc)
    burst = torch.where(rel >= 0, burst, torch.zeros_like(burst))
    x = noise + is_q[:, None].to(torch.float32) * burst
    sd, mean = torch.std_mean(x, dim=1, correction=0, keepdim=True)
    return (x - mean) / sd


class RowStream:
    """Rows ``[lo, hi)`` of one labelled stream, generated chunk by chunk
    on ``device`` and kept on the host once made."""

    def __init__(self, seed: int, label: str, length: int, device,
                 chunk_rows: int, quake_frac: float = 0.1):
        self.seed, self.label, self.length = seed, label, length
        self.device = torch.device(device)
        self.chunk_rows = chunk_rows
        self.quake_frac = quake_frac
        self._chunks: dict[int, np.ndarray] = {}

    def device_chunk(self, c: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(subseed(self.seed, self.label, c))
        return seismic(self.chunk_rows, self.length, gen, self.device,
                       self.quake_frac)

    def chunk(self, c: int) -> np.ndarray:
        if c not in self._chunks:
            self._chunks[c] = self.device_chunk(c).cpu().numpy()
        return self._chunks[c]

    def rows(self, lo: int, hi: int) -> np.ndarray:
        """Host float32 rows ``[lo, hi)``, one array (a fresh copy)."""
        out = np.empty((hi - lo, self.length), np.float32)
        self.fill(out, lo)
        return out

    def fill(self, out: np.ndarray, lo: int) -> None:
        """Write rows ``[lo, lo + len(out))`` into ``out``."""
        hi, cr = lo + out.shape[0], self.chunk_rows
        for c in range(lo // cr, -(-hi // cr)):
            a, b = max(lo, c * cr), min(hi, (c + 1) * cr)
            out[a - lo:b - lo] = self.chunk(c)[a - c * cr:b - c * cr]

    def device_rows(self, lo: int, hi: int) -> torch.Tensor:
        """Rows ``[lo, hi)`` made again on the device, never cached."""
        cr, parts = self.chunk_rows, []
        for c in range(lo // cr, -(-hi // cr)):
            a, b = max(lo, c * cr), min(hi, (c + 1) * cr)
            parts.append(self.device_chunk(c)[a - c * cr:b - c * cr])
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def drop(self, below: int) -> None:
        """Forget host chunks wholly below row ``below``."""
        for c in [c for c in self._chunks if (c + 1) * self.chunk_rows <= below]:
            del self._chunks[c]
