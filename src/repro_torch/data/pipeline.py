"""Deterministic, resumable, shardable data pipeline.

Every batch is a pure function of (seed, step) — there is no iterator state
to checkpoint: restoring a run at step N regenerates exactly the batches a
non-interrupted run would have seen. Per-host sharding slices the global
batch by host id. Batches are numpy arrays, bit for bit the reference
package's for the same (seed, step, host).

The pipeline also exposes a Coconut hook: any 1-D series view of the stream
(raw feature frames, token-embedding traces) can be teed into a
StreamingIndex for windowed nearest-neighbor exploration of the training
stream — the paper's streaming scenario as a framework feature.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class TokenPipeline:
    """Synthetic token stream for LM training (stateless-resumable)."""

    def __init__(self, cfg: PipelineConfig, model_cfg: ModelConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide by n_hosts")
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.cfg.host_id])
        )

    def batch(self, step: int) -> dict:
        rng = self._rng(step)
        mc = self.model_cfg
        b, s = self.local_batch, self.cfg.seq_len
        z = rng.zipf(1.3, size=(b, s))
        tokens = np.minimum(z - 1, mc.vocab - 1).astype(np.int32)
        out = {"tokens": tokens}
        if mc.frontend == "vision":
            out["tokens"] = tokens[:, : s - mc.n_vis_tokens]
            out["patches"] = rng.standard_normal(
                (b, mc.n_vis_tokens, mc.d_frontend)
            ).astype(np.float32)
        elif mc.frontend == "audio":
            out = {
                "features": rng.standard_normal((b, s, mc.d_frontend)).astype(np.float32),
                "targets": rng.integers(0, mc.vocab, (b, s)).astype(np.int32),
                "mask": (rng.random((b, s)) < 0.5),
            }
        return out

    def series_view(self, batch: dict, series_len: int) -> Optional[np.ndarray]:
        """A 1-D data-series view of the batch for Coconut indexing (the
        exploration hook): audio frames directly; otherwise token-id traces."""
        if "features" in batch:
            x = batch["features"][..., 0]
        else:
            x = batch["tokens"].astype(np.float32)
        s = x.shape[1]
        if s < series_len:
            return None
        n = s // series_len
        return x[:, : n * series_len].reshape(-1, series_len)
