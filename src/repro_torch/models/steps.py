"""Prefill and decode step factories (the serving half of the reference's
``models/steps.py``; the training half comes with the training substrate)."""
from __future__ import annotations

from .transformer import ModelConfig, decode_step, prefill


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, token):
        return decode_step(params, cfg, cache, token)

    return serve_step
