"""Train / prefill / decode step factories with microbatched grad
accumulation and remat.

The reference computes its cross-entropy in a one-hot einsum form, so that
the vocab axis can stay sharded over a "model" mesh axis. One card has no
such axis: here the label's log-probability is taken with ``torch.gather``.
That is exact (the einsum adds the label's logit to products that are
exactly zero) and saves a (B, S, vocab) f32 one-hot.

Gradients are dicts keyed by the model's parameter names (its
``named_parameters`` order).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import shardctx
from .transformer import ModelConfig, decode_step, forward, logits_fn, prefill


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    lb_loss_weight: float = 0.01  # MoE load-balance aux
    remat: bool = True
    compression: Optional[str] = None  # None | "int8" | "topk"


def _shift_labels(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token labels + validity mask (last position dropped)."""
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask


def _xent(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """Masked mean cross-entropy. Under a sharding context the f32 logits
    are pinned to (DP, None, "model"), where the reference pins its one-hot:
    the vocab axis stays sharded into the logsumexp and the gather."""
    lf = shardctx.constrain(logits.float(), shardctx.DP, None, "model")
    lse = torch.logsumexp(lf, dim=-1)
    # the gathered column keeps its trailing dim until the subtraction: a
    # DTensor gather over a sharded vocab is a masked partial sum, whose
    # reduction masks (..., 1)-shaped values only
    ll = torch.gather(lf, -1, labels.long()[..., None])
    nll = (lse[..., None] - ll)[..., 0] * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: dict, lb_weight: float = 0.01,
            remat: bool = False):
    hidden, lb, _ = forward(params, cfg, batch, remat=remat)
    if cfg.frontend == "audio":
        logits = logits_fn(params, cfg, hidden)
        mask = batch["mask"].float()
        loss = _xent(cfg, logits, batch["targets"], mask)
    elif cfg.frontend == "vision":
        # loss only over the text positions (after the n_vis image tokens)
        text_h = hidden[:, cfg.n_vis_tokens:, :]
        logits = logits_fn(params, cfg, text_h)
        labels, mask = _shift_labels(batch["tokens"])
        loss = _xent(cfg, logits, labels, mask)
    else:
        logits = logits_fn(params, cfg, hidden)
        labels, mask = _shift_labels(batch["tokens"])
        loss = _xent(cfg, logits, labels, mask)
    return loss + lb_weight * lb, {"xent": loss, "lb": lb}


def make_loss_and_grad(cfg: ModelConfig, tcfg: TrainConfig):
    def lg(params, batch):
        """(loss, aux, grads) of ``params`` (a module; differentiating turns
        its parameters' gradients on). A parameter the loss does not reach
        gets a zero gradient, as ``jax.value_and_grad`` gives it."""
        names, leaves = zip(*params.named_parameters())
        for p in leaves:
            p.requires_grad_(True)
        loss, aux = loss_fn(params, cfg, batch, tcfg.lb_loss_weight, tcfg.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, dict(zip(names, grads))

    return lg


def microbatched_grads(cfg: ModelConfig, tcfg: TrainConfig, params, batch: dict,
                       param_gather=None, grad_constrain=None):
    """Grad-accumulate over tcfg.grad_accum microbatches, in a loop.

    batch tensors are (B, ...); B must divide by grad_accum. Grads in f32,
    accumulated as ``acc + g / grad_accum`` and the loss as ``loss /
    grad_accum``, in the reference's order.

    param_gather / grad_constrain (a sharded launch layer's hooks): the
    params are gathered once before the microbatches, and each
    microbatch's grads are constrained before they accumulate.
    """
    g = tcfg.grad_accum
    lg = make_loss_and_grad(cfg, tcfg)
    pg = param_gather(params) if param_gather is not None else params
    shard_g = grad_constrain if grad_constrain is not None else (lambda t: t)

    def f32(grads):
        return shard_g({k: x.float() for k, x in grads.items()})

    if g == 1:
        loss, aux, grads = lg(pg, batch)
        return loss, aux, f32(grads)

    def resh(x):
        b = x.shape[0]
        return x.reshape((g, b // g) + tuple(x.shape[1:]))

    mbatch = {k: resh(v) for k, v in batch.items()}
    acc = shard_g({k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.named_parameters()})
    loss_acc = torch.zeros((), dtype=torch.float32, device=next(params.parameters()).device)
    auxs = []
    for i in range(g):
        loss, aux, grads = lg(pg, {k: v[i] for k, v in mbatch.items()})
        grads = f32(grads)
        acc = {k: a + grads[k] / g for k, a in acc.items()}
        loss_acc = loss_acc + loss / g
        auxs.append(aux)
    aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    return loss_acc, aux, acc


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, optimizer,
                    param_gather=None, grad_constrain=None):
    """optimizer: repro_torch.train.optimizer.AdamW instance. The step
    updates the parameters and the optimizer state in place and returns
    them with the step's metrics (tensors on the parameters' device)."""

    def train_step(params, opt_state, batch, step):
        loss, aux, grads = microbatched_grads(
            cfg, tcfg, params, batch, param_gather, grad_constrain
        )
        params, opt_state, gnorm = optimizer.update(params, grads, opt_state, step)
        metrics = {"loss": loss, "grad_norm": gnorm, **aux}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, token):
        return decode_step(params, cfg, cache, token)

    return serve_step
