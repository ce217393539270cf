"""The training entry point.

Trains ``--arch`` (its smoke config with ``--smoke``) on one device,
``--device``: ``cuda`` unless asked otherwise (without a card that raises),
or ``cpu``. Demonstrates the full fault-tolerance loop: atomic checkpoints,
auto-resume, deterministic data (restart-exact), optional gradient
compression, and a --crash-at flag that kills the process mid-run to prove
recovery.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \\
        --steps 200 --global-batch 8 --seq-len 64 --ckpt-dir /tmp/ck --ckpt-every 50

Restart-exactness (a run resumed from a checkpoint ends bit for bit where
the uninterrupted run ends) needs each step to be a fixed function of its
parameters, optimizer state, batch and step number. What that takes on a
card was measured with ``scripts/train_determinism.py`` (an H100, torch
2.11): with deterministic mode off, repeated gradients of smollm-360m (full
width, 2 x 4,096 tokens) and of the smoke MoE archs (top-2) were bit for
bit equal (the embedding's backward, an accumulating ``index_put_``, runs
a sort-based kernel; a top-2 combine adds two terms into each zeroed row,
which commutes), but with deepseek-moe-16b routed top-6, as its full
config routes, every gradient leaf and the loss differed between repeats:
the MoE combine's ``index_add_`` sums three or more terms a row with
atomics in run-time order. So ``main`` turns on
``torch.use_deterministic_algorithms(True)`` for the run (restored when it
returns), and sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless the
environment has a value (the mode refuses cuBLAS calls without it).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ..configs import get_config
from ..core.verify_engine import resolve_device
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..models.steps import TrainConfig, make_train_step
from ..models.transformer import init_params
from ..train import checkpoint as ckpt
from ..train.optimizer import AdamW, AdamWConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--compression", default=None, choices=[None, "int8", "topk"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="simulate a node failure at this step (exit 17)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default; raises "
                         "without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    """Train; returns the final parameters (the model) and optimizer state,
    the first step run, and each step's metrics (host floats) and wall
    seconds (up to the device finishing the step)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        return _train(args, device)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _train(args, device: torch.device) -> dict:
    cfg = get_config(args.arch, smoke=args.smoke)
    pipe = TokenPipeline(
        PipelineConfig(global_batch=args.global_batch, seq_len=args.seq_len,
                       seed=args.seed), cfg)
    opt = AdamW(AdamWConfig(learning_rate=args.lr, warmup_steps=args.warmup,
                            total_steps=args.steps, compression=args.compression))
    tcfg = TrainConfig(grad_accum=args.grad_accum, remat=True,
                       compression=args.compression)
    step_fn = make_train_step(cfg, tcfg, opt)

    params = init_params(cfg, torch.Generator(device).manual_seed(args.seed), device)
    state = opt.init(params)
    start = 0
    if args.ckpt_dir:
        hit = ckpt.restore_latest(args.ckpt_dir, {"params": params, "opt": state})
        if hit:
            start, tree, _ = hit
            with torch.no_grad():
                for name, p in params.named_parameters():
                    p.copy_(tree["params"][name])
            state = tree["opt"]
            print(f"[train] resumed from step {start}")

    metrics_seen, seconds = [], []
    t0 = time.time()
    for s in range(start, args.steps):
        if s == args.crash_at:
            print(f"[train] simulating node failure at step {s}")
            raise SystemExit(17)
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch(s).items()}
        params, state, metrics = step_fn(params, state, batch, s)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t_step)
        metrics_seen.append(metrics)
        if (s + 1) % args.log_every == 0 or s == start:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            tok_s = args.global_batch * args.seq_len * (s + 1 - start) / (time.time() - t0)
            print(f"[train] step {s+1}/{args.steps} loss={loss:.4f} "
                  f"gnorm={gn:.3f} tok/s={tok_s:.0f}", flush=True)
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, s + 1, {"params": params, "opt": state},
                      extra={"arch": args.arch}, async_write=False)
            print(f"[train] checkpoint @ {s+1}")
    print(f"[train] done in {time.time()-t0:.1f}s")
    return {"cfg": cfg, "params": params, "opt": state, "start": start,
            "metrics": [{k: float(v) for k, v in m.items()} for m in metrics_seen],
            "step_seconds": seconds}


if __name__ == "__main__":
    main()
