#!/usr/bin/env python3
"""Which of the training path's operations need deterministic mode on one
NVIDIA card: the same loss and gradients computed repeatedly, from the same
weights and batch, with ``torch.use_deterministic_algorithms`` off and then
on, and the parameter leaves whose gradients differ between repeats
counted. ``launch/train.py``'s restart-exactness rests on each step being a
fixed function of its inputs; a leaf that differs with the mode off shows
an operation whose sums are ordered at run time (atomics).

    python3 scripts/train_determinism.py [--arch A] [--smoke] [--batch B]
        [--seq-len S] [--top-k K] [--repeats N]

Each case prints one line; the card's name and power limit come first. The
default cases: the MoE archs and smollm-360m at smoke size over 16 x 512
tokens, deepseek-moe-16b's smoke config routed to 6 experts a token as its
full config routes (the smoke config routes to 2), then smollm-360m at full
width over 2 x 4,096 tokens (with the seconds of one loss-and-grad).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

DEFAULT_CASES = [("deepseek-moe-16b", True, 16, 512, None),
                 ("granite-moe-1b-a400m", True, 16, 512, None),
                 ("smollm-360m", True, 16, 512, None), ("deepseek-moe-16b", True, 16, 512, 6),
                 ("smollm-360m", False, 2, 4096, None)]


def run_case(torch, arch, smoke, batch, seq_len, top_k, repeats):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.steps import TrainConfig, make_loss_and_grad
    from repro_torch.models.transformer import init_params

    dev = torch.device("cuda")
    cfg = get_config(arch, smoke=smoke)
    if top_k is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=top_k))
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    pipe = TokenPipeline(PipelineConfig(global_batch=batch, seq_len=seq_len, seed=0), cfg)
    data = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(0).items()}
    lg = make_loss_and_grad(cfg, TrainConfig(remat=True))
    for det in (False, True):
        torch.use_deterministic_algorithms(det)
        outs, secs = [], []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(lg(model, data))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        first = outs[0]
        differ = sorted({n for o in outs[1:] for n, g in o[2].items()
                         if not torch.equal(g, first[2][n])})
        losses = all(torch.equal(o[0], first[0]) for o in outs)
        print(f"[determinism] {arch}{' smoke' if smoke else ''}"
              f"{f' top-{top_k}' if top_k else ''} {batch}x{seq_len} "
              f"deterministic={det}: loss equal over {repeats} repeats {losses}; "
              f"{len(differ)} of {len(first[2])} gradient leaves differ {differ[:4]}; "
              f"loss and grads {min(secs):.3f}-{max(secs):.3f}s", flush=True)
        del outs
    torch.use_deterministic_algorithms(False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one case instead of the defaults")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--top-k", type=int, default=None,
                    help="route an MoE arch to this many experts a token")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_determinism: needs an NVIDIA card")
    # torch's deterministic mode refuses cuBLAS without it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), f"torch {torch.__version__}", flush=True)
    cases = ([(args.arch, args.smoke, args.batch, args.seq_len, args.top_k)] if args.arch
             else DEFAULT_CASES)
    for case in cases:
        run_case(torch, *case, args.repeats)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
