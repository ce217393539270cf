#!/usr/bin/env python3
"""Time the three screens (``ops.screen_select`` over f32 and bf16 tables,
``ops.screen_select_quant`` over int8) on one NVIDIA card, each at five
shapes of the kernel phase and the serving pass, and the ``topk_ed``,
``min_ed``, ``paa`` and ``sax_pack`` kernels beside them (``topk_ed`` also
at k = 1 at ``min_ed``'s shapes: the slate route to the same answer;
``paa`` and ``sax_pack`` at the query path's 16 rows and over 1,024,000
rows of the seismic table, w = 16, c = 8); optionally of another source
tree of the port, so that two builds compare on one card.

    python3 scripts/bench_screen_quant.py [--tree DIR] [--label NAME]
        [--others] [--only NAME,...] [--save FILE] [--compare FILE]

``--tree`` is a checkout (or ``git archive``) of the repository whose
``src/repro_torch`` is measured; its kernels are built into its own
``build/``. Tables and queries are made on the card from fixed seeds, so two
runs on one card get the same inputs: ``--save`` keeps every kernel output
and ``--compare`` reports, per shape, whether the outputs of an earlier run
are equal bit for bit. Each case is first held against the plain version
within the engine's certificate bound (``chip_smoke.Case.check``), or bit
for bit (``paa``, ``sax_pack``).
Kernel times are the profiler's device time per launch of the kernels named
in ``KERNELS`` (and of the memsets, logged apart); ``library`` is the
PyTorch yardstick of ``chip_smoke.py``. ``--only`` keeps the cases whose
name contains one of the given words (e.g. ``--others --only paa``). The
launch floor, a one-element elementwise kernel's device time in the same
timing, is measured last. Prints one line per case and, last, a JSON object
of all of them.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the device kernels of the wrappers, in every build of the port so far
KERNELS = ("screen_partial_kernel", "slate_merge_kernel", "screen_quant_kernel",
           "screen_dense_kernel", "topk_ed_kernel", "min_ed_kernel",
           "min_ed_unpack_kernel", "sax_pack_kernel", "paa_kernel")
SUMMARY_ROWS = 1_024_000  # the seismic set of chip_smoke.py's serve phases
TABLE_ROWS = 1 << 20
D = 256
S = 13


def device_split(torch, fn, reps):
    """Device ms per launch of each kernel in KERNELS (and memsets) that
    ``fn`` launches, from the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            continue
        name = next((k for k in KERNELS if k in e.key), None)
        if name is None and "memset" in e.key.lower():
            name = "memset"
        if name is not None and e.self_device_time_total > 0:
            total[name] += e.self_device_time_total
            count[name] += e.count
    return {k: total[k] / 1e3 / count[k] for k in total}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--others", action="store_true",
                    help="also the topk_ed, min_ed, paa and sax_pack kernels")
    ap.add_argument("--only", default=None,
                    help="comma-separated words: keep the cases whose name holds one")
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_screen_quant: needs an NVIDIA card")
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.core import SummarizationConfig
    from repro_torch.kernels import _build, ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[{args.label}] {smi}; ops from {ops.__file__}", flush=True)
    _build.library()
    for ln in _build.BUILD_LOG.splitlines():
        if any(w in ln for w in ("screen_", "topk_ed", "min_ed", "sax_pack", "paa",
                                 "registers", "spill")):
            print(f"[{args.label}] ptxas: {ln.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    xc = cs.seismic_table(torch, TABLE_ROWS, D, gen, dev)
    perm = torch.randperm(TABLE_ROWS, generator=gen, device=dev)
    q = {m: (xc[torch.randint(0, TABLE_ROWS, (m,), generator=gen, device=dev)]
             + 0.01 * torch.randn((m, D), generator=gen, device=dev)).contiguous()
         for m in (16, 64)}
    rows = {16384: perm[:16384], 49152: perm[:49152], None: None}
    cases = [(f"{kind} {what}", kind, m, n)
             for kind in ("int8", "f32", "bf16")
             for what, m, n in (("serving m=16 n=16384/2^20", 16, 16384),
                                ("m=16 n=49152/2^20", 16, 49152),
                                ("m=16 full 2^20", 16, None),
                                ("m=64 n=49152/2^20", 64, 49152),
                                ("m=64 full 2^20", 64, None))]
    if args.others:
        cases += [("topk_ed m=1 n=32768", "topk", 1, 32768),
                  ("topk_ed m=64 full 2^20", "topk", 64, None),
                  ("min_ed m=16 full 2^20", "min_ed", 16, None),
                  ("min_ed m=64 full 2^20", "min_ed", 64, None),
                  ("topk_ed k=1 m=16 full 2^20", "topk1", 16, None),
                  ("topk_ed k=1 m=64 full 2^20", "topk1", 64, None),
                  ("paa 16 rows", "paa", 16, None),
                  ("paa 1024000 rows", "paa", SUMMARY_ROWS, None),
                  ("sax_pack 16 rows", "sax_pack", 16, None),
                  ("sax_pack 1024000 rows", "sax_pack", SUMMARY_ROWS, None)]
    if args.only:
        cases = [c for c in cases if any(w in c[0] for w in args.only.split(","))]
    summary_cfg = SummarizationConfig(series_len=D, n_segments=16, card_bits=8)
    stored = {}
    saved, results = {}, []
    earlier = torch.load(args.compare) if args.compare else {}
    for name, kind, m, n in cases:
        if kind in ("int8", "f32", "bf16"):
            if kind not in stored:
                stored.clear()
                stored[kind] = cs.stored(torch, xc, kind)
            table, scale, xn2 = stored[kind]
            case = cs.Case(torch, ops, ref, q[m], table, scale, xn2, rows[n], S)
            err, share, ndiff = case.check()
            check = f"max|delta d2| {err:.3e} ({share:.2e} of the bound), {ndiff} swapped"
        elif kind in ("topk", "topk1"):
            x = xc if n is None else xc[perm[:n]].contiguous()
            qq = q[16][:1].contiguous() if m == 1 else q[m]
            case = cs.TopkCase(torch, ops, ref, qq, x, S if kind == "topk" else 1)
            err, share, ndiff = case.check()
            check = f"max|delta d2| {err:.3e} ({share:.2e} of the bound), {ndiff} swapped"
        elif kind in ("paa", "sax_pack"):
            x = xc[:m] if kind == "paa" else ref.paa_ref(xc[:m], 16).contiguous()
            case = cs.SummarizeCase(torch, ops, ref, kind, x, summary_cfg)
            err = cs.case_error(torch, case)
            check = f"max|kernel - plain| {err:.3e}"
            if err != 0:
                raise SystemExit(f"bench_screen_quant: {name} differs from its plain version")
        else:
            case = cs.MinEdCase(torch, ops, ref, q[m], xc)
            err, share, ndiff, _ = case.check()
            check = f"max|delta d2| {err:.3e} ({share:.2e} of the bound), {ndiff} swapped"
        out = case.kernel()
        torch.cuda.synchronize()
        saved[name] = [t.cpu() for t in (out if isinstance(out, tuple) else (out,))]
        same = None
        if name in earlier:
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(saved[name], earlier[name]))
        split = device_split(torch, case.kernel, args.reps)
        kernel_ms = sum(v for k, v in split.items() if k != "memset")
        call_ms = cs.events_ms(torch, case.kernel, args.reps)
        library_ms = cs.events_ms(torch, case.library, 10)
        bound_ms, bound_by = case.bound()
        r = {"case": name, "tree": args.label, "kernel_ms": kernel_ms, "split_ms": split,
             "call_ms": call_ms, "library_ms": library_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "check": check, "bitwise_equal_to_compare": same}
        results.append(r)
        print(f"[{args.label}] {name}: kernel {kernel_ms:.4f} ms "
              f"({', '.join(f'{k} {v:.4f}' for k, v in split.items())}), call "
              f"{call_ms:.4f}, library {library_ms:.4f}, bound {bound_ms:.4f} "
              f"({bound_by}); {check}; bitwise = compare: {same}", flush=True)
        del case
    one = torch.zeros(1, device=dev)
    floor_ms, _ = cs.kernel_device_ms(torch, lambda: one.add_(1.0), args.reps,
                                      ("elementwise_kernel",))
    print(f"[{args.label}] launch floor (a one-element elementwise kernel): "
          f"{floor_ms} ms", flush=True)
    if args.save:
        Path(args.save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(saved, args.save)
    print(json.dumps({"device": smi, "launch_floor_ms": floor_ms, "results": results}))
    return 0 if all(not math.isnan(r["kernel_ms"]) for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
