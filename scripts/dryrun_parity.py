#!/usr/bin/env python3
"""The port's dry run beside the reference's, cell for cell, on a CPU
host with both packages (the reference needs JAX; the port's dry run runs
on fake tensors, ``--device cpu``).

    python3 scripts/dryrun_parity.py [--shapes S,...] [--meshes single,multi]
        [--variant baseline] [--out DIR]
    python3 scripts/dryrun_parity.py --hlo SHAPE [--mesh single]
    python3 scripts/dryrun_parity.py --port-collectives SHAPE [--groups 2]

The first form runs ``python -m repro.launch.dryrun`` and ``python -m
repro_torch.launch.dryrun`` for smollm-360m's cells (one process each,
started together) and prints, per cell, memory per device (args + temp)
and collective bytes and counts by kind, reference beside port, with the
ratios. ``--hlo`` lowers one reference cell in this process and lists its
compiled collectives by kind, shape and replica groups, with their loop
multiplicity, and its largest non-collective outputs (what XLA's
temporaries hold). ``--port-collectives`` traces one port cell at
``--groups`` groups and lists its collectives by kind, local shape, dtype
and the model code that issued them.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ARCH = "smollm-360m"


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")


def table(shapes: str, meshes: list, variant: str, out: Path) -> None:
    procs = {}
    for mesh in meshes:
        for pkg in ("repro", "repro_torch"):
            cmd = [sys.executable, "-m", f"{pkg}.launch.dryrun", "--arch", ARCH,
                   "--shape", shapes, "--mesh", mesh, "--variant", variant,
                   "--out", str(out / pkg)]
            if pkg == "repro_torch":
                cmd += ["--device", "cpu"]
            log = open(out / f"{pkg}-{mesh}.log", "w")
            procs[(pkg, mesh)] = (subprocess.Popen(cmd, env=_env(), stdout=log,
                                                   stderr=subprocess.STDOUT), time.time())
    for (pkg, mesh), (p, t0) in procs.items():
        rc = p.wait()
        print(f"# {pkg} {mesh}: exit {rc} after {time.time() - t0:.1f} s", flush=True)
    suffix = "" if variant == "baseline" else f"_{variant}"
    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")
    print("cell | GB/dev ref (args + temp) | GB/dev port (args + temp) | ratio | "
          + " | ".join(f"{k} GB ref / port (count)" for k in kinds))
    for mesh in meshes:
        for shape in shapes.split(","):
            name = f"{ARCH}__{shape}__{mesh}{suffix}.json"
            try:
                r = json.loads((out / "repro" / name).read_text())
                p = json.loads((out / "repro_torch" / name).read_text())
            except FileNotFoundError as e:
                print(f"{shape} {mesh}: missing {e.filename}")
                continue
            rm, pm = r["mem_per_device"], p["mem_per_device"]
            cols = []
            for k in kinds:
                rc, pc = r["collectives"].get(k, {}), p["collectives"].get(k, {})
                cols.append(f"{rc.get('bytes', 0) / 1e9:.4f} / {pc.get('bytes', 0) / 1e9:.4f} "
                            f"({rc.get('count', 0)} / {pc.get('count', 0)})")
            print(f"{shape} {mesh} | {rm['total_gb']} ({rm['args_bytes'] / 1e9:.3f} + "
                  f"{rm['temp_bytes'] / 1e9:.3f}) | {pm['total_gb']} "
                  f"({pm['args_bytes'] / 1e9:.3f} + {pm['temp_bytes'] / 1e9:.3f}) | "
                  f"{pm['total_gb'] / rm['total_gb']:.3f} | " + " | ".join(cols)
                  + f" | total coll ratio {p['collective_bytes_per_device'] / max(r['collective_bytes_per_device'], 1):.3f}"
                  + f" | port traced {p['lower_s']} s", flush=True)


def reference_hlo(shape: str, mesh: str, big: float) -> None:
    """The reference's compiled collectives and large outputs of one cell."""
    sys.path.insert(0, str(SRC))
    from repro.launch import dryrun, hlo_analysis as ha

    text = {}
    real = ha.analyze_hlo

    def capture(t):
        text["hlo"] = t
        return real(t)

    dryrun.analyze_hlo = capture
    res = dryrun.lower_cell(ARCH, shape, mesh == "multi")
    comps = ha._split_computations(text["hlo"])
    entry = comps.pop("__entry__")[0]
    edges = {}
    for name, lines in comps.items():
        edges[name] = []
        for ln in lines:
            m = ha._WHILE_RE.search(ln)
            if m:
                cond, body = m.group(1), m.group(2)
                tm = ha._TRIP_RE.search(ln)
                trip = int(tm.group(1)) if tm else max(
                    (int(c) for c in ha._CONST_RE.findall(" ".join(comps.get(cond, [])))),
                    default=1)
                edges[name] += [(body, trip), (cond, trip + 1)]
    mult = collections.Counter()

    def visit(n, m):
        mult[n] += m
        for child, trip in edges.get(n, []):
            visit(child, m * trip)

    visit(entry, 1.0)
    op_re = re.compile(r"^(?:ROOT\s+)?%?[\w.\-]+\s*=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[^\]]*\]\S*))"
                       r"\s+([a-z][\w\-]*)\(")
    colls, outs = collections.defaultdict(lambda: [0, 0.0]), collections.defaultdict(lambda: [0, 0.0])
    for name, m in mult.items():
        for ln in comps.get(name, []):
            om = op_re.match(ln)
            if not om:
                continue
            nbytes, op = ha._type_bytes(om.group(1)), om.group(2)
            if any(op.startswith(c) for c in ha._COLL_OPS):
                rg = re.search(r"replica_groups=(\S{0,40})", ln)
                key = (op, om.group(1)[:90], rg.group(1) if rg else "")
                colls[key][0] += int(m)
                colls[key][1] += nbytes * m
            elif nbytes > big:
                outs[(op, om.group(1)[:90])][0] += int(m)
                outs[(op, om.group(1)[:90])][1] = nbytes
    print(f"# reference {shape} {mesh}: mem {res['mem_per_device']}")
    for (op, shp, rg), (n, b) in sorted(colls.items(), key=lambda kv: -kv[1][1])[:30]:
        print(f"{b / 1e9:10.4f} GB {n:6d}x {op} {shp} groups {rg}")
    print("# largest non-collective outputs (bytes each, count over loop trips)")
    for (op, shp), (n, b) in sorted(outs.items(), key=lambda kv: -kv[1][1])[:20]:
        print(f"{b / 1e9:10.4f} GB {n:6d}x {op} {shp}")


def port_collectives(shape: str, groups: int) -> None:
    """The port's collectives of one cell at ``groups`` groups, by site."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun, hlo_analysis as ha
    from repro_torch.launch.mesh import dp_axes, make_production_mesh
    from repro_torch.models import shardctx

    tally = collections.defaultdict(lambda: [0, 0.0])
    real = ha.CostMode._local

    def site():
        for fr in reversed(traceback.extract_stack()[:-3]):
            if "repro_torch" in fr.filename and not any(
                    skip in fr.filename for skip in ("/launch/", "shardctx")):
                return f"{fr.filename.split('repro_torch/')[-1]}:{fr.lineno}"
        return "?"

    def local(self, func, args, out):
        kind = ha._collective_kind(func)
        if kind is not None and not self._shadow:
            for t in ha._tensors(out):
                key = (kind, tuple(t.shape), str(t.dtype).removeprefix("torch."), site())
                tally[key][0] += 1
                tally[key][1] += ha._nbytes(t)
        return real(self, func, args, out)

    ha.CostMode._local = local
    dryrun.fake_group(256, "cpu")
    mesh = make_production_mesh(multi_pod=False, device_type="cpu")
    cfg = dryrun._depth(get_config(ARCH), groups)
    with shardctx.ctx(mesh, dp_axes(False)):
        res, secs, *_ = dryrun._trace(cfg, SHAPES[shape], SHAPES[shape].kind, "baseline",
                                      mesh, False, "cpu")
    print(f"# port {shape} at {groups} groups: traced {secs:.1f} s, peak live "
          f"{res['peak_live_bytes']} B, {json.dumps(res['collectives'])}")
    for (kind, shp, dt, where), (n, b) in sorted(tally.items(), key=lambda kv: -kv[1][1])[:30]:
        print(f"{b / 1e9:10.4f} GB {n:6d}x {kind} {shp} {dt} at {where}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="train_4k,prefill_32k,decode_32k")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "opt"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--hlo", default=None, metavar="SHAPE")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--big", type=float, default=2e7,
                    help="--hlo: list outputs larger than this many bytes")
    ap.add_argument("--port-collectives", default=None, metavar="SHAPE")
    ap.add_argument("--groups", type=int, default=2)
    args = ap.parse_args(argv)
    if args.hlo:
        return reference_hlo(args.hlo, args.mesh, args.big)
    if args.port_collectives:
        return port_collectives(args.port_collectives, args.groups)
    out = Path(args.out or tempfile.mkdtemp(prefix="dryrun-parity-"))
    out.mkdir(parents=True, exist_ok=True)
    table(args.shapes, args.meshes.split(","), args.variant, out)


if __name__ == "__main__":
    main()
