#!/usr/bin/env python3
"""Compare the machine code (SASS) of kernels in two builds of the port's
kernel library, instance by instance, so that a change to one kernel can show
that the others it shares a source with compiled to the same instructions.

    python3 scripts/compare_sass.py TREE_A TREE_B [--kernels NAME ...]

Each TREE is a checkout whose kernels were built already (its
``build/repro_torch_kernels/libcoconut_kernels-*.so``, newest first). Needs
``cuobjdump`` of the CUDA toolkit. Instances are matched by their mangled
names with the per-file anonymous namespace taken out, and compared with
addresses and encodings left out. Prints SAME or DIFF per instance of the
named kernels (by default the three screens' entry points) and exits 1 if
any differs or is missing from either build.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

ANON = re.compile(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+")


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "cuobjdump")


def library(tree: str) -> Path:
    libs = sorted(Path(tree, "build", "repro_torch_kernels").glob("libcoconut_kernels-*.so"),
                  key=lambda p: p.stat().st_mtime, reverse=True)
    if not libs:
        raise SystemExit(f"compare_sass: no built kernel library under {tree}/build")
    return libs[0]


def functions(so: Path) -> dict[str, list[str]]:
    """SASS instructions of each function in ``so``, by normalized name."""
    out = subprocess.run([cuobjdump(), "-sass", str(so)], capture_output=True, text=True,
                         check=True).stdout
    funcs: dict[str, list[str]] = {}
    name = None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = ANON.sub("ANON", m.group(1))
            funcs[name] = []
        elif name is not None and "/*" in ln:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", ln).strip()
            if ins:
                funcs[name].append(ins)
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--kernels", nargs="+",
                    default=["screen_dense_kernel", "screen_quant_kernel"])
    args = ap.parse_args()
    a, b = functions(library(args.tree_a)), functions(library(args.tree_b))
    names = sorted(k for k in set(a) | set(b) if any(n in k for n in args.kernels))
    differ = 0
    for k in names:
        same = k in a and k in b and a[k] == b[k]
        differ += not same
        print(f"{'SAME' if same else 'DIFF'} {len(a.get(k, []))} / {len(b.get(k, []))} "
              f"instructions: {k}")
    print(f"{len(names) - differ} of {len(names)} instances the same")
    return 1 if differ or not names else 0


if __name__ == "__main__":
    sys.exit(main())
