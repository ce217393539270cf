"""Memory-budgeted two-pass external sort — how Coconut builds indexes.

Pass 1 splits the input into memory-budget-sized chunks, sorts each with an
in-memory sort and writes a sorted run (all sequential I/O). Pass 2 merges
the runs with k open sequential cursors into the final sorted order (again
sequential). Contrast with top-down insertion (ADS+ baseline): one random
page read+write per insert.

The byte/pass accounting follows the real streaming algorithm; the in-memory
``np.lexsort`` over run keys stands in for the k-way cursor merge (keys are
16 bytes/entry, so even a billion-entry merge holds keys in RAM — the paper
budget concerns the 1KB series payloads, which here are only *moved* in run
order, i.e. sequentially per run).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .io_model import DiskModel
from .sortable import lexsort_keys


@dataclasses.dataclass
class SortReport:
    n_entries: int
    n_runs: int
    n_passes: int
    mem_budget_entries: int


def external_sort_order(
    keys: np.ndarray,
    mem_budget_entries: int,
    disk: DiskModel | None = None,
    payload_bytes_per_entry: int = 0,
) -> tuple[np.ndarray, SortReport]:
    """Return the permutation sorting ``keys`` (N, n_words uint32) lexico-
    graphically, with I/O accounted for a two-pass external sort under the
    given memory budget (entries)."""
    n = keys.shape[0]
    m = max(1, int(mem_budget_entries))
    n_runs = max(1, math.ceil(n / m))
    entry_bytes = keys.shape[1] * 4 + payload_bytes_per_entry

    orders = []
    for r in range(n_runs):
        lo, hi = r * m, min(n, (r + 1) * m)
        o = lexsort_keys(keys[lo:hi])
        orders.append(o + lo)
        if disk is not None:
            disk.read_seq((hi - lo) * entry_bytes, offset=lo * entry_bytes)
            disk.write_seq((hi - lo) * entry_bytes, offset=lo * entry_bytes)

    if n_runs == 1:
        return orders[0], SortReport(n, 1, 1, m)

    # merge pass: k-way sequential merge of the sorted runs
    run_order = np.concatenate(orders)
    merged = lexsort_keys(keys[run_order])
    if disk is not None:
        disk.read_seq(n * entry_bytes)
        disk.write_seq(n * entry_bytes)
    return run_order[merged], SortReport(n, n_runs, 2, m)
