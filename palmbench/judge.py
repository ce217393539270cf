"""The comparison that decides ``correct``.

Each answer is (m, k) squared distances ascending and (m, k) ids, padded
with (inf, -1). Three numbers are compared, each against its limit:

* ``dist_gap``: the widest gap between a distance the answer reports at a
  rank and the reference's distance at that rank;
* ``id_gap``: the widest gap between a reported distance and the true
  float64 distance of the id reported beside it;

both as a share of the query's k-th reference distance, over every slot
the reference fills and the answer fills with an admissible id; and

* ``bad_ids``: slots the reference fills that the answer leaves empty or
  fills with an id that is out of range, out of the window or repeated
  in its row, and slots the answer fills where the reference has none.

The TF32 control (the reference put in the program's place, its products
in TF32) is ``reference.exact_topk`` at ``precision="tf32"``.
"""
from __future__ import annotations

import numpy as np


def readings(prog_d, prog_i, ref_d, ref_i, true_d, lo, hi) -> dict:
    """The three numbers over stacked answers; ``lo``/``hi`` (m,) bound the
    ids each query may be answered with."""
    prog_d = np.asarray(prog_d, np.float64)
    prog_i = np.asarray(prog_i, np.int64)
    m, k = ref_i.shape
    have = ref_i >= 0
    nref = have.sum(axis=1)
    kth = ref_d[np.arange(m), np.maximum(nref - 1, 0)]
    scale = np.maximum(np.where(nref > 0, kth, 1.0), 1e-30)[:, None]
    lo = np.asarray(lo)[:, None]
    hi = np.asarray(hi)[:, None]
    out_of_range = (prog_i < lo) | (prog_i >= hi)
    srt = np.sort(np.where(prog_i >= 0, prog_i, -1 - np.arange(k)[None, :]), axis=1)
    dup = np.zeros_like(have)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    bad = (have & out_of_range) | (~have & (prog_i >= 0))
    good = have & ~out_of_range
    with np.errstate(invalid="ignore"):
        dgap = np.abs(prog_d - ref_d) / scale
        igap = np.abs(np.asarray(true_d, np.float64) - prog_d) / scale
    dgap = np.where(np.isfinite(dgap), dgap, np.inf)
    igap = np.where(np.isfinite(igap), igap, np.inf)
    return {
        "dist_gap": float(dgap[good].max()) if good.any() else 0.0,
        "id_gap": float(igap[good].max()) if good.any() else 0.0,
        "bad_ids": int(bad.sum() + dup.sum()),
    }


def checks(values: dict, limits: dict) -> dict:
    """Each compared number beside its limit."""
    return {name: {"value": values[name], "limit": limits[name]}
            for name in limits}


def passed(chk: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in chk.values())
