"""The port's serving loop against the reference's.

Both ``serve_coconut`` loops run on the same small namespace and seeds (the
port with ``device="cpu"``). Every window query either loop answers is
recorded through its ``StreamingIndex``: the port must serve the same ids,
batch for batch, in the exact and the approximate tier (whose recall oracle
is recorded too). Async ingest is compared in the exact tier only, whose
answers do not depend on which runs the worker has published yet. Flags that are not ported yet are refused at parse time.
"""
import argparse

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core import streaming as rstream  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro_torch.core import streaming as pstream  # noqa: E402
from repro_torch.core.verify_engine import get_engine  # noqa: E402
from repro_torch.launch import serve as pserve  # noqa: E402

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)


def _args(tier, ingest, dtype):
    return argparse.Namespace(
        mode="coconut", scheme="BTP", batches=10, batch_size=1000,
        series_len=32, query_batch=12, window=5, k=3, tier=tier, n_blocks=2,
        shard="none", ingest=ingest, approx=False, prewarm=False,
        screen_dtype=dtype, device="cpu")


def _record(monkeypatch, module):
    """Wrap the module's batched window queries to log every answer."""
    log = []
    for name in ("window_knn_batch", "window_knn_approx_batch"):
        real = getattr(module.StreamingIndex, name)

        def wrapped(self, Q, t0, t1, *a, _real=real, _name=name, **kw):
            vals, ids, stats = _real(self, Q, t0, t1, *a, **kw)
            log.append((_name, t0, t1, vals.copy(), ids.copy()))
            return vals, ids, stats

        monkeypatch.setattr(module.StreamingIndex, name, wrapped)
    return log


@pytest.mark.parametrize("tier,ingest,dtype", [
    ("exact", "sync", "f32"), ("exact", "async", "int8"),
    ("approx", "sync", "bf16"), ("approx", "sync", "int8")])
def test_serve_coconut_serves_the_reference_ids(tier, ingest, dtype,
                                                monkeypatch, capsys):
    plog = _record(monkeypatch, pstream)
    rlog = _record(monkeypatch, rstream)
    calls0 = get_engine("cpu").stats["calls"]
    out = pserve.serve_coconut(_args(tier, ingest, dtype))
    rserve.serve_coconut(_args(tier, ingest, dtype))
    assert len(plog) == len(rlog) == (2 if tier == "approx" else 1) * 2
    for (pn, pt0, pt1, pv, pids), (rn, rt0, rt1, rv, rids) in zip(plog, rlog):
        assert (pn, pt0, pt1) == (rn, rt0, rt1)
        np.testing.assert_array_equal(pids, rids)
        np.testing.assert_array_equal(pv, rv)
    # the loop returns what it served: the recorded tier answers
    served = [e for e in plog if (e[0] == "window_knn_approx_batch")
              == (tier == "approx")]
    assert len(out["served"]) == len(served) == 2
    for (b, t0, t1, qs, ids), rec in zip(out["served"], served):
        assert (t0, t1) == rec[1:3] and qs.shape == (12, 32)
        np.testing.assert_array_equal(ids, rec[4])
    assert out["latency_ms"].shape == (2,)
    if ingest == "sync":  # async runs may still be unpublished at query time
        assert out["engine"]["calls"] > calls0  # the device screen served
    text = capsys.readouterr().out
    assert "latency ms/query p50=" in text and "engine on cpu" in text
    # both loops log every verified row: the same modeled I/O and heat map
    for tag in ("[serve] access heat map:", "[serve] ingested"):
        lines = [ln for ln in text.splitlines() if ln.startswith(tag)]
        assert len(lines) == 2 and lines[0] == lines[1]


@pytest.mark.parametrize("argv,what", [
    (["--mode", "lm"], "--mode lm"), (["--gateway"], "--gateway"),
    (["--shard", "mesh"], "--shard mesh")])
def test_unported_flags_are_refused_at_parse_time(argv, what, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(pserve, "serve_coconut",
                        lambda args: pytest.fail("served an unported mode"))
    with pytest.raises(SystemExit):
        pserve.main(["--device", "cpu", *argv])
    assert what in capsys.readouterr().err


def test_parser_keeps_the_reference_flags():
    args = pserve.build_parser().parse_args([])
    for flag in ("scheme", "batches", "batch_size", "series_len",
                 "query_batch", "window", "k", "tier", "n_blocks", "ingest",
                 "screen_dtype", "prewarm"):
        assert hasattr(args, flag)
    assert args.device == "cuda"  # the card unless the caller asks otherwise


@pytest.mark.parametrize("gen", ["random_walk", "astronomy", "seismic"])
def test_synthetic_series_are_bitwise_the_reference(gen):
    from repro.data import synthetic as rsyn
    from repro_torch.data import synthetic as psyn

    for seed in (0, 7):
        a = getattr(psyn, gen)(300, 96, seed=seed)
        b = getattr(rsyn, gen)(300, 96, seed=seed)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
