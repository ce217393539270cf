"""The port's serving loop against the reference's.

Both ``serve_coconut`` loops run on the same small namespace and seeds (the
port with ``device="cpu"``). Every window query either loop answers is
recorded through its ``StreamingIndex``: the port must serve the same ids,
batch for batch, in the exact and the approximate tier (whose recall oracle
is recorded too). Async ingest is compared in the exact tier only. There each
exact window query first drains the ingest backlog, in both packages, so
both loops query the same published runs and log the same modeled I/O:
without the drain, what a query reads depends on how far the background
worker has got, which neither package makes deterministic. The gateway
loop (``--gateway``) keeps the reference's flags and defaults and runs at a
tiny size on the CPU. Flags that are not ported yet are refused at parse
time.
"""
import argparse
import sys

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
    """Wrap the module's batched window queries to log every answer. An
    exact window query drains the async ingest backlog first (a no-op under
    sync ingest), so it reads the same published runs in both packages."""
    log = []
    for name in ("window_knn_batch", "window_knn_approx_batch"):
        real = getattr(module.StreamingIndex, name)

        def wrapped(self, Q, t0, t1, *a, _real=real, _name=name, **kw):
            if _name == "window_knn_batch":
                assert self.drain(timeout=300)
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
    for (b, t0, t1, qs, ids, d2), rec in zip(out["served"], served):
        assert (t0, t1) == rec[1:3] and qs.shape == (12, 32)
        np.testing.assert_array_equal(ids, rec[4])
        np.testing.assert_array_equal(d2, rec[3])
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
    (["--mode", "lm"], "--mode lm"), (["--shard", "mesh"], "--shard mesh"),
    (["--gateway", "--shard", "mesh"], "--shard mesh")])
def test_unported_flags_are_refused_at_parse_time(argv, what, monkeypatch,
                                                  capsys):
    for loop in ("serve_coconut", "serve_gateway"):
        monkeypatch.setattr(pserve, loop,
                            lambda args: pytest.fail("served an unported mode"))
    with pytest.raises(SystemExit):
        pserve.main(["--device", "cpu", *argv])
    assert what in capsys.readouterr().err


@pytest.mark.parametrize("argv,loop", [
    (["--gateway"], "serve_gateway"), (["--gateway", "--autotune"],
                                       "serve_gateway"),
    ([], "serve_coconut")])
def test_gateway_flag_selects_the_gateway_loop(argv, loop, monkeypatch):
    ran = []
    for name in ("serve_coconut", "serve_gateway"):
        monkeypatch.setattr(pserve, name,
                            lambda args, _n=name: ran.append((_n, args)))
    pserve.main(["--device", "cpu", *argv])
    assert [n for n, _ in ran] == [loop]
    assert ran[0][1].autotune == ("--autotune" in argv)


GATEWAY_FLAGS = ("gateway", "arrival_rate", "deadline_ms", "slo_p99_ms",
                 "requests", "autotune")


def test_gateway_flags_have_the_reference_defaults(monkeypatch):
    """The reference's parser lives inside its ``main``: run it with
    ``--gateway`` and its loop replaced, and read the defaults it parsed."""
    seen = []
    monkeypatch.setattr(rserve, "serve_gateway", seen.append)
    monkeypatch.setattr(sys, "argv", ["serve", "--gateway"])
    rserve.main()
    ref = seen[0]
    got = pserve.build_parser().parse_args(["--gateway"])
    for flag in GATEWAY_FLAGS + ("query_batch", "window", "k", "batches",
                                 "batch_size", "series_len", "scheme",
                                 "prewarm", "screen_dtype"):
        assert getattr(got, flag) == getattr(ref, flag), flag
    assert (got.arrival_rate, got.deadline_ms, got.slo_p99_ms,
            got.requests, got.autotune) == (500.0, 5.0, 50.0, 400, False)


def test_serve_gateway_tiny_run_on_the_cpu(capsys):
    """--gateway --autotune --device cpu at a tiny size: every request
    answered, the summary printed, zero retraces after the warm-up, and
    every exact windowed answer (its window was drained before serving)
    equal to the direct call."""
    args = pserve.build_parser().parse_args([
        "--gateway", "--autotune", "--device", "cpu", "--batches", "10",
        "--batch-size", "500", "--series-len", "64", "--requests", "64"])
    out = pserve.serve_gateway(args)
    resps, reqs, idx = out["responses"], out["requests"], out["index"]
    assert len(resps) == len(reqs) == 64 and out["warmup"] == 16
    assert out["latency_ms"].shape == out["queue_wait_ms"].shape == (48,)
    assert out["retraces"] == 0
    st = out["stats"]  # read after the dispatcher stopped: every batch
    assert st["submitted"] == st["served"] == 64 and st["autotune"]
    assert sum(s * c for s, c in st["batch_hist"].items()) == 64
    assert st["tuner_decisions"] > 0 and out["tuner"]["profiles"]
    assert idx.raw.n == 10 * 500
    pre = (2 * 10) // 3
    for q, kw, r in zip(out["queries"], reqs, resps):
        assert r.ids.shape == (5,) and (np.diff(r.vals) >= 0).all()
        win = kw.get("window")
        if win is not None:
            assert win == (pre - 5, pre - 1)
            lo, hi = win[0] * 500, (win[1] + 1) * 500
            assert ((r.ids >= lo) & (r.ids < hi)).all()
            if r.tier_served == "exact":
                vals, ids, _ = idx.window_knn_batch(q[None], *win, k=5)
                np.testing.assert_array_equal(r.ids, ids[0])
                np.testing.assert_array_equal(r.vals, vals[0])
    text = capsys.readouterr().out
    for tag in ("[gateway] prewarmed", "[gateway] 48 measured requests",
                "[gateway] shed_rate=", "[gateway] post-warm-up retraces=0",
                "[autotune] profile", "[autotune] [advise/"):
        assert tag in text, tag


def _reference_parser(monkeypatch):
    """The reference builds its parser inside ``main``: let ``main`` build
    it, and stop it at ``parse_args``."""
    seen = []

    class Stop(Exception):
        pass

    def capture(self, *a, **kw):
        seen.append(self)
        raise Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(Stop):
            rserve.main()
    return seen[0]


def _flags(ap):
    return {a.option_strings[0]: a for a in ap._actions
            if a.option_strings and a.dest != "help"}


def test_parser_keeps_the_reference_flags(monkeypatch):
    """Flag for flag, the port's parser is the reference's: the same
    destinations, defaults, choices, types and actions. It adds
    ``--device``; ``--arch`` and ``--decode-tokens`` (the LM mode's) wait
    for the LM substrate."""
    ref, port = _flags(_reference_parser(monkeypatch)), _flags(pserve.build_parser())
    assert set(port) - set(ref) == {"--device"}
    assert set(ref) - set(port) == {"--arch", "--decode-tokens"}
    for flag in set(ref) & set(port):
        r, p = ref[flag], port[flag]
        assert (p.option_strings, p.dest, p.default, p.choices, p.type,
                p.nargs, p.const, type(p)) == (
            r.option_strings, r.dest, r.default, r.choices, r.type,
            r.nargs, r.const, type(r)), flag
    args = pserve.build_parser().parse_args([])
    assert args.device == "cuda"  # the card unless the caller asks otherwise
    assert (args.approx, args.storage, args.storage_dir) == (False, "auto", None)


SMALL = ["--device", "cpu", "--batches", "10", "--batch-size", "500",
         "--series-len", "64", "--query-batch", "12", "--k", "3"]


def _served(out):
    return [(b, t0, t1, ids, d2) for b, t0, t1, _, ids, d2 in out["served"]]


def _assert_served_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[:3] == y[:3]
        np.testing.assert_array_equal(x[3], y[3])
        np.testing.assert_array_equal(x[4], y[4])


def test_approx_flag_is_the_approximate_tier(capsys):
    """``--approx``, the reference's deprecated alias, serves what ``--tier
    approx`` serves (and the log names the approximate tier)."""
    outs = []
    for argv in (["--approx"], ["--tier", "approx"]):
        args = pserve.build_parser().parse_args(SMALL + argv)
        outs.append(pserve.serve_coconut(args))
        text = capsys.readouterr().out
        assert "queries (approx)" in text and "recall@3=" in text
        assert len(outs[-1]["recalls"]) == 2
    _assert_served_equal(_served(outs[0]), _served(outs[1]))
    assert outs[0]["recalls"] == outs[1]["recalls"]


def test_serve_file_storage_serves_the_model_answers_and_reopens(tmp_path,
                                                                capsys):
    """``--storage file --storage-dir DIR`` serves what ``--storage model``
    serves, logs its measured I/O, and leaves a directory that
    ``StreamingIndex.recover`` reopens with every row and the same answers."""
    out_m = pserve.serve_coconut(pserve.build_parser().parse_args(
        SMALL + ["--storage", "model"]))
    assert out_m["measured_io"] == {}
    assert "[serve] measured io" not in capsys.readouterr().out
    out_f = pserve.serve_coconut(pserve.build_parser().parse_args(
        SMALL + ["--storage", "file", "--storage-dir", str(tmp_path)]))
    text = capsys.readouterr().out
    assert f"[serve] file storage backend at {tmp_path}" in text
    assert "[serve] measured io: wrote" in text
    m = out_f["measured_io"]
    assert m["raw_write_bytes"] == 10 * 500 * 64 * 4 and m["wal_records"] == 10
    assert m["manifest_commits"] > 0
    _assert_served_equal(_served(out_m), _served(out_f))
    idx = out_f["index"]
    idx.close()
    rec = pstream.StreamingIndex.recover(idx.cfg, str(tmp_path))
    assert rec.raw.n == 10 * 500 and rec.n_partitions == idx.n_partitions
    b, t0, t1, qs, ids, d2 = out_f["served"][-1]
    vals, got, _ = rec.window_knn_batch(qs, t0, t1, k=3)
    np.testing.assert_array_equal(got, ids)
    np.testing.assert_array_equal(vals, d2)
    rec.close()


@pytest.mark.parametrize("gen", ["random_walk", "astronomy", "seismic"])
def test_synthetic_series_are_bitwise_the_reference(gen):
    from repro.data import synthetic as rsyn
    from repro_torch.data import synthetic as psyn

    for seed in (0, 7):
        a = getattr(psyn, gen)(300, 96, seed=seed)
        b = getattr(rsyn, gen)(300, 96, seed=seed)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
