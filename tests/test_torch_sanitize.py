"""The port's runtime sanitizer (``repro_torch.analysis.sanitize``): the
reference's ten cases (``tests/test_sanitize.py``) against the port's
classes, on the CPU — ranked locks, snapshot seals, and an end-to-end run
proving the port's pipeline is sanitizer-clean."""
import threading

import numpy as np
import pytest

from repro_torch.analysis import sanitize
from repro_torch.core import (
    RunRegistry, SortedRun, StreamConfig, StreamingIndex, SummarizationConfig,
)
from repro_torch.core.verify_engine import get_engine


@pytest.fixture
def sanitizer():
    sanitize.install()
    try:
        yield
    finally:
        sanitize.uninstall()


def scfg(n=32):
    return SummarizationConfig(series_len=n, n_segments=4, card_bits=4)


# ------------------------------------------------------------ ranked locks
def test_legal_lock_order_registry_then_engine(sanitizer):
    reg = RunRegistry()
    eng = get_engine("cpu")
    with reg._lock:
        with eng._lock:  # pin-epilogue shape: reap -> release_view
            pass
    assert reg._lock.owner is None and eng._lock.owner is None


def test_lock_order_inversion_raises(sanitizer):
    reg = RunRegistry()
    eng = get_engine("cpu")
    with pytest.raises(sanitize.SanitizerError, match="inversion"):
        with eng._lock:
            with reg._lock:
                pass
    assert eng._lock.owner is None


def test_ranked_lock_is_reentrant_and_tracks_owner(sanitizer):
    reg = RunRegistry()
    with reg._lock:
        assert reg._lock.owner == threading.current_thread().name
        with reg._lock:
            pass
        assert reg._lock.owner == threading.current_thread().name
    assert reg._lock.owner is None


def test_inversion_names_both_locks(sanitizer):
    reg = RunRegistry()
    eng = get_engine("cpu")  # a singleton made before install() is ranked too
    try:
        with eng._lock:
            with reg._lock:
                pass
        raise AssertionError("inversion not caught")
    except sanitize.SanitizerError as e:
        msg = str(e)
        assert "RunRegistry._lock" in msg and "VerifyEngine._lock" in msg


# ---------------------------------------------------------- snapshot seals
def test_sorted_run_seal_trips_on_public_attr(sanitizer, rng):
    run, _ = SortedRun.build(
        rng.standard_normal((64, 32)).astype(np.float32), np.arange(64), scfg(),
        device="cpu")
    with pytest.raises(sanitize.SanitizerError, match="sealed SortedRun"):
        run.t_min = 0
    with pytest.raises(sanitize.SanitizerError, match="sealed SortedRun"):
        run.block_size = 1


def test_sorted_run_underscore_lazy_caches_stay_writable(sanitizer, rng):
    run, _ = SortedRun.build(
        rng.standard_normal((64, 32)).astype(np.float32), np.arange(64), scfg(),
        materialized=True, device="cpu")
    assert run.entry_norms2().shape == (64,)  # sets run._norms2 through the seal


def test_runset_mutation_rebranded(sanitizer):
    snap = RunRegistry().current()
    with pytest.raises(sanitize.SanitizerError, match="immutable"):
        snap.epoch = 99


def test_registry_publish_path_clean_under_seal(sanitizer, rng):
    from repro_torch.core import BufferChunk

    reg = RunRegistry()
    chunk = BufferChunk(rng.standard_normal((8, 32)).astype(np.float32), np.arange(8))
    snap = reg.append_buffer(chunk)
    assert snap.epoch == 1 and snap.buffer_n == 8


def test_uninstall_restores_classes(rng):
    sanitize.install()
    sanitize.uninstall()
    run, _ = SortedRun.build(
        rng.standard_normal((16, 32)).astype(np.float32), np.arange(16), scfg(),
        device="cpu")
    run.t_min = -1
    assert not sanitize.installed()


# ------------------------------------------------------------- end to end
def test_streaming_index_end_to_end_under_sanitizer(sanitizer, rng):
    """Ingest + serve with seals and ranked locks armed, the device path on
    the CPU: the port's pipeline is invariant-clean, and its answers are the
    f64 brute force."""
    idx = StreamingIndex(StreamConfig(
        scheme="BTP", summarization=scfg(), buffer_entries=64, growth_factor=4,
        block_size=32, device="cpu"))
    seen = []
    for b in range(4):
        x = rng.standard_normal((48, 32)).astype(np.float32)
        idx.ingest(x, np.full(48, b, np.int64))
        seen.append(x)
        if b:
            qs = rng.standard_normal((4, 32)).astype(np.float32)
            d2, ids, _ = idx.window_knn_batch(qs, 0, b, k=3)
            assert ids.shape == (4, 3)
            allx = np.concatenate(seen).astype(np.float64)
            brute = ((qs.astype(np.float64)[:, None, :] - allx[None]) ** 2).sum(-1)
            np.testing.assert_allclose(np.sort(d2, axis=1),
                                       np.sort(brute, axis=1)[:, :3], rtol=1e-6)
