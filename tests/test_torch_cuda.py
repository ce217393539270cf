"""The CUDA kernels on the card: each held against its plain PyTorch version,
and the engine's answers held to the CPU's (slates beyond one kernel pass
included). Every test here needs an NVIDIA
card and the CUDA toolkit, carries the ``cuda`` marker and skips without a
card. Nothing here imports JAX, so the machine with the card runs it:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import verify_engine as pve
from repro_torch.kernels import _build, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    return torch.device("cuda")


def _quantize(xf):
    amax = np.abs(xf).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    x = np.clip(np.rint(xf / scale[:, None]), -127, 127).astype(np.int8)
    deq = x.astype(np.float64) * scale[:, None]
    return x, scale, np.einsum("nd,nd->n", deq, deq).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("m,n,d,k", [(16, 5000, 256, 13), (64, 3000, 128, 128),
                                     (5, 129, 96, 7)])
def test_cuda_kernels_match_plain(cuda, dtype, m, n, d, k):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(cuda)
    xf = rng.standard_normal((n, d)).astype(np.float32)
    rows = torch.from_numpy(rng.permutation(n)[: n - 7].astype(np.int32)).to(cuda)
    r = rows.long()
    ops.reset_launches()
    if dtype == "int8":
        x, scale, xn2 = (torch.from_numpy(a).to(cuda) for a in _quantize(xf))
        v, i, qn2 = ops.screen_select_quant(q, x, scale, xn2, k, rows=rows)
        pv, pi, pqn2 = ref.screen_select_quant_ref(q, x[r], scale[r], xn2[r], k)
        pfull, pord, _ = ref.screen_select_quant_ref(q, x[r], scale[r], xn2[r],
                                                     r.numel())
    else:
        x = torch.from_numpy(xf).to(cuda)
        if dtype == "bf16":
            x = x.to(torch.bfloat16)
        xn2 = (x.float() * x.float()).sum(-1)
        v, i, qn2 = ops.screen_select(q, x, xn2, k, rows=rows)
        pv, pi, pqn2 = ref.screen_select_ref(q, x[r], xn2[r], k)
        pfull, pord, _ = ref.screen_select_ref(q, x[r], xn2[r], r.numel())
    torch.cuda.synchronize()
    name = "screen_select_quant" if dtype == "int8" else "screen_select"
    assert ops.LAUNCHES[name] == 1
    # f32 sums in another order: the tolerance scales with the magnitudes
    # the screen adds up
    tol = 1e-5 * float(pqn2.max() + xn2.max())
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(), rtol=1e-5,
                               atol=tol)
    # ids equal, except that near-tied candidates (within the f32 tolerance
    # of each other) may come in either order: the kernel's picks must then
    # have the plain version's distances
    d2 = torch.empty_like(pfull).scatter_(1, pord.long(), pfull)
    picked = torch.gather(d2, 1, i.long())
    differ = i.cpu() != pi.cpu()
    assert differ.float().mean() < 0.01
    np.testing.assert_allclose(picked.cpu().numpy(), pv.cpu().numpy(),
                               rtol=1e-5, atol=tol)
    np.testing.assert_allclose(qn2.cpu().numpy(), pqn2.cpu().numpy(), rtol=1e-5)


def test_cuda_kernel_pads_and_ties(cuda):
    """Exact ties keep the lower position, sentinel pads stay behind real
    rows, and a slate wider than the candidates pads with (inf, -1)."""
    q = torch.zeros((3, 32), device=cuda)
    x = torch.zeros((40, 32), device=cuda)
    xn2 = torch.zeros(40, device=cuda)
    xn2[:5] = ops.BIG_NORM2
    v, i, _ = ops.screen_select(q, x, xn2, 4)
    assert i.tolist() == [[5, 6, 7, 8]] * 3
    rows = torch.tensor([7, 3, 3, 9], dtype=torch.int32, device=cuda)
    v, i, _ = ops.screen_select(q, x, xn2, 6, rows=rows)
    assert i.tolist() == [[0, 3, 1, 2, -1, -1]] * 3
    assert torch.isinf(v[:, 4:]).all()
    # one entry past a pass: a second pass continues after the first's ties
    n = ops.pass_slate() + 8
    ops.reset_launches()
    v, i, _ = ops.screen_select(q, torch.zeros((n, 32), device=cuda),
                                torch.zeros(n, device=cuda), ops.pass_slate() + 1)
    assert ops.LAUNCHES["screen_select"] == 2
    assert i.tolist() == [list(range(ops.pass_slate() + 1))] * 3
    assert (v == 0).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_engine_answers_do_not_depend_on_the_device(cuda, dtype):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((20000, 128)).astype(np.float32).cumsum(axis=1)
    Q = rng.standard_normal((48, 128)).astype(np.float32).cumsum(axis=1)
    trows = np.sort(rng.choice(20000, 9000, replace=False))
    out = []
    for dev in ("cpu", "cuda"):
        eng = pve.VerifyEngine(dtype=dtype, device=dev)
        view = eng.build_view(X)
        out.append(eng.screen_topk(view, trows, Q, 5))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][0], out[1][0])


# ---------------------------------------------------------------------------
# the fused screens (csrc/screen_fused.cu): widths, copy units, merge,
# streams, launches
# ---------------------------------------------------------------------------
_NAME = {"int8": "screen_select_quant", "f32": "screen_select", "bf16": "screen_select"}
_DEVICE_KERNEL = {"int8": "screen_quant_kernel", "f32": "screen_dense_kernel",
                  "bf16": "screen_dense_kernel"}


def _table_case(cuda, rng, m, n, d, dtype="int8", offset=0):
    """Queries and a table of ``dtype`` whose rows start ``offset`` bytes
    past an aligned base (a view into a larger buffer): (q, x, scale or
    None, xn2)."""
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(cuda)
    xf = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == "int8":
        xq, scale, xn2 = _quantize(xf)
        xt, scale, xn2 = (torch.from_numpy(a).to(cuda) for a in (xq, scale, xn2))
    else:
        xt = torch.from_numpy(xf).to(cuda)
        xt = xt.to(torch.bfloat16) if dtype == "bf16" else xt
        scale, xn2 = None, (xt.float() * xt.float()).sum(-1)
    elt = xt.element_size()
    assert offset % elt == 0
    buf = torch.empty(n * d + 16 // elt, dtype=xt.dtype, device=cuda)
    x = buf[offset // elt:offset // elt + n * d].view(n, d)
    x.copy_(xt)
    return q, x, scale, xn2


def _screen(q, x, scale, xn2, k, rows=None):
    if scale is None:
        return ops.screen_select(q, x, xn2, k, rows=rows)
    return ops.screen_select_quant(q, x, scale, xn2, k, rows=rows)


def _plain(q, x, scale, xn2, k, rows=None):
    if rows is not None:
        r = rows.long()
        x, xn2, scale = x[r], xn2[r], None if scale is None else scale[r]
    if scale is None:
        return ref.screen_select_ref(q, x, xn2, k)
    return ref.screen_select_quant_ref(q, x, scale, xn2, k)


@pytest.mark.parametrize("dtype,d,offset", [
    ("int8", 100, 1), ("int8", 100, 0), ("int8", 256, 4), ("int8", 300, 0),
    ("int8", 600, 8), ("int8", 2048, 0), ("f32", 100, 4), ("f32", 600, 0),
    ("bf16", 100, 4), ("bf16", 600, 0)])
def test_cuda_quant_any_width_and_alignment(cuda, dtype, d, offset):
    """Rows of any width (several staged slices above 256 bytes) on a table
    whose base is 16-, 4- or 1-byte aligned, for the int8, f32 and bf16
    screens: the same slate as the plain version."""
    rng = np.random.default_rng(d + offset)
    m, n, k = 19, 4099, 13
    q, x, scale, xn2 = _table_case(cuda, rng, m, n, d, dtype, offset)
    assert x.data_ptr() % 16 == offset % 16
    rows = torch.from_numpy(rng.permutation(n)[: n - 5].astype(np.int32)).to(cuda)
    ops.reset_launches()
    v, i, qn2 = _screen(q, x, scale, xn2, k, rows)
    pfull, pord, pqn2 = _plain(q, x, scale, xn2, n - 5, rows)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[_NAME[dtype]] == 1
    _hold_slate(v, i, pfull, pord, k, 1e-5 * float(pqn2.max() + xn2.max()))
    np.testing.assert_allclose(qn2.cpu().numpy(), pqn2.cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("d", [2049, 4096])
@pytest.mark.parametrize("dtype", ["int8", "f32", "bf16"])
def test_cuda_screens_take_rows_wider_than_the_query_staging(cuda, dtype, d):
    """Rows too wide for a block to stage its queries whole (the queries
    then come a slice a stage, beside the rows): the same slate as the
    plain version, through one kernel launch."""
    rng = np.random.default_rng(d)
    q, x, scale, xn2 = _table_case(cuda, rng, 21, 3001, d, dtype)
    ops.reset_launches()
    v, i, qn2 = _screen(q, x, scale, xn2, 13)
    pfull, pord, pqn2 = _plain(q, x, scale, xn2, x.shape[0])
    torch.cuda.synchronize()
    assert ops.LAUNCHES[_NAME[dtype]] == 1
    _hold_slate(v, i, pfull, pord, 13, 1e-5 * float(pqn2.max() + xn2.max()))
    np.testing.assert_allclose(qn2.cpu().numpy(), pqn2.cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("k", [13, 200])
def test_cuda_quant_equal_rows_keep_the_lower_positions(cuda, k):
    """Every row equal, over many splits of the candidate axis: the slate is
    the first k positions, in order, at one distance."""
    n, d = 70000, 64
    q = torch.full((5, d), 0.25, device=cuda)
    x = torch.full((n, d), 3, dtype=torch.int8, device=cuda)
    scale = torch.full((n,), 0.5, device=cuda)
    xn2 = torch.full((n,), float(d) * 2.25, device=cuda)
    for rows in (None, torch.arange(n - 1, -1, -1, dtype=torch.int32, device=cuda)):
        v, i, _ = ops.screen_select_quant(q, x, scale, xn2, k, rows=rows)
        assert i.tolist() == [list(range(k))] * 5
        assert (v == v[0, 0]).all()


@pytest.mark.parametrize("dtype", ["int8", "f32", "bf16"])
def test_cuda_quant_two_streams_at_once(cuda, dtype):
    """Two passes issued on two streams at once: each equals the same call
    made alone, bit for bit, and its plain version."""
    rng = np.random.default_rng(11)
    cases = [_table_case(cuda, rng, 16, 30000, 256, dtype),
             _table_case(cuda, rng, 40, 20000, 128, dtype)]
    alone = [_screen(*c, 13) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    together = []
    for c, st in zip(cases, streams):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            together.append(_screen(*c, 13))
    torch.cuda.synchronize()
    for c, a, b in zip(cases, alone, together):
        assert torch.equal(a[1], b[1])
        assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
        pfull, pord, pqn2 = _plain(*c, c[1].shape[0])
        _hold_slate(b[0], b[1], pfull, pord, 13, 1e-5 * float(pqn2.max() + c[3].max()))


@pytest.mark.parametrize("k", [13, 200])
@pytest.mark.parametrize("dtype", ["int8", "f32", "bf16"])
def test_cuda_quant_one_launch_per_pass(cuda, dtype, k):
    """One fused kernel launch per pass (screen_quant_kernel for int8,
    screen_dense_kernel for f32 and bf16) and no separate merge kernel: the
    launch count says so, and the profiler's trace holds no other kernel of
    the screens (it may drop launches of a short run, never add them)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(12)
    case = _table_case(cuda, rng, 16, 50000, 256, dtype)
    _screen(*case, k)
    torch.cuda.synchronize()
    calls, passes = 4, -(-k // ops.pass_slate())
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            _screen(*case, k)
            torch.cuda.synchronize()
    assert ops.LAUNCHES[_NAME[dtype]] == calls * passes
    names = collections.Counter()
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CPU"):
            names[e.key] += e.count
    fused = sum(c for name, c in names.items() if _DEVICE_KERNEL[dtype] in name)
    assert 0 < fused <= calls * passes, names
    other = {"screen_quant_kernel", "screen_dense_kernel"} - {_DEVICE_KERNEL[dtype]}
    assert not any(o in name for name in names for o in other), names
    assert not any("slate_merge" in name or "screen_partial" in name for name in names), names


# ---------------------------------------------------------------------------
# topk_ed, paa and sax_pack (the kernel backend)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,n,d,k", [(16, 4096, 256, 13), (64, 3000, 128, 128),
                                     (5, 129, 96, 7), (3, 20, 64, 30)])
def test_cuda_topk_ed_matches_plain(cuda, m, n, d, k):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    ops.reset_launches()
    v, i = ops.topk_ed(q, x, k)
    kk = min(k, n)
    pv, pi = ref.topk_ed_ref(q, x, kk)
    pfull, pord = ref.topk_ed_ref(q, x, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_ed"] == 1
    assert v.shape == i.shape == (m, k)
    tol = 1e-5 * float((q * q).sum(-1).max() + (x * x).sum(-1).max())
    np.testing.assert_allclose(v[:, :kk].cpu().numpy(), pv.cpu().numpy(),
                               rtol=1e-5, atol=tol)
    d2 = torch.empty_like(pfull).scatter_(1, pord.long(), pfull)
    picked = torch.gather(d2, 1, i[:, :kk].long())
    assert (i[:, :kk].cpu() != pi.cpu()).float().mean() < 0.01
    np.testing.assert_allclose(picked.cpu().numpy(), pv.cpu().numpy(),
                               rtol=1e-5, atol=tol)
    assert torch.isinf(v[:, kk:]).all() and (i[:, kk:] == -1).all()


def test_cuda_topk_ed_ties_empty_and_cap(cuda):
    v, i = ops.topk_ed(torch.zeros((3, 32), device=cuda),
                       torch.zeros((40, 32), device=cuda), 4)
    assert i.tolist() == [[0, 1, 2, 3]] * 3
    x = torch.randn((32, 64), device=cuda).repeat(2, 1)  # row j == row j + 32
    _, i = ops.topk_ed(x[:4] + 0.01, x, 2)
    assert (i[:, 0] < 32).all() and (i[:, 1] >= 32).all()
    ops.reset_launches()
    v, i = ops.topk_ed(torch.zeros((0, 8), device=cuda), torch.zeros((5, 8), device=cuda), 3)
    assert v.shape == (0, 3)
    v, i = ops.topk_ed(torch.zeros((2, 8), device=cuda), torch.zeros((0, 8), device=cuda), 3)
    assert torch.isinf(v).all() and (i == -1).all()
    assert ops.LAUNCHES["topk_ed"] == 0  # empty batches launch nothing
    n = ops.pass_slate() + 8
    v, i = ops.topk_ed(torch.zeros((2, 8), device=cuda), torch.zeros((n, 8), device=cuda),
                       ops.pass_slate() + 1)
    assert ops.LAUNCHES["topk_ed"] == 2  # a slate one past a pass takes two
    assert i.tolist() == [list(range(ops.pass_slate() + 1))] * 2


def _topk_tol(q, x):
    """f32 sums in another order: the tolerance scales with the magnitudes
    the d2 adds up (the norms of both sides)."""
    return 1e-5 * float((q * q).sum(-1).max() + torch.nan_to_num(x * x).sum(-1).max())


def _hold_topk_and_min_ed(q, x, k):
    """topk_ed in one launch, held to the plain slate; min_ed equal to its
    k = 1 answer bit for bit. Returns the slate."""
    ops.reset_launches()
    v, i = ops.topk_ed(q, x, k)
    tv, ti = ops.topk_ed(q, x, 1)
    mv, mi = ops.min_ed(q, x)
    pfull, pord = ref.topk_ed_ref(q, x, x.shape[0])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_ed"] == 2 and ops.LAUNCHES["min_ed"] == 1
    _hold_slate(v, i, pfull, pord, k, _topk_tol(q, x))
    assert torch.equal(mi, ti[:, 0]) and torch.equal(mv.view(torch.int32),
                                                    tv[:, 0].view(torch.int32))
    return v, i


@pytest.mark.parametrize("d", [29, 160, 2049, 4096])
def test_cuda_topk_ed_any_width_matches_plain_and_min_ed(cuda, d):
    """Rows of 4-byte units (29, 2,049) and of 16-byte units (160, 4,096:
    32-query blocks at 21 queries), and rows too wide for a block to stage
    its queries whole (2,049, 4,096): the plain slate, and min_ed equal to
    topk_ed's k = 1 answer bit for bit."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((21, d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((3001, d)).astype(np.float32)).to(cuda)
    _hold_topk_and_min_ed(q, x, 13)


def test_cuda_topk_ed_on_a_4_byte_aligned_base_with_a_nan_row(cuda):
    """Rows of 29 values starting 116 bytes past an aligned base (``x[1:]``
    of a contiguous table, so 4-byte copies), one of them NaN: the NaN row
    never enters the slate, and the rest is the plain slate."""
    rng = np.random.default_rng(29)
    n = 3000
    base = torch.from_numpy(rng.standard_normal((n + 1, 29)).astype(np.float32)).to(cuda)
    x = base[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    x[77] = float("nan")
    q = torch.from_numpy(rng.standard_normal((19, 29)).astype(np.float32)).to(cuda)
    q[0] = x[76] + 0.001  # row 77's neighbour is this query's nearest
    _, i = _hold_topk_and_min_ed(q, x, 13)
    assert not (i == 77).any() and (i >= 0).all()
    assert int(i[0, 0]) == 76


@pytest.mark.parametrize("k", [13, 200])
def test_cuda_topk_ed_one_launch_per_pass(cuda, k):
    """One topk_ed_kernel launch per pass at its most frequent pass (1 query
    over 32,768 rows) and no separate merge kernel: the launch count says
    so, and the profiler's trace holds no other slate kernel (it may drop
    launches of a short run, never add them)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.standard_normal((1, 256)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((32768, 256)).astype(np.float32)).to(cuda)
    ops.topk_ed(q, x, k)
    torch.cuda.synchronize()
    calls, passes = 4, -(-k // ops.pass_slate())
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.topk_ed(q, x, k)
            torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_ed"] == calls * passes
    names = collections.Counter()
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CPU"):
            names[e.key] += e.count
    fused = sum(c for name, c in names.items() if "topk_ed_kernel" in name)
    assert 0 < fused <= calls * passes, names
    other = ("slate_merge", "screen_partial", "screen_dense_kernel", "screen_quant_kernel")
    assert not any(o in name for name in names for o in other), names


@pytest.mark.parametrize("b,n,w,c", [(1000, 256, 16, 8), (257, 96, 12, 6),
                                     (33, 64, 8, 4), (5, 128, 16, 2),
                                     (40, 16384, 16, 8), (7, 65536, 16, 8),
                                     (513, 256, 32, 8), (300, 256, 64, 4),
                                     (16, 256, 16, 8)])
def test_cuda_summarize_matches_plain(cuda, b, n, w, c):
    """PAA sums in the plain version's order, so values, symbols and keys
    are bitwise the plain version's; keys equal the host's interleave.
    Series too long to stage in a block's shared memory (16,384 and 65,536
    values) are summed from device memory, in the same order."""
    from repro_torch.core import sortable, summarization

    cfg = summarization.SummarizationConfig(series_len=n, n_segments=w, card_bits=c)
    rng = np.random.default_rng(2)
    xh = rng.standard_normal((b, n)).astype(np.float32).cumsum(axis=1) / 8
    x = torch.from_numpy(xh).to(cuda)
    ops.reset_launches()
    p, sym, keys = ops.summarize(x, cfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paa"] == 1 and ops.LAUNCHES["sax_pack"] == 1
    pp = ref.paa_ref(x, w)
    psym, pkeys = ref.sax_pack_ref(pp, ops.breakpoint_table(c, x.device), c, cfg.key_words)
    np.testing.assert_array_equal(p.cpu().numpy().view(np.uint32),
                                  pp.cpu().numpy().view(np.uint32))
    np.testing.assert_array_equal(sym.cpu().numpy(), psym.cpu().numpy())
    np.testing.assert_array_equal(keys.cpu().numpy(), pkeys.cpu().numpy())
    host = ops.keys_to_host(keys)
    np.testing.assert_array_equal(
        host, sortable.interleave(summarization.sax_from_paa(p.cpu().numpy(), cfg), cfg))
    ops.reset_launches()
    assert ops.paa(torch.zeros((0, n), device=cuda), cfg).shape == (0, w)
    assert ops.sax_and_keys(torch.zeros((0, w), device=cuda), cfg)[1].shape == (
        0, cfg.key_words)
    assert ops.LAUNCHES["paa"] == ops.LAUNCHES["sax_pack"] == 0


@pytest.mark.parametrize("b", [1, 16, 33, 1_024_000])
def test_cuda_sax_and_keys_planted_values_in_one_launch(cuda, b):
    """Symbols and int64 key words bit for bit the plain version's, with
    values planted on breakpoints, NaN and infinities, from one
    ``sax_pack_kernel`` launch: the launch count says so, and the profiler's
    trace holds no other kernel (the words come out as int64, no elementwise
    conversion after it; the trace may drop launches, never add them)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import summarization

    cfg = summarization.SummarizationConfig(series_len=256, n_segments=16, card_bits=8)
    rng = np.random.default_rng(21)
    ph = rng.standard_normal((b, 16)).astype(np.float32)
    bph = summarization.breakpoints(8)
    planted = np.array([bph[0], bph[127], bph[-1], np.nan, np.inf, -np.inf, -0.0],
                       np.float32)
    at = rng.choice(ph.size, size=min(ph.size, 1000), replace=False)
    ph.reshape(-1)[at] = np.resize(planted, at.size)
    p = torch.from_numpy(ph).to(cuda)
    ops.sax_and_keys(p, cfg)
    torch.cuda.synchronize()
    ops.reset_launches()
    sym, keys = ops.sax_and_keys(p, cfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sax_pack"] == 1
    assert sym.dtype == torch.int32 and keys.dtype == torch.int64
    psym, pkeys = ref.sax_pack_ref(p, ops.breakpoint_table(8, p.device), 8, cfg.key_words)
    assert torch.equal(sym, psym) and torch.equal(keys, pkeys)
    assert int(keys.min()) >= 0 and int(keys.max()) < 2 ** 32
    calls = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.sax_and_keys(p, cfg)
        torch.cuda.synchronize()
    names = collections.Counter()
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CPU"):
            names[e.key] += e.count
    sax = sum(c for name, c in names.items() if "sax_pack_kernel" in name)
    assert 0 < sax <= calls, names
    others = [n for n in names if "kernel" in n.lower() and "sax_pack_kernel" not in n]
    assert not others, names


def test_kernel_backend_answers_do_not_depend_on_the_device(cuda):
    from repro_torch.core import (ADSConfig, ADSIndex, CTree, CTreeConfig, RawStore,
                                  SummarizationConfig)

    rng = np.random.default_rng(5)
    X = rng.standard_normal((6000, 128)).astype(np.float32).cumsum(axis=1)
    Q = rng.standard_normal((16, 128)).astype(np.float32).cumsum(axis=1)
    scfg = SummarizationConfig(series_len=128, n_segments=16, card_bits=8)
    out = []
    for dev in ("cpu", "cuda"):
        raw = RawStore(128, device=dev)
        ids = raw.append(X)
        ct = CTree(CTreeConfig(summarization=scfg, block_size=256, device=dev))
        ct.bulk_build(X, ids)
        ads = ADSIndex(ADSConfig(summarization=scfg, leaf_size=512, device=dev))
        ads.insert_batch(X, ids)
        ops.reset_launches()
        res = [ct.knn_batch(Q, k=5, raw=raw, backend="kernel"),
               ct.knn_approx_batch(Q, k=5, n_blocks=4, raw=raw, backend="kernel"),
               ads.knn_batch(Q, k=5, raw=raw, backend="kernel"),
               ads.knn_approx_batch(Q, k=5, raw=raw, backend="kernel")]
        if dev == "cuda":
            assert min(ops.LAUNCHES[n] for n in ("topk_ed", "paa", "sax_pack")) > 0
        out.append(res)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[0], b[0])


# ---------------------------------------------------------------------------
# slates beyond one kernel pass, min_ed and mindist
# ---------------------------------------------------------------------------
def _hold_slate(v, i, pfull, pord, k, tol):
    """Values within ``tol`` of the plain slate; ids equal except between
    near-tied candidates, whose plain distances must then agree."""
    pv = pfull[:, :k]
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(), rtol=1e-5, atol=tol)
    d2 = torch.empty_like(pfull).scatter_(1, pord.long(), pfull)
    picked = torch.gather(d2, 1, i.long())
    np.testing.assert_allclose(picked.cpu().numpy(), pv.cpu().numpy(), rtol=1e-5, atol=tol)


@pytest.mark.parametrize("k", [200, 500])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "topk_ed"])
def test_cuda_slates_beyond_one_pass_match_plain(cuda, kind, k):
    rng = np.random.default_rng(6)
    m, n, d = 16, 3001, 128
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(cuda)
    xf = rng.standard_normal((n, d)).astype(np.float32)
    xf[1::97] = xf[0]  # exact ties across the pass boundaries
    ops.reset_launches()
    if kind == "int8":
        x, scale, xn2 = (torch.from_numpy(a).to(cuda) for a in _quantize(xf))
        v, i, _ = ops.screen_select_quant(q, x, scale, xn2, k)
        pfull, pord, _ = ref.screen_select_quant_ref(q, x, scale, xn2, n)
        name = "screen_select_quant"
    elif kind == "topk_ed":
        x = torch.from_numpy(xf).to(cuda)
        xn2 = (x * x).sum(-1)
        v, i = ops.topk_ed(q, x, k)
        pfull, pord = ref.topk_ed_ref(q, x, n)
        name = "topk_ed"
    else:
        x = torch.from_numpy(xf).to(cuda)
        if kind == "bf16":
            x = x.to(torch.bfloat16)
        xn2 = (x.float() * x.float()).sum(-1)
        v, i, _ = ops.screen_select(q, x, xn2, k)
        pfull, pord, _ = ref.screen_select_ref(q, x, xn2, n)
        name = "screen_select"
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == -(-k // ops.pass_slate())
    assert v.shape == i.shape == (m, k) and (i >= 0).all()
    assert (i.long().sort(1).values.diff(1) > 0).all()  # no candidate twice
    _hold_slate(v, i, pfull, pord, k, 1e-5 * float((q * q).sum(-1).max() + xn2.max()))


@pytest.mark.parametrize("m,n,d", [(16, 100003, 256), (64, 4097, 96), (5, 1, 32),
                                   (3, 130, 200), (17, 5000, 256), (33, 5000, 256)])
def test_cuda_min_ed_matches_plain(cuda, m, n, d):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(cuda)
    q[0] = x[n // 2]  # a query equal to a row: d2 near 0, maybe below
    ops.reset_launches()
    v, i = ops.min_ed(q, x)
    tv, ti = ops.topk_ed(q, x, 1)
    pfull, pord = ref.topk_ed_ref(q, x, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["min_ed"] == 1
    assert v.shape == i.shape == (m,) and i.dtype == torch.int32
    # the same arithmetic as topk_ed: its k = 1 answer, bit for bit
    assert torch.equal(i, ti[:, 0]) and torch.equal(v, tv[:, 0])
    tol = 1e-5 * float((q * q).sum(-1).max() + (x * x).sum(-1).max())
    _hold_slate(v[:, None], i[:, None], pfull, pord, 1, tol)
    assert int(i[0]) == n // 2 and abs(float(v[0])) < tol


@pytest.mark.parametrize("m", [16, 17, 33])
def test_cuda_min_ed_tie_across_a_split_border(cuda, m):
    """A row and its copy in the next split of the plan, each asked exactly
    by one query (d2 about 0, maybe below): the lower row wins, in one
    launch, with topk_ed's k = 1 answer bit for bit; at 16-query blocks and
    at partial 32-query blocks."""
    rng = np.random.default_rng(m)
    n, d = 100003, 256
    chunk, n_splits = ops._splits(cuda, n, m, 1, _build.layout()["screen"])
    assert n_splits > 1
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(cuda)
    a = [3, chunk - 1, 2 * chunk + 5]  # copies at a + chunk: the next split
    x[[r + chunk for r in a]] = x[a]
    q[: len(a)] = x[a]
    ops.reset_launches()
    v, i = ops.min_ed(q, x)
    tv, ti = ops.topk_ed(q, x, 1)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["min_ed"] == 1
    assert i[: len(a)].tolist() == a
    assert torch.equal(i, ti[:, 0]) and torch.equal(v.view(torch.int32),
                                                    tv[:, 0].view(torch.int32))


def test_cuda_min_ed_ties_negative_zero_and_empty(cuda):
    x = torch.randn((32, 64), device=cuda).repeat(3, 1)  # row j == j + 32 == j + 64
    q = x[[40, 70, 5]].clone()  # each equals three rows: the lowest must win
    v, i = ops.min_ed(q, x)
    assert i.tolist() == [8, 6, 5]
    # every d2 exactly 0 (and -0.0 from 0 - 0 must not beat +0.0): row 0
    v, i = ops.min_ed(torch.zeros((3, 16), device=cuda), torch.zeros((40, 16), device=cuda))
    assert i.tolist() == [0, 0, 0] and (v == 0).all()
    ops.reset_launches()
    v, i = ops.min_ed(torch.zeros((0, 8), device=cuda), torch.zeros((5, 8), device=cuda))
    assert v.shape == i.shape == (0,)
    v, i = ops.min_ed(torch.zeros((2, 8), device=cuda), torch.zeros((0, 8), device=cuda))
    assert torch.isinf(v).all() and (i == -1).all()
    assert ops.LAUNCHES["min_ed"] == 0  # empty batches launch nothing


@pytest.mark.parametrize("b,w,c", [(100003, 16, 8), (4097, 8, 4), (513, 6, 5)])
def test_cuda_mindist_matches_plain_bitwise(cuda, b, w, c):
    from repro_torch.core import summarization

    cfg = summarization.SummarizationConfig(series_len=w * 8, n_segments=w, card_bits=c)
    rng = np.random.default_rng(8)
    lo, hi = summarization.sax_region(rng.integers(0, 2 ** c, (b, w)), cfg)
    lo, hi = torch.from_numpy(lo).to(cuda), torch.from_numpy(hi).to(cuda)
    qp = torch.from_numpy(rng.standard_normal(w).astype(np.float32)).to(cuda)
    ops.reset_launches()
    out = ops.mindist(qp, lo, hi, cfg)
    # a view that starts one row in: not 16-byte aligned when w % 4 != 0
    tail = ops.mindist(qp, lo[1:], hi[1:], cfg)
    want = ref.mindist_ref(qp, lo, hi, cfg.segment_len)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mindist"] == 2
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert torch.equal(tail.view(torch.int32), want[1:].view(torch.int32))
    ops.reset_launches()
    assert ops.mindist(qp, lo[:0], hi[:0], cfg).shape == (0,)
    assert ops.LAUNCHES["mindist"] == 0


@pytest.mark.parametrize("backend", ["device", "kernel"])
def test_knn_batch_beyond_one_pass_does_not_depend_on_the_device(cuda, backend):
    """k = 200 asks the engine for a slate of 208 (k + its slack of 8), two
    kernel passes: the answers equal the CPU's, through a kernel launch."""
    from repro_torch.core import CTree, CTreeConfig, RawStore, SummarizationConfig

    rng = np.random.default_rng(9)
    X = rng.standard_normal((6000, 128)).astype(np.float32).cumsum(axis=1)
    Q = rng.standard_normal((16, 128)).astype(np.float32).cumsum(axis=1)
    scfg = SummarizationConfig(series_len=128, n_segments=16, card_bits=8)
    out = []
    for dev in ("cpu", "cuda"):
        raw = RawStore(128, device=dev)
        ids = raw.append(X)
        ct = CTree(CTreeConfig(summarization=scfg, block_size=256, device=dev))
        ct.bulk_build(X, ids)
        ops.reset_launches()
        out.append(ct.knn_batch(Q, k=200, raw=raw, backend=backend))
        if dev == "cuda":
            name = "topk_ed" if backend == "kernel" else "screen_select"
            assert ops.LAUNCHES[name] > 0
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][0], out[1][0])
    d2 = ((X[None].astype(np.float64) - Q[:, None]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1, kind="stable")[:, :200]
    np.testing.assert_array_equal(out[1][1], want)


def test_file_backed_index_answers_as_the_model_backed_one(cuda, tmp_path):
    """A small file-backed StreamingIndex on the card (its arenas filled
    from memory-mapped files) answers bit for bit as the model-backed one,
    and so does the index recovered from its directory, on the card; the
    device screen launches in each, and topk_ed under ``backend="kernel"``."""
    from repro_torch.core import StreamConfig, StreamingIndex, SummarizationConfig

    rng = np.random.default_rng(11)
    batches = [rng.standard_normal((300, 64)).astype(np.float32).cumsum(axis=1)
               for _ in range(12)]
    Q = rng.standard_normal((12, 64)).astype(np.float32).cumsum(axis=1)
    cfg = StreamConfig(scheme="BTP", summarization=SummarizationConfig(
        series_len=64, n_segments=8, card_bits=6), buffer_entries=1024,
        growth_factor=3, block_size=128, storage="model", device="cuda")

    def ask(idx, backend="device"):
        ops.reset_launches()
        out = [idx.window_knn_batch(Q, t0, t1, k=5, backend=backend)
               for t0, t1 in ((0, 11), (2, 9))]
        assert ops.LAUNCHES["topk_ed" if backend == "kernel" else "screen_select"] > 0
        return out

    answers = []
    for storage in ("model", "file"):
        idx = StreamingIndex(dataclasses.replace(cfg, storage=storage,
                                                 storage_dir=str(tmp_path)))
        for b, x in enumerate(batches):
            idx.ingest(x, np.full(300, b, np.int64))
        answers.append(ask(idx))
        idx.close()
    rec = StreamingIndex.recover(cfg, str(tmp_path))
    assert rec.raw.n == 12 * 300 and rec.raw.device.type == "cuda"
    runs = list(rec.lsm.registry.current().runs_newest_first())
    assert runs and all(torch.device(r.device).type == "cuda" for r in runs)
    answers += [ask(rec), ask(rec, "kernel")]
    for got in answers[1:]:
        for a, b in zip(answers[0], got):
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[0], b[0])
    rec.close()
