"""The port's kernel wrappers against the reference kernels.

On the CPU the port's ``ops`` wrappers (``screen_select(_quant)``,
``topk_ed(_bucketed)``, ``paa``, ``sax_and_keys``, ``summarize``,
``min_ed``, ``mindist``) run their plain PyTorch versions; the reference
runs its Pallas kernels in interpret mode. Same inputs, made with numpy:
slate ids, symbols and keys must be equal, and values agree to f32
tolerance, 1e-5 relative (tiled and whole-matrix f32 sums differ in the
last bits: up to 4.6e-5 absolute on the top-k sweep's d2 of ~250, so
bitwise agreement belongs after the engine's f64 re-rank; ``min_ed`` is
held as the reference's own test holds it, to 2e-4 / 1e-3). The pass loop
of slates longer than one kernel pass runs over the plain versions here.
The CUDA kernels are held against the plain versions in
``test_torch_cuda.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import summarization as rsum  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import sortable as psort  # noqa: E402
from repro_torch.core import summarization as psum  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tol(q, xn2):
    """atol scaled by the magnitudes the f32 screen adds up."""
    qn2 = np.einsum("md,md->m", q, q)
    return 1e-5 * (float(qn2.max()) + float(np.max(xn2, initial=0.0)))


def _quantize(xf):
    amax = np.abs(xf).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    x = np.clip(np.rint(xf / scale[:, None]), -127, 127).astype(np.int8)
    deq = x.astype(np.float64) * scale[:, None]
    return x, scale, np.einsum("nd,nd->n", deq, deq).astype(np.float32)


@pytest.mark.parametrize("k", [1, 5, 18])
@pytest.mark.parametrize("m,n,d", [(8, 512, 128), (7, 333, 64), (1, 100, 96),
                                   (16, 64, 128)])
def test_screen_select_matches_reference(m, n, d, k, rng):
    q = rng.standard_normal((m, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    xn2 = np.einsum("nd,nd->n", x, x).astype(np.float32)
    v, i, qn2 = ops.screen_select(_t(q), _t(x), _t(xn2), k)
    rv, ri, rqn2 = rops.screen_select(q, x, xn2, k, block_m=8, block_n=64)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=_tol(q, xn2))
    np.testing.assert_allclose(qn2.numpy(), np.asarray(rqn2), rtol=1e-5)
    kk = min(k, n)
    ov, oi, _ = rref.screen_select_ref(jnp.asarray(q), jnp.asarray(x),
                                        jnp.asarray(xn2), kk)
    np.testing.assert_array_equal(i.numpy()[:, :kk], np.asarray(oi))
    assert np.all(v.numpy()[:, kk:] == np.inf)
    assert np.all(i.numpy()[:, kk:] == -1)


@pytest.mark.parametrize("k", [1, 5, 18])
@pytest.mark.parametrize("m,n,d", [(8, 512, 128), (7, 333, 64), (1, 100, 96),
                                   (16, 64, 128)])
def test_screen_select_quant_matches_reference(m, n, d, k, rng):
    q = rng.standard_normal((m, d)).astype(np.float32)
    x, scale, xn2 = _quantize(rng.standard_normal((n, d)).astype(np.float32))
    v, i, qn2 = ops.screen_select_quant(_t(q), _t(x), _t(scale), _t(xn2), k)
    rv, ri, rqn2 = rops.screen_select_quant(q, x, scale, xn2, k,
                                            block_m=8, block_n=64)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=_tol(q, xn2))
    np.testing.assert_allclose(qn2.numpy(), np.asarray(rqn2), rtol=1e-5)
    kk = min(k, n)
    ov, oi, _ = rref.screen_select_quant_ref(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(scale), jnp.asarray(xn2), kk)
    np.testing.assert_array_equal(i.numpy()[:, :kk], np.asarray(oi))


def test_sentinel_norm_keeps_pads_out(rng):
    """Pad candidates carry BIG_NORM2 in the norms (their rows are zero):
    they never displace a real candidate and do not overflow the screen."""
    q = rng.standard_normal((4, 64)).astype(np.float32)
    x = np.zeros((128, 64), np.float32)
    x[:70] = rng.standard_normal((70, 64))
    xn2 = np.full(128, ops.BIG_NORM2, np.float32)
    xn2[:70] = np.einsum("nd,nd->n", x[:70], x[:70])
    v, i, _ = ops.screen_select(_t(q), _t(x), _t(xn2), 70)
    assert np.isfinite(v.numpy()).all() and (v.numpy() < 1e29).all()
    assert (i.numpy() >= 0).all() and (i.numpy() < 70).all()
    v, i, _ = ops.screen_select(_t(q), _t(x), _t(xn2), 75)
    assert (i.numpy()[:, 70:] >= 70).all()  # pads only after every real row
    assert (v.numpy()[:, 70:] >= 1e29).all()


def test_bf16_table_equals_f32_of_dequantized(rng):
    """bf16 tables are upcast in registers: the slate equals an f32 launch
    over the dequantized values exactly."""
    q = rng.standard_normal((8, 64)).astype(np.float32)
    xb = torch.from_numpy(rng.standard_normal((200, 64)).astype(np.float32)
                          ).to(torch.bfloat16)
    x32 = xb.to(torch.float32)
    xn2 = (x32 * x32).sum(-1)
    vb, ib, _ = ops.screen_select(_t(q), xb, xn2, 7)
    v32, i32, _ = ops.screen_select(_t(q), x32, xn2, 7)
    np.testing.assert_array_equal(ib.numpy(), i32.numpy())
    np.testing.assert_array_equal(vb.numpy(), v32.numpy())
    # and the reference agrees on the same bf16 values
    rv, ri, _ = rops.screen_select(q, jnp.asarray(x32.numpy()).astype(jnp.bfloat16),
                                   xn2.numpy(), 7, block_m=8, block_n=64)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ri))


def test_quant_all_zero_rows_use_unit_scale(rng):
    q = rng.standard_normal((4, 64)).astype(np.float32)
    x = np.zeros((70, 64), np.int8)
    scale = np.ones(70, np.float32)
    xn2 = np.zeros(70, np.float32)
    v, i, qn2 = ops.screen_select_quant(_t(q), _t(x), _t(scale), _t(xn2), 3)
    np.testing.assert_allclose(v.numpy(), qn2.numpy()[:, None].repeat(3, 1),
                               rtol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.tile([0, 1, 2], (4, 1)))


def test_ties_keep_the_lower_index():
    """Equal distances keep the lower candidate index — the reference's
    lexicographic order. ``torch.topk`` gives [6, 5, 4] on eight ties and
    would fail here."""
    q = np.zeros((2, 16), np.float32)
    x = np.zeros((8, 16), np.float32)
    xn2 = np.zeros(8, np.float32)
    v, i, _ = ops.screen_select(_t(q), _t(x), _t(xn2), 3)
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 2], [0, 1, 2]])
    _, ri, _ = rops.screen_select(q, x, xn2, 3, block_m=8, block_n=8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    # ties broken inside a mixed slate: rows 3 and 5 duplicate row 1
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    x[3] = x[1]
    x[5] = x[1]
    q = np.repeat(x[1:2] + 0.01, 2, axis=0)
    xn2 = np.einsum("nd,nd->n", x, x).astype(np.float32)
    _, i, _ = ops.screen_select(_t(q), _t(x), _t(xn2), 4)
    np.testing.assert_array_equal(i.numpy()[:, :3], [[1, 3, 5], [1, 3, 5]])


def test_empty_batch_and_no_candidates(rng):
    x = rng.standard_normal((10, 16)).astype(np.float32)
    xn2 = np.einsum("nd,nd->n", x, x).astype(np.float32)
    v, i, qn2 = ops.screen_select(torch.zeros((0, 16)), _t(x), _t(xn2), 4)
    assert v.shape == (0, 4) and i.shape == (0, 4) and qn2.shape == (0,)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    v, i, qn2 = ops.screen_select(_t(q), torch.zeros((0, 16)),
                                  torch.zeros(0), 4)
    assert (v.numpy() == np.inf).all() and (i.numpy() == -1).all()
    np.testing.assert_allclose(qn2.numpy(), np.einsum("md,md->m", q, q),
                               rtol=1e-6)
    v, i, _ = ops.screen_select(_t(q), _t(x), _t(xn2), 4,
                                rows=torch.zeros(0, dtype=torch.int32))
    assert (v.numpy() == np.inf).all() and (i.numpy() == -1).all()


def test_row_list_gathers_inside_the_screen(rng):
    """``rows`` picks candidates from the table: the slate (positions into
    ``rows``) equals a screen over the gathered copy."""
    q = rng.standard_normal((5, 32)).astype(np.float32)
    x = rng.standard_normal((300, 32)).astype(np.float32)
    xn2 = np.einsum("nd,nd->n", x, x).astype(np.float32)
    rows = rng.choice(300, 120, replace=False).astype(np.int32)
    v, i, _ = ops.screen_select(_t(q), _t(x), _t(xn2), 9, rows=_t(rows))
    gv, gi, _ = ops.screen_select(_t(q), _t(x[rows]), _t(xn2[rows]), 9)
    np.testing.assert_array_equal(i.numpy(), gi.numpy())
    np.testing.assert_array_equal(v.numpy(), gv.numpy())
    with pytest.raises(IndexError):
        ops.screen_select(_t(q), _t(x), _t(xn2), 9,
                          rows=torch.tensor([0, 300], dtype=torch.int32))


def test_plain_screen_refuses_tf32():
    """The certificate assumes true f32 products: the plain screen refuses
    to run while TF32 is allowed, and nothing in the port turns it on."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    q = torch.ones((2, 8))
    x = torch.ones((4, 8))
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            ref.screen_select_ref(q, x, (x * x).sum(-1), 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_cpu_tensors_never_count_as_kernel_launches(rng):
    ops.reset_launches()
    q = rng.standard_normal((4, 16)).astype(np.float32)
    x, scale, xn2 = _quantize(rng.standard_normal((40, 16)).astype(np.float32))
    ops.screen_select(_t(q), _t(x.astype(np.float32)), _t(xn2), 3)
    ops.screen_select_quant(_t(q), _t(x), _t(scale), _t(xn2), 3)
    ops.topk_ed(_t(q), _t(x.astype(np.float32)), 3)
    cfg = psum.SummarizationConfig(series_len=16, n_segments=4, card_bits=4)
    ops.summarize(_t(x.astype(np.float32)), cfg)
    ops.min_ed(_t(q), _t(x.astype(np.float32)))
    ops.mindist(_t(q[0, :4]), torch.zeros((5, 4)), torch.ones((5, 4)), cfg)
    assert ops.LAUNCHES == {"screen_select": 0, "screen_select_quant": 0,
                            "topk_ed": 0, "paa": 0, "sax_pack": 0, "min_ed": 0,
                            "mindist": 0}


# ---------------------------------------------------------------------------
# topk_ed: the kernel backend's top-k with norms computed from the rows
# ---------------------------------------------------------------------------
def _hold_topk(v, i, rv, ri, kk):
    np.testing.assert_array_equal(i.numpy()[:, :kk], np.asarray(ri)[:, :kk])
    np.testing.assert_allclose(v.numpy()[:, :kk], np.asarray(rv)[:, :kk],
                               rtol=1e-5)


@pytest.mark.parametrize("k", [1, 5, 10])
@pytest.mark.parametrize("m,n,d", [(8, 512, 128), (7, 333, 64), (64, 1024, 128),
                                   (1, 100, 96), (3, 29, 160)])
def test_topk_ed_matches_reference(m, n, d, k, rng):
    q = rng.standard_normal((m, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    v, i = ops.topk_ed(_t(q), _t(x), k)
    rv, ri = rops.topk_ed(q, x, k, block_m=8, block_n=64)
    kk = min(k, n)
    _hold_topk(v, i, rv, ri, kk)
    ov, oi = rref.topk_ed_ref(jnp.asarray(q), jnp.asarray(x), kk)
    _hold_topk(v, i, ov, oi, kk)
    assert np.all(v.numpy()[:, kk:] == np.inf)
    assert np.all(i.numpy()[:, kk:] == -1)
    assert v.shape == i.shape == (m, k) and i.dtype == torch.int32


@pytest.mark.parametrize("m,n", [(1, 3), (5, 1), (13, 67)])
def test_topk_ed_k_beyond_candidates_pads(m, n, rng):
    q = rng.standard_normal((m, 64)).astype(np.float32)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    v, i = ops.topk_ed(_t(q), _t(x), 4)
    rv, ri = rops.topk_ed(q, x, 4, block_m=8, block_n=64)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5)


def test_topk_ed_ties_break_to_smaller_index(rng):
    q = rng.standard_normal((4, 64)).astype(np.float32)
    x = np.tile(rng.standard_normal((32, 64)).astype(np.float32), (2, 1))
    v, i = ops.topk_ed(_t(q), _t(x), 3)
    assert np.all(i.numpy()[:, 0] < 32)  # duplicate at j and j+32: j wins
    _, ri = rops.topk_ed(q, x, 3, block_m=8, block_n=32)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    _, i = ops.topk_ed(torch.zeros((2, 8)), torch.zeros((8, 8)), 3)
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 2], [0, 1, 2]])


def test_topk_ed_empty_queries_and_empty_candidates(rng):
    x = rng.standard_normal((32, 64)).astype(np.float32)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    v, i = ops.topk_ed(torch.zeros((0, 64)), _t(x), 3)
    assert v.shape == (0, 3) and i.shape == (0, 3)
    v, i = ops.topk_ed(_t(q), torch.zeros((0, 64)), 3)
    assert (v.numpy() == np.inf).all() and (i.numpy() == -1).all()
    v, i = ops.topk_ed_bucketed(_t(q), torch.zeros((0, 64)), 4)
    assert v.shape == (4, 4) and (i == -1).all() and np.isinf(v).all()
    with pytest.raises(TypeError):
        ops.topk_ed(_t(q).double(), _t(x).double(), 3)


@pytest.mark.parametrize("e", [63, 64, 65, 127, 128])
def test_topk_ed_bucketed_matches_reference(e, rng):
    """The reference pads candidates to power-of-two buckets; the port does
    not, and must be indistinguishable from it on either side of a bucket."""
    q = rng.standard_normal((5, 32)).astype(np.float32)
    x = rng.standard_normal((e, 32)).astype(np.float32)
    v, i = ops.topk_ed_bucketed(_t(q), _t(x), 7)
    rv, ri = rops.topk_ed_bucketed(q, x, 7)
    assert i.dtype == np.int64 and v.dtype == np.float32
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(v, rv, rtol=1e-5)
    v, i = ops.topk_ed_bucketed(_t(q), _t(x[:3]), 7)
    rv, ri = rops.topk_ed_bucketed(q, x[:3], 7)
    assert i.shape == (5, 3)
    np.testing.assert_array_equal(i, ri)


# ---------------------------------------------------------------------------
# the summarize front: PAA -> SAX symbols -> interleaved sortable keys
# ---------------------------------------------------------------------------
def _near_breakpoint(x, p, c):
    """Rows with a PAA value nearer a breakpoint than the f32 error of a
    segment mean in any summation order (``2 L u mean|x|``, u = 2^-24):
    the only rows whose symbols may depend on the order."""
    b, n = x.shape
    w = p.shape[1]
    mag = np.abs(x.astype(np.float64)).reshape(b, w, n // w).mean(-1)
    bound = 2.0 * (n // w) * 2.0 ** -24 * mag
    bps = psum.breakpoints(c).astype(np.float64)
    gap = np.abs(p.astype(np.float64)[..., None] - bps).min(-1)
    return (gap <= bound).any(-1)


@pytest.mark.parametrize("b,n,w", [(64, 128, 16), (100, 256, 16), (8, 64, 8),
                                   (257, 96, 12), (4, 16384, 16)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_paa_matches_reference(b, n, w, dtype, rng):
    rc = rsum.SummarizationConfig(series_len=n, n_segments=w, card_bits=8)
    pc = psum.SummarizationConfig(series_len=n, n_segments=w, card_bits=8)
    x = rng.standard_normal((b, n)).astype(dtype)
    out = ops.paa(_t(x.astype(np.float32)), pc)
    np.testing.assert_allclose(out.numpy(), np.asarray(rops.paa(x, rc)),
                               rtol=1e-5, atol=1e-6)
    # one fixed summation order: left to right, then divided by the length
    seg = x.astype(np.float32).reshape(b, w, n // w)
    acc = seg[:, :, 0].copy()
    for j in range(1, n // w):
        acc += seg[:, :, j]
    np.testing.assert_array_equal(out.numpy(), acc / np.float32(n // w))


@pytest.mark.parametrize("b,w,c", [(64, 16, 8), (100, 8, 4), (33, 12, 6),
                                   (8, 16, 2)])
def test_sax_and_keys_match_reference(b, w, c, rng):
    rc = rsum.SummarizationConfig(series_len=w * 4, n_segments=w, card_bits=c)
    pc = psum.SummarizationConfig(series_len=w * 4, n_segments=w, card_bits=c)
    p = rng.standard_normal((b, w)).astype(np.float32)
    p[0, :3] = psum.breakpoints(c)[:3]  # values exactly on a breakpoint
    sym, keys = ops.sax_and_keys(_t(p), pc)
    rsym, rkeys = rops.sax_and_keys(p, rc)
    assert sym.dtype == torch.int32 and keys.dtype == torch.int64
    np.testing.assert_array_equal(sym.numpy(), np.asarray(rsym))
    host = ops.keys_to_host(keys)
    assert host.dtype == np.uint32
    np.testing.assert_array_equal(host, np.asarray(rkeys))
    np.testing.assert_array_equal(host, psort.interleave(psum.sax_from_paa(p, pc), pc))


@pytest.mark.parametrize("b,n,w,c", [(120, 128, 16, 8), (77, 64, 8, 6),
                                     (16, 256, 16, 8)])
def test_summarize_matches_reference_and_host(b, n, w, c, rng):
    """Keys equal the reference's kernel path and the host summarization,
    except on rows whose PAA lies within f32 tolerance of a breakpoint
    (counted; the summation orders differ there)."""
    rc = rsum.SummarizationConfig(series_len=n, n_segments=w, card_bits=c)
    pc = psum.SummarizationConfig(series_len=n, n_segments=w, card_bits=c)
    x = rng.standard_normal((b, n)).astype(np.float32).cumsum(axis=1) / 8
    p, sym, keys = ops.summarize(_t(x), pc)
    rp, rsym, rkeys = rops.summarize(x, rc)
    near = _near_breakpoint(x, p.numpy(), c)
    assert near.mean() < 0.05
    far = ~near
    np.testing.assert_allclose(p.numpy(), np.asarray(rp), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(sym.numpy()[far], np.asarray(rsym)[far])
    np.testing.assert_array_equal(ops.keys_to_host(keys)[far], np.asarray(rkeys)[far])
    hsym = psum.sax(x, pc)
    np.testing.assert_array_equal(sym.numpy()[far], hsym[far])
    np.testing.assert_array_equal(ops.keys_to_host(keys)[far],
                                  psort.interleave(hsym, pc)[far])


def test_summarize_skips_znorm_like_the_reference(rng):
    """The reference's kernel path summarizes raw series whatever
    ``cfg.znorm`` says (its host ``paa`` z-normalizes); the port keeps that."""
    pc = psum.SummarizationConfig(series_len=64, n_segments=8, card_bits=6,
                                  znorm=True)
    rc = rsum.SummarizationConfig(series_len=64, n_segments=8, card_bits=6,
                                  znorm=True)
    x = 3.0 + rng.standard_normal((20, 64)).astype(np.float32)
    p, sym, _ = ops.summarize(_t(x), pc)
    np.testing.assert_allclose(p.numpy(), np.asarray(rops.summarize(x, rc)[0]),
                               rtol=1e-5)
    assert not np.array_equal(sym.numpy(), psum.sax(x, pc))


def test_summarize_empty_batch(rng):
    cfg = psum.SummarizationConfig(series_len=64, n_segments=8, card_bits=6)
    assert ops.paa(torch.zeros((0, 64)), cfg).shape == (0, 8)
    sym, keys = ops.sax_and_keys(torch.zeros((0, 8)), cfg)
    assert sym.shape == (0, 8) and keys.shape == (0, cfg.key_words)
    assert sym.dtype == torch.int32 and keys.dtype == torch.int64
    p, sym, keys = ops.summarize(torch.zeros((0, 64)), cfg)
    assert p.shape == (0, 8) and sym.shape == (0, 8)
    with pytest.raises(ValueError):
        ops.paa(torch.zeros((3, 60)), cfg)


# ---------------------------------------------------------------------------
# slates beyond one kernel pass: the pass loop over the plain versions
# ---------------------------------------------------------------------------
def _tied_table(rng, n, d):
    """Rows with exact duplicates (equal d2 to any query) and all-zero rows
    (equal d2 among themselves), so passes end inside runs of ties."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[1::7] = x[0]
    x[3::11] = 0.0
    return x


@pytest.mark.parametrize("kk", [20, 50])
@pytest.mark.parametrize("name", ["screen_select", "screen_select_quant", "topk_ed"])
def test_slate_in_passes_equals_the_one_shot_slate(name, kk, rng):
    """``ops`` takes a slate longer than one kernel pass in passes, each
    after the previous pass's last entry. With the pass width patched to 8,
    the passes over the plain versions must give the one-shot slate,
    ties included."""
    q = _t(rng.standard_normal((6, 24)).astype(np.float32))
    q[1] = 0.0  # every all-zero row ties with every other for this query
    xf = _tied_table(rng, 90, 24)
    if name == "screen_select_quant":
        xi, scale, xn2 = (_t(a) for a in _quantize(xf))

        def plain(s, floor=None):
            return ref.screen_select_quant_ref(q, xi, scale, xn2, s, floor=floor)
    elif name == "screen_select":
        x = _t(xf)
        xn2 = (x * x).sum(-1)

        def plain(s, floor=None):
            return ref.screen_select_ref(q, x, xn2, s, floor=floor)
    else:
        x = _t(xf)

        def plain(s, floor=None):
            v, i = ref.topk_ed_ref(q, x, s, floor=floor)
            return v, i, None
    passes = []

    def step(s, floor):
        passes.append(s)
        return plain(s, floor)

    v, i, _ = ops.slate_in_passes(step, kk, 8)
    want_v, want_i, _ = plain(kk)
    assert passes == [8] * (kk // 8) + ([kk % 8] if kk % 8 else [])
    np.testing.assert_array_equal(i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(v.numpy(), want_v.numpy())
    # a floor past every candidate leaves only empty slots
    v, i, _ = plain(4, (torch.full((6,), np.inf), torch.full((6,), 90)))
    assert (v == np.inf).all() and (i == ref.EMPTY_ID).all()


# ---------------------------------------------------------------------------
# min_ed: per-query minimum squared ED and its row
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,n,d", [(8, 512, 128), (7, 333, 64), (128, 1024, 256),
                                   (1, 100, 96)])
def test_min_ed_matches_reference(m, n, d, rng):
    q = rng.standard_normal((m, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    v, i = ops.min_ed(_t(q), _t(x))
    rv, ri = rops.min_ed(q, x, block_m=8, block_n=64)
    assert v.shape == i.shape == (m,) and i.dtype == torch.int32
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=2e-4, atol=1e-3)
    # ids equal, or the rows picked lie within the tolerance of each other
    # (tiled and whole-matrix f32 sums differ in the last bits: F1)
    d2 = ((x.astype(np.float64)[None] - q.astype(np.float64)[:, None]) ** 2).sum(-1)
    rows = np.arange(m)
    same = i.numpy() == np.asarray(ri)
    np.testing.assert_allclose(d2[rows, i.numpy()][~same],
                               d2[rows, np.asarray(ri)][~same], rtol=2e-4, atol=1e-3)


def test_min_ed_empty_cases(rng):
    x = _t(rng.standard_normal((10, 16)).astype(np.float32))
    v, i = ops.min_ed(torch.zeros((0, 16)), x)
    rv, ri = rops.min_ed(np.zeros((0, 16), np.float32), x.numpy())
    assert v.shape == i.shape == (0,) == np.asarray(rv).shape
    v, i = ops.min_ed(torch.ones((3, 16)), torch.zeros((0, 16)))
    rv, ri = rops.min_ed(np.ones((3, 16), np.float32), np.zeros((0, 16), np.float32))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert (v.numpy() == np.inf).all() and (i.numpy() == -1).all()
    with pytest.raises(TypeError):
        ops.min_ed(torch.ones((2, 16), dtype=torch.float64), x.double())
    with pytest.raises(ValueError):
        ops.min_ed(torch.ones((2, 8)), x)


def test_min_ed_argmin_is_exact_on_separated_data(rng):
    q = rng.standard_normal((4, 64)).astype(np.float32)
    x = rng.standard_normal((256, 64)).astype(np.float32) + 10.0
    x[17] = q[0]
    x[42] = q[1]
    x[200] = q[2]
    x[3] = q[3]
    v, i = ops.min_ed(_t(q), _t(x))
    rv, ri = rops.min_ed(q, x, block_m=8, block_n=64)
    np.testing.assert_array_equal(i.numpy(), [17, 42, 200, 3])
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), 0.0, atol=1e-3)


@pytest.mark.parametrize("m,n,d", [(8, 512, 128), (3, 29, 160), (16, 1000, 256)])
def test_topk_ed_at_k1_agrees_with_min_ed(m, n, d, rng):
    q = _t(rng.standard_normal((m, d)).astype(np.float32))
    x = _t(rng.standard_normal((n, d)).astype(np.float32))
    v, i = ops.min_ed(q, x)
    tv, ti = ops.topk_ed(q, x, 1)
    np.testing.assert_array_equal(i.numpy(), ti.numpy()[:, 0])
    np.testing.assert_array_equal(v.numpy(), tv.numpy()[:, 0])


def test_min_ed_duplicate_rows_keep_the_lower_index(rng):
    base = rng.standard_normal((32, 64)).astype(np.float32)
    x = np.tile(base, (3, 1))  # row j == row j + 32 == row j + 64
    q = base[[5, 9, 30]] + 0.01
    v, i = ops.min_ed(_t(q), _t(x))
    np.testing.assert_array_equal(i.numpy(), [5, 9, 30])
    _, ri = rops.min_ed(q, x, block_m=8, block_n=32)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    v, i = ops.min_ed(torch.zeros((2, 8)), torch.zeros((8, 8)))
    np.testing.assert_array_equal(i.numpy(), [0, 0])


# ---------------------------------------------------------------------------
# mindist: the MINDIST_PAA_SAX lower bound
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,w", [(512, 16), (100, 8), (2048, 16)])
def test_mindist_matches_reference(b, w, rng):
    rc = rsum.SummarizationConfig(series_len=w * 8, n_segments=w, card_bits=8)
    pc = psum.SummarizationConfig(series_len=w * 8, n_segments=w, card_bits=8)
    sym = rng.integers(0, 256, (b, w)).astype(np.int64)
    lo, hi = psum.sax_region(sym, pc)
    qp = rng.standard_normal(w).astype(np.float32)
    out = ops.mindist(_t(qp), _t(lo), _t(hi), pc)
    expect = rops.mindist(qp, lo, hi, rc, block_b=128)
    assert out.shape == (b,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=1e-5)
    # the kernel's order: segments added left to right, each step rounded
    d = np.maximum(np.maximum(lo - qp, np.float32(0)), np.maximum(qp - hi, np.float32(0)))
    acc = np.zeros(b, np.float32)
    for s in range(w):
        acc = acc + d[:, s] * d[:, s]
    np.testing.assert_array_equal(out.numpy(), acc * np.float32(pc.segment_len))


def test_mindist_empty_batch(rng):
    pc = psum.SummarizationConfig(series_len=64, n_segments=8, card_bits=6)
    rc = rsum.SummarizationConfig(series_len=64, n_segments=8, card_bits=6)
    qp = rng.standard_normal(8).astype(np.float32)
    out = ops.mindist(_t(qp), torch.zeros((0, 8)), torch.zeros((0, 8)), pc)
    assert out.shape == (0,) and out.dtype == torch.float32
    assert np.asarray(rops.mindist(qp, np.zeros((0, 8), np.float32),
                                   np.zeros((0, 8), np.float32), rc)).shape == (0,)
    with pytest.raises(ValueError):
        ops.mindist(_t(qp), torch.zeros((3, 8)), torch.zeros((3, 4)), pc)
    with pytest.raises(TypeError):
        ops.mindist(_t(qp), torch.zeros((3, 8), dtype=torch.float64),
                    torch.zeros((3, 8), dtype=torch.float64), pc)


@pytest.mark.parametrize("w,c", [(16, 8), (8, 4)])
def test_mindist_lower_bounds_the_f64_ed(w, c, rng):
    """Every entry's bound (its SAX region against the query's PAA) lies at
    or below its f64 squared ED to the query, up to f32 rounding; so do the
    bounds of block zone maps over the same entries."""
    n = 128
    cfg = psum.SummarizationConfig(series_len=n, n_segments=w, card_bits=c)
    x = rng.standard_normal((600, n)).astype(np.float32).cumsum(axis=1) / 8
    q = rng.standard_normal((5, n)).astype(np.float32).cumsum(axis=1) / 8
    sym = psum.sax(x, cfg)
    lo, hi = psum.sax_region(sym, cfg)
    qp = ops.paa(_t(q), cfg)
    ed2 = ((x.astype(np.float64)[None] - q.astype(np.float64)[:, None]) ** 2).sum(-1)
    for j in range(q.shape[0]):
        lb = ops.mindist(qp[j], _t(lo), _t(hi), cfg).numpy().astype(np.float64)
        assert (lb <= ed2[j] * (1 + 1e-5)).all()
        assert (lb > 0).mean() > 0.5  # the bound prunes, not only holds
        blocks = sym.reshape(6, 100, w)
        blo, bhi = psum.sax_region(blocks.min(1), cfg)[0], psum.sax_region(blocks.max(1),
                                                                           cfg)[1]
        blb = ops.mindist(qp[j], _t(blo), _t(bhi), cfg).numpy().astype(np.float64)
        assert (blb <= ed2[j].reshape(6, 100).min(1) * (1 + 1e-5)).all()


# ---------------------------------------------------------------------------
# the int8 kernel's one-launch merge rule, emulated in plain torch
# ---------------------------------------------------------------------------
def _split_slates(d2, k, bounds, floor):
    """Per row: each split [a, b)'s lexicographic top-k of the candidates
    after the floor, padded with (inf, EMPTY_ID), and T, the least k-th
    entry over the splits."""
    empty = (float("inf"), ref.EMPTY_ID)
    for row in range(d2.shape[0]):
        vals = d2[row].tolist()
        fk = None if floor is None else (float(floor[0][row]), int(floor[1][row]))
        slates = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            ents = sorted(e for e in ((vals[j], j) for j in range(a, b))
                          if fk is None or fk < e)[:k]
            slates.append(ents + [empty] * (k - len(ents)))
        yield slates, min(sl[k - 1] for sl in slates)


def _threshold_merge(d2, k, bounds, floor=None):
    """The threshold rule: the first k of the real split entries at or
    below T."""
    empty = (float("inf"), ref.EMPTY_ID)
    out = []
    for slates, t in _split_slates(d2, k, bounds, floor):
        kept = sorted(e for sl in slates for e in sl if e <= t and e != empty)[:k]
        out.append(kept + [empty] * (k - len(kept)))
    return out


def _minima_walk_merge(d2, k, bounds, floor=None):
    """The merge of ``csrc/screen_quant.cu``: every split's least entry (at
    or below T) is offered, then the splits whose least entry made the slate
    are walked in order while their entries beat the slate's worst entry
    and lie at or below T."""
    empty = (float("inf"), ref.EMPTY_ID)
    out = []
    for slates, t in _split_slates(d2, k, bounds, floor):
        slate = sorted(sl[0] for sl in slates if sl[0] <= t and sl[0] != empty)[:k]
        slate += [empty] * (k - len(slate))
        walked = [sl for sl in slates if sl[0] in slate and sl[0] != empty]
        for sl in walked:
            for e in sl[1:]:
                if not (e < slate[-1] and e <= t):
                    break
                slate = sorted(slate + [e])[:k]
        out.append(slate)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rule", [_threshold_merge, _minima_walk_merge],
                         ids=["threshold", "minima-walk"])
@pytest.mark.parametrize("case", ["random", "ties", "empty-splits", "short-splits",
                                  "s=1", "floor", "floor-past-most", "all-equal"])
def test_split_merge_equals_the_one_shot_slate(case, rule, seed):
    """Merging the splits' slates by either rule loses no entry of the
    row's slate: cutting them at the least k-th entry over the splits, and
    walking from the split minima (the int8 kernel's merge). Exact ties
    across splits, empty splits, splits shorter than k, k = 1 and a
    floor."""
    rng = np.random.default_rng(seed)
    m, n, k, n_cuts = 5, 240, 13, 7
    d2 = rng.standard_normal((m, n)).astype(np.float32)
    if case == "ties":  # few distinct values: exact ties inside and across splits
        d2 = rng.integers(0, 4, (m, n)).astype(np.float32)
    elif case == "all-equal":
        d2 = np.zeros((m, n), np.float32)
    elif case == "short-splits":
        k, n_cuts = 30, 40  # splits of ~6 candidates, shorter than k
    elif case == "s=1":
        k = 1
    cuts = np.sort(rng.integers(0, n + 1, n_cuts))
    if case == "empty-splits":
        cuts = np.repeat(cuts, 2)  # every other split is empty
    bounds = [0, *cuts.tolist(), n]
    d2 = torch.from_numpy(d2)
    floor = None
    if case.startswith("floor"):  # the last entry of an earlier pass of the row
        sv, si = ref._lex_topk(d2, 200 if case == "floor-past-most" else 40)
        floor = (sv[:, -1], si[:, -1])
    want_v, want_i = ref._lex_topk(d2, k, floor)
    got = rule(d2, k, bounds, floor)
    assert torch.equal(torch.tensor([[e[1] for e in r] for r in got], dtype=torch.int32),
                       want_i)
    assert torch.equal(torch.tensor([[e[0] for e in r] for r in got]), want_v)


# ---------------------------------------------------------------------------
# the fused screen's layout (csrc/screen_fused.cu): its splits and its staging
# ---------------------------------------------------------------------------
FUSED_CU = Path(ops.__file__).resolve().parent / "csrc" / "screen_fused.cu"


def _fused_constants():
    """The ``constexpr int`` constants of the fused screen's source."""
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", FUSED_CU.read_text())}


# (queries, candidates, SMs) of each split plan: the serving pass (16 queries
# over 2,048 gathered rows on 8 SMs: one tile a split, as 16,384 rows on
# 132); 64 queries over 8,292 rows (several tiles a split and a short last
# one, as over the full table); topk_ed's most frequent pass on the card's
# own 132 SMs (1 query over 32,768 rows: 256 one-tile splits, 15 of the
# block's 16 query slots empty); topk_ed over a table of 5,000 rows, not a
# whole number of tiles, at 64 queries (32-query blocks, BM_WIDE)
_SPLIT_SHAPES = {"serving": (16, 2048, 8), "full": (64, 8292, 8),
                 "topk-pass": (1, 32768, 132), "topk-wide": (64, 5000, 8)}


@pytest.mark.parametrize("s", [13, 128])
@pytest.mark.parametrize("case", ["random", "ties", "floor"])
@pytest.mark.parametrize("shape", ["serving", "full", "topk-pass", "topk-wide"])
def test_minima_walk_over_the_splits_ops_makes(shape, case, s, monkeypatch):
    """The fused kernel's merge rule over the candidate splits that
    ``ops._splits`` makes for the kernel's layout (8 SMs standing in for the
    card's 132, except at topk_ed's pass, planned for 132), for the screens
    and topk_ed (``_SPLIT_SHAPES``). The merged slate equals the one-shot
    slate."""
    c = _fused_constants()
    layout = {"tile": c["TN"], "query_block": c["BM"], "pass_slate": c["PASS_SLATE"]}
    cpu = torch.device("cpu")
    m, n, sms = _SPLIT_SHAPES[shape]
    monkeypatch.setitem(ops._SM_COUNT, cpu, sms)
    chunk, n_splits = ops._splits(cpu, n, m, s, layout)
    assert chunk % layout["tile"] == 0 and (n_splits - 1) * chunk < n <= n_splits * chunk
    if shape in ("serving", "topk-pass"):
        assert chunk == layout["tile"]
    else:
        assert chunk > layout["tile"] and n % chunk
    if shape == "topk-pass":
        assert n_splits == 256 and c["BM"] - m == 15
    if shape == "topk-wide":  # f32 at m > BM: blocks of BM_WIDE, fewer than the tickets
        assert m > c["BM"] and -(-m // c["BM_WIDE"]) == 2 <= -(-m // c["BM"])
    bounds = [min(n, j * chunk) for j in range(n_splits + 1)]
    rng = np.random.default_rng(len(case) + s)
    rows = min(m, 4)  # the merge is per query: a few rows of the batch
    d2 = rng.standard_normal((rows, n)).astype(np.float32)
    if case == "ties":
        d2 = rng.integers(0, 4, (rows, n)).astype(np.float32)
    d2 = torch.from_numpy(d2)
    floor = None
    if case == "floor":
        sv, si = ref._lex_topk(d2, 40)
        floor = (sv[:, -1], si[:, -1])
    want_v, want_i = ref._lex_topk(d2, s, floor)
    got = _minima_walk_merge(d2, s, bounds, floor)
    assert torch.equal(torch.tensor([[e[1] for e in r] for r in got], dtype=torch.int32),
                       want_i)
    assert torch.equal(torch.tensor([[e[0] for e in r] for r in got]), want_v)


class _RecordingLibrary:
    """A stand-in for the built kernel library: records each
    ``coconut_topk_ed`` and ``coconut_min_ed`` call and launches nothing."""

    def __init__(self):
        self.calls = []

    def coconut_topk_ed(self, *args):
        self.calls.append(args)
        return 0

    def coconut_min_ed(self, *args):
        self.calls.append(args)
        return 0


def _record_launches(monkeypatch):
    """The recording library in place of the built one, the fused kernel's
    layout as the library's only layout (so that a plan from any other
    fails), the card's 132 SMs standing in for the CPU's, and a record of
    the int64 tensors made (the wrappers' scratch), by data pointer.
    Returns (library, screen layout, int64 tensors)."""
    from repro_torch.kernels import _build

    c = _fused_constants()
    screen = {"tile": c["TN"], "query_block": c["BM"], "pass_slate": c["PASS_SLATE"]}
    monkeypatch.setattr(_build, "layout", lambda: {"screen": screen})
    lib = _RecordingLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(ops, "_stream", lambda dev: 0)
    monkeypatch.setitem(ops._SM_COUNT, torch.device("cpu"), 132)
    int64 = {}
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        if t.dtype == torch.int64:
            int64[t.data_ptr()] = t
        return t

    monkeypatch.setattr(torch, "empty", empty)
    return lib, screen, int64


def test_topk_ed_wrapper_plans_from_the_screen_layout(monkeypatch):
    """``ops.topk_ed``'s CUDA wrapper (run here over CPU tensors against a
    recording library) plans each pass from the fused kernel's layout: its
    splits are ``ops._splits`` of the screen layout, its one int64 scratch
    holds the partial slates, the thresholds and a ticket per query block
    of that layout, and it calls ``coconut_topk_ed`` once per pass, counting
    each call once. A slate of 200 takes two passes, the second after the
    first's last entry."""
    c = _fused_constants()
    lib, screen, int64 = _record_launches(monkeypatch)
    cpu = torch.device("cpu")
    m, n, d, k = 3, 5000, 24, 200
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((m, d)).astype(np.float32))
    x = _t(rng.standard_normal((n, d)).astype(np.float32))
    ops.reset_launches()
    v, i, _ = ops._launch_screen("topk_ed", q, x, None, None, k, k, None, n)
    assert v.shape == i.shape == (m, k)
    assert ops.LAUNCHES["topk_ed"] == len(lib.calls) == 2
    assert sum(ops.LAUNCHES.values()) == 2
    m_blocks = -(-m // c["BM"])
    for call, s in zip(lib.calls, (c["PASS_SLATE"], k - c["PASS_SLATE"])):
        (q_ptr, cm, cd, x_ptr, cn, cs, chunk, n_splits, fv, fi, scratch,
         *_outs, stream) = call
        assert (q_ptr, cm, cd, x_ptr, cn, cs, stream) == (q.data_ptr(), m, d, x.data_ptr(),
                                                          n, s, 0)
        assert (chunk, n_splits) == ops._splits(cpu, n, m, s, screen)
        assert int64[scratch].numel() == m * n_splits * s + m + -(-m_blocks // 2)
        assert (fv is None) == (fi is None) == (s == c["PASS_SLATE"])


@pytest.mark.parametrize("m,n,d", [(5, 1, 8), (17, 5000, 24), (64, 100003, 8)])
def test_min_ed_wrapper_plans_from_the_screen_layout(m, n, d, monkeypatch):
    """``ops.min_ed``'s CUDA wrapper (run here over CPU tensors against a
    recording library) makes one ``coconut_min_ed`` call per batch over the
    splits of topk_ed's pass at k = 1 (``ops._splits`` of the screen
    layout, s = 1), with a scratch of m int64 keys, and counts it once."""
    lib, screen, int64 = _record_launches(monkeypatch)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(m)
    q = _t(rng.standard_normal((m, d)).astype(np.float32))
    x = _t(rng.standard_normal((n, d)).astype(np.float32))
    ops.reset_launches()
    v, i = ops._launch_min_ed(q, x)
    assert v.shape == i.shape == (m,) and v.dtype == torch.float32 and i.dtype == torch.int32
    assert ops.LAUNCHES["min_ed"] == len(lib.calls) == 1
    assert sum(ops.LAUNCHES.values()) == 1
    q_ptr, cm, cd, x_ptr, cn, chunk, n_splits, best, out_v, out_i, stream = lib.calls[0]
    assert (q_ptr, cm, cd, x_ptr, cn, stream) == (q.data_ptr(), m, d, x.data_ptr(), n, 0)
    assert (chunk, n_splits) == ops._splits(cpu, n, m, 1, screen)
    assert (out_v, out_i) == (v.data_ptr(), i.data_ptr())
    assert int64[best].shape == (m,)


# ---------------------------------------------------------------------------
# min_ed's epilogue on the fused body, emulated in plain torch
# ---------------------------------------------------------------------------
_NO_KEY = (1 << 63) - 1  # the all-ones key, in the signed order below


def _lex_keys(d2, rows):
    """``lex_key`` of csrc/screen_fused.cu as int64s whose signed order is
    the keys' unsigned order (the top bit flipped): the d2 bits made
    order-preserving, -0.0 first made +0.0, then the row below them."""
    bits = (d2 + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(bits >= 1 << 31, 0xFFFFFFFF - bits, bits | (1 << 31))
    return (b - (1 << 31)) * (1 << 32) + rows


def _unpack_keys(keys):
    """``min_ed_unpack_kernel``: each key's d2 and row."""
    b = (keys >> 32) + (1 << 31)
    bits = torch.where(b >= 1 << 31, b & 0x7FFFFFFF, 0xFFFFFFFF - b)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32), (keys & 0xFFFFFFFF).to(torch.int32)


def _min_fold(d2, chunk, n_splits, bq, rng):
    """min_ed's epilogue, emulated: per split, query block and warp, the
    least key of the rows the warp's lanes take in each of the split's tiles
    (real rows only) for the warp's queries (real queries only: the rows of
    a block past m repeat query m - 1); then those minima folded into the
    answer with ``min`` in a shuffled order, as the blocks' atomicMins
    land. Returns the (m,) keys and the count of (split, block, warp) minima
    that held no key."""
    c = _fused_constants()
    tn, qt, warps = c["TN"], c["QT"], c["NTHREADS"] // 32
    m, n = d2.shape
    ct = bq * tn // c["NTHREADS"] // qt
    qgroups = bq // qt  # warps w and w + qgroups share queries, split a tile's rows
    keys = _lex_keys(d2, torch.arange(n))
    minima, empty = [], 0
    for split in range(n_splits):
        lo, hi = split * chunk, min(n, (split + 1) * chunk)
        rows = torch.arange(lo, max(lo, hi))
        taken = 0
        for mb in range(-(-m // bq)):
            for warp in range(warps):
                qg, grp = warp % qgroups, warp // qgroups
                cols = rows[((rows - lo) % tn) // (32 * ct) == grp]
                taken += len(cols) if mb == 0 and qg == 0 else 0
                queries = [g for g in (mb * bq + qt * qg + i for i in range(qt)) if g < m]
                if not queries:
                    continue
                if len(cols) == 0:
                    empty += 1
                    continue
                minima.append((queries, keys[queries][:, cols].amin(1)))
        assert taken == len(rows)  # the warps of a query group take each row once
    best = torch.full((m,), _NO_KEY, dtype=torch.int64)
    for j in rng.permutation(len(minima)):
        queries, k = minima[j]
        best[queries] = torch.minimum(best[queries], k)
    return best, empty


@pytest.mark.parametrize("m", [5, 17, 33])
@pytest.mark.parametrize("case", ["random", "border-tie", "signed-zero", "pad-split"])
def test_min_fold_over_the_splits_ops_makes(case, m, monkeypatch):
    """min_ed's epilogue over the splits ``ops._splits`` makes for topk_ed's
    pass at k = 1 (8 SMs standing in for the card's 132, so that a split
    holds several tiles and the last one is short), at 16-query blocks (m =
    5) and 32-query blocks (m = 17, 33; partial blocks): the folded keys
    give ``ref.min_ed_ref``'s answer and ``topk_ed_ref``'s k = 1 answer bit
    for bit, whatever order the minima land in. Cases: random rows; a row
    and its copy in the next split (the lower row wins); d2 of +0.0 and
    -0.0 tied across splits (the lower row wins, as +0.0); a split past the
    last row, of pad rows only (it folds nothing)."""
    c = _fused_constants()
    cpu = torch.device("cpu")
    monkeypatch.setitem(ops._SM_COUNT, cpu, 8)
    layout = {"tile": c["TN"], "query_block": c["BM"], "pass_slate": c["PASS_SLATE"]}
    n, d = 5000, 24
    bq = c["BM"] if m <= c["BM"] else c["BM_WIDE"]
    chunk, n_splits = ops._splits(cpu, n, m, 1, layout)
    assert chunk > c["TN"] and n % chunk and n_splits > 2
    rng = np.random.default_rng(m + len(case))
    q = rng.standard_normal((m, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    a = int(rng.integers(0, chunk))
    if case == "border-tie":  # row a (split 0) copied into split 1, asked exactly
        x[a + chunk] = x[a]
        q[0] = x[a]
    q, x = _t(q), _t(x)
    # the d2 of topk_ed_ref (and so of min_ed_ref), the same expression
    d2 = (q * q).sum(-1)[:, None] + (x * x).sum(-1)[None, :] - 2.0 * (q @ x.T)
    if case == "signed-zero":  # +0.0 and -0.0 tied, a split apart, both ways round
        d2 = d2.abs() + 1.0
        d2[0::2, a], d2[0::2, a + chunk] = 0.0, -0.0
        d2[1::2, a], d2[1::2, a + chunk] = -0.0, 0.0
    splits = n_splits + 1 if case == "pad-split" else n_splits
    best, empty = _min_fold(d2, chunk, splits, bq, rng)
    assert (empty > 0) == (case == "pad-split")  # only the pad split's warps hold no key
    v, i = _unpack_keys(best)
    want_v, want_i = ref._lex_topk(d2, 1)
    want_v = want_v[:, 0] + 0.0  # the key keeps +0.0 for -0.0
    assert torch.equal(i, want_i[:, 0])
    assert torch.equal(v.view(torch.int32), want_v.view(torch.int32))
    if case == "signed-zero":
        assert (i == a).all() and (v.view(torch.int32) == 0).all()
    else:
        rv, ri = ref.min_ed_ref(q, x)
        tv, ti = ref.topk_ed_ref(q, x, 1)
        assert torch.equal(i, ri) and torch.equal(i, ti[:, 0])
        assert torch.equal(v.view(torch.int32), rv.view(torch.int32))
        assert torch.equal(v.view(torch.int32), tv[:, 0].view(torch.int32))
    if case == "border-tie":
        assert int(i[0]) == a


def _xs_off(row, kk, ksp):
    """``xs_off`` of csrc/screen_fused.cu: the byte of a staged slice that
    holds byte kk of tile row ``row``."""
    return row * ksp + ((((kk >> 4) ^ row) & 7 | (kk >> 4) & ~7) << 4) + (kk & 15)


@pytest.mark.parametrize("width", [256, 200, 144])
@pytest.mark.parametrize("elt", [1, 2, 4])
def test_staged_slice_layout(elt, width):
    """A stage of ``width`` bytes a row (a whole stage, d = 200 int8, 100
    bf16 or 50 f32, and the last stage of d = 100 f32) at the kernel's slice
    stride of 256 bytes: every byte of the tile has a place of its own; a
    value, and each 16-, 4- or 1-byte copy unit, stays whole; the eight rows
    that a quarter warp reads hit eight distinct 16-byte bank groups; and
    the kernel's shortcuts for the chunk and tail offsets agree with it."""
    c = _fused_constants()
    tn, ks = c["TN"], c["KS"]
    ksp = (min(width, ks) + 127) & ~127  # slice_stride
    assert ksp == 256 and width % elt == 0
    off = np.array([[_xs_off(r, kk, ksp) for kk in range(width)] for r in range(tn)])
    assert off.min() >= 0 and off.max() < tn * ksp
    assert len(np.unique(off)) == off.size  # no two bytes share a place
    if width == ksp:
        assert len(np.unique(off)) == tn * ksp  # the slice is a bijection of its bytes
    for unit in {elt, 16, 4, 1}:
        if width % unit:
            continue
        start = off[:, ::unit]
        for b in range(1, unit):
            assert (off[:, b::unit] == start + b).all()
    for base in range(0, tn, 8):
        for kc in range(width // 16):
            groups = {(_xs_off(base + lane, 16 * kc, ksp) >> 4) & 7 for lane in range(8)}
            assert len(groups) == 8
    for row in range(tn):
        sw = row & 7
        for kc in range(width // 16):  # stage_dots' chunk offset
            assert row * ksp + ((((kc ^ sw) & 7) | (kc & ~7)) << 4) == off[row, 16 * kc]
        for kk in range(width // 16 * 16, width, elt):  # its tail offset
            assert row * ksp + (_xs_off(0, kk, ksp) ^ (sw << 4)) == off[row, kk]


# ---------------------------------------------------------------------------
# sax_pack's layout (csrc/summarize.cu): (row, segment) threads, the search
# down the breadth-first breakpoints, its steps' warp votes as bit planes,
# whole words built from the planes' pieces
# ---------------------------------------------------------------------------
SUMMARIZE_CU = Path(ops.__file__).resolve().parent / "csrc" / "summarize.cu"


def _summarize_constants():
    """The ``constexpr int`` constants of the summarize source, products
    and quotients of integer literals evaluated as C does (left to
    right, integer division)."""
    return {k: eval(v.replace("/", "//"), {"__builtins__": {}})  # digits and * / only
            for k, v in re.findall(r"constexpr int (\w+) = ([\d */]+);",
                                   SUMMARIZE_CU.read_text())}


def _sax_rows_per_sub(w, threads):
    """Rows of one sub-tile, as ``coconut_sax_pack`` plans them: 32 / w
    whole rows a warp, or ceil(w / 32) warps a row."""
    warps = threads // 32
    return warps * (32 // w) if w <= 32 else warps // -(-w // 32)


def _sax_task(i, w, c, nw, rows_per_sub, warps):
    """Word i of a tile as the kernel plans it: (first piece's plane, the
    row's first lane, where the piece starts against the word, its slice,
    count of pieces)."""
    per_warp = 32 // w if w <= 32 else 1
    warps_per_row = 1 if w <= 32 else -(-w // 32)
    rb, t = divmod(i, nw)
    if w <= 32:
        slot, lane0 = rb // per_warp, (rb % per_warp) * w
    else:
        k = rb // rows_per_sub
        slot, lane0 = k * warps + (rb - k * rows_per_sub) * warps_per_row, 0
    first, end = 32 * t, min(32 * t + 32, c * w)
    bit = first // w
    j = (first - bit * w) >> 5
    pieces, at, jj = 0, bit * w + 32 * j, j
    while at < end:
        at += min(32, w - 32 * jj)
        jj = 0 if jj + 1 == warps_per_row else jj + 1
        pieces += 1
    return (slot + j) * 8 + bit, lane0, bit * w + 32 * j - first, j, pieces


def _pack_task(plane, lane0, at, j, pieces):
    return (plane & 0x3FF) | lane0 << 10 | (at + 32) << 15 | j << 21 | pieces << 24


def _unpack_task(task):
    return (task & 0x3FF, (task >> 10) & 0x1F, ((task >> 15) & 0x3F) - 32,
            (task >> 21) & 7, (task >> 24) & 0x3F)


def _brev32(x):
    return int(f"{x:032b}"[::-1], 2)


def _emulate_sax_pack(p, bps, c, nw, sms=2):
    """``coconut_sax_pack`` and ``sax_pack_kernel`` on ``sms`` SMs, block by
    block: the persistent blocks' walk over tiles with the planes in two
    buffers, the thread -> (row, segment) map and the rows packed into
    warps, the breakpoints staged breadth first and NaN-padded, the search
    one step a level with each step's warp vote kept as a bit plane by lane
    0, and the words built per thread from the packed plan of its words.
    Entries the launch would not write stay -1."""
    k_ = _summarize_constants()
    threads, subtiles = k_["SAX_THREADS"], k_["SAX_SUBTILES"]
    b, w = p.shape
    warps, nodes = threads // 32, (1 << c) - 1
    rows_per_sub = _sax_rows_per_sub(w, threads)
    rows_per_block = subtiles * rows_per_sub
    n_tiles = -(-b // rows_per_block)
    grid = min(n_tiles, sms * k_["SAX_BLOCKS_PER_SM"])
    per_warp = 32 // w if w <= 32 else 1
    warps_per_row = 1 if w <= 32 else -(-w // 32)
    tid = np.arange(threads)
    lane, warp = tid % 32, tid // 32
    if w <= 32:
        q = lane // w
        r, seg, mine = warp * per_warp + q, lane - q * w, q < per_warp
    else:
        r = warp // warps_per_row
        seg = (warp - r * warps_per_row) * 32 + lane
        mine = (r < rows_per_sub) & (seg < w)
    sb = np.full(nodes, np.nan, np.float32)
    for i in range(nodes):
        level = (i + 1).bit_length() - 1
        s = ((2 * (i + 1 - (1 << level)) + 1) << (c - 1 - level)) - 1
        if s < bps.size:
            sb[i] = bps[s]
    tasks = [[_pack_task(*_sax_task(i, w, c, nw, rows_per_sub, warps))
              if i < rows_per_block * nw else 0
              for i in (t + m * threads for m in range(subtiles))] for t in range(threads)]
    sym = np.full((b, w), -1, np.int64)
    keys = np.full((b, nw), -1, np.int64)
    for block in range(grid):
        planes = np.full((2, subtiles * warps, 8), 0xDEADBEEF, np.int64)  # never read unwritten
        for buf, tile in enumerate(range(block, n_tiles, grid)):
            buf %= 2
            row0 = tile * rows_per_block
            for k in range(subtiles):
                if row0 + k * rows_per_sub >= b:
                    break
                row = row0 + k * rows_per_sub + r
                ok = mine & (row < b)
                x = np.where(ok, p[np.where(ok, row, 0), np.where(ok, seg, 0)], np.nan)
                node = np.zeros(threads, int)
                for level in range(c):
                    right = sb[node] <= x
                    votes = (right.reshape(warps, 32) << np.arange(32)).sum(1)
                    planes[buf, k * warps:(k + 1) * warps, level] = votes  # lane 0's store
                    node = 2 * node + np.where(right, 2, 1)
                sym[row[ok], seg[ok]] = node[ok] - nodes
            n_out = min(rows_per_block, b - row0) * nw
            flat = planes[buf].reshape(-1)
            for t in range(threads):
                for m in range(subtiles):
                    if t + m * threads >= n_out:
                        break
                    plane, lane0, at, j, pieces = _unpack_task(tasks[t][m])
                    word = 0
                    for _ in range(pieces):
                        width = min(32, w - 32 * j)
                        bits = _brev32(int(flat[plane]) >> lane0) & ((0xFFFFFFFF << (32 - width))
                                                                    & 0xFFFFFFFF)
                        word |= bits >> at if at >= 0 else (bits << -at) & 0xFFFFFFFF
                        at += width
                        j += 1
                        if j == warps_per_row:
                            j, plane = 0, plane + 1 - 8 * (warps_per_row - 1)
                        else:
                            plane += 8
                    keys.reshape(-1)[row0 * nw + t + m * threads] = word
    return sym, keys


def _planted_paa(rng, b, w, c):
    """Normal PAA values with planted ones on the breakpoints (first, middle,
    last), NaN, +inf, -inf and -0.0, at random places."""
    p = rng.standard_normal((b, w)).astype(np.float32)
    bps = psum.breakpoints(c)
    planted = np.array([bps[0], bps[len(bps) // 2], bps[-1], np.nan, np.inf, -np.inf,
                        -0.0], np.float32)
    at = rng.choice(b * w, size=min(b * w, 3 * planted.size), replace=False)
    p.reshape(-1)[at] = np.resize(planted, at.size)
    return p


@pytest.mark.parametrize("b", [1, 67, 300])
@pytest.mark.parametrize("w,c", [(16, 8), (12, 6), (8, 1), (32, 8), (64, 4)])
def test_sax_pack_emulation_matches_plain_and_pallas(w, c, b, rng):
    """The kernel's layout, emulated on the CPU, gives the plain version's
    and the Pallas kernel's symbols and key words bit for bit, planted
    breakpoints, NaN and infinities included. 67 rows end in a warp that
    holds part of its rows (w <= 16); 12 segments leave 8 lanes a warp
    idle; 64 segments take two warps a row; 300 rows at w >= 16 make the
    blocks walk several tiles, both plane buffers in turn."""
    from repro.kernels.sax_pack_kernel import sax_pack_pallas

    cfg = psum.SummarizationConfig(series_len=w * 4, n_segments=w, card_bits=c)
    nw = cfg.key_words
    p = _planted_paa(rng, b, w, c)
    bps = psum.breakpoints(c)
    sym, keys = _emulate_sax_pack(p, bps, c, nw)
    psym, pkeys = ref.sax_pack_ref(_t(p), _t(bps), c, nw)
    np.testing.assert_array_equal(sym, psym.numpy())
    np.testing.assert_array_equal(keys, pkeys.numpy())
    rsym, rkeys = sax_pack_pallas(jnp.asarray(p), jnp.asarray(bps), c, n_words=nw,
                                  block_b=b, interpret=True)
    np.testing.assert_array_equal(sym, np.asarray(rsym))
    np.testing.assert_array_equal(keys, np.asarray(rkeys).astype(np.int64))
    if b > 1:  # the planted values sit where they should
        assert (sym[np.isnan(p)] == 0).all() and (sym[p == np.inf] == 2 ** c - 1).all()


def test_sax_pack_plan_fits_every_width():
    """Every (w, c) the summarization allows (w c <= 256 key bits, c <= 8)
    fits the kernel's plan: the breakpoints one a thread, a tile's planes
    and its words the threads' SAX_SUBTILES slots, and each word's plan the
    bit fields it is packed into."""
    k = _summarize_constants()
    threads, subtiles, warps = k["SAX_THREADS"], k["SAX_SUBTILES"], k["SAX_THREADS"] // 32
    assert threads > k["MAX_BREAKPOINTS"] == 2 ** 8 - 1
    for c in range(1, 9):
        for w in range(1, 32 * k["MAX_WORDS"] // c + 1):
            nw = -(-w * c // 32)
            rows_per_sub = _sax_rows_per_sub(w, threads)
            assert rows_per_sub > 0 and nw <= k["MAX_WORDS"]
            assert subtiles * rows_per_sub * nw <= subtiles * threads
            for i in range(subtiles * rows_per_sub * nw):
                plane, lane0, at, j, pieces = _sax_task(i, w, c, nw, rows_per_sub, warps)
                assert 0 <= plane < subtiles * warps * 8 <= 1 << 10 and 0 <= lane0 < 32
                assert -32 < at < 32 and 0 <= j < 8 and 0 < pieces < 64
                assert _unpack_task(_pack_task(plane, lane0, at, j, pieces)) == (
                    plane, lane0, at, j, pieces)


# ---------------------------------------------------------------------------
# paa's layout (csrc/summarize.cu paa_kernel): one thread a (row, segment)
# pair at a time over a grid-strided walk, the pair's contiguous run of L
# values read as float4s (or floats) a chunk at a time before its adds, the
# sum started from -0.0 and taken left to right
# ---------------------------------------------------------------------------
H100_SMS = 132


def _paa_launch(b, n, w, sms=H100_SMS, base=0):
    """``coconut_paa``'s plan: (grid, vec). ``base`` is x's offset in
    floats from a 16-byte boundary."""
    k = _summarize_constants()
    blocks = -(-b * w // k["PAA_THREADS"])
    grid = min(blocks, max(1, sms) * k["PAA_BLOCKS_PER_SM"])
    return grid, (n // w) % 4 == 0 and base % 4 == 0


def _emulate_paa(x, w, sms=H100_SMS, base=0):
    """paa_kernel on the CPU, every thread of the grid side by side: the
    grid-stride walk over (row, segment) pairs, each pair's run loaded a
    chunk at a time (PAA_VEC_LOADS float4s, or PAA_SCALAR_LOADS floats) and
    added in order to -0.0 in f32, then divided by L. x lies ``base`` floats
    past a 16-byte boundary. Returns (PAA, writes a pair, reads a value,
    vector loads off a 16-byte boundary)."""
    b, n = x.shape
    L, pairs = n // w, b * w
    k = _summarize_constants()
    threads = k["PAA_THREADS"]
    grid, vec = _paa_launch(b, n, w, sms, base)
    mem = np.concatenate([np.zeros(base, np.float32), x.reshape(-1)])
    out = np.full(pairs, np.nan, np.float32)
    written = np.zeros(pairs, np.int64)
    reads = np.zeros(mem.size, np.int64)
    misaligned = 0
    width, chunk = (4, k["PAA_VEC_LOADS"]) if vec else (1, k["PAA_SCALAR_LOADS"])
    per = L // width  # loads a run
    tid = np.arange(grid * threads)
    for start in range(0, pairs, grid * threads):  # the grid-stride loop
        e = start + tid
        e = e[e < pairs]
        acc = np.full(e.size, -0.0, np.float32)
        for c in range(0, per, chunk):
            loads = []
            for j in range(c, min(c + chunk, per)):  # all of the chunk's loads first
                at = base + e * L + width * j
                misaligned += int((at % width != 0).sum())
                vals = mem[at[:, None] + np.arange(width)]
                np.add.at(reads, (at[:, None] + np.arange(width)).ravel(), 1)
                loads.append(vals)
            for vals in loads:  # then the adds, in order
                for i in range(width):
                    acc = (acc + vals[:, i]).astype(np.float32)
        out[e] = (acc / np.float32(L)).astype(np.float32)
        written[e] += 1
    return out.reshape(b, w), written, reads[base:], misaligned


@pytest.mark.parametrize("b,n,w", [(1, 256, 16), (67, 256, 16), (300, 64, 8),
                                   (45, 120, 8), (33, 96, 12), (5, 16384, 16),
                                   (7, 90, 6), (3, 256, 16), (6, 100, 4), (5, 40, 2)])
def test_paa_emulation_matches_plain_and_pallas(b, n, w, rng):
    """The kernel's layout, emulated on the CPU, gives the plain version's
    PAA bit for bit, and the Pallas kernel's to f32 tolerance: every (row,
    segment) written once, every value read once. 67 and 3 rows end inside
    a block; 15-value (n = 120, n = 90 with n % 4 != 0) and 25-value
    segments take the scalar loads, 15 of them inside one chunk, 25 over
    a chunk and a tail; 5 float4s (n = 40) end in a short vector chunk;
    16,384 values a row are segments of 1,024 over 64 chunks. The walk is
    taken on the H100's 132 SMs and on one, where 300 x 8 pairs take three
    trips of the grid stride: the same bits."""
    from repro.kernels.paa_kernel import paa_pallas

    x = rng.standard_normal((b, n)).astype(np.float32)
    plain = ref.paa_ref(_t(x), w).numpy()
    for sms in (H100_SMS, 1):
        got, written, reads, misaligned = _emulate_paa(x, w, sms)
        assert (written == 1).all() and (reads == 1).all() and misaligned == 0
        np.testing.assert_array_equal(got.view(np.uint32), plain.view(np.uint32))
    assert _paa_launch(b, n, w)[1] == ((n // w) % 4 == 0)
    # the Pallas kernel's mean sums in its own order (test_paa_matches_reference)
    np.testing.assert_allclose(
        got, np.asarray(paa_pallas(jnp.asarray(x), w, block_b=b, interpret=True)),
        rtol=1e-5, atol=1e-6)


def test_paa_plan_writes_every_pair_once_and_aligns_vector_loads(rng):
    """Over a range of batches, lengths and segment counts, at a 16-byte
    aligned and an unaligned base, on 132 SMs and on 2: every (row,
    segment) is written once and every value read once; float4 loads are
    taken exactly where L % 4 == 0 and the base is aligned, and every one
    starts on a 16-byte boundary; the grid stays within launch limits (at
    least one block, at most PAA_BLOCKS_PER_SM an SM, blocks of at most
    1,024 threads), and the query path's 16 x 256 batch spreads over
    several SMs. A run of -0.0 keeps its sign: the sum starts from -0.0."""
    k = _summarize_constants()
    assert 32 <= k["PAA_THREADS"] <= 1024 and k["PAA_THREADS"] % 32 == 0
    assert k["PAA_THREADS"] * k["PAA_BLOCKS_PER_SM"] <= 2048  # threads an SM
    for b in (1, 2, 16, 33, 130):
        for w in (1, 3, 4, 8, 16):
            for L in (1, 2, 3, 4, 5, 8, 15, 16, 17, 20, 64, 65):
                for sms, base in ((H100_SMS, 0), (2, 0), (2, 1), (H100_SMS, 2)):
                    x = rng.standard_normal((b, w * L)).astype(np.float32)
                    got, written, reads, misaligned = _emulate_paa(x, w, sms, base)
                    grid, vec = _paa_launch(b, w * L, w, sms, base)
                    assert 1 <= grid <= sms * k["PAA_BLOCKS_PER_SM"]
                    assert grid * k["PAA_THREADS"] >= min(b * w, sms * k["PAA_THREADS"]
                                                          * k["PAA_BLOCKS_PER_SM"])
                    assert vec == (L % 4 == 0 and base % 4 == 0) and misaligned == 0
                    assert (written == 1).all() and (reads == 1).all()
                    np.testing.assert_array_equal(
                        got.view(np.uint32), ref.paa_ref(_t(x), w).numpy().view(np.uint32))
    for b in (10 ** 6, 1_024_000, 2 ** 31 // 16):  # the whole set and beyond
        assert _paa_launch(b, 256, 16)[0] == H100_SMS * k["PAA_BLOCKS_PER_SM"] < 2 ** 31 - 1
    assert _paa_launch(16, 256, 16)[0] >= 4
    zeros = np.full((2, 64), -0.0, np.float32)
    got = _emulate_paa(zeros, 4)[0]
    assert np.signbit(got).all() and np.array_equal(
        got.view(np.uint32), ref.paa_ref(_t(zeros), 4).numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# mindist's layout (csrc/lower_bound.cu): one thread a region, float4 reads
# of lo and hi where a row is whole 16-byte words
# ---------------------------------------------------------------------------
LOWER_BOUND_CU = Path(ops.__file__).resolve().parent / "csrc" / "lower_bound.cu"


def _emulate_mindist(q, lo, hi, seg_len):
    """mindist_kernel block by block: NTHREADS rows a block, each row's
    segments in order (four at a time from float4 words when the wrapper
    asks for the vector path), each max, square and sum rounded in f32."""
    nthreads = int(re.search(r"constexpr int NTHREADS = (\d+);",
                             LOWER_BOUND_CU.read_text()).group(1))
    b, w = lo.shape
    vec = w % 4 == 0  # the wrapper's test (torch allocations are aligned)
    out = np.full(b, np.nan, np.float32)
    written = np.zeros(b, np.int64)
    zero = np.float32(0)
    for blk in range(-(-b // nthreads)):
        row = blk * nthreads + np.arange(nthreads)
        row = row[row < b]
        acc = np.zeros(row.size, np.float32)
        words = lo[row].reshape(row.size, -1, 4) if vec else None
        for s in range(w):
            lv = words[:, s // 4, s % 4] if vec else lo[row, s]
            d = np.maximum(np.maximum((lv - q[s]).astype(np.float32), zero),
                           np.maximum((q[s] - hi[row, s]).astype(np.float32), zero))
            acc = (acc + (d * d).astype(np.float32)).astype(np.float32)
        out[row] = (np.float32(seg_len) * acc).astype(np.float32)
        written[row] += 1
    return out, written


@pytest.mark.parametrize("b,w", [(1, 16), (300, 16), (257, 8), (1000, 12), (513, 6),
                                 (40, 3)])
def test_mindist_emulation_matches_plain_and_pallas(b, w, rng):
    """The kernel's layout, emulated on the CPU, gives the plain version's
    bounds bit for bit and the Pallas kernel's to 1e-5: every region written
    once, over whole and short blocks, the vector path (w % 4 == 0) and the
    scalar one, regions open to +-1e30 at the edges (the distributed
    query's) and queries on the breakpoints."""
    from repro.kernels.lb_kernel import mindist_pallas

    cfg = psum.SummarizationConfig(series_len=w * 8, n_segments=w, card_bits=8)
    sym = rng.integers(0, 256, (b, w)).astype(np.int64)
    bps = psum.breakpoints(8).astype(np.float32)
    lo = np.concatenate([[-1e30], bps]).astype(np.float32)[sym]
    hi = np.concatenate([bps, [1e30]]).astype(np.float32)[sym]
    q = rng.standard_normal(w).astype(np.float32)
    q[: w // 2] = bps[rng.integers(0, bps.size, w // 2)]
    got, written = _emulate_mindist(q, lo, hi, cfg.segment_len)
    assert (written == 1).all() and (got >= 0).all()
    plain = ref.mindist_ref(_t(q), _t(lo), _t(hi), cfg.segment_len).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), plain.view(np.uint32))
    np.testing.assert_array_equal(got, ops.mindist(_t(q), _t(lo), _t(hi), cfg).numpy())
    pallas = mindist_pallas(jnp.asarray(q), jnp.asarray(lo), jnp.asarray(hi),
                            cfg.segment_len, block_b=b, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5)
