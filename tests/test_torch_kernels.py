"""The port's screen+select wrappers against the reference kernels.

On the CPU the port's ``ops.screen_select(_quant)`` run their plain PyTorch
versions; the reference runs its Pallas kernels in interpret mode. Same
inputs, made with numpy: slate ids must be equal, and screen values agree
to f32 tolerance (tiled and whole-matrix f32 sums differ in the last bits,
so bitwise agreement belongs after the engine's f64 re-rank). The CUDA
kernels are held against the plain versions in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
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
    assert ops.LAUNCHES == {"screen_select": 0, "screen_select_quant": 0}
