"""The CUDA kernels on the card: each held against its plain PyTorch version,
and the engine's answers held to the CPU's. Every test here needs an NVIDIA
card and the CUDA toolkit, carries the ``cuda`` marker and skips without a
card. Nothing here imports JAX, so the machine with the card runs it:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import verify_engine as pve
from repro_torch.kernels import ops, ref

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
    n = ops.max_slate() + 8
    with pytest.raises(ValueError, match="maximum"):
        ops.screen_select(q, torch.zeros((n, 32), device=cuda),
                          torch.zeros(n, device=cuda), ops.max_slate() + 1)


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
