"""Bad fixture (lives under core/: the dtype rule is path-scoped)."""
import torch


def make_buffers(n, dev):
    a = torch.zeros((n, 4), device=dev)  # BAD: dtype-less constructor in core/
    b = torch.arange(n, device=dev)  # BAD: dtype-less constructor in core/
    c = torch.full((n,), 0.5)  # BAD: the fill value picks the dtype
    return a, b, c


def screen_pass(q, x):
    q64 = q.double()
    return q64 @ x.T  # BAD: f64 operand in a screen-side matmul


def rerank_slate(q, x):
    return torch.einsum("md,nd->mn", q, x)  # BAD: no f64 cast on certify path


def certify_rows(q, table):
    rows = table.to(torch.bfloat16)
    return torch.einsum("md,nd->mn", q.double(), rows)  # BAD: bf16 un-upcast


def quantize_rows(x, dt):
    return x.to(dtype=dt)  # BAD: dynamic dtype in a quantization helper
