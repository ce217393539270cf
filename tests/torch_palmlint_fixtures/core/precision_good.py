"""Good fixture: spelled dtypes, f32 screen, f64 certify, torch's spellings."""
import torch


def make_buffers(n, dev):
    a = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    b = torch.arange(n, dtype=torch.int64, device=dev)
    c = torch.full((n,), 0.5, dtype=torch.float32)
    return a, b, c


def screen_pass(q, x):
    return q.float() @ x.T


def rerank_slate(q, x):
    return torch.einsum("md,nd->mn", q.to(torch.float64), x.double())


def quantize_rows(x, dev):
    return x.to(torch.int8).to(dev)  # a spelled cast, then a move
