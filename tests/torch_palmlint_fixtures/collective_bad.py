"""Bad fixture: SPMD bodies that branch on rank-local data around a collective."""
import os

import torch.distributed as dist


def gather_rows(t, group):
    if dist.get_rank() == 0:  # BAD: only rank 0 all-gathers
        dist.all_gather([t], t, group=group)
    return t


def reduce_counts(t, path):
    if os.path.exists(path):  # BAD: leaves early on some ranks
        return t
    dist.all_reduce(t)
    return t


def exchange(t, out):
    n = int(t.sum().item())
    while n > 0:  # BAD: loop trip count is a local tensor's value
        dist.all_to_all_single(out, t)
        n -= 1
    return out


def per_leaf(leaves):
    rank = dist.get_rank()
    for leaf in leaves:
        if rank and not leaf.any():  # BAD: skips the next leaf's gather
            continue
        leaf.full_tensor()


def checked(t):
    assert t.sum().item() > 0  # BAD: fails on some ranks before the reduce
    helper(t)
    return t


def helper(t):
    dist.all_reduce(t)  # reached through the call graph
