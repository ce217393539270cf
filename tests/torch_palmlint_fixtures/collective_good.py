"""Good fixture: every rank reaches each collective alike."""
import os

import numpy as np
import torch.distributed as dist


def save(leaves, path):
    host = [leaf.full_tensor() for leaf in leaves]  # every rank gathers
    if dist.get_rank() != 0:  # fine: after the last collective
        return None
    np.save(path, host[0])
    return path


def reduce_then_write(t, path):
    dist.all_reduce(t)
    if os.path.exists(path):  # fine: no collective follows
        return t
    return t


def shape_branch(t, out, group):
    if t.shape[0] % dist.get_world_size(group):  # fine: same on every rank
        raise ValueError("rows do not split")
    dist.all_to_all_single(out, t, group=group)
    return out


def local_write(cache, value, slot, lo, size):
    value = value.redistribute(value.device_mesh, cache.placements)
    i = slot - lo
    if 0 <= i < size and value.to_local().any():  # fine: writes only
        cache.to_local()[i] = value.to_local()[0]
