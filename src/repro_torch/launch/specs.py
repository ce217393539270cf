"""Sharding rules: parameter / optimizer-state / activation / cache specs
for the production meshes, and their placement as ``DTensor``s.

Strategy: FSDP over "data" (every large weight's first core dim), TP over
"model" (heads / ff / vocab / experts), DP over ("pod","data") for the
batch. Optimizer moments mirror the param specs, so state is fully
ZeRO-sharded. Dims that don't divide the mesh axis are left unsharded (e.g.
rwkv6's 40 heads vs the 16-way model axis falls back to sharding head_dim).

A spec is a :class:`P`, one entry per tensor dimension (a mesh axis name, a
tuple of names, or ``None``), as a ``PartitionSpec`` is; ``to_shardings``
turns a tree of them into ``(mesh, placements)`` pairs, which
``distribute_tensor`` and ``redistribute`` take. Spec functions read only
the mesh's axis names and sizes (``mesh_dim_names``, ``shape``), so they run
without a process group.

The port's parameters are one block a layer (``groups.g.j.attn.wq``), where
the reference stacks each pattern position over the groups: a parameter's
spec is the reference leaf's spec without its leading stacked ``None``. The
cache keeps the reference's stacked layout, and its specs carry over as
they are.
"""
from __future__ import annotations

import collections

import torch
from torch import nn
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..models.shardctx import axis_sizes, placements
from .mesh import dp_axes


class P(tuple):
    """A partition spec: ``P("data", None)``; a tuple of one axis is that
    axis, as a ``PartitionSpec`` normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                                     else tuple(e) if isinstance(e, list) else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _div(n: int, size: int) -> bool:
    return n % size == 0


def leaf_spec(path_names: list[str], shape: tuple, mesh) -> P:
    """Sharding rule for one parameter (one layer's, unstacked)."""
    sz = axis_sizes(mesh)
    dm, dd = sz["model"], sz["data"]
    core = tuple(shape)
    name = path_names[-1]

    if len(core) <= 1:
        # norms / biases / small vectors: shard if cleanly divisible by model
        if len(core) == 1 and core[0] >= 1024 and _div(core[0], dm):
            return P("model")
        return P(*(None,) * len(core))
    if name == "embed":  # (Vp, D): vocab over model only
        return P("model" if _div(core[0], dm) else None, None)
    if name in ("w1", "w3") and len(core) == 3:  # MoE (E, D, Fe): EP on model
        return P("model" if _div(core[0], dm) else None,
                 "data" if _div(core[1], dd) else None, None)
    if name == "w2" and len(core) == 3:  # MoE (E, Fe, D)
        return P("model" if _div(core[0], dm) else None, None,
                 "data" if _div(core[2], dd) else None)
    # output projections (X, D): model x data (reduce dim sharded over model)
    if name in ("wo", "w2", "w_out", "cm_v", "lm_head") and len(core) == 2:
        if name == "lm_head":  # (D, Vp): data x model
            return P("data" if _div(core[0], dd) else None,
                     "model" if _div(core[1], dm) else None)
        return P("model" if _div(core[0], dm) else None,
                 "data" if _div(core[1], dd) else None)
    if len(core) == 2:  # generic input projection (D, X): data x model
        return P("data" if _div(core[0], dd) else None,
                 "model" if _div(core[1], dm) else None)
    return P(*(None,) * len(core))


def _named(params) -> dict:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def param_specs(params, mesh) -> dict:
    """{parameter name: spec} of a model (or a dict keyed by its
    parameter names; ``meta`` tensors will do)."""
    return {name: leaf_spec(name.split("."), tuple(p.shape), mesh)
            for name, p in _named(params).items()}


def opt_specs(opt_state, pspecs):
    """Optimizer state mirrors params per moment tree ({'m','v',['err']})."""
    return {k: pspecs for k in opt_state}


def _map(tree, fn):
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def _dp_size(mesh, multi_pod: bool) -> tuple:
    sz = axis_sizes(mesh)
    dp = dp_axes(multi_pod)
    size = 1
    for a in dp:
        size *= sz[a]
    return dp, size


def batch_specs(batch, mesh, multi_pod: bool):
    """Batch-dim data parallel where divisible; replicate otherwise."""
    dp, dp_size = _dp_size(mesh, multi_pod)

    def one(leaf):
        lead = dp if _div(leaf.shape[0], dp_size) else None
        return P(lead, *(None,) * (len(leaf.shape) - 1))

    return _map(batch, one)


def cache_specs(cache, mesh, multi_pod: bool):
    """KV-cache / recurrent-state specs: batch over dp; the sequence dim of
    (B, S, ...) caches over "model" when divisible (context-parallel
    decode), else the widest trailing dim that divides it. ``pos`` (an int
    here, a scalar there) gets ``P()``."""
    dp, dp_size = _dp_size(mesh, multi_pod)
    dm = axis_sizes(mesh)["model"]

    def one(leaf, stacked):
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
            return P()
        core = list(leaf.shape[1:] if stacked else leaf.shape)
        spec: list = [None] * len(core)
        if _div(core[0], dp_size):
            spec[0] = dp
        if len(core) >= 3 and _div(core[1], dm) and core[1] >= dm:
            spec[1] = "model"
        else:
            for d in range(len(core) - 1, 0, -1):
                if _div(core[d], dm) and core[d] >= dm:
                    spec[d] = "model"
                    break
        return P(*([None] + spec if stacked else spec))

    def walk(node, stacked):
        if isinstance(node, dict):
            return {k: walk(v, stacked or k == "groups") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, stacked) for v in node]
        return None if node is None else one(node, stacked)

    return walk(cache, False)


def drop_axis_specs(spec_tree, axis: str = "data"):
    """Remove one mesh axis from every spec in a tree (e.g. turn FSDP+TP
    param specs into TP-only for serving / ZeRO-1 gathers)."""

    def drop_entry(e):
        if e == axis:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a != axis)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return e

    return _map(spec_tree, lambda spec: P(*(drop_entry(e) for e in spec)))


def to_shardings(spec_tree, mesh):
    """Each spec -> ``(mesh, placements)``."""
    return _map(spec_tree, lambda spec: (mesh, placements(spec, mesh)))


def _place(x, spec, mesh):
    """A DTensor redistributed to ``spec``; a plain tensor stays plain."""
    if not isinstance(x, DTensor):
        return x
    want = placements(spec, mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def constrain_tree(tree, spec_tree, mesh):
    """``_place`` over a tree of tensors and its tree of specs (dicts by
    key, lists in order); a module is constrained by parameter name, into a
    new module of the same structure whose parameters are the constrained
    tensors."""
    if isinstance(tree, nn.Module):
        return rebuild(tree, lambda name, p: _place(p, spec_tree[name], mesh))
    if isinstance(tree, dict):
        return {k: constrain_tree(v, spec_tree[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [constrain_tree(v, s, mesh) for v, s in zip(tree, spec_tree)]
    return _place(tree, spec_tree, mesh)


def zero1_hooks(model, pspecs: dict, mesh):
    """The ``opt`` variant's train-step hooks ``(param_gather,
    grad_constrain)``: ZeRO-1 gather-once over "data" for the dense
    parameters (up to 3-D counting the reference's stacked layer dim, as
    the reference counts them; gathering the MoE expert tensors blew the
    dispatch up, so experts keep FSDP), and each microbatch's gradients
    placed back by ``pspecs``."""
    gathered_all = drop_axis_specs(pspecs, "data")
    gathered = {}
    for name, p in _named(model).items():
        ref_ndim = p.ndim + (1 if name.startswith("groups.") else 0)
        gathered[name] = gathered_all[name] if ref_ndim <= 3 else pspecs[name]

    def param_gather(m):
        return constrain_tree(m, gathered, mesh)

    def grad_constrain(g):
        return constrain_tree(g, pspecs, mesh)

    return param_gather, grad_constrain


def _tree(module: nn.Module, fn, prefix: str = ""):
    if isinstance(module, nn.ModuleList):
        return [_tree(m, fn, f"{prefix}{i}.") for i, m in enumerate(module)]
    out = {n: fn(prefix + n, p) for n, p in module._parameters.items()}
    out.update({n: _tree(m, fn, f"{prefix}{n}.") for n, m in module._modules.items()})
    return out


def rebuild(model: nn.Module, fn) -> nn.Module:
    """A new model of ``model``'s class and config holding ``fn(name, p)`` in
    place of each parameter, in the same ``named_parameters`` order."""
    return type(model)(model.cfg, _tree(model, fn))


def distribute_model(model: nn.Module, pspecs: dict, mesh) -> nn.Module:
    """``model`` with every parameter replaced, in place, by a frozen
    ``DTensor`` parameter placed by its spec (rank 0's values)."""
    for name, p in list(model.named_parameters()):
        owner, leaf = model, name
        if "." in name:
            path, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        owner._parameters[leaf] = nn.Parameter(
            distribute_tensor(p.detach(), mesh, placements(pspecs[name], mesh)),
            requires_grad=False)
    return model


def distribute_tree(tree, spec_tree, mesh):
    """Plain tensors of a tree -> ``DTensor``s placed by the specs."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, spec_tree[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [distribute_tree(v, s, mesh) for v, s in zip(tree, spec_tree)]
    if not isinstance(tree, torch.Tensor):
        return tree
    return distribute_tensor(tree, mesh, placements(spec_tree, mesh))


# ---------------------------------------------------------------------------
# ops the sharding propagation refuses
# ---------------------------------------------------------------------------
def _is_dtensor_call(types) -> bool:
    return any(issubclass(t, DTensor) for t in types)


def _whole(x) -> bool:
    """Every mesh dim that shards or splits ``x`` has one rank: its local
    tensor is the whole tensor."""
    mesh = x.device_mesh
    return all(mesh.size(i) == 1 for i, p in enumerate(x.placements) if not p.is_replicate())


def _replicated(x, gathered=None):
    """``x`` whole on this rank. Under fake or meta tensors a layout whose
    redistribution needs data (a strided shard) is made from the shape
    alone, and its gather's bytes are added to ``gathered``."""
    if not isinstance(x, DTensor):
        return x
    if _whole(x):
        return x.to_local()
    try:
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim).to_local()
    except (RuntimeError, NotImplementedError, IndexError):
        if not (is_fake(x.to_local()) or x.to_local().is_meta):
            raise
    if gathered is not None:
        gathered.append(x.numel() * x.element_size())
    return x.to_local().new_empty(x.shape)


_REFUSALS = (RuntimeError, NotImplementedError, IndexError,
             AssertionError)  # AssertionError: in place on a plain tensor
# (op, the DTensor args' placements and shapes) -> how it ran once refused:
# "batch" or "local"; the same call is not tried as it is again (DTensor's
# refusal depends on nothing else). Only ops refused once are looked up.
_REFUSED: dict = {}
_REFUSED_OPS: set = set()


def _call_key(func, args, kwargs):
    flat, spec = tree_flatten((args, kwargs))
    dts = [a for a in flat if isinstance(a, DTensor)]
    return flat, spec, dts, (func, tuple((tuple(a.placements), tuple(a.shape)) for a in dts))


def _batch_only(x):
    """``x`` with every mesh dim that does not shard its dim 0 replicated."""
    if not isinstance(x, DTensor):
        return x
    want = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in x.placements]
    if want == list(x.placements):
        return x
    if _whole(x):  # nothing to gather: the same local tensor, placed anew
        return DTensor.from_local(x.to_local(), x.device_mesh, want, run_check=False)
    try:
        return x.redistribute(x.device_mesh, want)
    except (RuntimeError, NotImplementedError, IndexError):
        return x


def call_replicating(func, args, kwargs, refused=None, gathered=None):
    """``func`` on ``DTensor`` arguments; where ``DTensor`` has no sharding
    strategy for the op or its layouts (``searchsorted``; a view that
    splits a sharded dim into a count that does not divide the axis, as
    smollm's 15 heads on a 16-wide model axis), the op runs on every rank
    over its arguments replicated, and its outputs are replicated
    ``DTensor``s (what XLA calls a full rematerialization). Arguments the
    op writes get its result back in their own placements. ``refused``
    (a Counter) counts such ops by name; ``gathered`` see ``_replicated``."""
    known = None
    if func in _REFUSED_OPS:  # an op refused before: its layouts looked up
        flat, spec, dts, key = _call_key(func, args, kwargs)
        known = _REFUSED.get(key)
    if known is None:
        try:
            return func(*args, **kwargs)
        except _REFUSALS:
            flat, spec, dts, key = _call_key(func, args, kwargs)
            if not dts:
                raise
            _REFUSED_OPS.add(func)
    if refused is not None:
        refused[str(func.overloadpacket.__name__)] += 1
    mesh = dts[0].device_mesh
    if known in (None, "batch") and not func._schema.is_mutable:
        # first keep the batch (dim 0) sharded and replicate the rest
        kept = [_batch_only(a) for a in flat]
        if any(k is not a for k, a in zip(kept, flat)):
            try:
                kargs, kkwargs = tree_unflatten(kept, spec)
                out = func(*kargs, **kkwargs)
                _REFUSED[key] = "batch"
                return out
            except _REFUSALS:
                pass
    _REFUSED[key] = "local"
    local = [_replicated(a, gathered) for a in flat]
    largs, lkwargs = tree_unflatten(local, spec)
    out = func(*largs, **lkwargs)
    rep = [Replicate()] * mesh.ndim
    written = [i for i, a in enumerate(func._schema.arguments)
               if a.alias_info is not None and a.alias_info.is_write and i < len(args)]
    for i in written:
        dst = args[i]
        if isinstance(dst, DTensor):
            back = DTensor.from_local(largs[i], mesh, rep, run_check=False)
            dst.to_local().copy_(back.redistribute(mesh, dst.placements).to_local())
    if written:
        return args[written[0]]
    return tree_map(lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
                    if isinstance(t, torch.Tensor) else t, out)


class ReplicateRefused(TorchDispatchMode):
    """Runs every ``DTensor`` op through :func:`call_replicating`; plain ops
    pass through. ``refused`` counts the ops that ran replicated."""

    def __init__(self):
        super().__init__()
        self.refused = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_call(types) and not isinstance(func, torch._ops.HigherOrderOperator):
            return call_replicating(func, args, kwargs, self.refused)
        return func(*args, **kwargs)
