"""The port's training half (``repro_torch.models.steps``' train step,
``repro_torch.train``, ``repro_torch.data.pipeline``,
``repro_torch.launch.train``) against the reference's, on the same numpy
inputs made from a seed, on the CPU.

Weights are drawn with numpy in the reference's layout and carried into
both packages (``tests/test_torch_models.py``'s ``_draw``): as jax arrays
into the reference, through ``params_from_numpy`` into the port; the
port's gradients and states come back through ``reference_tree`` /
``params_to_numpy``. Batches come from the reference's ``TokenPipeline``
(every frontend's inputs).

Tolerances:

* f32 tier (both packages' dtype globals patched to f32, as in
  ``test_torch_models.py``): loss and aux within F32_TOL; every gradient
  leaf within F32_TOL of that leaf's largest |g|. One AdamW step: m within
  F32_TOL and v within 2 F32_TOL of the leaf's largest value; a new
  parameter within 1e-5 where the reference's |g| exceeds 1e-3 of its
  leaf's largest (the step's sign is settled: AdamW's first steps move a
  weight by about lr sign(g)), elsewhere within 2 lr (the sign of a
  gradient inside the summation noise is not defined).
* bf16 tier (as shipped): the loss within BF16_LOSS_TOL (measured <= 0.0060
  over three weight draws of each of the ten archs); in MoE archs every
  token routed differently must be a router near tie.
* optimizer alone: f32 within 1e-6 (relative), bf16 parameters within one
  bf16 ulp. The global norm sums the leaves in another order than the
  reference's (its dict keys sorted), so nothing is compared bitwise
  across packages except batches and checkpoints.
"""
import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_torch_models as tm  # noqa: E402
from test_torch_models import f32  # noqa: E402,F401  (the f32 tier's fixture)

from repro import configs as rconfigs  # noqa: E402
from repro.core import StreamConfig as RStreamConfig  # noqa: E402
from repro.core import StreamingIndex as RStreamingIndex  # noqa: E402
from repro.core import SummarizationConfig as RSummarizationConfig  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import steps as rsteps  # noqa: E402
from repro.train import checkpoint as rckpt  # noqa: E402
from repro.train import compression as rcomp  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.core import StreamConfig, StreamingIndex, SummarizationConfig  # noqa: E402
from repro_torch.data import pipeline as ppipe  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import steps as psteps  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.weights import (  # noqa: E402
    params_from_numpy, params_to_numpy, port_named, reference_tree, tensor_from_numpy,
    tensor_to_numpy)
from repro_torch.train import checkpoint as pckpt  # noqa: E402
from repro_torch.train import compression as pcomp  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402

torch.set_num_threads(1)

ARCH_IDS = rconfigs.ARCH_IDS
F32_TOL = 1e-4
BF16_LOSS_TOL = 0.02
LR = 1e-3
SRC = Path(__file__).resolve().parents[1] / "src"


# ------------------------------------------------------------------ helpers
def _flat(tree) -> dict:
    """A tree's leaves by the reference's checkpoint names, as f32 numpy
    (bf16 as the values of its patterns)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "_".join(str(tm._key(p)) for p in path)
        a = np.asarray(leaf)
        if a.dtype == np.uint16:  # the port's bf16 patterns
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.astype(np.float32)
    return out


def _port_flat(named: dict) -> dict:
    return _flat(jax.tree.map(tensor_to_numpy, reference_tree(
        {k: v.detach() for k, v in named.items()})))


def _leafwise(got: dict, want: dict, tol, what):
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (what, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= tol * scale, (what, name, err, scale)


def _pipe_batch(rcfg, global_batch, seq_len, seed, step=0):
    return rpipe.TokenPipeline(rpipe.PipelineConfig(
        global_batch=global_batch, seq_len=seq_len, seed=seed), rcfg).batch(step)


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _both_cfgs(arch, smoke=True):
    return rconfigs.get_config(arch, smoke=smoke), pconfigs.get_config(arch, smoke=smoke)


def _opt_cfgs(**kw):
    return ropt.AdamWConfig(**kw), popt.AdamWConfig(**kw)


# ------------------------------------------------------------------ pipeline
@pytest.mark.parametrize("arch", ["smollm-360m", "llava-next-34b", "hubert-xlarge"])
@pytest.mark.parametrize("n_hosts", [1, 2])
def test_pipeline_batches_are_the_reference_bit_for_bit(arch, n_hosts):
    rcfg, pcfg = _both_cfgs(arch)
    for host in range(n_hosts):
        kw = dict(global_batch=8, seq_len=32, seed=5, n_hosts=n_hosts, host_id=host)
        ref = rpipe.TokenPipeline(rpipe.PipelineConfig(**kw), rcfg)
        port = ppipe.TokenPipeline(ppipe.PipelineConfig(**kw), pcfg)
        assert port.local_batch == ref.local_batch == 8 // n_hosts
        for step in (0, 17):
            want, got = ref.batch(step), port.batch(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
                assert got[k].tobytes() == want[k].tobytes(), (arch, k)
            for n in (8, 32, 64):
                rv, pv = ref.series_view(want, n), port.series_view(got, n)
                assert (rv is None) == (pv is None)
                if rv is not None:
                    assert pv.tobytes() == rv.tobytes()


def test_pipeline_refuses_a_batch_that_does_not_split_over_the_hosts():
    with pytest.raises(ValueError, match="n_hosts"):
        ppipe.TokenPipeline(ppipe.PipelineConfig(global_batch=5, seq_len=8, n_hosts=2),
                            pconfigs.get_config("smollm-360m", smoke=True))


def test_pipeline_series_view_feeds_streaming_index():
    """The port's counterpart of ``tests/test_system.py``'s hook test: the
    port's ``series_view`` teed into the port's ``StreamingIndex``, answers
    equal to the reference's on the same batches."""
    rcfg, pcfg = _both_cfgs("hubert-xlarge")
    kw = dict(global_batch=4, seq_len=64, seed=0)
    rp = rpipe.TokenPipeline(rpipe.PipelineConfig(**kw), rcfg)
    pp = ppipe.TokenPipeline(ppipe.PipelineConfig(**kw), pcfg)
    skw = dict(series_len=32, n_segments=8, card_bits=4)
    ridx = RStreamingIndex(RStreamConfig(scheme="BTP", summarization=RSummarizationConfig(**skw),
                                         buffer_entries=64, block_size=32))
    pidx = StreamingIndex(StreamConfig(scheme="BTP", summarization=SummarizationConfig(**skw),
                                       buffer_entries=64, block_size=32, device="cpu"))
    for step in range(5):
        view = pp.series_view(pp.batch(step), 32)
        assert view is not None and view.shape[1] == 32
        ts = np.full(len(view), step, np.int64)
        np.testing.assert_array_equal(
            pidx.ingest(view.astype(np.float32), ts),
            ridx.ingest(rp.series_view(rp.batch(step), 32).astype(np.float32), ts))
    Q = pp.series_view(pp.batch(99), 32).astype(np.float32)
    res, _ = pidx.window_knn(Q[0], 0, 4, k=1)
    want, _ = ridx.window_knn(Q[0], 0, 4, k=1)
    assert len(res) == 1 and res == want
    d2, ids, _ = pidx.window_knn_batch(Q, 1, 3, k=3)
    rd2, rids, _ = ridx.window_knn_batch(Q, 1, 3, k=3)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_allclose(d2, rd2, rtol=1e-6)


# --------------------------------------------------------------- compression
def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 33)).astype(np.float32),
            "b": (1e-3 * rng.standard_normal(50)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_round_trips_match_the_reference(kind):
    g, err = _grads(1), {k: 0.1 * v for k, v in _grads(2).items()}
    got, got_err = pcomp.make_compressor(kind)(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in err.items()})
    want, want_err = rcomp.make_compressor(kind)(
        {k: jnp.asarray(v) for k, v in g.items()}, {k: jnp.asarray(v) for k, v in err.items()})
    for k in g:
        for a, b in ((got[k], want[k]), (got_err[k], want_err[k])):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(b).max()))
        if kind == "topk":  # the kept entries are the same ones
            np.testing.assert_array_equal(got[k].numpy() != 0, np.asarray(want[k]) != 0)
    assert pcomp.make_compressor(None) is None
    with pytest.raises(ValueError):
        pcomp.make_compressor("fp4")


# ----------------------------------------------------------------- optimizer
@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 60), (0, 10)])
def test_schedule_matches_the_reference(warmup, total):
    rc, pc = _opt_cfgs(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    r, p = ropt.AdamW(rc), popt.AdamW(pc)
    for step in (0, warmup, (warmup + total) // 2, total, total + 5):
        got = p.schedule(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(r.schedule(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)


def _opt_inputs(seed, bf16):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal(37).astype(np.float32),
              "k": (0.3 * rng.standard_normal((5, 7))).astype(np.float32)}
    if bf16:
        params["k"] = np.asarray(jnp.asarray(params["k"], jnp.bfloat16))
    grads = {k: (0.05 * rng.standard_normal(np.shape(v))).astype(np.float32)
             for k, v in params.items()}
    state = {"m": {k: (0.01 * rng.standard_normal(np.shape(v))).astype(np.float32)
                   for k, v in params.items()},
             "v": {k: (1e-4 * rng.random(np.shape(v))).astype(np.float32)
                   for k, v in params.items()}}
    return params, grads, state


def _ptensor(a):
    return tensor_from_numpy(a, "cpu")


@pytest.mark.parametrize("compression", [None, "int8", "topk"])
@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_update_matches_the_reference(compression, bf16):
    params, grads, state = _opt_inputs(3, bf16)
    rc, pc = _opt_cfgs(learning_rate=1e-2, warmup_steps=3, total_steps=20,
                       grad_clip=0.5, compression=compression)
    r, p = ropt.AdamW(rc), popt.AdamW(pc)
    rstate = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in state.items()}
    pstate = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()}
              for k, v in state.items()}
    if compression:
        err = {n: (0.01 * np.random.default_rng(4).standard_normal(np.shape(a))
                   ).astype(np.float32) for n, a in params.items()}
        rstate["err"] = {n: jnp.asarray(a) for n, a in err.items()}
        pstate["err"] = {n: torch.from_numpy(a.copy()) for n, a in err.items()}
    rparams = {n: jnp.asarray(a) for n, a in params.items()}
    pparams = {n: _ptensor(a) for n, a in params.items()}
    for step in (0, 5):
        rparams, rstate, rnorm = r.update(
            rparams, {n: jnp.asarray(a) for n, a in grads.items()}, rstate, jnp.int32(step))
        pparams, pstate, pnorm = p.update(
            pparams, {n: torch.from_numpy(a) for n, a in grads.items()}, pstate, step)
        np.testing.assert_allclose(float(pnorm), float(rnorm), rtol=1e-6)
        for n in params:
            want, got = rparams[n], pparams[n]
            if want.dtype == jnp.bfloat16:
                assert got.dtype == torch.bfloat16
                w16 = np.asarray(want).view(np.uint16).astype(np.int32)
                g16 = got.view(torch.int16).numpy().astype(np.int32) & 0xFFFF
                assert int(np.abs(w16 - g16).max()) <= 1, n  # one bf16 ulp
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                           atol=1e-7)
            for key in rstate:
                np.testing.assert_allclose(pstate[key][n].numpy(), np.asarray(rstate[key][n]),
                                           rtol=1e-6, atol=1e-9)
        # carry the reference's values on, so each step compares one update
        pparams = {n: _ptensor(np.asarray(a)) for n, a in rparams.items()}
        pstate = {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
                  for k, v in rstate.items()}


def _quadratic_losses(compression, steps=60):
    opt = popt.AdamW(popt.AdamWConfig(learning_rate=0.1, weight_decay=0.0, warmup_steps=1,
                                      total_steps=steps, compression=compression))
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(32).astype(np.float32))
    params = {"w": torch.zeros(32)}
    state = opt.init(params)
    losses = []
    for s in range(steps):
        g = {"w": 2 * (params["w"] - target)}
        losses.append(float(torch.sum((params["w"] - target) ** 2)))
        params, state, _ = opt.update(params, g, state, s)
    return losses


@pytest.mark.parametrize("compression", [None, "int8", "topk"])
def test_adamw_converges_with_and_without_compression(compression):
    losses = _quadratic_losses(compression)
    assert losses[-1] < 0.05 * losses[0]


def test_grad_clip_bounds_update():
    opt = popt.AdamW(popt.AdamWConfig(learning_rate=1.0, grad_clip=1e-3, warmup_steps=1))
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    _, _, gnorm = opt.update(params, {"w": torch.full((4,), 1e9)}, state, 0)
    assert float(gnorm) > 1e8  # norm reported pre-clip


def test_schedule_warmup_and_decay():
    opt = popt.AdamW(popt.AdamWConfig(learning_rate=1.0, warmup_steps=10, total_steps=100))
    assert float(opt.schedule(0)) == 0.0
    assert float(opt.schedule(10)) == pytest.approx(1.0)
    assert float(opt.schedule(100)) == pytest.approx(0.1, abs=1e-3)


def test_adamw_state_is_f32_and_follows_the_module():
    cfg = pconfigs.get_config("deepseek-moe-16b", smoke=True)
    model = pt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = popt.AdamW(popt.AdamWConfig(compression="int8"))
    state = opt.init(model)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(state) == ["err", "m", "v"]
    for tree in state.values():
        assert list(tree) == names
        assert all(t.dtype == torch.float32 and float(t.abs().max()) == 0 for t in tree.values())


# ------------------------------------------------------- loss, grads, steps
def _train_batch(rcfg, seed):
    return _pipe_batch(rcfg, 4, 24, seed)


@functools.lru_cache(maxsize=None)
def _ref_f32(arch):
    """The reference's f32-tier results for ``arch`` (the caller holds the
    f32 patches): loss_fn and its grads, microbatched_grads at grad_accum 2
    and one make_train_step, in one jit."""
    rcfg = rconfigs.get_config(arch, smoke=True)
    tree = tm._draw(rcfg, 200 + ARCH_IDS.index(arch), f32=True)
    batch = _train_batch(rcfg, ARCH_IDS.index(arch))
    tcfg = rsteps.TrainConfig(grad_accum=2, remat=True)
    opt = ropt.AdamW(ropt.AdamWConfig(learning_rate=LR, warmup_steps=1))
    step = rsteps.make_train_step(rcfg, tcfg, opt)

    def run(params, batch):
        (loss, aux), grads = jax.value_and_grad(
            lambda p: rsteps.loss_fn(p, rcfg, batch, 0.01, False), has_aux=True)(params)
        mloss, maux, mgrads = rsteps.microbatched_grads(rcfg, tcfg, params, batch)
        new, state, metrics = step(params, opt.init(params), batch, jnp.int32(1))
        return (loss, aux, grads), (mloss, maux, mgrads), (new, state, metrics)

    out = jax.jit(run)(tm._jax(tree), tm._jax(batch))
    return tree, batch, jax.tree.map(np.asarray, out)


def _port_model(arch, tree):
    return params_from_numpy(pconfigs.get_config(arch, smoke=True), tree, "cpu")


def _aux_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= F32_TOL * max(1.0, abs(float(want[k]))), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_the_reference(arch, f32):
    tree, batch, ((loss, aux, grads), _, _) = _ref_f32(arch)
    pcfg = pconfigs.get_config(arch, smoke=True)
    model = _port_model(arch, tree)
    ploss, paux = psteps.loss_fn(model, pcfg, _tbatch(batch))
    assert abs(float(ploss) - float(loss)) <= F32_TOL
    _aux_close(paux, aux)
    lg = psteps.make_loss_and_grad(pcfg, psteps.TrainConfig(remat=False))
    gl, gaux, pgrads = lg(model, _tbatch(batch))
    assert float(gl) == float(ploss)
    assert list(pgrads) == [n for n, _ in model.named_parameters()]
    _leafwise(_port_flat(pgrads), _flat(grads), F32_TOL, arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_microbatched_grads_match_the_reference_scan(arch, f32):
    tree, batch, (_, (loss, aux, grads), _) = _ref_f32(arch)
    pcfg = pconfigs.get_config(arch, smoke=True)
    model = _port_model(arch, tree)
    ploss, paux, pgrads = psteps.microbatched_grads(
        pcfg, psteps.TrainConfig(grad_accum=2, remat=True), model, _tbatch(batch))
    assert abs(float(ploss) - float(loss)) <= F32_TOL
    _aux_close(paux, aux)
    assert all(g.dtype == torch.float32 for g in pgrads.values())
    _leafwise(_port_flat(pgrads), _flat(grads), F32_TOL, arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_the_reference(arch, f32):
    """One make_train_step (grad_accum 2, remat) in the f32 tier: metrics,
    the new parameters and the m/v states (tolerances in the docstring)."""
    tree, batch, ((_, _, grads), _, (new, state, metrics)) = _ref_f32(arch)
    pcfg = pconfigs.get_config(arch, smoke=True)
    model = _port_model(arch, tree)
    opt = popt.AdamW(popt.AdamWConfig(learning_rate=LR, warmup_steps=1))
    step = psteps.make_train_step(pcfg, psteps.TrainConfig(grad_accum=2, remat=True), opt)
    pstate = opt.init(model)
    out, pstate, pmetrics = step(model, pstate, _tbatch(batch), 1)
    assert out is model
    _aux_close(pmetrics, metrics)
    _leafwise(_port_flat(pstate["m"]), _flat(state["m"]), F32_TOL, "m")
    _leafwise(_port_flat(pstate["v"]), _flat(state["v"]), 2 * F32_TOL, "v")
    got, want, g = _port_flat(dict(model.named_parameters())), _flat(new), _flat(grads)
    before = _flat(tree)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        settled = np.abs(g[name]) > 1e-3 * max(float(np.abs(g[name]).max()), 1e-30)
        err = np.abs(got[name] - w)
        assert float(err[settled].max(initial=0)) <= 1e-5, name
        assert float(err.max()) <= 2 * LR, name
        assert not settled.any() or not np.array_equal(got[name], before[name]), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_matches_the_reference_in_bf16(arch, monkeypatch):
    rcfg, pcfg = _both_cfgs(arch)
    tree = tm._draw(rcfg, 300 + ARCH_IDS.index(arch))
    batch = _train_batch(rcfg, 7)
    routing = tm.Routing(monkeypatch)
    want, _ = jax.jit(lambda p, b: rsteps.loss_fn(p, rcfg, b))(tm._jax(tree), tm._jax(batch))
    got, _ = psteps.loss_fn(params_from_numpy(pcfg, tree, "cpu"), pcfg, _tbatch(batch))
    n = tm._router_calls(rcfg)
    routing.flipped([(n, 4)])  # fails unless every routing difference is a near tie
    assert np.isfinite(float(got))
    assert abs(float(got) - float(want)) <= BF16_LOSS_TOL, (float(got), float(want))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_grads_equal_the_plain_ones_bit_for_bit(arch):
    pcfg = pconfigs.get_config(arch, smoke=True)
    model = pt.init_params(pcfg, torch.Generator().manual_seed(5), "cpu")
    batch = _tbatch(_train_batch(rconfigs.get_config(arch, smoke=True), 3))
    out = {}
    for remat in (False, True):
        lg = psteps.make_loss_and_grad(pcfg, psteps.TrainConfig(remat=remat))
        out[remat] = lg(model, batch)
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[False][2].items():
        assert torch.equal(out[True][2][name], g), name


def test_params_frozen_until_the_trainer_differentiates():
    cfg = pconfigs.get_config("smollm-360m", smoke=True)
    model = pt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    batch = _tbatch(_train_batch(rconfigs.get_config("smollm-360m", smoke=True), 0))
    psteps.make_loss_and_grad(cfg, psteps.TrainConfig())(model, batch)
    assert all(p.requires_grad for p in model.parameters())


# ------------------------------------------------------------- checkpoints
def test_params_to_numpy_inverts_params_from_numpy():
    rcfg, pcfg = _both_cfgs("recurrentgemma-9b")
    tree = tm._draw(rcfg, 9)
    back = params_to_numpy(params_from_numpy(pcfg, tree, "cpu"))
    want = {n: np.asarray(a) for n, a in _named_leaves(tree).items()}
    got = _named_leaves(back)
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        if w.dtype.name == "bfloat16":
            assert got[n].dtype == np.uint16
            w = w.view(np.uint16)
        assert got[n].dtype == w.dtype and got[n].tobytes() == w.tobytes(), n


def _named_leaves(tree):
    return {"_".join(str(tm._key(p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.bfloat16), {"c": torch.tensor(7, dtype=torch.int32)}]}
    pckpt.save(str(tmp_path), 3, tree, extra={"foo": 1})
    assert pckpt.latest_step(str(tmp_path)) == 3
    like = jax.tree.map(lambda t: t.to("meta"), tree)
    restored, extra = pckpt.restore(str(tmp_path), 3, like, device="cpu")
    assert extra == {"foo": 1}
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    again, _ = pckpt.restore(str(tmp_path), 3, tree)  # like's own device
    assert torch.equal(again["b"][0], tree["b"][0])
    with pytest.raises(ValueError, match="meta"):
        pckpt.restore(str(tmp_path), 3, like)
    t = pckpt.save(str(tmp_path), 4, tree, async_write=True)
    t.join(timeout=60)
    assert not t.is_alive() and pckpt.latest_step(str(tmp_path)) == 4


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    pckpt.save(str(tmp_path), 1, {"a": torch.ones(3)})
    os.makedirs(tmp_path / "step_00000002.tmp")  # simulated crashed save
    assert pckpt.latest_step(str(tmp_path)) == 1
    assert pckpt.restore_latest(str(tmp_path / "none"), {"a": torch.ones(3)}) is None


def test_checkpoint_shape_mismatch_raises(tmp_path):
    pckpt.save(str(tmp_path), 1, {"a": torch.ones(3)})
    with pytest.raises(ValueError):
        pckpt.restore(str(tmp_path), 1, {"a": torch.empty(4, device="meta")}, device="cpu")


def _train_tree(arch):
    """A trainer's checkpoint tree in the reference's layout (params bf16
    as shipped, m and v f32), numpy leaves from a seed."""
    rcfg = rconfigs.get_config(arch, smoke=True)
    params = tm._draw(rcfg, 11)
    m = jax.tree.map(lambda a: np.asarray(a, np.float32) * 0.5, params)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32) ** 2, params)
    return {"params": params, "opt": {"m": m, "v": v}}


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-moe-16b", "hubert-xlarge"])
def test_checkpoints_cross_between_the_packages(arch, tmp_path):
    """The reference's checkpoint restores into the port bit for bit, the
    port's into the reference, and the .npy files of one tree are the same
    bytes."""
    tree = _train_tree(arch)
    pcfg = pconfigs.get_config(arch, smoke=True)
    model = params_from_numpy(pcfg, tree["params"], "cpu")
    state = {k: port_named(jax.tree.map(lambda a: torch.from_numpy(a.copy()), v))
             for k, v in tree["opt"].items()}
    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    rckpt.save(str(rdir), 5, tm._jax(tree), extra={"arch": arch})
    pckpt.save(str(pdir), 5, {"params": model, "opt": state}, extra={"arch": arch})
    rfiles = sorted(os.listdir(rdir / "step_00000005"))
    assert rfiles == sorted(os.listdir(pdir / "step_00000005"))
    for name in rfiles:
        if name.endswith(".npy"):
            assert (rdir / "step_00000005" / name).read_bytes() == \
                (pdir / "step_00000005" / name).read_bytes(), name
    rman = json.loads((rdir / "step_00000005" / "manifest.json").read_text())
    pman = json.loads((pdir / "step_00000005" / "manifest.json").read_text())
    assert pman["leaves"] == rman["leaves"] and pman["n_devices"] == 1
    assert pman["step"] == rman["step"] and pman["extra"] == rman["extra"]

    # the reference's checkpoint into the port
    fresh = pt.init_params(pcfg, torch.Generator().manual_seed(1), "cpu")
    like = {"params": fresh, "opt": {k: {n: torch.empty_like(t, device="meta")
                                         for n, t in v.items()} for k, v in state.items()}}
    step, got, extra = pckpt.restore_latest(str(rdir), like, device="cpu")
    assert step == 5 and extra == {"arch": arch}
    for name, p in model.named_parameters():
        assert torch.equal(got["params"][name].view(torch.int16) if p.dtype == torch.bfloat16
                           else got["params"][name],
                           p.view(torch.int16) if p.dtype == torch.bfloat16 else p), name
    for k in state:
        for name, t in state[k].items():
            assert torch.equal(got["opt"][k][name], t), (k, name)

    # the port's checkpoint into the reference
    rlike = jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), jnp.asarray(a).dtype),
                         tree)
    back, _ = rckpt.restore(str(pdir), 5, rlike)
    for (n, a), (_, b) in zip(_named_leaves(tree).items(), _named_leaves(back).items()):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), n


# ------------------------------------------------------------ crash/resume
def test_crash_resume_is_bitwise_identical(tmp_path):
    """Train 6 steps straight vs crash-at-3 + restore + 3 more — identical
    (deterministic pipeline + checkpointed optimizer state)."""
    cfg = pconfigs.get_config("smollm-360m", smoke=True)
    pipe = ppipe.TokenPipeline(ppipe.PipelineConfig(global_batch=4, seq_len=24, seed=1), cfg)
    opt = popt.AdamW(popt.AdamWConfig(learning_rate=1e-3, warmup_steps=1))
    step_fn = psteps.make_train_step(cfg, psteps.TrainConfig(grad_accum=1, remat=False), opt)

    def run(params, state, s0, s1):
        for s in range(s0, s1):
            batch = {k: torch.from_numpy(v) for k, v in pipe.batch(s).items()}
            params, state, _ = step_fn(params, state, batch, s)
        return params, state

    def fresh():
        p = pt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        return p, opt.init(p)

    p_straight, s_straight = run(*fresh(), 0, 6)
    p3, st3 = run(*fresh(), 0, 3)
    pckpt.save(str(tmp_path), 3, {"params": p3, "opt": st3})
    p0, s0 = fresh()
    restored, _ = pckpt.restore(str(tmp_path), 3, {"params": p0, "opt": s0})
    with torch.no_grad():
        for name, p in p0.named_parameters():
            p.copy_(restored["params"][name])
    p_resumed, s_resumed = run(p0, restored["opt"], 3, 6)
    for (name, a), (_, b) in zip(p_straight.named_parameters(), p_resumed.named_parameters()):
        assert torch.equal(a, b), name
    for k in s_straight:
        for name, t in s_straight[k].items():
            assert torch.equal(t, s_resumed[k][name]), (k, name)


# ------------------------------------------------------------------- CLI
def _reference_parser(monkeypatch):
    """The reference builds its parser inside ``main``: let ``main`` build
    it, and stop it at ``parse_args``."""
    seen = []

    class Stop(Exception):
        pass

    def capture(self, *a, **kw):
        seen.append(self)
        raise Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(Stop):
            rtrain.main()
    return seen[0]


def _flags(ap):
    return {a.option_strings[0]: a for a in ap._actions
            if a.option_strings and a.dest != "help"}


def test_parser_keeps_the_reference_flags(monkeypatch):
    """Flag for flag, the port's parser is the reference's: the same
    destinations, defaults, choices, types and actions. It adds
    ``--device``, whose default is the card."""
    ref, port = _flags(_reference_parser(monkeypatch)), _flags(ptrain.build_parser())
    assert set(port) - set(ref) == {"--device"}
    assert set(ref) - set(port) == set()
    for flag in ref:
        r, p = ref[flag], port[flag]
        assert (p.option_strings, p.dest, p.default, p.choices, p.type,
                p.nargs, p.const, p.help, type(p)) == (
            r.option_strings, r.dest, r.default, r.choices, r.type,
            r.nargs, r.const, r.help, type(r)), flag
    assert ptrain.build_parser().parse_args([]).device == "cuda"


SMOKE = ["--smoke", "--device", "cpu", "--steps", "6", "--global-batch", "4",
         "--seq-len", "24", "--grad-accum", "2", "--log-every", "2"]


def test_cli_crash_and_resume_end_bit_for_bit_where_the_straight_run_ends(tmp_path, capsys):
    straight = ptrain.main(SMOKE)
    text = capsys.readouterr().out
    for tag in ("[train] step 1/6 loss=", "[train] step 2/6 loss=", "[train] step 6/6",
                "[train] done in"):
        assert tag in text, tag
    assert straight["start"] == 0 and len(straight["metrics"]) == 6
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in straight["metrics"])
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(SystemExit) as exc:
        ptrain.main(SMOKE + ck + ["--crash-at", "3"])
    assert exc.value.code == 17
    text = capsys.readouterr().out
    assert "[train] checkpoint @ 2" in text
    assert "[train] simulating node failure at step 3" in text
    assert pckpt.latest_step(str(tmp_path)) == 2
    resumed = ptrain.main(SMOKE + ck)
    text = capsys.readouterr().out
    assert "[train] resumed from step 2" in text and "[train] checkpoint @ 6" in text
    assert resumed["start"] == 2
    assert resumed["metrics"] == straight["metrics"][2:]
    for (name, a), (_, b) in zip(straight["params"].named_parameters(),
                                 resumed["params"].named_parameters()):
        assert torch.equal(a, b), name
    for k, tree in straight["opt"].items():
        for name, t in tree.items():
            assert torch.equal(t, resumed["opt"][k][name]), (k, name)
    assert not torch.are_deterministic_algorithms_enabled()  # restored after the run


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cli_trains_every_arch_on_the_cpu(arch):
    out = ptrain.main(["--arch", arch] + SMOKE[:-2] + ["--steps", "2"])
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    init = pt.init_params(out["cfg"], torch.Generator().manual_seed(0), "cpu")
    moved = [n for (n, a), (_, b) in zip(init.named_parameters(),
                                         out["params"].named_parameters())
             if not torch.equal(a, b)]
    assert moved


def test_cli_runs_as_a_module_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m",
           "--smoke", "--device", "cpu", "--steps", "2", "--global-batch", "2",
           "--seq-len", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path),
           "--ckpt-every", "1", "--crash-at", "1"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 17, out.stderr
    assert "[train] step 1/2 loss=" in out.stdout
    out = subprocess.run(cmd[:-2], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] resumed from step 1" in out.stdout and "[train] done in" in out.stdout


def test_train_config_fields_equal_the_reference():
    assert [f.name for f in dataclasses.fields(psteps.TrainConfig)] == \
        [f.name for f in dataclasses.fields(rsteps.TrainConfig)]
    assert dataclasses.asdict(psteps.TrainConfig()) == dataclasses.asdict(rsteps.TrainConfig())
    assert dataclasses.asdict(popt.AdamWConfig()) == dataclasses.asdict(ropt.AdamWConfig())
    assert dataclasses.asdict(ppipe.PipelineConfig(8, 16)) == \
        dataclasses.asdict(rpipe.PipelineConfig(8, 16))
