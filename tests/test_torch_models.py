"""The port's LM substrate (``repro_torch.models``, ``repro_torch.configs``)
against the reference's, on the same numpy inputs made from a seed.

Weights are drawn with numpy in the reference's parameter layout (its
``init_params`` tree, groups stacked) and carried into both packages: as
jax arrays into the reference, through ``params_from_numpy`` into the
port. The reference's calls are jitted.

Two tiers. The f32 tier monkeypatches both packages' ``COMPUTE_DTYPE`` and
``PARAM_DTYPE`` module globals to f32 and casts the parameters to f32: the
two then compute the same math in the same precision and agree to
summation order (F32_TOL). The bf16 tier runs as shipped: logits within
BF16_TOL (the bound of the reference's own decode-against-forward test),
and the argmax equal wherever the reference's top-1/top-2 margin exceeds
twice that. In an MoE arch a bf16 rounding difference in a router's input
can send a token to another expert where two experts' router probabilities
nearly tie, and that changes the token's logits by more than the bound.
So both packages' routing is recorded (the reference's through a debug
callback on ``lax.top_k``, at run time), and a position is held to the
bound only where its token and every earlier token of its sequence were
routed alike in every layer. A later position sees a token routed
differently through attention and is held to twice the bound (measured
<= 0.395 there, <= 0.084 where all was routed alike). A token routed
differently must be a near tie (the reference's k-th and (k+1)-th
probabilities within ROUTER_TIE of its top one), and at most a quarter of
the compared positions may be. The f32 tier holds every position, and the
MoE tests hold the dispatch itself (gate ids, overflow) equal.
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import attention as ra  # noqa: E402
from repro.models import common as rcm  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import rglru as rrg  # noqa: E402
from repro.models import rwkv6 as rrw  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.models import attention as pa  # noqa: E402
from repro_torch.models import common as pcm  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models import rglru as prg  # noqa: E402
from repro_torch.models import rwkv6 as prw  # noqa: E402
from repro_torch.models import steps as psteps  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.weights import params_from_numpy, tensor_from_numpy  # noqa: E402

torch.set_num_threads(1)

ARCH_IDS = rconfigs.ARCH_IDS
DECODERS = [a for a in ARCH_IDS if not rconfigs.get_config(a, smoke=True).encoder_only]
F32_TOL = 1e-4  # both packages in f32: summation order only (measured <= 1.2e-5)
BF16_TOL = 0.35  # tests/test_models.py's decode-against-forward bound
MODULE_TOL = 2e-5  # one block in f32, relative to the output's largest magnitude
# a near tie of the router: the gap between the k-th and (k+1)-th expert's
# probability, relative to the top one (measured at bf16 flips: <= 0.046)
ROUTER_TIE = 0.1


# ------------------------------------------------------------------ helpers
@pytest.fixture
def f32(monkeypatch):
    """Both packages compute in f32 (the reference's modules unchanged: a
    runtime patch of their dtype globals)."""
    for m in (rcm, ra, rt):
        for name in ("COMPUTE_DTYPE", "PARAM_DTYPE"):
            if hasattr(m, name):
                monkeypatch.setattr(m, name, jnp.float32)
    for m in (pcm, pa, pt):
        for name in ("COMPUTE_DTYPE", "PARAM_DTYPE"):
            if hasattr(m, name):
                monkeypatch.setattr(m, name, torch.float32)


@pytest.fixture(params=["f32", "bf16"])
def tier(request):
    if request.param == "f32":
        request.getfixturevalue("f32")
    return request.param


def _key(entry):
    return getattr(entry, "key", getattr(entry, "idx", None))


def _draw(cfg, seed, f32=False):
    """Seeded numpy weights in the reference's layout and dtypes (bf16
    leaves as the reference's numpy bf16 arrays), cast to f32 for the f32
    tier. Scales follow the reference's init; vectors it makes constant get
    a random spread, so that every weight reaches the result."""
    shapes = jax.eval_shape(lambda: rt.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = _key(path[-1])
        shape = leaf.shape
        if name in ("mu", "mu_cm"):
            a = rng.uniform(0.0, 0.1, shape)
        elif name in ("conv_w", "u"):
            a = 0.1 * rng.standard_normal(shape)
        elif name == "w_lora_b":
            a = 0.01 * rng.standard_normal(shape)
        elif name == "embed":
            a = 0.02 * rng.standard_normal(shape)
        elif len(shape) >= 2 and not (len(shape) == 2 and path[0] == "groups"):
            # (a vector stacked over the groups is 2-D)
            a = rng.standard_normal(shape) * shape[-2] ** -0.5
        else:  # norm scales, biases and the decay constants
            base = {"lam": 0.7, "w0": -0.6}.get(name, 0.0)
            a = base + 0.1 * rng.standard_normal(shape)
        a = a.astype(np.float32)
        if f32 or leaf.dtype == jnp.float32:
            return a
        return np.asarray(jnp.asarray(a, leaf.dtype))

    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        leaves.append(draw(tuple(_key(p) for p in path), leaf))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _batch(cfg, B, S, rng):
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal((B, S, cfg.d_frontend)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_frontend)).astype(np.float32)
    return batch


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


class Routing:
    """Both packages' top-k gate ids, one entry a router call, in call
    order (the reference's delivered by an ordered debug callback)."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        real_ref, real_port = jax.lax.top_k, pmoe.top_k

        def ref_top_k(probs, k):
            vals, idx = real_ref(probs, k)
            jax.debug.callback(lambda i, p: self.ref.append((np.asarray(i), np.asarray(p))),
                               idx, probs, ordered=True)
            return vals, idx

        def port_top_k(probs, k):
            vals, idx = real_port(probs, k)
            self.port.append(idx.numpy())
            return vals, idx

        monkeypatch.setattr(jax.lax, "top_k", ref_top_k)
        monkeypatch.setattr(pmoe, "top_k", port_top_k)

    def flipped(self, calls):
        """(B, T) flags, over the tokens of ``calls`` (per model call in
        order: its number of router calls and its batch size B) laid out
        in time order: whether the token was routed differently in some
        layer (None without a router). Fails unless every difference is a
        near tie."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port) == sum(n for n, _ in calls)
        if not self.port:
            return None
        out, at = [], 0
        for n, b in calls:
            differ = np.zeros(len(self.port[at]), bool)
            for (ids, probs), got in zip(self.ref[at:at + n], self.port[at:at + n]):
                k = ids.shape[-1]
                here = (np.sort(ids, -1) != np.sort(got, -1)).any(-1)
                top = np.sort(probs, -1)[:, ::-1]
                tie = (top[:, k - 1] - top[:, k]) <= ROUTER_TIE * top[:, 0]
                assert tie[here].all(), "routing differs away from a near tie"
                differ |= here
            out.append(differ.reshape(b, -1))
            at += n
        return np.concatenate(out, axis=1)


def _check_logits(tier, cfg, want, got, what, flipped=None):
    """want, got: (B, T, V) logits; flipped: (B, T) routing flags of the
    compared positions' sequences up to each of them (None: all alike)."""
    want = np.asarray(want, np.float32)[..., :cfg.vocab]
    got = _np(got)[..., :cfg.vocab]
    err = np.abs(want - got).max(axis=-1)
    if tier == "f32":
        assert err.max() <= F32_TOL, (what, err.max())
        return
    if flipped is None:
        flipped = np.zeros(err.shape, bool)
    own = flipped[:, -err.shape[1]:] if flipped.shape[1] > err.shape[1] else flipped
    after = (np.cumsum(flipped, axis=1) - flipped)[:, -err.shape[1]:] > 0
    assert own.sum() <= 0.25 * own.size, (what, int(own.sum()))
    alike = ~own & ~after
    assert err[alike].max() <= BF16_TOL, (what, np.sort(err[alike])[-4:])
    assert err[~own & after].max(initial=0) <= 2 * BF16_TOL, what
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = alike & (top2[..., 1] - top2[..., 0] > 2 * BF16_TOL)
    assert (want.argmax(-1) == got.argmax(-1))[sure].all(), what


def _close(got, want, tol=MODULE_TOL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, float(np.abs(got - want).max())


def _both(tensors):
    """numpy arrays -> (jax arrays, torch tensors)."""
    return [jnp.asarray(a) for a in tensors], [torch.from_numpy(np.array(a)) for a in tensors]


def _ref_logits_fn(cfg):
    def fn(p, b):
        h, lb, _ = rt.forward(p, cfg, b)
        return rt.logits_fn(p, cfg, h), lb
    return jax.jit(fn)


# --------------------------------------------------------- per-module parity
def test_rms_norm_rope_swiglu(f32):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    scale = 0.1 * rng.standard_normal(8).astype(np.float32)
    (jx, js), (tx, ts) = _both([x, scale])
    _close(pcm.rms_norm(tx, ts), rcm.rms_norm(jx, js))
    pos1 = np.arange(3, 8)
    pos2 = rng.integers(0, 100, (2, 5))
    for pos in (pos1, pos2):
        (jp,), (tp,) = _both([pos])
        _close(pcm.rope(tx, tp, 1e4), rcm.rope(jx, jp, 1e4))
    w1, w3, w2 = (rng.standard_normal(s).astype(np.float32) / 3
                  for s in ((8, 12), (8, 12), (12, 8)))
    (a, b, c), (d, e, f) = _both([w1, w3, w2])
    _close(pcm.swiglu(tx, d, e, f), rcm.swiglu(jx, a, b, c))


def test_rms_norm_keeps_bf16_multiplies():
    rng = np.random.default_rng(1)
    x = np.asarray(jnp.asarray(rng.standard_normal((4, 16)), jnp.bfloat16))
    scale = (0.1 * rng.standard_normal(16)).astype(np.float32)
    got = pcm.rms_norm(tensor_from_numpy(x, "cpu"), torch.from_numpy(scale))
    want = rcm.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    assert got.dtype == torch.bfloat16
    _close(got, want, 2 ** -7)


def _qkv(rng, b, sq, sk, h, kv, hd):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


@pytest.mark.parametrize("causal", [True, False])
def test_naive_attention(f32, causal):
    rng = np.random.default_rng(2)
    jq, tq = _both(_qkv(rng, 2, 8, 8 if not causal else 24, 4, 2, 8))
    _close(pa.naive_attention(*tq, causal=causal), ra.naive_attention(*jq, causal=causal))


@pytest.mark.parametrize("causal,s,chunk", [(True, 32, 8), (False, 32, 8),
                                            (True, 2048, 1024)])
def test_flash_attention(f32, causal, s, chunk):
    rng = np.random.default_rng(3)
    jq, tq = _both(_qkv(rng, 1, s, s, 2, 1, 8))
    want = jax.jit(lambda q, k, v: ra.flash_attention(
        q, k, v, causal=causal, q_chunk=chunk, k_chunk=chunk))(*jq)
    got = pa.flash_attention(*tq, causal=causal, q_chunk=chunk, k_chunk=chunk)
    _close(got, want)
    # the same math as the naive path, and the route auto takes at 2048
    _close(got, pa.naive_attention(*tq, causal=causal))
    if s >= pa.FLASH_MIN_SEQ:
        assert torch.equal(pa.gqa_attention(*tq, causal=causal), got)


def test_flash_attention_bf16():
    rng = np.random.default_rng(4)
    arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in _qkv(rng, 1, 64, 64, 4, 2, 16)]
    want = jax.jit(lambda q, k, v: ra.flash_attention(q, k, v, q_chunk=16, k_chunk=16))(
        *[jnp.asarray(a) for a in arrs])
    got = pa.flash_attention(*[tensor_from_numpy(a, "cpu") for a in arrs],
                             q_chunk=16, k_chunk=16)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2 ** -6)


@pytest.mark.parametrize("s,window", [(27, 8), (32, 8), (5, 8)])
def test_sliding_attention(f32, s, window):
    rng = np.random.default_rng(5)
    jq, tq = _both(_qkv(rng, 2, s, s, 4, 1, 8))
    _close(pa.sliding_attention(*tq, window),
           jax.jit(ra.sliding_attention, static_argnums=3)(*jq, window))


@pytest.mark.parametrize("pos", [1, 13, 24])
def test_decode_attention(f32, pos):
    rng = np.random.default_rng(6)
    jq, tq = _both(_qkv(rng, 2, 1, 24, 4, 2, 8))
    _close(pa.decode_attention(*tq, pos), ra.decode_attention(*jq, jnp.int32(pos)))


@pytest.mark.parametrize("pos", [3, 8, 13, 30])
def test_decode_sliding_attention(f32, pos):
    rng = np.random.default_rng(7)
    jq, tq = _both(_qkv(rng, 2, 1, 8, 4, 1, 8))
    _close(pa.decode_sliding_attention(*tq, pos, 8),
           ra.decode_sliding_attention(*jq, jnp.int32(pos), 8))


def _mla_params(rng, d, h, dims):
    shapes = {"q_down": (d, dims.q_lora), "q_norm": (dims.q_lora,),
              "q_up": (dims.q_lora, h * (dims.nope_dim + dims.rope_dim)),
              "kv_down": (d, dims.kv_lora + dims.rope_dim), "kv_norm": (dims.kv_lora,),
              "kv_up": (dims.kv_lora, h * (dims.nope_dim + dims.v_dim)),
              "wo": (h * dims.v_dim, d)}
    return {k: (rng.standard_normal(s) * (s[0] ** -0.5 if len(s) == 2 else 0.1)
                ).astype(np.float32) for k, s in shapes.items()}


def test_mla(f32):
    rng = np.random.default_rng(8)
    d, h = 32, 4
    rdims = ra.MLADims(q_lora=16, kv_lora=12, rope_dim=8, nope_dim=8, v_dim=8)
    pdims = pa.MLADims(**dataclasses.asdict(rdims))
    p = _mla_params(rng, d, h, rdims)
    jp, tp = _jax(p), {k: torch.from_numpy(v) for k, v in p.items()}
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    (jx, jpos), (tx, tpos) = _both([x, np.arange(24)])
    want = jax.jit(lambda p, x, pos: ra.mla_qkv(p, x, pos, rdims, h, 1e4))(jp, jx, jpos)
    for got, w in zip(pa.mla_qkv(tp, tx, tpos, pdims, h, 1e4), want):
        _close(got, w)
    got, (ckv, krope) = pa.mla_attention(tp, tx, tpos, pdims, h, 1e4)
    want, (rckv, rkrope) = jax.jit(lambda p, x, pos: ra.mla_attention(
        p, x, pos, rdims, h, 1e4))(jp, jx, jpos)
    for g, w in ((got, want), (ckv, rckv), (krope, rkrope)):
        _close(g, w)
    # absorbed decode at pos 20 over a 32-slot cache holding 19 tokens
    cache = [rng.standard_normal((2, 32, n)).astype(np.float32)
             for n in (rdims.kv_lora, rdims.rope_dim)]
    x1 = x[:, :1]
    (jc, jk, jx1), (tc, tk, tx1) = _both(cache + [x1])
    got = pa.mla_decode(tp, tx1, torch.tensor([19]), tc, tk, 20, pdims, h, 1e4)
    want = jax.jit(lambda p, x, c, k: ra.mla_decode(
        p, x, jnp.asarray([19]), c, k, jnp.int32(20), rdims, h, 1e4))(jp, jx1, jc, jk)
    for g, w in zip(got, want):
        _close(g, w)


def _moe_params(rng, d, dims, dtype):
    e, fe = dims.n_experts, dims.d_expert
    shapes = {"router": (d, e), "w1": (e, d, fe), "w3": (e, d, fe), "w2": (e, fe, d)}
    if dims.n_shared:
        fs = dims.n_shared * fe
        shapes.update(shared_w1=(d, fs), shared_w3=(d, fs), shared_w2=(fs, d))
    p = {k: (rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
         for k, s in shapes.items()}
    if dtype == "bf16":  # the router stays f32, as the reference makes it
        p = {k: v if k == "router" else np.asarray(jnp.asarray(v, jnp.bfloat16))
             for k, v in p.items()}
    return p


@pytest.mark.parametrize("cf,n_shared,dtype", [(8.0, 1, "f32"), (0.5, 0, "f32"),
                                               (0.5, 2, "bf16")])
def test_moe_dispatch_matches_reference(cf, n_shared, dtype, monkeypatch):
    """Gate ids equal, overflow equal (capacity 0.5 drops assignments), the
    outputs and the load-balance loss to rounding."""
    rng = np.random.default_rng(9)
    d = 24
    rdims = rmoe.MoEDims(n_experts=8, top_k=2, d_expert=16, n_shared=n_shared,
                         capacity_factor=cf)
    pdims = pmoe.MoEDims(**dataclasses.asdict(rdims))
    p = _moe_params(rng, d, rdims, dtype)
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    seen = {}
    real_ref, real_port = jax.lax.top_k, pmoe.top_k

    def ref_top_k(probs, k):
        out = real_ref(probs, k)
        seen["ref"] = np.asarray(out[1])
        return out

    def port_top_k(probs, k):
        out = real_port(probs, k)
        seen["port"] = out[1].numpy()
        return out

    monkeypatch.setattr(jax.lax, "top_k", ref_top_k)
    monkeypatch.setattr(pmoe, "top_k", port_top_k)
    want, raux = rmoe.moe_mlp(_jax(p), jnp.asarray(x), rdims)
    got, paux = pmoe.moe_mlp({k: tensor_from_numpy(v, "cpu") for k, v in p.items()},
                             tensor_from_numpy(x, "cpu"), pdims)
    np.testing.assert_array_equal(seen["port"], seen["ref"])
    assert float(paux["overflow_frac"]) == float(raux["overflow_frac"])
    assert (float(raux["overflow_frac"]) > 0) == (cf < 1)
    _close(got, want, MODULE_TOL if dtype == "f32" else 2 ** -6)
    assert abs(float(paux["lb_loss"]) - float(raux["lb_loss"])) <= 1e-5


def test_top_k_keeps_the_lower_index_on_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]], np.float32)
    vals, idx = pmoe.top_k(torch.from_numpy(probs), 2)
    rvals, ridx = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


def _rglru_params(rng, d, r):
    shapes = {"w_in": (d, r), "w_gate": (d, r), "conv_w": (4, r), "conv_b": (r,),
              "w_a": (r, r), "b_a": (r,), "w_x": (r, r), "b_x": (r,), "lam": (r,),
              "w_out": (r, d)}
    p = {k: (rng.standard_normal(s) * (s[0] ** -0.5 if len(s) == 2 else 0.1)
             ).astype(np.float32) for k, s in shapes.items()}
    p["lam"] += 0.7
    return p


def test_rglru(f32):
    rng = np.random.default_rng(10)
    d, r = 16, 24
    p = _rglru_params(rng, d, r)
    jp, tp = _jax(p), {k: torch.from_numpy(v) for k, v in p.items()}
    x = rng.standard_normal((2, 37, d)).astype(np.float32)
    h0 = rng.standard_normal((2, r)).astype(np.float32)
    tail = rng.standard_normal((2, 3, r)).astype(np.float32)
    jin, tin = _both([x, h0, tail])
    for got, want in zip(prg.rglru_block(tp, *tin), jax.jit(rrg.rglru_block)(jp, *jin)):
        _close(got, want)
    jin, tin = _both([x[:, :1], h0, tail])
    for got, want in zip(prg.rglru_decode(tp, *tin), jax.jit(rrg.rglru_decode)(jp, *jin)):
        _close(got, want)


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(11)
    coef = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 29, 3)))
    x = torch.from_numpy(rng.standard_normal((2, 29, 3)))
    h, want = torch.zeros(2, 3, dtype=torch.float64), []
    for t in range(29):
        h = coef[:, t] * h + x[:, t]
        want.append(h)
    torch.testing.assert_close(prg.linear_scan(coef, x), torch.stack(want, 1))


def _rwkv_params(rng, d, hd, ff):
    tree = jax.eval_shape(lambda: rrw.rwkv6_init(rcm.KeyGen(jax.random.PRNGKey(0)), d, hd, ff))
    out = {}
    for k, leaf in tree.items():
        s = leaf.shape
        if k in ("mu", "mu_cm"):
            a = rng.uniform(0, 0.1, s)
        elif k == "w_lora_b":
            a = 0.01 * rng.standard_normal(s)
        elif len(s) == 2 and k != "u":
            a = rng.standard_normal(s) * s[0] ** -0.5
        else:
            a = {"w0": -0.6}.get(k, 0.0) + 0.1 * rng.standard_normal(s)
        out[k] = a.astype(np.float32)
    return out


def test_rwkv6(f32):
    rng = np.random.default_rng(12)
    d, hd, ff = 32, 8, 48
    p = _rwkv_params(rng, d, hd, ff)
    jp, tp = _jax(p), {k: torch.from_numpy(v) for k, v in p.items()}
    x = rng.standard_normal((2, 21, d)).astype(np.float32)  # pads to 32
    state = 0.1 * rng.standard_normal((2, d // hd, hd, hd)).astype(np.float32)
    xprev = rng.standard_normal((2, d)).astype(np.float32)
    jin, tin = _both([x, state, xprev])
    got = prw.rwkv6_time_mix(tp, tin[0], hd, tin[1], tin[2])
    want = jax.jit(rrw.rwkv6_time_mix, static_argnums=2)(jp, jin[0], hd, jin[1], jin[2])
    for g, w in zip(got, want):
        _close(g, w)
    jin1, tin1 = _both([x[:, :1]])
    got = prw.rwkv6_time_mix_decode(tp, tin1[0], hd, tin[1], tin[2])
    want = jax.jit(rrw.rwkv6_time_mix_decode, static_argnums=2)(jp, jin1[0], hd, jin[1], jin[2])
    for g, w in zip(got, want):
        _close(g, w)
    for g, w in zip(prw.rwkv6_channel_mix(tp, tin[0], tin[2]),
                    jax.jit(rrw.rwkv6_channel_mix)(jp, jin[0], jin[2])):
        _close(g, w)


# ------------------------------------------------------------- whole model
def _router_calls(cfg):
    return cfg.n_layers - cfg.first_dense if cfg.moe is not None else 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch, tier, monkeypatch):
    rcfg, pcfg = rconfigs.get_config(arch, smoke=True), pconfigs.get_config(arch, smoke=True)
    tree = _draw(rcfg, ARCH_IDS.index(arch), f32=tier == "f32")
    batch = _batch(rcfg, 2, 24, np.random.default_rng(1))
    routing = Routing(monkeypatch)
    want, rlb = _ref_logits_fn(rcfg)(_jax(tree), _jax(batch))
    model = params_from_numpy(pcfg, tree, "cpu")
    h, lb, cache = pt.forward(model, pcfg, _torch(batch))
    assert cache is None
    assert h.dtype == (torch.float32 if tier == "f32" else torch.bfloat16)
    got = pt.logits_fn(model, pcfg, h)
    assert got.shape == want.shape
    _check_logits(tier, rcfg, want, got, arch,
                  routing.flipped([(_router_calls(rcfg), got.shape[0])]))
    if rcfg.vocab_padded > rcfg.vocab:  # padded ids unreachable
        assert float(got[..., rcfg.vocab:].max()) < -1e8
    if tier == "f32":
        assert abs(float(lb) - float(rlb)) <= 1e-5
    assert torch.equal(model(_torch(batch))[0], h)  # the module's forward


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items() if k != "pos"}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    if tree is None:
        return None
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) if k != "pos" for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_reference(arch, tier, monkeypatch):
    """Prefill 16 tokens, then 3 decode steps teacher-forced with the same
    tokens in both packages: every step's logits, and the cache's layout
    (its values in the f32 tier). The port's decode also matches its own
    forward, as the reference's test holds the reference."""
    rcfg, pcfg = rconfigs.get_config(arch, smoke=True), pconfigs.get_config(arch, smoke=True)
    tree = _draw(rcfg, 100 + ARCH_IDS.index(arch), f32=tier == "f32")
    B, S, P = 2, 24, 16
    batch = _batch(rcfg, B, S, np.random.default_rng(2))
    toks = batch["tokens"]
    pre = dict(batch, tokens=toks[:, :P])
    params = _jax(tree)
    model = params_from_numpy(pcfg, tree, "cpu")
    routing = Routing(monkeypatch)
    lg, cache = jax.jit(lambda p, b: rt.prefill(p, rcfg, b))(params, _jax(pre))
    plg, pcache = pt.prefill(model, pcfg, _torch(pre))
    assert pcache["pos"] == int(cache["pos"])
    assert _layout(pcache) == _layout(cache)
    if tier == "f32":
        for g, w in zip(_leaves(pcache), _leaves(cache)):
            _close(g, w, F32_TOL)
    decode = jax.jit(lambda p, c, t: rt.decode_step(p, rcfg, c, t))
    wants, gots = [lg], [plg]
    for t in range(P, P + 3):
        lg, cache = decode(params, cache, jnp.asarray(toks[:, t:t + 1]))
        plg, pcache = pt.decode_step(model, pcfg, pcache, torch.from_numpy(toks[:, t:t + 1]))
        wants.append(lg)
        gots.append(plg)
    assert pcache["pos"] == int(cache["pos"])
    # the compared positions are the prompt's last token and the three
    # decoded ones: the last 4 of each sequence's routing flags
    n = _router_calls(rcfg)
    flipped = routing.flipped([(n, B)] * 4)
    _check_logits(tier, rcfg, np.stack(wants, 1), torch.stack(gots, 1), arch, flipped)
    off = rcfg.n_vis_tokens if rcfg.frontend == "vision" else 0
    h = pt.forward(model, pcfg, _torch(batch))[0]
    own = pt.logits_fn(model, pcfg, h[:, off + P - 1:off + P + 3])
    err = float((own - torch.stack(gots, 1)).abs()[..., :rcfg.vocab].max())
    assert err < (F32_TOL if tier == "f32" else BF16_TOL), err


def test_step_factories_are_prefill_and_decode_step():
    cfg = pconfigs.get_config("smollm-360m", smoke=True)
    model = pt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 9)))
    lg, cache = psteps.make_prefill_step(cfg)(model, {"tokens": toks[:, :8]})
    lg2, cache2 = pt.prefill(model, cfg, {"tokens": toks[:, :8]})
    assert torch.equal(lg, lg2) and cache["pos"] == cache2["pos"] == 8
    assert cache["prefix"] == [] and cache["groups"][0]["k"].shape[:3] == (3, 2, 72)
    step = psteps.make_decode_step(cfg)
    a, _ = step(model, cache, toks[:, 8:])
    b, _ = pt.decode_step(model, cfg, cache2, toks[:, 8:])
    assert torch.equal(a, b)


def test_make_cache_is_zero_in_the_prefill_layout():
    cfg = pconfigs.get_config("recurrentgemma-9b", smoke=True)
    model = pt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 8), dtype=torch.long)
    _, filled = pt.prefill(model, cfg, {"tokens": toks}, cache_len=12)
    empty = pt.make_cache(cfg, 2, 12, "cpu")
    assert _layout(empty) == _layout(filled) and empty["pos"] == 0
    assert all(float(t.abs().max()) == 0 for t in _leaves(empty))


# -------------------------------------------------------- configs and init
def test_configs_equal_the_reference():
    assert pconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    for arch, smoke in itertools.product(ARCH_IDS, (False, True)):
        assert (dataclasses.asdict(pconfigs.get_config(arch, smoke))
                == dataclasses.asdict(rconfigs.get_config(arch, smoke))), arch
    for name in ("SHAPES", "SMOKE_SHAPES"):
        ref, port = getattr(rconfigs, name), getattr(pconfigs, name)
        assert {k: dataclasses.asdict(v) for k, v in port.items()} == \
            {k: dataclasses.asdict(v) for k, v in ref.items()}
    for arch, shape in itertools.product(ARCH_IDS, rconfigs.SHAPES):
        assert pconfigs.cell_is_skipped(arch, shape) == rconfigs.cell_is_skipped(arch, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_equal_the_reference(arch):
    rcfg, pcfg = rconfigs.get_config(arch), pconfigs.get_config(arch)
    assert pcfg.n_params() == rcfg.n_params()
    if rcfg.moe is not None:  # else both are n_params()
        assert pcfg.n_params_active() == rcfg.n_params_active()


def _port_tree(model, cfg):
    """The port's parameters in the reference's layout (groups stacked)."""
    flat = {}
    for name, t in model.named_parameters():
        keys = tuple(int(k) if k.isdigit() else k for k in name.split("."))
        if keys[0] == "groups":  # groups.g.j.rest -> groups.j.rest, stacked over g
            flat.setdefault(("groups",) + keys[2:], []).append((keys[1], t.detach()))
        else:
            flat[keys] = t.detach()
    return {k: torch.stack([t for _, t in sorted(v, key=lambda e: e[0])])
            if isinstance(v, list) else v for k, v in flat.items()}


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(_key(p) for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_has_the_reference_names_shapes_dtypes(arch):
    rcfg, pcfg = rconfigs.get_config(arch, smoke=True), pconfigs.get_config(arch, smoke=True)
    ref = _ref_flat(jax.eval_shape(lambda: rt.init_params(rcfg, jax.random.PRNGKey(0))))
    model = pt.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    port = _port_tree(model, pcfg)
    assert sorted(port) == sorted(ref)
    for k, leaf in ref.items():
        assert tuple(port[k].shape) == leaf.shape, k
        assert str(port[k].dtype).replace("torch.", "") == str(leaf.dtype), k
    assert isinstance(model, torch.nn.Module)
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b",
                                  "recurrentgemma-9b", "rwkv6-3b"])
def test_init_params_draws_like_the_reference(arch):
    """Constant leaves equal the reference's exactly; random leaves have its
    mean and standard deviation within sampling error (5 standard errors,
    plus bf16 rounding)."""
    rcfg, pcfg = rconfigs.get_config(arch, smoke=True), pconfigs.get_config(arch, smoke=True)
    ref = {k: np.asarray(v, np.float32)
           for k, v in _ref_flat(rt.init_params(rcfg, jax.random.PRNGKey(0))).items()}
    port = {k: v.float().numpy()
            for k, v in _port_tree(pt.init_params(pcfg, torch.Generator().manual_seed(0),
                                                  "cpu"), pcfg).items()}
    for k, want in ref.items():
        got = port[k]
        if np.ptp(want) == 0:
            np.testing.assert_array_equal(got, want, err_msg=str(k))
            continue
        n = want.size
        sd = float(want.std())
        assert abs(float(got.mean()) - float(want.mean())) <= 5 * sd / math.sqrt(n) + 1e-3 * sd, k
        assert abs(float(got.std()) - sd) <= 5 * sd / math.sqrt(2 * n) + 1e-2 * sd, k


def test_params_from_numpy_keeps_bf16_bits():
    x = np.asarray(jnp.asarray(np.random.default_rng(4).standard_normal((3, 5)),
                               jnp.bfloat16))
    assert x.dtype.name == "bfloat16"
    t = tensor_from_numpy(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), x.view(np.int16))
