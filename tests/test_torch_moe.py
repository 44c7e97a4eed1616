"""The MoE family on the port against the JAX package, on the CPU: the
router, the slot assignment and capacity, the capacity-buffer dispatch
(with and without drops), the decode step's per-token routing, and the
smoke configs of both MoE archs (moonshot-v1-16b-a3b with GQA,
deepseek-v2-236b with MLA) as whole models and through ``DecodePlan``.

Both sides start from the JAX package's initial weights (``moe_init``, or
the model's ``init`` carried through its checkpoint); inputs are numpy
arrays from one seed.  f32 throughout: the routing compares bit for bit,
values within rtol 1e-5 / atol 1e-6 (the router's probabilities and aux
within rtol 1e-6).  The module-level inputs are drawn at std ``X_STD``, so
that the MoE's outputs are O(1) and atol 1e-6 is a few f32 ulps of the
terms they sum; at std 1 the outputs reach ~5 and two f32 orders of the
expert products differ by up to 3.3e-6 on the near-zero ones.  The whole
models meet rtol 1e-5 / atol 1e-5 (the dense family's bar) from their own
embeddings.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import runtime as jrt
from repro.checkpoint.store import save_checkpoint
from repro.models import build_model as j_build_model
from repro.models import moe as jmoe
from repro.sharding.rules import ShardCtx
from repro_torch.checkpoint import lm_params_from_flat, flat_from_lm, load_flat
from repro_torch.models import moe as tmoe
from repro_torch.runtime import Request, ServiceConfig, serve_model

MOE = ("moonshot-v1-16b-a3b", "deepseek-v2-236b")
TOL = dict(rtol=1e-5, atol=1e-6)
ROUTER_TOL = dict(rtol=1e-6, atol=0)
RNG = np.random.default_rng(11)
X_STD = 0.5
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _module(cfg, tree):
    """A port ``MoE`` holding the reference's ``moe_init`` pytree."""
    m = tmoe.MoE(cfg)
    with torch.no_grad():
        for name, p in m.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[part]
            p.copy_(_t(node))
    return m


def _cfg(arch="moonshot-v1-16b-a3b", **kw):
    return dataclasses.replace(jcfg.get_smoke_config(arch), **kw)


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("t,e,k", [(7, 8, 2), (33, 64, 6), (5, 160, 6)])
def test_router_topk(t, e, k):
    logits = (2 * RNG.standard_normal((t, e))).astype(np.float32)
    wp, wi, waux = jmoe.router_topk(jnp.asarray(logits), k)
    gp, gi, gaux = tmoe.router_topk(_t(logits), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gp, wp, **ROUTER_TOL)
    _close(gaux, waux, **ROUTER_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_topk_breaks_ties_toward_the_lower_index(dtype):
    """Exact ties at and across the k-th place: the lower expert index
    first, as ``jax.lax.top_k`` takes it.  bf16 logits (the published
    configs' router dtype) coarsened so that many rows tie."""
    k, e = 3, 16
    rows = [np.zeros(e), np.full(e, 2.0)]  # every expert tied
    tied = np.zeros(e)
    tied[[1, 5, 9, 12]] = 3.0  # four tied for three places
    rows.append(tied)
    edge = np.linspace(0, 1, e)
    edge[[4, 10]] = 5.0
    edge[[2, 7, 15]] = 4.0  # the k-th place tied three ways
    rows.append(edge)
    coarse = np.round(RNG.standard_normal((40, e)) * 2) / 2  # half-integers: ties everywhere
    logits = np.concatenate([np.stack(rows), coarse]).astype(np.float32)
    tl = _t(logits).to(getattr(torch, dtype))
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    wp, wi, waux = jmoe.router_topk(jl, k)
    gp, gi, gaux = tmoe.router_topk(tl, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gi[0].tolist() == [0, 1, 2] and gi[2].tolist() == [1, 5, 9]
    assert gi[3].tolist() == [4, 10, 2]
    _close(gp, wp, **ROUTER_TOL)
    _close(gaux, waux, **ROUTER_TOL)


@pytest.mark.parametrize("capacity", [1, 3, 8, 100])
def test_slots(capacity):
    e = 6
    e_flat = RNG.integers(0, e, 50)
    ws, wk = jmoe._slots(jnp.asarray(e_flat, jnp.int32), e, capacity)
    gs, gk = tmoe._slots(_t(e_flat), e, capacity)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))


@pytest.mark.parametrize("tokens,k,e,cf", [
    (1, 6, 64, 1.25), (1, 2, 8, 8.0), (37, 2, 8, 0.5), (768, 6, 64, 1.25),
    (700, 6, 160, 1.25), (4096, 6, 64, 64 / 6),
])
def test_capacity(tokens, k, e, cf):
    assert tmoe._capacity(tokens, k, e, cf) == jmoe._capacity(tokens, k, e, cf)


# ---------------------------------------------------------------- dispatch
def _dispatch_inputs(cfg, t):
    params = jmoe.moe_init(jax.random.PRNGKey(3), cfg)
    x = (X_STD * RNG.standard_normal((t, cfg.d_model))).astype(np.float32)
    logits = x @ np.asarray(params["router"])
    probs, idx, _ = jmoe.router_topk(jnp.asarray(logits), cfg.top_k)
    return params, x, np.asarray(probs), np.asarray(idx)


def _dropped(idx, n_experts, capacity):
    _, keep = jmoe._slots(jnp.asarray(idx.reshape(-1)), n_experts, capacity)
    return int((~np.asarray(keep)).sum())


@pytest.mark.parametrize("cf,e_lo,e_loc", [(8.0, 0, None), (0.5, 0, None), (0.5, 2, 4)],
                         ids=["no_drops", "drops", "drops_shard"])
def test_dispatch_compute(cf, e_lo, e_loc):
    cfg = _cfg(capacity_factor=cf)
    t = 37
    params, x, probs, idx = _dispatch_inputs(cfg, t)
    e_loc = e_loc or cfg.n_experts
    cap = jmoe._capacity(t, cfg.top_k, cfg.n_experts, cf)
    if cf < 1:
        assert _dropped(idx, cfg.n_experts, cap) > 0
    w = {n: np.asarray(params[n])[e_lo:e_lo + e_loc] for n in ("gate", "up", "down")}
    want = jmoe._dispatch_compute(jnp.asarray(x), jnp.asarray(probs), jnp.asarray(idx),
                                  *(jnp.asarray(w[n]) for n in ("gate", "up", "down")),
                                  e_lo, cap)
    got = tmoe._dispatch_compute(_t(x), _t(probs), _t(idx).long(),
                                 *(_t(w[n]) for n in ("gate", "up", "down")), e_lo, cap)
    _close(got, want)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no_drops", "drops"])
def test_moe_apply(arch, cf):
    cfg = _cfg(arch, capacity_factor=cf)
    params = jmoe.moe_init(jax.random.PRNGKey(4), cfg)
    x = (X_STD * RNG.standard_normal((2, 19, cfg.d_model))).astype(np.float32)
    want, waux = jmoe.moe_apply(params, jnp.asarray(x), cfg, ShardCtx())
    got, gaux = tmoe.moe_apply(_module(cfg, params), _t(x), cfg)
    if cf < 1:
        logits = x.reshape(-1, cfg.d_model) @ np.asarray(params["router"])
        _, idx, _ = jmoe.router_topk(jnp.asarray(logits), cfg.top_k)
        cap = jmoe._capacity(38, cfg.top_k, cfg.n_experts, cf)
        assert _dropped(np.asarray(idx), cfg.n_experts, cap) > 0
    _close(got, want)
    _close(gaux, waux, **ROUTER_TOL)


@pytest.mark.parametrize("slots", [1, 3, 4])
def test_moe_decode_equals_a_per_token_moe_apply(slots):
    """The decode step's S tokens in one call equal the reference's
    ``moe_apply`` called once a token (its ``vmap``'d one-token step),
    at the configured capacity factor, which drops nothing at T = 1."""
    cfg = _cfg(capacity_factor=1.25)
    params = jmoe.moe_init(jax.random.PRNGKey(5), cfg)
    x = (X_STD * RNG.standard_normal((slots, 1, cfg.d_model))).astype(np.float32)
    got = tmoe.moe_decode(_module(cfg, params), _t(x), cfg)
    assert got.shape == (slots, 1, cfg.d_model)
    for s in range(slots):
        want, _ = jmoe.moe_apply(params, jnp.asarray(x[s:s + 1]), cfg, ShardCtx())
        _close(got[s:s + 1], want)


def test_moe_init_distributions():
    """``moe_init``'s shapes and fan-ins: truncated normal at 1/sqrt(E) for
    gate/up (axis 0), 1/sqrt(f) for down (axis 1), 1/sqrt(d) elsewhere."""
    cfg = dataclasses.replace(_cfg(), d_model=128, n_experts=16, moe_d_ff=256)
    m = tmoe.MoE(cfg)
    with torch.no_grad():
        m.init(torch.Generator().manual_seed(0))
    ref = jmoe.moe_init(jax.random.PRNGKey(0), cfg)
    got = dict(m.named_parameters())
    for name in ("router", "gate", "up", "down", "shared.gate", "shared.up", "shared.down"):
        node = ref
        for part in name.split("."):
            node = node[part]
        want = np.asarray(node)
        assert tuple(got[name].shape) == want.shape, name
        np.testing.assert_allclose(float(got[name].std()), float(want.std()), rtol=0.05)
        # cut at 2 sigma: the cut normal's std is 0.88 sigma
        assert float(got[name].abs().max()) <= 1.01 * 2 * float(want.std()) / 0.88


# ------------------------------------------------------------ whole models
@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """arch -> (cfg, reference model, its params, port model, flat arrays)."""
    out = {}
    for arch in MOE:
        cfg = jcfg.get_smoke_config(arch)
        jm = j_build_model(cfg)
        params = jm.init(jax.random.PRNGKey(0))
        flat = load_flat(save_checkpoint(str(tmp_path_factory.mktemp(arch)), 0, params))
        out[arch] = (cfg, jm, params, lm_params_from_flat(cfg, flat, device="cpu"), flat)
    return out


def _with_cfg(tm, flat, **kw):
    """The same weights under a config with other MoE settings."""
    cfg = dataclasses.replace(tm.cfg, **kw)
    return cfg, lm_params_from_flat(cfg, flat, device="cpu")


def _pad(c, smax):
    return jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, smax - a.shape[2])] + [(0, 0)] * (a.ndim - 3)),
        c)


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_aux(models, arch):
    cfg, jm, params, tm, _ = models[arch]
    assert [type(b.attn).__name__ for b in tm.blocks] == ["MLA" if arch.startswith("deep")
                                                          else "GQA"] * cfg.n_layers
    assert len(tm.dense_layers) == 1 and len(tm.layers) == 2
    toks = RNG.integers(0, cfg.vocab_size, (2, 23)).astype(np.int32)
    want, waux = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, aux = tm({"tokens": _t(toks).long()})
    _close(got, want, **MODEL_TOL)
    _close(aux, waux, **ROUTER_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_then_five_decode_steps(models, arch):
    """Prefill (logits and cache), then five greedy decode steps with the
    rows at their own lengths: every step's logits and cache against the
    reference's scalar-position step row by row, tokens equal."""
    cfg, jm, params, tm, _ = models[arch]
    lens, smax = (19, 7), 32
    jcache, tcache, jtok, ttok = [], tm.init_cache(len(lens), smax), [], []
    jprefill = jax.jit(jm.prefill)
    for r, n in enumerate(lens):
        p = RNG.integers(0, cfg.vocab_size, n).astype(np.int32)
        want, c = jprefill(params, {"tokens": jnp.asarray(p[None])})
        got, tc = tm.prefill({"tokens": _t(p[None]).long()})
        _close(got, want, **MODEL_TOL)
        for name in c:
            _close(tc[name], c[name], **MODEL_TOL)
            tcache[name][:, r, :n] = tc[name][:, 0]
        jcache.append(_pad(c, smax))
        jtok.append(int(jnp.argmax(want[0])))
        ttok.append(int(got[0].argmax()))
    assert jtok == ttok
    jstep = jax.jit(jm.decode_step)
    cur = np.array(lens)
    for _ in range(5):
        got, tcache = tm.decode_step(tcache, torch.tensor(ttok)[:, None], _t(cur))
        for r in range(len(lens)):
            want, jcache[r] = jstep(params, jcache[r], jnp.asarray([[jtok[r]]], jnp.int32),
                                    jnp.asarray(cur[r], jnp.int32))
            _close(got[r:r + 1], want, **MODEL_TOL)
            for name in jcache[r]:
                _close(tcache[name][:, r:r + 1], jcache[r][name], **MODEL_TOL)
            jtok[r] = int(jnp.argmax(want[0]))
        ttok = got.argmax(-1).tolist()
        assert ttok == jtok
        cur = cur + 1


@pytest.mark.parametrize("arch", MOE)
def test_prefill_with_drops(models, arch):
    """capacity_factor 0.5 drops assignments in the prefill's MoE layers:
    the port drops the same ones (logits and cache as the reference's)."""
    _, _, params, tm, flat = models[arch]
    cfg, tm = _with_cfg(tm, flat, capacity_factor=0.5)
    jm = j_build_model(cfg)
    p = RNG.integers(0, cfg.vocab_size, 29).astype(np.int32)
    dropped = []
    real = tmoe._slots

    def counting(e_flat, n_experts, capacity):
        slot, fits = real(e_flat, n_experts, capacity)
        dropped.append(int((~fits).sum()))
        return slot, fits

    tmoe._slots = counting
    try:
        got, tc = tm.prefill({"tokens": _t(p[None]).long()})
    finally:
        tmoe._slots = real
    assert len(dropped) == 2 and min(dropped) > 0, dropped
    want, c = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(p[None])})
    _close(got, want, **MODEL_TOL)
    for name in c:
        _close(tc[name], c[name], **MODEL_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_matches_forward(models, arch):
    """The reference's ``test_prefill_decode_matches_forward`` on the port
    itself: decode(prefill(x[:-1]), x[-1]) equals forward(x) at the last
    two positions, within its rtol 1e-3 / atol 2e-3."""
    cfg, _, _, tm, _ = models[arch]
    b, s = 2, 32
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (b, s)))
    full, _ = tm({"tokens": toks})
    last_pre, cache = tm.prefill({"tokens": toks[:, :-1]})
    np.testing.assert_allclose(last_pre.numpy(), full[:, -2].numpy(), rtol=1e-3, atol=2e-3)
    padded = tm.init_cache(b, s + 3)
    for name, c in cache.items():
        padded[name][:, :, :s - 1] = c
    logits, _ = tm.decode_step(padded, toks[:, -1:], s - 1)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), rtol=1e-3, atol=2e-3)


def _ref_requests(reqs):
    return [jrt.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        eos_id=r.eos_id) for r in reqs]


@pytest.mark.parametrize("arch", MOE)
def test_generate_token_identical_to_the_reference_plan(models, arch):
    """Five requests through two slots with prompt buckets, at the
    configured capacity factor and at 0.5 (bucketed prefills then drop):
    the port's slot-batched ``DecodePlan`` gives the reference's
    ``DecodePlan``'s completions token for token."""
    _, _, params, tm, flat = models[arch]
    lengths = (19, 5, 11, 8, 14)
    for cf in (tm.cfg.capacity_factor, 0.5):
        cfg, model = _with_cfg(tm, flat, capacity_factor=cf)
        reqs = [Request(rid=i, prompt=RNG.integers(0, cfg.vocab_size, n).astype(np.int32),
                        max_new_tokens=6) for i, n in enumerate(lengths)]
        kw = dict(max_batch=2, max_seq=48, buckets=(8, 16, 24))
        ref = jrt.serve_model(j_build_model(cfg), params, jrt.ServiceConfig(**kw)).generate(
            _ref_requests(reqs))
        out = serve_model(model, ServiceConfig(**kw)).generate(reqs)
        ref, out = {c.rid: c for c in ref}, {c.rid: c for c in out}
        assert ref.keys() == out.keys() == set(range(len(lengths)))
        for rid in ref:
            np.testing.assert_array_equal(out[rid].tokens, ref[rid].tokens, err_msg=f"cf {cf}")
            assert out[rid].steps == ref[rid].steps == 6


def test_bucketed_moe_prefill_differs_from_exact_once_tokens_drop(models):
    """A reference fault the port keeps: a bucketed prefill is an
    exact-length one only while nothing drops.  At capacity_factor 8 the
    two agree; at 0.5 the pad tokens raise the capacity (16 slots an
    expert for 72 tokens, 8 for the prompt's 60), fewer real assignments
    drop, and the logits move.  The port moves as the reference does."""
    _, _, params, tm, flat = models["moonshot-v1-16b-a3b"]
    n, m = 60, 72
    assert (jmoe._capacity(n, 2, 8, 0.5), jmoe._capacity(m, 2, 8, 0.5)) == (8, 16)
    p = RNG.integers(0, tm.cfg.vocab_size, n).astype(np.int32)
    padded = np.zeros((1, m), np.int32)
    padded[0, :n] = p
    gaps = {}
    for cf in (8.0, 0.5):
        cfg, model = _with_cfg(tm, flat, capacity_factor=cf)
        jm = j_build_model(cfg)
        exact, _ = model.prefill({"tokens": _t(p[None]).long()})
        bucketed, _ = model.prefill({"tokens": _t(padded).long(), "last_pos": n - 1})
        j_exact, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(p[None])})
        j_bucketed, _ = jax.jit(jm.prefill)(
            params, {"tokens": jnp.asarray(padded), "last_pos": jnp.asarray(n - 1, jnp.int32)})
        _close(exact, j_exact, **MODEL_TOL)
        _close(bucketed, j_bucketed, **MODEL_TOL)
        gaps[cf] = float((bucketed - exact).abs().max())
        assert gaps[cf] == pytest.approx(float(jnp.abs(j_bucketed - j_exact).max()), abs=1e-5)
    print(f"largest logit difference, bucketed against exact: {gaps}")
    assert gaps[8.0] < 1e-5 and gaps[0.5] > 1e-2, gaps


@pytest.mark.parametrize("arch", MOE)
def test_weights_round_trip_bit_identical(models, arch):
    cfg, _, _, tm, flat = models[arch]
    got = flat_from_lm(tm)
    want = {k: v.numpy() for k, v in flat.items()}
    assert got.keys() == want.keys()
    assert any(k.startswith("dense_layers/") for k in got)
    assert any(k.startswith("layers/moe/shared/") for k in got)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    again = lm_params_from_flat(cfg, got, device="cpu")
    for (name, a), (_, b) in zip(tm.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), name
