"""MLA (DeepSeek-V2's multi-head latent attention) on the port against the
JAX package, on the CPU: the latent cache (``mla_latent``), the expanded
prefill/forward path (``mla_attention``), the absorbed decode step
(``mla_decode``, one position a row against the reference called once a
row), each with a low-rank q branch (``q_lora_rank`` > 0) and without
(= 0); then MLA on a dense config, built and served as a whole model.

Weights are the reference's ``mla_init`` (or the model's ``init``,
carried through its checkpoint); inputs are numpy arrays from one seed;
f32 within rtol 1e-5 / atol 1e-5.
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
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.sharding.rules import ShardCtx
from repro_torch.checkpoint import lm_params_from_flat, flat_from_lm, load_flat
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as t_build_model
from repro_torch.runtime import Request, ServiceConfig, serve_model

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(13)
Q_LORA = [32, 0]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(q_lora):
    return dataclasses.replace(jcfg.get_smoke_config("deepseek-v2-236b"), q_lora_rank=q_lora,
                               q_chunk=8, kv_chunk=8)


def _pair(cfg, seed=0):
    """(the reference's ``mla_init`` pytree, a port ``MLA`` holding it)."""
    params = jattn.mla_init(jax.random.PRNGKey(seed), cfg)
    m = tattn.MLA(cfg)
    with torch.no_grad():
        for name, p in m.named_parameters():
            node = params
            for part in name.split("."):
                node = node[part]
            p.copy_(_t(node))
    return params, m


@pytest.mark.parametrize("q_lora", Q_LORA)
def test_mla_params_and_init(q_lora):
    cfg = _cfg(q_lora)
    params, m = _pair(cfg)
    names = {n for n, _ in m.named_parameters()}
    branch = {"q_down", "q_norm.scale", "q_up"} if q_lora else {"wq"}
    assert names == {"kv_down", "kv_norm.scale", "k_up", "v_up", "wo"} | branch
    own = tattn.MLA(cfg)
    with torch.no_grad():
        own.init(torch.Generator().manual_seed(0))
    for name, p in own.named_parameters():
        want = dict(m.named_parameters())[name]
        assert p.shape == want.shape, name
        if name.endswith("scale"):
            assert torch.equal(p, torch.ones_like(p))


@pytest.mark.parametrize("q_lora", Q_LORA)
def test_mla_latent(q_lora):
    cfg = _cfg(q_lora)
    params, m = _pair(cfg)
    x = RNG.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(9)
    wc, wr = jattn.mla_latent(params, jnp.asarray(x), jnp.asarray(pos), cfg)
    gc, gr = tattn.mla_latent(m, _t(x), _t(pos), cfg)
    assert gc.shape == (2, 9, cfg.kv_lora_rank) and gr.shape == (2, 9, cfg.qk_rope_dim)
    _close(gc, wc)
    _close(gr, wr)


@pytest.mark.parametrize("q_lora", Q_LORA)
@pytest.mark.parametrize("s", [21, 8], ids=["chunked_ragged", "one_chunk"])
def test_mla_attention(q_lora, s):
    cfg = _cfg(q_lora)
    params, m = _pair(cfg)
    x = RNG.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s)
    want = jattn.mla_attention(params, jnp.asarray(x), jnp.asarray(pos), cfg, ShardCtx())
    got = tattn.mla_attention(m, _t(x), _t(pos), cfg)
    _close(got, want)
    # the latent made once and passed in gives the same output
    lat = tattn.mla_latent(m, _t(x), _t(pos), cfg)
    torch.testing.assert_close(tattn.mla_attention(m, _t(x), _t(pos), cfg, latent=lat), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("q_lora", Q_LORA)
def test_mla_decode_per_row_lengths(q_lora):
    """Rows at their own lengths in one call equal the reference's
    scalar-position step called row by row (its vmap), and a scalar length
    serves every row."""
    cfg = _cfg(q_lora)
    params, m = _pair(cfg)
    b, smax = 3, 20
    x = RNG.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ckv = RNG.standard_normal((b, smax, cfg.kv_lora_rank)).astype(np.float32)
    krope = RNG.standard_normal((b, smax, cfg.qk_rope_dim)).astype(np.float32)
    lens = np.array([1, 9, 20])
    got = tattn.mla_decode(m, _t(x), _t(ckv), _t(krope), _t(lens), cfg)
    assert got.shape == (b, 1, cfg.d_model)
    for r in range(b):
        want = jattn.mla_decode(params, jnp.asarray(x[r:r + 1]), jnp.asarray(ckv[r:r + 1]),
                                jnp.asarray(krope[r:r + 1]), jnp.asarray(lens[r]), cfg)
        _close(got[r:r + 1], want)
    _close(tattn.mla_decode(m, _t(x), _t(ckv), _t(krope), 9, cfg),
           jattn.mla_decode(params, *map(jnp.asarray, (x, ckv, krope)), jnp.asarray(9), cfg))


@pytest.mark.parametrize("q_lora", Q_LORA)
def test_absorbed_decode_equals_the_expanded_attention(q_lora):
    """The port against itself: the absorbed step over the latent cache of
    a sequence equals the expanded attention's last position."""
    cfg = _cfg(q_lora)
    _, m = _pair(cfg)
    s = 13
    x = torch.from_numpy(RNG.standard_normal((2, s, cfg.d_model)).astype(np.float32))
    pos = torch.arange(s)
    full = tattn.mla_attention(m, x, pos, cfg)
    ckv, krope = tattn.mla_latent(m, x, pos, cfg)
    got = tattn.mla_decode(m, x[:, -1:], ckv, krope, s, cfg)
    torch.testing.assert_close(got, full[:, -1:], **TOL)


# ------------------------------------------------ MLA on the dense family
def _dense_mla(q_lora):
    return dataclasses.replace(jcfg.get_smoke_config("yi-9b"), attn_kind="mla",
                               q_lora_rank=q_lora, kv_lora_rank=24, qk_nope_dim=16,
                               qk_rope_dim=8, v_head_dim=12)


@pytest.fixture(scope="module")
def dense_mla(tmp_path_factory):
    out = {}
    for q_lora in (16, 0):
        cfg = _dense_mla(q_lora)
        jm = j_build_model(cfg)
        params = jm.init(jax.random.PRNGKey(1))
        flat = load_flat(save_checkpoint(str(tmp_path_factory.mktemp(f"mla{q_lora}")), 0, params))
        out[q_lora] = (cfg, jm, params, lm_params_from_flat(cfg, flat, device="cpu"), flat)
    return out


@pytest.mark.parametrize("q_lora", [16, 0])
def test_dense_mla_builds_and_matches_the_reference(dense_mla, q_lora):
    """A dense config with ``attn_kind="mla"`` builds (the reference's
    branches read only ``attn_kind``): forward logits, the latent cache's
    shapes, prefill and three decode steps against the reference's, and
    its flat arrays round-trip bit for bit."""
    cfg, jm, params, tm, flat = dense_mla[q_lora]
    assert cfg.family == "dense" and not hasattr(tm, "dense_layers")
    assert all(isinstance(b.attn, tattn.MLA) for b in tm.blocks)
    assert tm.cache_shapes(2, 30) == {"ckv": (cfg.n_layers, 2, 30, 24),
                                      "krope": (cfg.n_layers, 2, 30, 8)}
    toks = RNG.integers(0, cfg.vocab_size, (2, 23)).astype(np.int32)
    want, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, aux = tm({"tokens": _t(toks).long()})
    assert float(aux) == 0.0
    _close(got, want)
    p = toks[0, :17]
    want, c = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(p[None])})
    got, tc = tm.prefill({"tokens": _t(p[None]).long()})
    _close(got, want)
    smax = 24
    c = jax.tree_util.tree_map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, smax - 17), (0, 0)]), c)
    cache = tm.init_cache(1, smax)
    for name in cache:
        cache[name][:, :, :17] = tc[name]
    tok = int(got.argmax())
    for i in range(3):
        want, c = jax.jit(jm.decode_step)(params, c, jnp.asarray([[tok]], jnp.int32),
                                          jnp.asarray(17 + i, jnp.int32))
        got, cache = tm.decode_step(cache, torch.tensor([[tok]]), 17 + i)
        _close(got, want)
        tok = int(got.argmax())
    back = flat_from_lm(tm)
    assert back.keys() == flat.keys()
    assert all(np.array_equal(back[k], flat[k].numpy()) for k in back)


def test_dense_mla_generate_token_identical(dense_mla):
    cfg, jm, params, tm, _ = dense_mla[16]
    reqs = [Request(rid=i, prompt=RNG.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=5) for i, n in enumerate((12, 4, 9))]
    kw = dict(max_batch=2, max_seq=32, buckets=(8, 16))
    ref = jrt.serve_model(jm, params, jrt.ServiceConfig(**kw)).generate(
        [jrt.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=5) for r in reqs])
    out = serve_model(tm, ServiceConfig(**kw)).generate(reqs)
    ref, out = {c.rid: c.tokens for c in ref}, {c.rid: c.tokens for c in out}
    assert ref.keys() == out.keys()
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid])


def test_build_model_serves_the_moe_family_and_mla():
    """Both MoE archs and MLA on a dense config build; the families of
    later slices still raise, naming theirs."""
    from repro_torch import configs as tcfg

    for arch in ("deepseek-v2-236b", "moonshot-v1-16b-a3b"):
        m = t_build_model(tcfg.get_smoke_config(arch), device="cpu")
        assert m.cfg.family == "moe" and len(m.blocks) == m.cfg.n_layers
    assert t_build_model(_dense_mla(0), device="cpu").cfg.attn_kind == "mla"
