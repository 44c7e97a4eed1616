"""The enc-dec family (seamless-m4t) on the port against the JAX package,
on the CPU: cross attention, the encoder, the decoder's forward, prefill
and decode steps, and the weights carried across both ways under the
reference's flat keys.

Both sides start from the JAX package's initial weights (``EncDecLM.init``
written with its ``save_checkpoint``, read with ``load_flat`` and
``lm_params_from_flat``); inputs are numpy arrays from one seed.  The
smoke config in f32 within rtol 1e-5 / atol 1e-5.  The source is 40
frames, ragged against the smoke config's 32-position chunks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint.store import save_checkpoint
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.sharding.rules import ShardCtx
from repro_torch.checkpoint import flat_from_lm, lm_params_from_flat, load_flat
from repro_torch.models import EncDecLM, build_model
from repro_torch.models import attention as tattn
from repro_torch.runtime import DecodePlan, ServiceConfig

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(31)
B, SRC, DEC = 2, 40, 10


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(cfg, reference model, its params, port model, flat arrays)."""
    cfg = jcfg.get_smoke_config(ARCH)
    jm = j_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    flat = load_flat(save_checkpoint(str(tmp_path_factory.mktemp("encdec")), 0, params))
    return cfg, jm, params, lm_params_from_flat(cfg, flat, device="cpu"), flat


def _inputs(cfg, b=B, src=SRC, dec=DEC):
    enc = RNG.standard_normal((b, src, cfg.d_model)).astype(np.float32)
    toks = RNG.integers(0, cfg.vocab_size, (b, dec)).astype(np.int32)
    return enc, toks


def _batches(enc, toks):
    return ({"enc_embeds": jnp.asarray(enc), "tokens": jnp.asarray(toks)},
            {"enc_embeds": _t(enc), "tokens": _t(toks).long()})


def test_build_model_gives_encdec_and_the_decode_plan_refuses_it(model):
    cfg, _, _, tm, _ = model
    assert isinstance(build_model(cfg, device="cpu"), EncDecLM) and isinstance(tm, EncDecLM)
    with pytest.raises(ValueError, match="decoder-only"):
        DecodePlan(tm, ServiceConfig())


def test_cross_attention(model):
    cfg, _, params, tm, _ = model
    x = RNG.standard_normal((B, DEC, cfg.d_model)).astype(np.float32)
    enc = RNG.standard_normal((B, SRC, cfg.d_model)).astype(np.float32)
    for layer in range(cfg.n_dec_layers):
        p_l = jax.tree_util.tree_map(lambda a, i=layer: a[i], params["dec_layers"]["xattn"])
        want = jattn.cross_attention(p_l, jnp.asarray(x), jnp.asarray(enc), cfg, ShardCtx())
        got = tattn.cross_attention(tm.dec_layers[layer].xattn, _t(x), _t(enc), cfg)
        _close(got, want)


def test_encode(model):
    cfg, jm, params, tm, _ = model
    enc, _ = _inputs(cfg)
    _close(tm.encode(_t(enc)), jax.jit(jm.encode)(params, jnp.asarray(enc)))


def test_forward(model):
    cfg, jm, params, tm, _ = model
    jb, tb = _batches(*_inputs(cfg))
    want, _ = jax.jit(jm.forward)(params, jb)
    got, aux = tm(tb)
    assert got.shape == want.shape == (B, DEC, cfg.vocab_size) and float(aux) == 0.0
    _close(got, want)


def test_prefill_logits_and_cache(model):
    cfg, jm, params, tm, _ = model
    jb, tb = _batches(*_inputs(cfg))
    want, wc = jax.jit(jm.prefill)(params, jb)
    got, gc = tm.prefill(tb)
    _close(got, want)
    assert gc.keys() == wc.keys() == tm.cache_shapes(B, DEC, SRC).keys()
    for name in wc:
        assert gc[name].shape == tm.cache_shapes(B, DEC, SRC)[name]
        assert gc[name].dtype == tm.cache_dtypes()[name]
        _close(gc[name], wc[name])


def test_prefill_then_decode_steps(model):
    """Two rows prefilled at their own lengths, then five greedy steps of
    both rows in one call (a position a row): every step's logits and
    cache against the reference's scalar-position step row by row."""
    cfg, jm, params, tm, _ = model
    lens, smax = (7, 3), 16
    enc, _ = _inputs(cfg)
    tcache = tm.init_cache(len(lens), smax, SRC)
    jprefill, jstep = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jcache, jtok, ttok = [], [], []
    for r, n in enumerate(lens):
        toks = RNG.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
        jb, tb = _batches(enc[r:r + 1], toks)
        want, c = jprefill(params, jb)
        got, tc = tm.prefill(tb)
        _close(got, want)
        for name, t in tc.items():
            tcache[name][:, r, :t.shape[2]] = t[:, 0]
        pad = [(0, 0), (0, 0), (0, smax - n), (0, 0), (0, 0)]
        jcache.append({k: (jnp.pad(v, pad) if k in ("k", "v") else v) for k, v in c.items()})
        jtok.append(int(jnp.argmax(want[0])))
        ttok.append(int(got[0].argmax()))
    assert jtok == ttok
    cur = np.array(lens)
    for _ in range(5):
        got, tcache = tm.decode_step(tcache, torch.tensor(ttok)[:, None], _t(cur))
        for r in range(len(lens)):
            want, jcache[r] = jstep(params, jcache[r], jnp.asarray([[jtok[r]]], jnp.int32),
                                    jnp.asarray(cur[r], jnp.int32))
            _close(got[r:r + 1], want)
            for name, c in jcache[r].items():
                _close(tcache[name][:, r:r + 1], c)
            jtok[r] = int(jnp.argmax(want[0]))
        ttok = [int(t) for t in got.argmax(-1)]
        assert ttok == jtok
        cur = cur + 1


def test_encdec_decode_matches_forward(model):
    """The reference's ``test_encdec_decode_matches_forward`` on the port:
    the cross k/v of the encoder's states, an empty self-attention cache,
    every token decoded one at a time; the last step's logits equal
    ``forward``'s last position."""
    cfg, _, _, tm, _ = model
    b, s = 2, 32
    sd = s // cfg.dec_ratio
    enc = _t(RNG.standard_normal((b, s, cfg.d_model)).astype(np.float32))
    toks = _t(RNG.integers(0, cfg.vocab_size, (b, sd))).long()
    full, _ = tm({"enc_embeds": enc, "tokens": toks})
    encoded = tm.encode(enc)
    cache = tm.init_cache(b, sd + 2, s)
    for li, block in enumerate(tm.dec_layers):
        cache["xk"][li], cache["xv"][li] = tattn.cross_kv(block.xattn, encoded)
    logits = None
    for t in range(sd):
        logits, cache = tm.decode_step(cache, toks[:, t:t + 1], t)
    _close(logits, full[:, -1, :], rtol=1e-3, atol=2e-3)


def test_flat_keys_round_trip(model):
    """``flat_from_lm`` gives the reference checkpoint's arrays bit for
    bit, under its keys (each stack's layers on the leading axis), and
    they load back into an equal model; ``params()`` is the same tree."""
    cfg, _, params, tm, flat = model
    got = flat_from_lm(tm)
    assert got.keys() == flat.keys()
    assert {"dec_layers/xattn/wq", "dec_layers/ln_x/scale", "enc_norm/bias",
            "enc_layers/mlp/up", "unembed"} <= got.keys()
    assert got["dec_layers/xattn/wk"].shape == (cfg.n_dec_layers, cfg.d_model, cfg.n_kv_heads,
                                                cfg.d_head)
    for k in got:
        assert got[k].dtype == flat[k].numpy().dtype and np.array_equal(got[k], flat[k].numpy()), k
    back = lm_params_from_flat(cfg, got, device="cpu")
    for (n1, p1), (n2, p2) in zip(back.named_parameters(), tm.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2)
    tree = tm.params()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = tree
        for part in path:
            node = node[part.key]
        assert np.array_equal(node.numpy(), np.asarray(leaf))


def test_bf16_serving_weights_and_caches():
    """The published config's compute dtype: bf16 matrices and caches, f32
    norms; prefill + one decode step finite."""
    cfg = dataclasses.replace(jcfg.get_smoke_config(ARCH), dtype="bfloat16")
    tm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert tm.dec_layers[0].xattn.wq.dtype == torch.bfloat16
    assert tm.enc_norm.scale.dtype == torch.float32
    assert set(tm.cache_dtypes().values()) == {torch.bfloat16}
    enc, toks = _inputs(cfg, b=1, src=8, dec=4)
    logits, cache = tm.prefill({"enc_embeds": _t(enc), "tokens": _t(toks).long()})
    full = tm.init_cache(1, 6, 8)
    for name, t in cache.items():
        full[name][:, :, :t.shape[2]] = t
    step, _ = tm.decode_step(full, logits.argmax(-1)[:, None], 4)
    assert logits.dtype == step.dtype == torch.float32 and bool(torch.isfinite(step).all())
