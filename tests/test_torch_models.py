"""The LM zoo's dense decoders on the port against the JAX package, on the
CPU: configs, the model primitives, the attention paths, whole-model
forward / prefill / decode, and the weights carried across both ways.

Both sides start from the JAX package's initial weights, written with its
``save_checkpoint`` and read into the port with ``load_flat`` and
``lm_params_from_flat``; inputs are numpy arrays from one seed.
The smoke configs in f32 within rtol 1e-5 / atol 1e-5, and in bf16 (the
published configs' compute dtype) within the tolerances derived at
``BF16_LOGIT_TOL``.
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
from repro.models import common as jcommon
from repro.sharding.rules import ShardCtx
from repro_torch import configs as tcfg
from repro_torch.checkpoint import (
    lm_params_from_flat,
    flat_from_lm,
    load_flat,
)
from repro_torch.models import attention as tattn
from repro_torch.models import CausalLM
from repro_torch.models import build_model as t_build_model
from repro_torch.models import common as tcommon

DENSE = ("gemma3-1b", "yi-9b", "phi3-medium-14b", "starcoder2-3b")
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _carry(cfg, params, tmp_path):
    """The JAX package's params -> a checkpoint -> a port model."""
    path = save_checkpoint(str(tmp_path), 0, params)
    return lm_params_from_flat(cfg, load_flat(path), device="cpu")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """arch -> (cfg, reference model, its params, port model)."""
    out = {}
    for arch in DENSE:
        cfg = jcfg.get_smoke_config(arch)
        jm = j_build_model(cfg)
        params = jm.init(jax.random.PRNGKey(0))
        out[arch] = (cfg, jm, params, _carry(cfg, params, tmp_path_factory.mktemp(arch)))
    return out


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", jcfg.ARCH_NAMES)
def test_configs_load_equal(arch, smoke):
    get_j = jcfg.get_smoke_config if smoke else jcfg.get_config
    get_t = tcfg.get_smoke_config if smoke else tcfg.get_config
    assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))
    assert get_t(arch).param_count() == get_j(arch).param_count()


def test_config_registry_and_shapes():
    assert tcfg.ARCH_NAMES == jcfg.ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    for arch in tcfg.ARCH_NAMES:
        for shape in tcfg.SHAPES:
            assert tcfg.shape_applicable(tcfg.get_config(arch), tcfg.SHAPES[shape]) == \
                jcfg.shape_applicable(jcfg.get_config(arch), jcfg.SHAPES[shape])


# -------------------------------------------------------------- primitives
RNG = np.random.default_rng(5)


def test_apply_rope_and_freqs():
    x = RNG.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9)
    for theta in (1e4, 1e6):
        _close(tcommon.rope_freqs(16, theta), jcommon.rope_freqs(16, theta))
        _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # one position per row, as the batched decode step ropes
    rows = np.array([3, 700, 0])
    x1 = RNG.standard_normal((3, 1, 2, 16)).astype(np.float32)
    got = tcommon.apply_rope(torch.from_numpy(x1), torch.from_numpy(rows)[:, None], 1e4)
    for b in range(3):
        _close(got[b:b + 1], jcommon.apply_rope(jnp.asarray(x1[b:b + 1]),
                                                jnp.asarray(rows[b:b + 1]), 1e4))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_apply(act):
    d, f = 24, 40
    jp = jcommon.mlp_init(jax.random.PRNGKey(1), d, f, act)
    mlp = tcommon.MLP(d, f, act)
    with torch.no_grad():
        for k, v in jp.items():
            getattr(mlp, k).copy_(torch.from_numpy(np.array(v)))
    x = RNG.standard_normal((2, 5, d)).astype(np.float32)
    _close(tcommon.mlp_apply(mlp, torch.from_numpy(x), act),
           jcommon.mlp_apply(jp, jnp.asarray(x), act, ShardCtx()))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    d = 32
    norm = tcommon.Norm(kind, d)
    scale = RNG.standard_normal(d).astype(np.float32)
    bias = RNG.standard_normal(d).astype(np.float32)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        if kind == "layernorm":
            norm.bias.copy_(torch.from_numpy(bias))
    jp = {"scale": jnp.asarray(scale)} | ({"bias": jnp.asarray(bias)} if kind == "layernorm" else {})
    x = (3 * RNG.standard_normal((4, 7, d)) + 1).astype(np.float32)
    _close(tcommon.norm_apply(kind, norm, torch.from_numpy(x)),
           jcommon.norm_apply(kind, jp, jnp.asarray(x)))
    # bf16 in, the norm in f32, bf16 out
    xb = torch.from_numpy(x).bfloat16()
    got = tcommon.norm_apply(kind, norm, xb)
    want = jcommon.norm_apply(kind, jp, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), rtol=2 ** -7, atol=0)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("sq,skv,qc,kc,window,q_offset", [
    (32, 32, 8, 16, None, 0),     # chunks smaller than the sequence
    (21, 21, 8, 8, 5, 0),         # ragged tails on both axes, a window
    (13, 40, 16, 16, 7, 27),      # a prefill continuation: q_offset, padded q
    (9, 9, 32, 32, None, 0),      # one chunk larger than the sequence
], ids=["chunked", "ragged_window", "offset", "one_chunk"])
def test_chunked_attention(sq, skv, qc, kc, window, q_offset):
    b, kh, g, d = 2, 2, 3, 8
    q = RNG.standard_normal((b, sq, kh, g, d)).astype(np.float32)
    k = RNG.standard_normal((b, skv, kh, d)).astype(np.float32)
    v = RNG.standard_normal((b, skv, kh, d)).astype(np.float32)
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), q_offset=q_offset,
                                  window=window, q_chunk=qc, kv_chunk=kc)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), q_offset=q_offset,
                                   window=window, q_chunk=qc, kv_chunk=kc)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 4, 1 << 30], ids=["full", "window", "big_window"])
def test_decode_attention_per_row_lengths(window):
    """Rows at their own lengths in one call equal the reference's scalar
    call row by row (its vmap)."""
    b, smax, kh, g, d = 3, 20, 2, 2, 8
    q = RNG.standard_normal((b, 1, kh, g, d)).astype(np.float32)
    kc = RNG.standard_normal((b, smax, kh, d)).astype(np.float32)
    vc = RNG.standard_normal((b, smax, kh, d)).astype(np.float32)
    lens = np.array([1, 9, 20])
    got = tattn.decode_attention(*map(torch.from_numpy, (q, kc, vc)), torch.from_numpy(lens),
                                 window=window)
    for r in range(b):
        want = jattn.decode_attention(jnp.asarray(q[r:r + 1]), jnp.asarray(kc[r:r + 1]),
                                      jnp.asarray(vc[r:r + 1]), jnp.asarray(lens[r]),
                                      window=window)
        _close(got[r:r + 1], want)
    # a scalar length serves every row, as in the reference
    _close(tattn.decode_attention(*map(torch.from_numpy, (q, kc, vc)), 9, window=window),
           jattn.decode_attention(*map(jnp.asarray, (q, kc, vc)), jnp.asarray(9), window=window))


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits(models, arch):
    cfg, jm, params, tm = models[arch]
    toks = RNG.integers(0, cfg.vocab_size, (2, 23)).astype(np.int32)  # > the smoke window 16
    want, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, aux = tm({"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_steps(models, arch):
    """prefill (logits and the k/v cache), then 6 decode steps with each
    row at its own length: every step's logits and cache against the
    reference's scalar-position step row by row."""
    cfg, jm, params, tm = models[arch]
    lens = (19, 7)  # mixed, and one longer than the smoke window 16
    smax = 32
    prompts = [RNG.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    jcache, tcache = [], tm.init_cache(len(lens), smax)
    jprefill = jax.jit(jm.prefill)
    for r, p in enumerate(prompts):
        want, c = jprefill(params, {"tokens": jnp.asarray(p[None])})
        got, tc = tm.prefill({"tokens": torch.from_numpy(p[None]).long()})
        _close(got, want)
        for name in ("k", "v"):
            _close(tc[name], c[name])
            tcache[name][:, r, :len(p)] = tc[name][:, 0]
        jcache.append(jax.tree_util.tree_map(
            lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, smax - a.shape[2]), (0, 0), (0, 0)]), c))
    jstep = jax.jit(jm.decode_step)
    cur = np.array(lens)
    for _ in range(6):
        toks = RNG.integers(0, cfg.vocab_size, (len(lens), 1)).astype(np.int32)
        got, tcache = tm.decode_step(tcache, torch.from_numpy(toks).long(), torch.from_numpy(cur))
        for r in range(len(lens)):
            want, jcache[r] = jstep(params, jcache[r], jnp.asarray(toks[r:r + 1]),
                                    jnp.asarray(cur[r], jnp.int32))
            _close(got[r:r + 1], want)
            for name in ("k", "v"):
                _close(tcache[name][:, r:r + 1], jcache[r][name])
        cur = cur + 1


def test_bucketed_prefill_equals_exact(models):
    """A right-padded prompt with ``last_pos`` gives the exact-length
    prefill's logits and cache prefix (gemma3: windowed attention, a
    prompt longer than the window), and its first greedy token.  Not bit
    for bit: the padded products take other BLAS blockings."""
    cfg, _, _, tm = models["gemma3-1b"]
    p = RNG.integers(0, cfg.vocab_size, 19).astype(np.int32)
    exact, ce = tm.prefill({"tokens": torch.from_numpy(p[None]).long()})
    padded = np.zeros((1, 24), np.int64)
    padded[0, :19] = p
    got, cb = tm.prefill({"tokens": torch.from_numpy(padded), "last_pos": 18})
    torch.testing.assert_close(got, exact, **TOL)
    torch.testing.assert_close(cb["k"][:, :, :19], ce["k"], **TOL)
    assert int(got.argmax()) == int(exact.argmax())


def test_gemma_layer_pattern(models):
    cfg, _, _, tm = models["gemma3-1b"]
    assert tm.window_l == [16, 16, 16, 16, 16, 1 << 30]
    assert tm.theta_l == [1e4] * 5 + [1e6]
    cfg_full = tcfg.get_config("gemma3-1b")
    m = t_build_model(dataclasses.replace(cfg_full, n_layers=12, vocab_size=8, d_model=8,
                                          d_ff=8, d_head=4), device="cpu")
    assert [i for i, w in enumerate(m.window_l) if w != 512] == [5, 11]


def test_padded_heads_against_reference(tmp_path):
    """``pad_heads_to`` pads per kv group; the padded model's forward equals
    the reference's padded model's (and the unpadded math)."""
    cfg = dataclasses.replace(jcfg.get_smoke_config("yi-9b"), pad_heads_to=6)
    jm = j_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(2))
    tm = _carry(cfg, params, tmp_path)
    wq = tm.layers[0].attn.wq.detach().reshape(cfg.d_model, 2, 3, cfg.d_head)
    assert float(wq[:, :, 2:].abs().max()) == 0.0 and float(wq[:, :, :2].abs().min()) >= 0.0
    toks = RNG.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    want, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, _ = tm({"tokens": torch.from_numpy(toks).long()})
    _close(got, want)
    # the port's own init pads the same way
    own = t_build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for layer in own.layers:
        assert float(layer.attn.wq.reshape(cfg.d_model, 2, 3, -1)[:, :, 2:].abs().max()) == 0.0
        assert float(layer.attn.wo.reshape(2, 3, cfg.d_head, -1)[:, 2:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="pad_heads_to=5 must be a multiple of n_kv_heads=2"):
        t_build_model(dataclasses.replace(cfg, pad_heads_to=5), device="cpu")


# ------------------------------------------------------------- bf16 datapath
# The published configs compute in bf16.  The attention products and the
# logits keep the f32 accumulator and p is cast to bf16 before PV, as in the
# reference: those match it to f32 rounding (the bf16 attention output bit
# for bit but for a rare element whose f32 accumulator lands on the other
# side of a bf16 rounding boundary).  The activations do not: torch's
# silu/gelu round once, XLA rounds each of their ops to bf16, so they differ
# by up to one bf16 ulp in about 40% of elements, and those flips accumulate
# over the layers.  The whole models are therefore held within
# BF16_LOGIT_TOL x the logits' std: 8 bf16 ulps (2^-7 each, relative) of
# the logit scale, twice the largest gap measured over the four smoke
# models (3.3-4.1 ulps).  Greedy tokens are compared up to the first step
# whose top-two margin in the reference is under BF16_NEAR_TIE x std, twice
# the logit tolerance, so no token before it can flip.
BF16_LOGIT_TOL = 8 * 2.0 ** -7
BF16_NEAR_TIE = 2 * BF16_LOGIT_TOL


def _bf16(a):
    return torch.from_numpy(a).bfloat16(), jnp.asarray(a).astype(jnp.bfloat16)


def _as_f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _within_one_ulp_mostly_exact(got, want):
    """bf16 outputs of the same math: every element within one bf16 ulp of
    the reference's, and at least 99% of them bit-equal."""
    got, want = _as_f32(got), _as_f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= ulp), float(np.abs(got - want).max())
    assert np.mean(got == want) >= 0.99, float(np.mean(got == want))


def test_attention_bf16():
    """Both attention paths on bf16 operands: f32 scores, p cast to bf16,
    f32 PV, the output cast to bf16, as the reference computes them."""
    b, s, kh, g, d = 2, 21, 2, 2, 32
    q, jq = _bf16(RNG.standard_normal((b, s, kh, g, d)).astype(np.float32))
    k, jk = _bf16(RNG.standard_normal((b, s, kh, d)).astype(np.float32))
    v, jv = _bf16(RNG.standard_normal((b, s, kh, d)).astype(np.float32))
    got = tattn.chunked_attention(q, k, v, window=7, q_chunk=8, kv_chunk=8)
    want = jattn.chunked_attention(jq, jk, jv, window=7, q_chunk=8, kv_chunk=8)
    assert got.dtype == torch.bfloat16
    _within_one_ulp_mostly_exact(got, want)
    lens = np.array([21, 9])
    got = tattn.decode_attention(q[:, :1], k, v, torch.from_numpy(lens), window=7)
    want = jnp.concatenate([jattn.decode_attention(jq[r:r + 1, :1], jk[r:r + 1], jv[r:r + 1],
                                                   jnp.asarray(lens[r]), window=7)
                            for r in range(b)])
    _within_one_ulp_mostly_exact(got, want)


def test_unembed_bf16_keeps_the_f32_accumulator():
    x, jx = _bf16(RNG.standard_normal((2, 5, 64)).astype(np.float32))
    table = RNG.standard_normal((300, 64)).astype(np.float32)
    emb = tcommon.Embedding(300, 64, dtype=torch.bfloat16)
    with torch.no_grad():
        emb.table.copy_(torch.from_numpy(table))
    got = tcommon.unembed(emb, x)
    assert got.dtype == torch.float32
    _close(got, jcommon.unembed({"table": jnp.asarray(table)}, jx))


@pytest.fixture(scope="module")
def models_bf16(models, tmp_path_factory):
    """arch -> (bf16 cfg, reference model, the f32 fixture's params, port
    model holding them in bf16)."""
    out = {}
    for arch, (cfg, _, params, _) in models.items():
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        out[arch] = (cfg, j_build_model(cfg), params,
                     _carry(cfg, params, tmp_path_factory.mktemp(arch + "-bf16")))
    return out


def _close_bf16(got, want):
    want = np.asarray(want)
    tol = BF16_LOGIT_TOL * float(want.std())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_bf16(models_bf16, arch):
    """The bf16 model (weights held in bf16) against the reference's bf16
    model: forward logits, prefill logits and 4 decode steps with rows at
    mixed lengths, one past the smoke window."""
    cfg, jm, params, tm = models_bf16[arch]
    assert tm.layers[0].attn.wq.dtype == torch.bfloat16
    toks = RNG.integers(0, cfg.vocab_size, (2, 23)).astype(np.int32)
    want, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, _ = tm({"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.float32
    _close_bf16(got, want)
    lens, smax = (19, 7), 32
    jcache, tcache = [], tm.init_cache(len(lens), smax)
    for r, n in enumerate(lens):
        p = RNG.integers(0, cfg.vocab_size, n).astype(np.int32)
        want, c = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(p[None])})
        got, tc = tm.prefill({"tokens": torch.from_numpy(p[None]).long()})
        _close_bf16(got, want)
        for name in ("k", "v"):
            tcache[name][:, r, :n] = tc[name][:, 0]
        jcache.append(jax.tree_util.tree_map(
            lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, smax - a.shape[2]), (0, 0), (0, 0)]), c))
    jstep = jax.jit(jm.decode_step)
    cur = np.array(lens)
    for _ in range(4):
        toks = RNG.integers(0, cfg.vocab_size, (len(lens), 1)).astype(np.int32)
        got, tcache = tm.decode_step(tcache, torch.from_numpy(toks).long(), torch.from_numpy(cur))
        for r in range(len(lens)):
            want, jcache[r] = jstep(params, jcache[r], jnp.asarray(toks[r:r + 1]),
                                    jnp.asarray(cur[r], jnp.int32))
            _close_bf16(got[r:r + 1], want)
        cur = cur + 1


@pytest.mark.parametrize("arch", DENSE)
def test_generate_bf16_tokens_before_near_ties(models_bf16, arch):
    """The port's slot-batched ``DecodePlan.generate`` in bf16 gives the
    reference's greedy tokens up to each request's first near-tie (five
    requests of mixed lengths through two slots, so slots refill)."""
    from repro_torch.runtime import Request, ServiceConfig, serve_model

    cfg, jm, params, tm = models_bf16[arch]
    new = 6
    prompts = [RNG.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (19, 5, 11, 8, 14)]
    out = serve_model(tm, ServiceConfig(max_batch=2, max_seq=32)).generate(
        [Request(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)])
    out = {c.rid: c.tokens for c in out}
    jprefill, jstep = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    compared = 0
    for rid, p in enumerate(prompts):
        logits, c = jprefill(params, {"tokens": jnp.asarray(p[None])})
        c = jax.tree_util.tree_map(
            lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 32 - a.shape[2]), (0, 0), (0, 0)]), c)
        for step in range(new):
            lg = np.asarray(logits[0])
            top2 = np.sort(lg)[-2:]
            if top2[1] - top2[0] < BF16_NEAR_TIE * lg.std():
                break
            tok = int(lg.argmax())
            assert int(out[rid][step]) == tok, (rid, step)
            compared += 1
            logits, c = jstep(params, c, jnp.asarray([[tok]], jnp.int32),
                              jnp.asarray(len(p) + step, jnp.int32))
    assert compared >= 1


# --------------------------------------------------------------- checkpoint
@pytest.mark.parametrize("arch", DENSE)
def test_weights_round_trip_bit_identical(models, tmp_path, arch):
    cfg, _, params, tm = models[arch]
    flat = flat_from_lm(tm)
    path = save_checkpoint(str(tmp_path), 0, params)
    ref_flat = {k: v.numpy() for k, v in load_flat(path).items()}
    assert flat.keys() == ref_flat.keys()
    for k in flat:
        assert flat[k].dtype == ref_flat[k].dtype and np.array_equal(flat[k], ref_flat[k]), k
    again = lm_params_from_flat(cfg, flat, device="cpu")
    for (name, a), (_, b) in zip(tm.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), name


def _unflatten(flat):
    tree = {}
    for key, a in flat.items():
        node = tree
        *head, leaf = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(a)
    return tree


@pytest.mark.parametrize("arch", ["gemma3-1b", "starcoder2-3b"])
def test_port_initialised_weights_decode_the_same_in_the_reference(arch):
    """The port's own init, carried to the JAX package, greedy-decodes the
    same tokens there (prefill, then 5 decode steps)."""
    cfg = tcfg.get_smoke_config(arch)
    tm = t_build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    params = _unflatten(flat_from_lm(tm))
    jm = j_build_model(jcfg.get_smoke_config(arch))
    prompt = RNG.integers(0, cfg.vocab_size, 18).astype(np.int32)
    want_logits, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(prompt[None])})
    got_logits, tc = tm.prefill({"tokens": torch.from_numpy(prompt[None]).long()})
    _close(got_logits, want_logits)
    jc = jax.tree_util.tree_map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 8), (0, 0), (0, 0)]), jc)
    tcache = tm.init_cache(1, 26)
    for name in ("k", "v"):
        tcache[name][:, :, :18] = tc[name]
    jt, tt = int(jnp.argmax(want_logits[0])), int(torch.argmax(got_logits[0]))
    assert jt == tt
    jstep = jax.jit(jm.decode_step)
    for i in range(5):
        wl, jc = jstep(params, jc, jnp.asarray([[jt]], jnp.int32), jnp.asarray(18 + i, jnp.int32))
        gl, tcache = tm.decode_step(tcache, torch.tensor([[tt]]), 18 + i)
        jt, tt = int(jnp.argmax(wl[0])), int(torch.argmax(gl[0]))
        assert jt == tt, f"step {i}"


# ------------------------------------------------------------------ refusals
@pytest.mark.parametrize("arch,slice_", [
    ("mamba2-1.3b", "Slice F3"), ("zamba2-2.7b", "Slice F4"), ("internvl2-1b", "Slice F5"),
    ("seamless-m4t-large-v2", "Slice F6"),
])
def test_build_model_names_the_slice(arch, slice_):
    """Slices F3-F6 are ported: every family builds, the enc-dec family
    (F6) as an ``EncDecLM``, and ``CausalLM`` refuses it by name."""
    cfg = tcfg.get_smoke_config(arch)
    model = t_build_model(cfg, device="cpu")
    assert model.cfg.family == cfg.family
    if slice_ == "Slice F6":
        assert type(model).__name__ == "EncDecLM"
        with pytest.raises(ValueError, match=f"{cfg.family}.*not a decoder-only family"):
            CausalLM(cfg, device="cpu")


def test_default_device_is_the_card():
    """``build_model`` and ``lm_params_from_flat`` put the model on
    the card unless the caller asks for the CPU: with no card they raise,
    as ``ExecutionConfig`` does, and never carry on quietly on the CPU."""
    cfg = tcfg.get_smoke_config("yi-9b")
    if torch.cuda.is_available() and torch.cuda.get_device_capability() >= (9, 0):
        assert t_build_model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        t_build_model(cfg)
    flat = flat_from_lm(t_build_model(cfg, device="cpu").init(torch.Generator()))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        lm_params_from_flat(cfg, flat)
