"""The state-space and front-end families on the port against the JAX
package, on the CPU: the SSD chunked scan, the Mamba-2 mixer and its
decode recurrence, and the smoke configs of mamba2-1.3b (ssm),
zamba2-2.7b (hybrid: Mamba-2 groups around one shared attention block)
and internvl2-1b (vlm: patch embeddings in front of the tokens) as whole
models and through ``DecodePlan``.

Both sides start from the JAX package's initial weights (``mamba2_init``,
or the model's ``init`` carried through its checkpoint); inputs are numpy
arrays from one seed.  f32 throughout: modules within rtol 1e-5 / atol
1e-6, whole models within rtol 1e-5 / atol 1e-5 (the dense family's
bar), tokens equal.

The reference keeps a prompt's decode conv history as its last K - 1
raw conv inputs; a prompt shorter than K - 1 (= 3) gives fewer rows, and
its serving plan pads them with zeros after the real inputs, where the
causal conv needs them before.  The port left-pads the history, so it is
held to the reference's ``forward`` there and to the reference's prefill
+ decode everywhere else; ``test_short_prompt_decodes_as_forward`` keeps
the reference's fault documented.
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
from repro.models import ssm as jssm
from repro.sharding.rules import ShardCtx
from repro_torch.checkpoint import lm_params_from_flat, flat_from_lm, load_flat
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm
from repro_torch.runtime import DecodePlan, Request, ServiceConfig, serve_model

ARCHS = ("mamba2-1.3b", "zamba2-2.7b", "internvl2-1b")
STATEFUL = ("mamba2-1.3b", "zamba2-2.7b")
TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(23)


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _module(cfg, tree):
    """A port ``Mamba2`` holding the reference's ``mamba2_init`` pytree."""
    m = tssm.Mamba2(cfg)
    with torch.no_grad():
        for name, p in m.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[part]
            p.copy_(_t(node))
    return m


def _ssd_inputs(b, s, h, p, g, n, a_std=0.3):
    x = (RNG.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    a = -np.abs(RNG.standard_normal((b, s, h)) * a_std).astype(np.float32)
    bm = (RNG.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cm = (RNG.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, a, bm, cm


def _flat_cache(c, prefix=""):
    """The reference's cache pytree under the port's flat names
    (``{"ssm": {"h"}}`` -> ``"ssm.h"``)."""
    out = {}
    for k, v in c.items():
        if isinstance(v, dict):
            out.update(_flat_cache(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


# -------------------------------------------------------------------- SSD
@pytest.mark.parametrize("s,chunk", [(16, 4), (32, 8), (24, 8), (13, 4)])
def test_ssd_chunked(s, chunk):
    """``tests/test_models.py::test_chunked_matches_naive``'s shapes (two
    groups over four heads, ragged tails included): y and the final state
    against the reference's chunked scan."""
    x, a, bm, cm = _ssd_inputs(2, s, 4, 8, 2, 6)
    wy, wh = jssm.ssd_chunked(*(jnp.asarray(t) for t in (x, a, bm, cm)), chunk)
    gy, gh = tssm.ssd_chunked(*(_t(t) for t in (x, a, bm, cm)), chunk)
    assert gy.dtype == torch.float32 and gh.shape == (2, 4, 8, 6)
    _close(gy, wy)
    _close(gh, wh)


def test_ssd_chunked_continues_from_h0():
    """The reference's ``test_initial_state_continuation``: the second
    half from the first half's state against the reference's, and the
    two halves against one scan of the whole."""
    x, a, bm, cm = _ssd_inputs(1, 32, 2, 4, 1, 4, a_std=0.2)
    halves = [tuple(t[:, sl] for t in (x, a, bm, cm)) for sl in (slice(0, 16), slice(16, 32))]
    jy1, jh1 = jssm.ssd_chunked(*(jnp.asarray(t) for t in halves[0]), 8)
    jy2, jh2 = jssm.ssd_chunked(*(jnp.asarray(t) for t in halves[1]), 8, h0=jh1)
    gy1, gh1 = tssm.ssd_chunked(*(_t(t) for t in halves[0]), 8)
    gy2, gh2 = tssm.ssd_chunked(*(_t(t) for t in halves[1]), 8, h0=gh1)
    _close(gy2, jy2)
    _close(gh2, jh2)
    fy, fh = tssm.ssd_chunked(*(_t(t) for t in (x, a, bm, cm)), 8)
    _close(torch.cat([gy1, gy2], 1), fy.numpy())
    _close(gh2, fh.numpy())


# ---------------------------------------------------------------- mixer
@pytest.fixture(scope="module")
def mixer():
    cfg = jcfg.get_smoke_config("mamba2-1.3b")
    params = jssm.mamba2_init(jax.random.PRNGKey(3), cfg)
    return cfg, params, _module(cfg, params)


@pytest.mark.parametrize("s", [3, 16, 37])
def test_mamba2_forward_with_state(mixer, s):
    """The mixer's output and its decode state (the f32 SSM state and the
    K - 1 raw conv inputs), one chunk, a whole number of chunks and a
    ragged tail."""
    cfg, params, m = mixer
    x = RNG.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    want, wst = jssm.mamba2_forward(params, jnp.asarray(x), cfg, ShardCtx(), return_state=True)
    got, gst = tssm.mamba2_forward(m, _t(x), cfg, return_state=True)
    _close(got, want)
    assert gst["h"].dtype == torch.float32 and tuple(gst["conv"].shape) == wst["conv"].shape
    _close(gst["h"], wst["h"])
    _close(gst["conv"], wst["conv"])


@pytest.mark.parametrize("s", [1, 2])
def test_mamba2_conv_history_left_pads_a_short_prompt(mixer, s):
    """Under K - 1 inputs the port's history is the reference's rows after
    K - 1 - s zero rows; the reference's has only s rows."""
    cfg, params, m = mixer
    x = RNG.standard_normal((1, s, cfg.d_model)).astype(np.float32)
    _, wst = jssm.mamba2_forward(params, jnp.asarray(x), cfg, ShardCtx(), return_state=True)
    _, gst = tssm.mamba2_forward(m, _t(x), cfg, return_state=True)
    k = cfg.ssm_conv
    assert wst["conv"].shape[1] == s and gst["conv"].shape[1] == k - 1
    assert not gst["conv"][:, :k - 1 - s].any()
    _close(gst["conv"][:, k - 1 - s:], wst["conv"])
    _close(gst["h"], wst["h"])


def test_mamba2_decode_steps(mixer):
    """Five decode steps from a prefilled state: each step's output and
    state against the reference's, the state written in place."""
    cfg, params, m = mixer
    x = RNG.standard_normal((3, 9, cfg.d_model)).astype(np.float32)
    _, wst = jssm.mamba2_forward(params, jnp.asarray(x), cfg, ShardCtx(), return_state=True)
    _, gst = tssm.mamba2_forward(m, _t(x), cfg, return_state=True)
    h_buf, conv_buf = gst["h"], gst["conv"]
    for _ in range(5):
        tok = RNG.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        want, wst = jssm.mamba2_decode_step(params, jnp.asarray(tok), wst, cfg)
        got = tssm.mamba2_decode_step(m, _t(tok), gst, cfg)
        assert gst["h"] is h_buf and gst["conv"] is conv_buf
        _close(got, want)
        _close(gst["h"], wst["h"])
        _close(gst["conv"], wst["conv"])


def test_mamba2_decode_continues_forward(mixer):
    """The port alone: forward over s + 1 inputs equals forward over s
    with state, then one decode step, at the last position."""
    cfg, _, m = mixer
    x = _t(RNG.standard_normal((2, 21, cfg.d_model)).astype(np.float32))
    full = tssm.mamba2_forward(m, x, cfg)
    _, st = tssm.mamba2_forward(m, x[:, :-1], cfg, return_state=True)
    step = tssm.mamba2_decode_step(m, x[:, -1:], st, cfg)
    np.testing.assert_allclose(step.numpy(), full[:, -1:].numpy(), rtol=1e-4, atol=1e-5)


def test_mamba2_init_distributions():
    """``mamba2_init``'s shapes and distributions: fan-in matrices, conv
    taps N(0, 0.1^2), A in [1, 16], softplus(dt_bias) in [1e-3, 1e-1]."""
    cfg = dataclasses.replace(jcfg.get_smoke_config("mamba2-1.3b"), d_model=256)
    m = tssm.Mamba2(cfg)
    m.init(torch.Generator().manual_seed(0))
    ref = jssm.mamba2_init(jax.random.PRNGKey(0), cfg)
    got = dict(m.named_parameters())
    for name in ("wz", "wx", "wB", "wC", "wdt", "conv_w", "out"):
        want = np.asarray(ref[name])
        assert tuple(got[name].shape) == want.shape, name
        np.testing.assert_allclose(float(got[name].std()), float(want.std()), rtol=0.1)
    a = torch.exp(got["A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert torch.equal(got["D"], torch.ones(got["D"].shape)) and not got["conv_b"].any()
    assert got["A_log"].dtype == got["dt_bias"].dtype == torch.float32


# ------------------------------------------------------------ whole models
@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """arch -> (cfg, reference model, its params, port model, flat arrays)."""
    out = {}
    for arch in ARCHS:
        cfg = jcfg.get_smoke_config(arch)
        jm = j_build_model(cfg)
        params = jm.init(jax.random.PRNGKey(0))
        flat = load_flat(save_checkpoint(str(tmp_path_factory.mktemp(arch)), 0, params))
        out[arch] = (cfg, jm, params, lm_params_from_flat(cfg, flat, device="cpu"), flat)
    return out


def _batch(cfg, b, s, embeds=False):
    toks = RNG.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    j, t = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks).long()}
    if embeds:
        e = RNG.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
        j["embeds"], t["embeds"] = jnp.asarray(e), _t(e)
    return j, t


def _cases():
    return [(a, False) for a in ARCHS] + [("internvl2-1b", True)]


@pytest.mark.parametrize("arch,embeds", _cases())
def test_forward_logits(models, arch, embeds):
    cfg, jm, params, tm, _ = models[arch]
    jb, tb = _batch(cfg, 2, 23, embeds)
    want, _ = jax.jit(jm.forward)(params, jb)
    got, aux = tm(tb)
    assert got.shape == want.shape == (2, 23 + (cfg.n_patches if embeds else 0), cfg.vocab_size)
    _close(got, want, **MODEL_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch,embeds", _cases())
def test_prefill_logits_and_cache(models, arch, embeds):
    """The last position's logits and every cache entry, under the
    reference's names (the hybrid's ``ssm/h`` as ``ssm.h``), each in its
    dtype: the SSM state f32, the rest the compute dtype."""
    cfg, jm, params, tm, _ = models[arch]
    jb, tb = _batch(cfg, 2, 19, embeds)
    want, wc = jax.jit(jm.prefill)(params, jb)
    got, gc = tm.prefill(tb)
    _close(got, want, **MODEL_TOL)
    wc = _flat_cache(wc)
    assert gc.keys() == wc.keys() == tm.cache_shapes(2, 19).keys()
    for name in wc:
        assert gc[name].dtype == tm.cache_dtypes()[name]
        _close(gc[name], wc[name], **MODEL_TOL)


@pytest.mark.parametrize("arch,embeds", _cases())
def test_prefill_then_decode_steps(models, arch, embeds):
    """Prefill two rows at their own lengths, then five greedy decode
    steps of both rows in one call: every step's logits and cache
    against the reference's scalar-position step row by row, tokens
    equal.  The prompts are at least K - 1 tokens (the reference's conv
    history is short below that)."""
    cfg, jm, params, tm, _ = models[arch]
    lens, smax = (17, 6), 48
    template = jax.eval_shape(lambda: jm.init_cache(1, smax))
    tcache = tm.init_cache(len(lens), smax)
    jcache, jtok, ttok, cur = [], [], [], []
    jprefill = jax.jit(jm.prefill)
    for r, n in enumerate(lens):
        jb, tb = _batch(cfg, 1, n, embeds)
        want, c = jprefill(params, jb)
        got, tc = tm.prefill(tb)
        _close(got, want, **MODEL_TOL)
        for name, t in tc.items():
            if name in ("k", "v"):
                tcache[name][:, r, :t.shape[2]] = t[:, 0]
            else:
                tcache[name][:, r] = t[:, 0]
        jcache.append(jrt.pad_cache_like(c, template))
        jtok.append(int(jnp.argmax(want[0])))
        ttok.append(int(got[0].argmax()))
        cur.append(n + (cfg.n_patches if embeds else 0))
    assert jtok == ttok
    jstep = jax.jit(jm.decode_step)
    cur = np.array(cur)
    for _ in range(5):
        got, tcache = tm.decode_step(tcache, torch.tensor(ttok)[:, None], _t(cur))
        for r in range(len(lens)):
            want, jcache[r] = jstep(params, jcache[r], jnp.asarray([[jtok[r]]], jnp.int32),
                                    jnp.asarray(cur[r], jnp.int32))
            _close(got[r:r + 1], want, **MODEL_TOL)
            for name, c in _flat_cache(jcache[r]).items():
                _close(tcache[name][:, r:r + 1], c, **MODEL_TOL)
            jtok[r] = int(jnp.argmax(want[0]))
        ttok = got.argmax(-1).tolist()
        assert ttok == jtok
        cur = cur + 1


def _ref_requests(reqs):
    return [jrt.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        eos_id=r.eos_id) for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_token_identical_to_the_reference_plan(models, arch):
    """Six requests of mixed lengths through two slots (so slots refill),
    with prompt buckets (the stateful families prefill at exact length
    all the same, as the reference's plan does): the port's ``DecodePlan``
    gives the reference's completions token for token, and prefills the
    same number of cells."""
    cfg, jm, params, tm, _ = models[arch]
    lengths = (19, 5, 11, 3, 14, 8)
    reqs = [Request(rid=i, prompt=RNG.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=6) for i, n in enumerate(lengths)]
    kw = dict(max_batch=2, max_seq=48, buckets=(8, 16, 24))
    jsvc = jrt.serve_model(jm, params, jrt.ServiceConfig(**kw))
    ref = jsvc.generate(_ref_requests(reqs))
    svc = serve_model(tm, ServiceConfig(**kw))
    out = svc.generate(reqs)
    ref, out = {c.rid: c for c in ref}, {c.rid: c for c in out}
    assert ref.keys() == out.keys() == set(range(len(lengths)))
    for rid in ref:
        np.testing.assert_array_equal(out[rid].tokens, ref[rid].tokens, err_msg=f"rid {rid}")
        assert out[rid].steps == ref[rid].steps == 6
    jstats = {k: v for k, v in jsvc.stats.items() if k != "telemetry"}
    tstats = {k: v for k, v in svc.stats.items() if k != "telemetry"}
    assert tstats.keys() == jstats.keys()
    for k in ("requests", "tokens_generated", "fused_steps", "prefill_cells"):
        assert tstats[k] == jstats[k], k
    want_cells = len(set(lengths)) if arch in STATEFUL else 3
    assert tstats["prefill_cells"] == want_cells


@pytest.mark.parametrize("arch", STATEFUL)
@pytest.mark.parametrize("n", [1, 2])
def test_short_prompt_decodes_as_forward(models, arch, n):
    """A 1- or 2-token prompt (under K - 1): the port's prefill + three
    decode steps give the reference's ``forward`` logits at each position,
    token for token.  The reference's own prefill + decode, its short
    history padded by its plan's ``pad_cache_like``, is more than 0.1 off
    at the first decoded position (its fault, not carried over)."""
    cfg, jm, params, tm, _ = models[arch]
    prompt = RNG.integers(0, cfg.vocab_size, n).astype(np.int32)
    smax = 16
    plan = DecodePlan(tm, ServiceConfig(max_batch=1, max_seq=smax))
    done = plan.generate([Request(rid=0, prompt=prompt, max_new_tokens=4)])
    toks = done[0].tokens
    seq = np.concatenate([prompt, toks[:-1]]).astype(np.int32)
    want, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(seq[None])})
    want = np.asarray(want)[0, n - 1:]
    np.testing.assert_array_equal(toks, want.argmax(-1))
    # the port's logits, step by step
    cache = tm.init_cache(1, smax)
    logits, c = tm.prefill({"tokens": _t(prompt[None]).long()})
    for name, t in c.items():
        if name in ("k", "v"):
            cache[name][:, :, :n] = t
        else:
            cache[name].copy_(t)
    got = [logits[0]]
    for i in range(3):
        logits, cache = tm.decode_step(cache, torch.tensor([[int(toks[i])]]), n + i)
        got.append(logits[0])
    _close(torch.stack(got), want, **MODEL_TOL)
    # the reference's prefill + decode, as its plan runs them
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(prompt[None])})
    assert _flat_cache(jc)[("ssm." if arch == "zamba2-2.7b" else "") + "conv"].shape[2] == n
    jc = jrt.pad_cache_like(jc, jax.eval_shape(lambda: jm.init_cache(1, smax)))
    jl, _ = jax.jit(jm.decode_step)(params, jc, jnp.asarray([[int(toks[0])]], jnp.int32),
                                    jnp.asarray(n, jnp.int32))
    off = float(np.abs(np.asarray(jl)[0] - want[1]).max())
    print(f"{arch}, {n}-token prompt: the reference's first decode logits {off} from forward's")
    assert off > 0.1


def test_stateful_state_bytes_do_not_grow_with_the_prompt(models):
    """A slot's ssm state is the same size at any max_seq; the hybrid's
    k/v grow with it, its ssm state does not."""
    _, _, _, tm, _ = models["mamba2-1.3b"]
    assert tm.cache_shapes(1, 16) == tm.cache_shapes(1, 4096)
    _, _, _, hm, _ = models["zamba2-2.7b"]
    a, b = hm.cache_shapes(1, 16), hm.cache_shapes(1, 4096)
    assert a["ssm.h"] == b["ssm.h"] and a["ssm.conv"] == b["ssm.conv"] and a["k"] != b["k"]


@pytest.mark.parametrize("arch", STATEFUL)
def test_bf16_cache_dtypes(arch):
    """In bf16 the SSM state stays f32 (the reference carries it in f32)
    and the conv history and k/v take the compute dtype; A_log and
    dt_bias stay f32 too."""
    cfg = dataclasses.replace(jcfg.get_smoke_config(arch), dtype="bfloat16")
    tm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    cache = tm.init_cache(2, 8)
    pre = "ssm." if cfg.family == "hybrid" else ""
    assert cache[pre + "h"].dtype == torch.float32 and cache[pre + "conv"].dtype == torch.bfloat16
    state = tssm.mamba2_init_state(cfg, 2, torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == {
        k: (tuple(cache[pre + k].shape[1:]), cache[pre + k].dtype) for k in ("h", "conv")}
    assert tm.layers[0].A_log.dtype == tm.layers[0].dt_bias.dtype == torch.float32
    assert tm.layers[0].wz.dtype == torch.bfloat16
    plan = DecodePlan(tm, ServiceConfig(max_batch=2, max_seq=32))
    done = plan.generate([Request(rid=i, prompt=RNG.integers(0, cfg.vocab_size, n)
                                  .astype(np.int32), max_new_tokens=4)
                          for i, n in enumerate((2, 9, 5))])
    assert sorted(c.rid for c in done) == [0, 1, 2] and all(len(c.tokens) == 4 for c in done)


# ------------------------------------------------------------- the plan
def test_prefill_cells_are_lru_bounded(models):
    """``cache_size=2`` with three prompt lengths (exact-length prefill):
    two live cells, one eviction, as the reference's plan counts them;
    its stats keys are the reference's."""
    cfg, jm, params, tm, _ = models["mamba2-1.3b"]
    reqs = [Request(rid=i, prompt=RNG.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=3) for i, n in enumerate((4, 7, 10))]
    kw = dict(max_batch=1, max_seq=32, cache_size=2)
    plan = DecodePlan(tm, ServiceConfig(**kw))
    plan.generate(reqs)
    st = plan.stats
    assert st["prefill_cells"] == 2 and st["prefill_cell_evictions"] == 1
    assert [m for m, _ in plan._prefill_cells.items()] == [7, 10]
    jplan = jrt.DecodePlan(jm, params, jrt.ServiceConfig(**kw))
    jplan.generate(_ref_requests(reqs))
    assert set(st) == set(jplan.stats)
    assert (jplan.stats["prefill_cells"], jplan.stats["prefill_cell_evictions"]) == (2, 1)


def test_strict_registry_lists_the_live_cells(models):
    cfg, _, _, tm, _ = models["mamba2-1.3b"]
    plan = DecodePlan(tm, ServiceConfig(max_batch=1, max_seq=32, cache_size=2, strict=True))
    plan.generate([Request(rid=i, prompt=RNG.integers(0, cfg.vocab_size, n).astype(np.int32),
                           max_new_tokens=2) for i, n in enumerate((4, 7, 10))])
    names = sorted(k for k in plan._strict_registry() if k.startswith("prefill["))
    assert names == ["prefill[10]", "prefill[7]"]


def test_decode_plan_refuses_an_enc_dec_model():
    """The reference's refusal at ``DecodePlan.__init__``: the plan serves
    decoder-only models, an enc-dec model serves through its functions."""
    model = build_model(jcfg.get_smoke_config("seamless-m4t-large-v2"), device="cpu")
    with pytest.raises(ValueError, match="through its own functions"):
        DecodePlan(model, ServiceConfig())


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip_bit_identical(models, arch):
    """The flat keys both ways: the port's ``flat_from_lm`` gives
    the reference checkpoint's arrays bit for bit, and loads back."""
    cfg, _, _, tm, flat = models[arch]
    got = flat_from_lm(tm)
    want = {k: v.numpy() for k, v in flat.items()}
    assert got.keys() == want.keys()
    if arch in STATEFUL:
        assert {"layers/A_log", "layers/norm_in/scale", "layers/conv_w"} <= got.keys()
    if arch == "zamba2-2.7b":
        assert "shared_attn/attn/wq" in got and got["shared_attn/attn/wq"].ndim == 3
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    again = lm_params_from_flat(cfg, got, device="cpu")
    for (name, a), (_, b) in zip(tm.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), name
