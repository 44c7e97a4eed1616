"""The deprecated per-slot ``ServeSession``: it warns, and its tokens equal
the reference's ``ServeSession`` (smoke configs, f32, the reference's
weights carried across) and the port's fused ``DecodePlan``."""
import warnings

import jax
import numpy as np
import pytest

from repro import runtime as jrt
from repro.checkpoint.store import save_checkpoint
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build_model
from repro_torch.checkpoint import lm_params_from_flat, load_flat
from repro_torch.runtime import Request, ServeSession, ServiceConfig, serve_model

ARCHS = ("yi-9b", "gemma3-1b", "mamba2-1.3b")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request, tmp_path_factory):
    arch = request.param
    cfg = j_smoke(arch)
    jm = j_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    path = save_checkpoint(str(tmp_path_factory.mktemp(arch)), 0, params)
    return cfg, jm, params, lm_params_from_flat(cfg, load_flat(path), device="cpu")


def _reqs(cfg, lengths, max_new=6, eos_id=None):
    rng = np.random.default_rng(11)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=max_new, eos_id=eos_id) for i, n in enumerate(lengths)]


def _by_rid(done):
    return {c.rid: c for c in done}


def _session(model, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return ServeSession(model, **kw)


def test_serve_session_warns(pair):
    with pytest.warns(DeprecationWarning, match="ServeSession is deprecated"):
        ServeSession(pair[3], max_batch=1, max_seq=32)


def test_tokens_equal_the_reference_serve_session(pair):
    cfg, jm, params, tm = pair
    reqs = _reqs(cfg, (5, 12, 3, 9, 7))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = _by_rid(jrt.ServeSession(jm, params, max_batch=2, max_seq=40).generate(
            [jrt.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
             for r in reqs]))
    out = _by_rid(_session(tm, max_batch=2, max_seq=40).generate(reqs))
    assert ref.keys() == out.keys()
    for rid in ref:
        np.testing.assert_array_equal(out[rid].tokens, ref[rid].tokens, err_msg=f"rid={rid}")
        assert out[rid].prefill_len == ref[rid].prefill_len
        assert out[rid].steps == ref[rid].steps


def test_tokens_equal_the_fused_decode_plan(pair):
    cfg, _, _, tm = pair
    reqs = _reqs(cfg, (4, 10, 6, 13), eos_id=None)
    plan = _by_rid(serve_model(tm, ServiceConfig(max_batch=2, max_seq=40)).generate(reqs))
    out = _by_rid(_session(tm, max_batch=2, max_seq=40).generate(reqs))
    assert plan.keys() == out.keys()
    for rid in plan:
        np.testing.assert_array_equal(out[rid].tokens, plan[rid].tokens, err_msg=f"rid={rid}")


def test_eos_and_max_seq_end_a_request(pair):
    cfg, _, _, tm = pair
    first = _session(tm, max_batch=1, max_seq=40).generate(_reqs(cfg, (6,), max_new=8))[0]
    eos = int(first.tokens[2])
    stop = _session(tm, max_batch=1, max_seq=40).generate(_reqs(cfg, (6,), max_new=8,
                                                                eos_id=eos))[0]
    assert list(stop.tokens) == list(first.tokens[:list(first.tokens).index(eos) + 1])
    short = _session(tm, max_batch=1, max_seq=9).generate(_reqs(cfg, (6,), max_new=8))[0]
    assert len(short.tokens) == 3  # positions 6, 7, 8: the cache ends at max_seq
