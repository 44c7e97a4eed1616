"""The LM zoo's training step on the port against the JAX package, on the
CPU: the loss and its gradients for every family, the train step with
AdamW under ``warmup_cosine``, microbatched accumulation, the f32 masters
under bf16 compute, and ``matmul_f32``'s backward.

Both sides start from the JAX package's initial weights (the port takes
the reference's pytree as it is: nested dicts, each stack's layers on a
leading axis); inputs are numpy arrays from one seed.  f32 smoke configs:
the loss and every gradient within rtol 1e-5 / atol 1e-6, three train
steps' losses and moments there too, and their params too but for at
most STEP_OUTLIERS of each leaf's elements, each of those within 2 x lr a
step: AdamW moves an element by lr x m / (sqrt(v) + eps), so where a
gradient sits within f32 noise of zero the two sides' moves differ by up
to 2 x lr (opposite signs).
bf16 compute (f32 masters): the loss within BF16_LOSS_RTOL, and each
gradient leaf, normwise, no farther from the reference's bf16 gradient,
nor from the reference's f32 gradient, than BF16_DRIFT_FACTOR x the
reference's own bf16 gradient is from its f32 one: the two round the
bf16 intermediates at other places (XLA fuses elementwise chains and
rounds once), so the port is held to the size of the reference's own
rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as j_build_model
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.optim.accumulation import microbatched_value_and_grad as j_microbatched
from repro_torch.models import build_model
from repro_torch.models.common import matmul_f32
from repro_torch.optim import AdamW, AdamWState, microbatched_value_and_grad, warmup_cosine
from repro_torch.optim.accumulation import value_and_grad

TOL = dict(rtol=1e-5, atol=1e-6)
PEAK_LR = 1e-3
STEP_OUTLIERS = 1e-3
BF16_LOSS_RTOL = 2e-3
BF16_DRIFT_FACTOR = 2.0
RNG = np.random.default_rng(41)
# One arch a family: dense with gemma3's window, MLA (with MoE), MoE with
# GQA and its aux loss, ssm, hybrid, vlm with embeds, encdec.
FAMILIES = ("gemma3-1b", "deepseek-v2-236b", "moonshot-v1-16b-a3b", "mamba2-1.3b",
            "zamba2-2.7b", "internvl2-1b", "seamless-m4t-large-v2")


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves(tree):
    """path -> numpy array of every leaf, for a JAX pytree or the port's
    tree (dicts, NamedTuples)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                       for p in path)
        out[key] = leaf.detach().float().numpy() if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf, np.float32)
    return out


def _assert_trees(got, want, **tol):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **(tol or TOL))


def _assert_step_params(got, want, steps):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        diff = np.abs(g[k] - w[k])
        out = diff > TOL["atol"] + TOL["rtol"] * np.abs(w[k])
        assert out.mean() <= STEP_OUTLIERS, (k, int(out.sum()), out.size)
        assert diff.max() <= 2 * PEAK_LR * steps, (k, float(diff.max()))


def _batch(cfg, b=4, s=24):
    """The reference's training batch of ``cfg``'s family (numpy)."""
    if cfg.family == "encdec":
        sd = max(s // cfg.dec_ratio, 4)
        return {"enc_embeds": RNG.standard_normal((b, s, cfg.d_model)).astype(np.float32),
                "tokens": RNG.integers(0, cfg.vocab_size, (b, sd)).astype(np.int32),
                "labels": RNG.integers(0, cfg.vocab_size, (b, sd)).astype(np.int32)}
    batch = {}
    if cfg.family == "vlm":
        batch["embeds"] = RNG.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    labels = RNG.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1  # masked positions
    batch.update(tokens=RNG.integers(0, cfg.vocab_size, (b, s)).astype(np.int32), labels=labels)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pair(arch, **over):
    cfg = dataclasses.replace(jcfg.get_smoke_config(arch), **over)
    jm = j_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    return cfg, jm, params, build_model(cfg, device="cpu", param_dtype=torch.float32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads(arch):
    cfg, jm, params, tm = _pair(arch)
    batch = _batch(cfg)
    want_l, want_g = jax.jit(jax.value_and_grad(jm.loss))(params, _jb(batch))
    got_l, got_g = value_and_grad(tm.loss)(_t(params), _tb(batch))
    np.testing.assert_allclose(float(got_l), float(want_l), **TOL)
    _assert_trees(got_g, want_g)
    if cfg.family == "moe":  # the aux loss is in the loss
        with torch.no_grad():
            assert float(tm(_tb(batch), _t(params))[1]) > 0.0


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps(arch):
    """Three steps of ``make_train_step(AdamW(warmup_cosine))``: the loss of
    each step, and the params and moments after each, against the
    reference's; nothing the step was given is written."""
    cfg, jm, params, tm = _pair(arch)
    jopt = JAdamW(learning_rate=j_warmup_cosine(PEAK_LR, 2, 10), weight_decay=0.1)
    topt = AdamW(learning_rate=warmup_cosine(PEAK_LR, 2, 10), weight_decay=0.1)
    jstep = jax.jit(jm.make_train_step(jopt, n_micro=1))
    tstep = tm.make_train_step(topt, n_micro=1)
    jp, js = params, jopt.init(params)
    tp = _t(params)
    ts = topt.init(tp)
    for _ in range(3):
        batch = _batch(cfg)
        before = _leaves((tp, ts))
        jp, js, jmet = jstep(jp, js, _jb(batch))
        tp2, ts2, tmet = tstep(tp, ts, _tb(batch))
        for k, v in _leaves((tp, ts)).items():
            assert np.array_equal(v, before[k]), f"the step wrote {k}"
        tp, ts = tp2, ts2
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **TOL)
        _assert_step_params(tp, jp, int(ts.step))
        _assert_trees(ts.mu, js.mu)
        assert int(ts.step) == int(js.step)


def test_microbatched_step_against_the_reference():
    """``n_micro=2``: the reference's scan over microbatches, summed in f32."""
    cfg, jm, params, tm = _pair("gemma3-1b")
    batch = _batch(cfg)
    want_l, want_g = jax.jit(j_microbatched(jm.loss, 2))(params, _jb(batch))
    got_l, got_g = microbatched_value_and_grad(tm.loss, 2)(_t(params), _tb(batch))
    np.testing.assert_allclose(float(got_l), float(want_l), **TOL)
    _assert_trees(got_g, want_g)
    assert all(g.dtype == torch.float32 for g in jax.tree_util.tree_leaves(
        got_g, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def test_microbatched_equals_full():
    """The reference's ``TestAccumulation`` case on the port."""
    w = torch.from_numpy(RNG.standard_normal((8, 4)).astype(np.float32))
    batch = {"x": torch.from_numpy(RNG.standard_normal((16, 8)).astype(np.float32))}

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"]) ** 2)

    l1, g1 = value_and_grad(loss)({"w": w}, batch)
    l2, g2 = microbatched_value_and_grad(loss, n_micro=4)({"w": w}, batch)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    np.testing.assert_allclose(g1["w"].numpy(), g2["w"].numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("rows,n_micro", [(5, 2), (3, 4)], ids=["remainder", "more-micro-than-rows"])
def test_microbatched_refuses_an_uneven_split(rows, n_micro):
    """A batch axis that ``n_micro`` does not divide is refused, as the
    reference's reshape refuses it, not cut to a part of the batch."""
    w = RNG.standard_normal((8, 4)).astype(np.float32)
    x = RNG.standard_normal((rows, 8)).astype(np.float32)

    def j_loss(p, b):
        return jnp.mean((b["x"] @ p["w"]) ** 2)

    def t_loss(p, b):
        return torch.mean((b["x"] @ p["w"]) ** 2)

    with pytest.raises(TypeError):
        j_microbatched(j_loss, n_micro)({"w": jnp.asarray(w)}, {"x": jnp.asarray(x)})
    with pytest.raises(ValueError, match="does not split"):
        microbatched_value_and_grad(t_loss, n_micro)({"w": torch.from_numpy(w)},
                                                     {"x": torch.from_numpy(x)})


def test_remat_changes_nothing():
    """``cfg.remat`` recomputes each layer in the backward: the same loss
    and gradients bit for bit."""
    cfg, _, params, tm = _pair("zamba2-2.7b")
    batch = _tb(_batch(cfg))
    l1, g1 = value_and_grad(tm.loss)(_t(params), batch)
    plain = build_model(dataclasses.replace(cfg, remat=False), device="cpu",
                        param_dtype=torch.float32)
    l2, g2 = value_and_grad(plain.loss)(_t(params), batch)
    assert torch.equal(l1, l2)
    for k, v in _leaves(g1).items():
        assert np.array_equal(v, _leaves(g2)[k]), k


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-2.7b"])
@pytest.mark.parametrize("over", [{}, {"cast_params_once": True, "sharded_xent": True}],
                         ids=["bf16", "bf16-cast-once-sharded-xent"])
def test_bf16_compute_with_f32_masters(arch, over):
    """The published configs' numerics: f32 masters, bf16 compute.  The
    gradients come back f32 (the casts' backward widens them; the tied
    table's two uses and zamba2's shared block at each group sum in f32)
    and hold to the reference's within the bf16 bounds; a train step
    keeps f32 params."""
    cfg, jm, params, tm = _pair(arch, dtype="bfloat16", **over)
    batch = _batch(cfg)
    jopt = JAdamW(learning_rate=1e-3)
    topt = AdamW(learning_rate=1e-3)
    if over.get("cast_params_once"):
        jvg = jax.jit(lambda p, b: jm.make_train_step(jopt, 1)(p, jopt.init(p), b)[2]["loss"])
        want_l = jvg(params, _jb(batch))
        got = tm.make_train_step(topt, 1)(_t(params), topt.init(_t(params)), _tb(batch))
        np.testing.assert_allclose(float(got[2]["loss"]), float(want_l), rtol=BF16_LOSS_RTOL)
        assert all(p.dtype == torch.float32 for p in _leaves_t(got[0]))
        return
    want_l, want_g = jax.jit(jax.value_and_grad(jm.loss))(params, _jb(batch))
    exact = jax.jit(jax.grad(j_build_model(dataclasses.replace(cfg, dtype="float32")).loss))(
        params, _jb(batch))
    got_l, got_g = value_and_grad(tm.loss)(_t(params), _tb(batch))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=BF16_LOSS_RTOL)
    assert all(t.dtype == torch.float32 for t in _leaves_t(got_g))
    g, w, f = _leaves(got_g), _leaves(want_g), _leaves(exact)
    for k in w:
        own = np.linalg.norm(w[k] - f[k])  # the reference's own bf16 rounding
        assert np.linalg.norm(g[k] - w[k]) <= BF16_DRIFT_FACTOR * own, k
        assert np.linalg.norm(g[k] - f[k]) <= BF16_DRIFT_FACTOR * own, k


def _leaves_t(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("shape_b", [(12, 5), (2, 12, 5)], ids=["2d", "batched"])
def test_matmul_f32_backward(shape_b):
    """bf16 operands: the f32 accumulator forward, and the reference's
    transposes backward (the f32 cotangent times the other operand in
    f32, rounded to the operand's dtype), a 2-D ``b`` summed over ``a``'s
    leading dims."""
    a = torch.from_numpy(RNG.standard_normal((2, 7, 12)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(RNG.standard_normal(shape_b).astype(np.float32)).bfloat16()
    g = torch.from_numpy(RNG.standard_normal((2, 7, 5)).astype(np.float32))
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, a.detach().float() @ b.detach().float(), rtol=0, atol=0)
    ga, gb = torch.autograd.grad(out, (a, b), g)
    want_a = (g @ b.detach().float().transpose(-1, -2)).bfloat16()
    if b.dim() == 2:
        want_b = (a.detach().float().reshape(-1, 12).T @ g.reshape(-1, 5)).bfloat16()
    else:
        want_b = (a.detach().float().transpose(-1, -2) @ g).bfloat16()
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga, want_a) and torch.equal(gb, want_b)


def test_params_tree_is_the_references():
    """``params()`` of a port model: the reference's pytree structure and
    shapes, new tensors (a step on it leaves the module alone)."""
    cfg, _, params, tm = _pair("moonshot-v1-16b-a3b")
    tm.init(torch.Generator().manual_seed(0))
    tree = tm.params()
    want = {k: v.shape for k, v in _leaves(params).items()}
    assert {k: v.shape for k, v in _leaves(tree).items()} == want
    assert tree["layers"]["moe"]["gate"].data_ptr() != tm.layers[0].moe.gate.data_ptr()
    assert all(p.requires_grad for p in tm.parameters())
    assert isinstance(AdamW().init(tree), AdamWState)
