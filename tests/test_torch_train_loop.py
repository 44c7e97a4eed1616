"""The training path around the step on the port, on the CPU: the
learning-rate schedules and the gradient compression against the JAX
package, the fault-tolerant train loop (the reference's five
``TestTrainLoop`` cases on the port), train-loop checkpoints crossing
between the packages both ways, and the training launcher for one arch of
each family.
"""
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import optim as jopt
from repro import runtime as jrt
from repro.models import build_model as j_build_model
from repro.optim import compression as jcomp
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim import (
    AdamW,
    apply_updates,
    constant,
    init_error_feedback,
    int8_allreduce,
    topk_compress_allreduce,
    warmup_cosine,
    warmup_linear,
)
from repro_torch.optim.accumulation import value_and_grad
from repro_torch.runtime import TrainLoopConfig, train_loop

RNG = np.random.default_rng(43)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------- schedules
@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("warmup_cosine", (1.0, 10, 100, 0.1)),
    ("warmup_cosine", (3e-4, 10, 20)),
    ("warmup_linear", (2e-3, 7, 50, 1e-4)),
])
def test_schedules_match_the_reference(name, args):
    """Each schedule at every step from 0 past its end, f32, against the
    reference's (its cos within an f32 ulp or two of XLA's)."""
    t_sched = {"constant": constant, "warmup_cosine": warmup_cosine,
               "warmup_linear": warmup_linear}[name](*args)
    j_sched = getattr(jopt, name)(*args)
    for step in range(0, 130):
        got = t_sched(torch.tensor(step, dtype=torch.int32))
        want = j_sched(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=3e-7, atol=1e-12)
    if name == "warmup_cosine" and len(args) == 4:  # the reference's own test
        assert float(t_sched(torch.tensor(0))) == 0.0
        assert abs(float(t_sched(torch.tensor(10))) - 1.0) < 1e-5
        assert abs(float(t_sched(torch.tensor(100))) - 0.1) < 1e-5


# ------------------------------------------------------------- compression
def _grads():
    return {"w": RNG.standard_normal((64, 32)).astype(np.float32),
            "b": RNG.standard_normal(100).astype(np.float32)}


def test_int8_allreduce_matches_the_reference():
    g = _grads()
    got, frac = int8_allreduce({k: torch.from_numpy(v) for k, v in g.items()})
    want, jfrac = jcomp.int8_allreduce({k: jnp.asarray(v) for k, v in g.items()}, axes=None)
    assert frac == jfrac == 0.25
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        scale = float(np.abs(g[k]).max()) / 127.0  # the reference's accuracy test
        assert np.abs(got[k].numpy() - g[k]).max() <= scale * 0.5 + 1e-6


def test_topk_error_feedback_matches_the_reference():
    """Fifty steps of top-k with error feedback on one gradient: each step's
    sent values and residual equal the reference's, and the mean sent
    transmits the signal (the reference's accumulation test)."""
    g = _grads()
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tef, jef = init_error_feedback(tg), jcomp.init_error_feedback(jg)
    total = {k: np.zeros_like(v) for k, v in g.items()}
    for _ in range(50):
        sent, tef, frac = topk_compress_allreduce(tg, tef, k_fraction=0.1)
        jsent, jef, jfrac = jcomp.topk_compress_allreduce(jg, jef, k_fraction=0.1)
        assert frac == jfrac
        for k in g:
            np.testing.assert_array_equal(sent[k].numpy(), np.asarray(jsent[k]))
            np.testing.assert_array_equal(tef.residual[k].numpy(), np.asarray(jef.residual[k]))
            total[k] += sent[k].numpy()
    for k in g:
        np.testing.assert_allclose(total[k] / 50, g[k], rtol=0.3, atol=0.15)


_COLLECTIVE = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.optim import init_error_feedback, int8_allreduce, topk_compress_allreduce


    def run(rank, world, port, out):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        g = {"w": torch.from_numpy(np.random.default_rng(rank).standard_normal((16, 8))
                                   .astype(np.float32))}
        q, _ = int8_allreduce(g, axes=dist.group.WORLD)
        sent, ef, _ = topk_compress_allreduce(g, init_error_feedback(g), 0.25,
                                              axes=dist.group.WORLD)
        np.savez(f"{out}/rank{rank}.npz", q=q["w"].numpy(), sent=sent["w"].numpy(),
                 res=ef.residual["w"].numpy())
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(run, args=(2, int(sys.argv[1]), sys.argv[2]), nprocs=2)
""")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_compression_over_a_process_group(tmp_path):
    """Two gloo ranks: the int8 all-reduce quantises both on the larger
    scale and returns the mean of the codes, dequantised; top-k sends the
    mean of each rank's kept entries and keeps the rest locally."""
    script = tmp_path / "collective.py"
    script.write_text(_COLLECTIVE)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    subprocess.run([sys.executable, str(script), str(_free_port()), str(tmp_path)],
                   check=True, env=env, timeout=240, capture_output=True)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    gs = [np.random.default_rng(r).standard_normal((16, 8)).astype(np.float32) for r in range(2)]
    scale = np.float32(max(np.abs(g).max() for g in gs)) / np.float32(127.0) + np.float32(1e-12)
    codes = [np.clip(np.round(g / scale), -127, 127).astype(np.int32) for g in gs]
    want_q = (codes[0] + codes[1]).astype(np.float32) * scale / np.float32(2.0)
    kept = []
    for g in gs:
        thresh = np.sort(np.abs(g).ravel())[::-1][int(0.25 * g.size) - 1]
        kept.append(np.where(np.abs(g) >= thresh, g, 0.0).astype(np.float32))
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["q"], want_q)
        np.testing.assert_allclose(ranks[r]["sent"], (kept[0] + kept[1]) / 2, rtol=1e-6)
        np.testing.assert_array_equal(ranks[r]["res"], gs[r] - kept[r])


# -------------------------------------------------------------- train loop
class TestTrainLoop:
    """The reference's ``TestTrainLoop``, on the port."""

    def _setup(self):
        params = {"w": torch.zeros(4)}
        opt = AdamW(learning_rate=0.1)
        opt_state = opt.init(params)
        target = torch.tensor([1.0, -1.0, 2.0, 0.5])

        def step_fn(p, s, batch):
            def loss(p, b):
                return torch.mean((p["w"] - target) ** 2) * b["scale"]

            lv, g = value_and_grad(loss)(p, batch)
            u, s = opt.update(g, s, p)
            return apply_updates(p, u), s, {"loss": lv}

        return params, opt_state, step_fn, lambda step: {"scale": torch.tensor(1.0)}

    def test_runs_to_completion(self, tmp_path):
        params, opt_state, step_fn, batch_fn = self._setup()
        res = train_loop(step_fn, params, opt_state, batch_fn,
                         TrainLoopConfig(total_steps=20, ckpt_dir=str(tmp_path), ckpt_every=5))
        assert res.steps_done == 20
        assert res.restarts == 0
        assert res.metrics[-1]["loss"] < res.metrics[0]["loss"]

    def test_failure_recovery(self, tmp_path):
        """Injected failures trigger a checkpoint restore and the loop completes."""
        params, opt_state, step_fn, batch_fn = self._setup()
        failed = {"count": 0}

        def injector(step):
            if step == 12 and failed["count"] < 2:
                failed["count"] += 1
                raise RuntimeError("simulated node failure")

        res = train_loop(step_fn, params, opt_state, batch_fn,
                         TrainLoopConfig(total_steps=20, ckpt_dir=str(tmp_path), ckpt_every=5),
                         fail_injector=injector)
        assert failed["count"] == 2
        assert res.restarts == 2
        assert res.metrics[-1]["step"] == 19

    def test_unrecoverable_failure_raises(self, tmp_path):
        params, opt_state, step_fn, batch_fn = self._setup()

        def injector(step):
            if step >= 3:
                raise RuntimeError("persistent failure")

        with pytest.raises(RuntimeError):
            train_loop(step_fn, params, opt_state, batch_fn,
                       TrainLoopConfig(total_steps=20, ckpt_dir=str(tmp_path), ckpt_every=2,
                                       max_retries=2),
                       fail_injector=injector)

    def test_failure_before_first_checkpoint_replays_from_init(self, tmp_path):
        """A failure before any checkpoint exists rewinds to the initial
        params, not to step 0 with the live ones."""
        opt_state = {"m": torch.zeros(1)}  # ignored by step_fn
        params = {"w": torch.zeros(1)}

        def step_fn(p, s, batch):
            return {"w": p["w"] + 1.0}, s, {"w": p["w"][0]}

        failed = {"count": 0}

        def injector(step):
            if step == 3 and failed["count"] < 1:
                failed["count"] += 1
                raise RuntimeError("failure before first checkpoint")

        res = train_loop(step_fn, params, opt_state, lambda step: {},
                         TrainLoopConfig(total_steps=5, ckpt_dir=str(tmp_path), ckpt_every=100),
                         fail_injector=injector)
        assert failed["count"] == 1 and res.restarts == 1
        assert res.metrics[-1]["w"] == 4.0
        assert [m["step"] for m in res.metrics] == list(range(5))

    def test_resume_from_checkpoint(self, tmp_path):
        params, opt_state, step_fn, batch_fn = self._setup()
        train_loop(step_fn, params, opt_state, batch_fn,
                   TrainLoopConfig(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=5))
        res2 = train_loop(step_fn, params, opt_state, batch_fn,
                          TrainLoopConfig(total_steps=15, ckpt_dir=str(tmp_path), ckpt_every=5))
        assert res2.steps_done == 5
        assert res2.metrics[0]["step"] == 10


def test_straggler_telemetry(tmp_path):
    """A step three times slower than the EMA is counted and reported."""
    import time

    slow = {11}
    seen = []

    def step_fn(p, s, batch):
        time.sleep(0.05 if batch["step"] in slow else 0.005)
        return p, s, {"loss": torch.tensor(0.0)}

    res = train_loop(step_fn, {"w": torch.zeros(1)}, {"m": torch.zeros(1)},
                     lambda step: {"step": step}, TrainLoopConfig(total_steps=15),
                     on_straggler=lambda step, dt, ema: seen.append(step))
    assert res.straggler_events == len(seen) >= 1 and 11 in seen


# --------------------------------------------- checkpoints across packages
ARCH = "gemma3-1b"


def _loop_pair():
    cfg = jcfg.get_smoke_config(ARCH)
    jm = j_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu", param_dtype=torch.float32)
    batches = [{"tokens": RNG.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
                "labels": RNG.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
               for _ in range(4)]
    return cfg, jm, params, tm, batches


def _reference_run(jm, params, batches, directory, total):
    opt = jopt.AdamW(learning_rate=jopt.warmup_cosine(1e-3, 2, 4), weight_decay=0.1)
    step = jax.jit(jm.make_train_step(opt, n_micro=1))
    return jrt.train_loop(step, params, opt.init(params),
                          lambda i: {k: jnp.asarray(v) for k, v in batches[i].items()},
                          jrt.TrainLoopConfig(total_steps=total, ckpt_dir=directory, ckpt_every=2))


def _port_run(tm, params, batches, directory, total):
    opt = AdamW(learning_rate=warmup_cosine(1e-3, 2, 4), weight_decay=0.1)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    return train_loop(tm.make_train_step(opt, n_micro=1), tp, opt.init(tp),
                      lambda i: {k: torch.from_numpy(v) for k, v in batches[i].items()},
                      TrainLoopConfig(total_steps=total, ckpt_dir=directory, ckpt_every=2))


def _final_params(directory):
    from repro_torch.checkpoint import latest_checkpoint, load_flat

    step, path = latest_checkpoint(directory)
    return step, {k: v for k, v in load_flat(path).items() if k.startswith("params/")}


@pytest.mark.parametrize("first", ["reference", "port"])
def test_train_loop_checkpoint_crosses_packages(tmp_path, first):
    """A run of one package checkpoints at step 2; the other package resumes
    it (the params, ``opt/step`` and the moments under the reference's
    flat keys) and takes steps 2 and 3; the first package, resumed from a
    copy of the same checkpoint, takes them too: the two step-4 params
    agree (the step tolerance of ``test_torch_train``)."""
    _, jm, params, tm, batches = _loop_pair()
    runs = {"reference": lambda d, n: _reference_run(jm, params, batches, d, n),
            "port": lambda d, n: _port_run(tm, params, batches, d, n)}
    other = "port" if first == "reference" else "reference"
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    runs[first](a, 2)
    shutil.copytree(a, b)
    res_other = runs[other](a, 4)
    res_same = runs[first](b, 4)
    assert res_other.steps_done == res_same.steps_done == 2
    assert [m["step"] for m in res_other.metrics] == [2, 3]
    np.testing.assert_allclose([m["loss"] for m in res_other.metrics],
                               [m["loss"] for m in res_same.metrics], rtol=1e-5)
    (sa, pa), (sb, pb) = _final_params(a), _final_params(b)
    assert sa == sb == 4 and pa.keys() == pb.keys() and "params/layers/attn/wq" in pa
    for k in pa:
        diff = (pa[k] - pb[k]).abs()
        assert float((diff > 1e-6 + 1e-5 * pb[k].abs()).float().mean()) <= 1e-3, k
        assert float(diff.max()) <= 2 * 1e-3 * 4, k


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ["gemma3-1b", "moonshot-v1-16b-a3b", "deepseek-v2-236b",
                                  "mamba2-1.3b", "zamba2-2.7b", "internvl2-1b",
                                  "seamless-m4t-large-v2"])
def test_launcher_on_the_cpu(arch, capsys, tmp_path):
    """``python -m repro_torch.launch.train --arch A --smoke --device cpu``,
    three steps of batch 2 x seq 32: the reference's output lines, finite
    losses; the first arch also checkpoints and resumes, and profiles."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "32"]
    if arch == "gemma3-1b":
        argv += ["--ckpt-dir", str(tmp_path / "ckpt"), "--profile-dir", str(tmp_path / "prof")]
    res = launch_train.main(argv)
    out = capsys.readouterr().out
    assert f"[train] {arch}" in out and "[train] done: loss" in out
    assert res.steps_done == 3 and all(np.isfinite(m["loss"]) for m in res.metrics)
    if arch == "gemma3-1b":
        assert os.listdir(tmp_path / "prof")
        again = launch_train.main(argv[:-4] + ["--ckpt-dir", str(tmp_path / "ckpt")]
                                  + ["--steps", "4"])
        assert again.steps_done == 1 and again.metrics[0]["step"] == 3


def test_launcher_refuses_a_mesh():
    with pytest.raises(SystemExit, match="no mesh"):
        launch_train.main(["--arch", "gemma3-1b", "--device", "cpu", "--mesh", "host"])
