"""The port's hot-path guard on the CPU: torchlint's rules (TL000, TL001,
TL003, TL004) and waivers, the dogfood gate over ``src/repro_torch``, the
strict primitives, compile-once invariants across repeated fit/evaluate
rounds, the seeded violations (a shape change, an off-device state leaf,
a non-finite update), strict serving (batched, streaming, the yi-9b smoke
decoder, the continual lifecycle), ``profile_dir=`` and ``use_kernels=``.

Against the JAX package on the same numpy inputs: a strict fit of the port
from the JAX-initialised state matches the reference's strict fit at the
whole-fit parity tolerance of ``tests/test_torch_network.py``, and TL004
finds the lines JL004 finds on the reference's lock-discipline cases
(``tests/test_analysis.py``'s ``TestJL004LockDiscipline``)."""
import json
import os
import subprocess
import sys
import textwrap
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.analysis.lint import lint_source as jax_lint_source
from repro.checkpoint.store import path_key
from repro.core import DenseLayer as JDense
from repro.core import ExecutionConfig as JExecutionConfig
from repro.core import Network as JNetwork
from repro.core import StructuralPlasticityLayer as JPlastic
from repro.core import UnitLayout as JUnitLayout
from repro.core import onehot_layout as jonehot
from repro_torch.analysis import lint_source
from repro_torch.analysis.strict import (
    SYNC_MESSAGE,
    Counted,
    HostTransferError,
    NonFiniteError,
    RecompileError,
    RecompileSentinel,
    dispatch_guard,
    finite_checker,
)
from repro_torch.checkpoint import flat_from_network_state, network_state_from_flat
from repro_torch.core import (
    DenseLayer,
    ExecutionConfig,
    Network,
    StructuralPlasticityLayer,
    UnitLayout,
    onehot_layout,
)
from repro_torch.data import complementary_code, mnist_like
from repro_torch.kernels import _build, ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOT = "repro_torch/runtime/service.py"  # any DEFAULT_HOT_MODULES entry
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5  # tests/test_torch_network.py's whole-fit parity


def _lint(src, path="pkg/cold.py"):
    return lint_source(textwrap.dedent(src), path)


def _rules(findings):
    return [f.rule for f in findings]


# ----------------------------------------------------------------- linting
class TestTL001HostSync:
    def test_item_in_compiled_function_flagged(self):
        findings = _lint(
            """
            import torch

            def epoch(state, xs):
                def body(carry, xb):
                    return carry + xb.item()
                return torch.compile(body)(state, xs)
            """
        )
        assert _rules(findings) == ["TL001"]
        assert ".item()" in findings[0].message

    def test_host_sync_in_compiled_decorated_fn(self):
        findings = _lint(
            """
            import numpy as np
            import torch

            @torch.compile
            def step(s, xb):
                return s + np.asarray(xb)
            """
        )
        assert _rules(findings) == ["TL001"]

    def test_sync_inside_graph_capture_flagged(self):
        findings = _lint(
            """
            import torch

            def capture(g, x):
                with torch.cuda.graph(g):
                    y = x * 2
                    n = y.sum().cpu()
                return n
            """
        )
        assert _rules(findings) == ["TL001"]

    def test_float_cast_of_shape_is_static_and_clean(self):
        findings = _lint(
            """
            import torch

            @torch.compile
            def step(s, xb):
                return s * float(xb.shape[0]) + int(len(xb)) + int(xb.numel())
            """
        )
        assert findings == []

    def test_float_cast_of_compiled_value_flagged(self):
        findings = _lint(
            """
            import torch

            @torch.compile
            def step(s, xb):
                return s * float(xb)
            """
        )
        assert _rules(findings) == ["TL001"]

    @pytest.mark.parametrize("call", [
        "x.cpu()", "x.numpy()", "x.tolist()", "x.item()", "x.nonzero()",
        "torch.cuda.synchronize()", "x.to('cpu')", "int(torch.argmax(x))",
        "bool(torch.isfinite(x).all())", "np.asarray(torch.relu(x))", "torch.unique(x)",
    ])
    def test_hot_module_flags_every_sync(self, call):
        findings = _lint(
            f"""
            import numpy as np
            import torch

            def readback(x):
                return {call}
            """,
            path=HOT,
        )
        assert "TL001" in _rules(findings), call

    def test_cold_module_host_code_is_clean(self):
        findings = _lint(
            """
            def gather(x, idx):
                return x.cpu().numpy()[idx]
            """
        )
        assert findings == []

    def test_hot_module_host_values_are_clean(self):
        # int() over host data, np.asarray of host rows and a dtype test
        # are fine on a hot module: only tensor-valued conversions sync.
        findings = _lint(
            """
            import numpy as np
            import torch

            def count(tokens, slot, rows, t):
                flag = int(t.dtype == torch.bfloat16)
                return int(tokens[slot]), np.asarray(rows, np.float32), flag
            """,
            path=HOT,
        )
        assert findings == []


class TestTL003Recompile:
    @pytest.mark.parametrize("make", [
        "torch.compile(layer.fwd)", "_build.build_all()", "masked_matmul.plan(m, k, n, sms)",
        "torch.cuda.CUDAGraph()",
    ])
    def test_build_inside_loop_flagged(self, make):
        findings = _lint(
            f"""
            import torch

            def sweep(layers, x, m, k, n, sms):
                outs = []
                for layer in layers:
                    outs.append({make})
                return outs
            """
        )
        assert _rules(findings) == ["TL003"], make

    def test_unhashable_cache_key_flagged(self):
        findings = _lint(
            """
            import functools

            @functools.lru_cache(maxsize=None)
            def plan(shape, sms):
                return shape

            def run():
                return plan([128, 1568], 132)
            """
        )
        assert _rules(findings) == ["TL003"]

    def test_closure_captured_mutable_flagged(self):
        findings = _lint(
            """
            import torch

            def make(x):
                table = [1, 2, 3]

                def body(a):
                    return a + table[0]

                return torch.compile(body)(x)
            """
        )
        assert "TL003" in _rules(findings)

    def test_hoisted_compile_is_clean(self):
        findings = _lint(
            """
            import torch

            def sweep(layers, x):
                fns = [torch.compile(l.fwd) for l in layers]
                outs = []
                for fn in fns:
                    outs.append(fn(x))
                return outs
            """
        )
        assert findings == []


# The reference's TestJL004LockDiscipline cases (tests/test_analysis.py),
# written once for both linters: {LOCKS} names the registration attribute.
_LOCK_SRC = """
    import threading

    class Plan{base}:
        def __init__(self):
            {lock}
            self.count = 0

        def bump(self):
            {body}
"""
LOCK_CASES = {
    "unlocked_write": _LOCK_SRC.format(
        base="", lock="self._lock = threading.Lock()", body="self.count += 1"),
    "locked_write": _LOCK_SRC.format(
        base="", lock="self._lock = threading.Lock()",
        body="with self._lock:\n                self.count += 1"),
    "lockless_class": _LOCK_SRC.format(base="", lock="pass", body="self.count += 1"),
    "inherited_lock": """
        import threading

        class Base:
            def __init__(self):
                self._lock = threading.Lock()

        class Child(Base):
            def bump(self):
                self.count = 1
    """,
    "registered_lock": """
        import threading

        class Bundle:
            {LOCKS} = ("_lock",)

            def __init__(self, lock=None):
                self._lock = lock if lock is not None else threading.Lock()
                self.count = 0

            def bump(self):
                self.count += 1
    """,
    "condition_variable": """
        import threading

        class Router:
            def __init__(self):
                self._cv = threading.Condition()
                self._state = "new"

            def kill(self):
                self._state = "stopped"
    """,
    "locked_suffix": """
        import threading

        class Router:
            def __init__(self):
                self._cv = threading.Condition()
                self.n = 0

            def bump(self):
                with self._cv:
                    self._bump_locked()

            def _bump_locked(self):
                self.n += 1
    """,
}
LOCK_WANT = {
    "unlocked_write": 1, "locked_write": 0, "lockless_class": 0, "inherited_lock": 1,
    "registered_lock": 1, "condition_variable": 1, "locked_suffix": 0,
}


class TestTL004LockDiscipline:
    @pytest.mark.parametrize("case", sorted(LOCK_CASES))
    def test_lock_discipline(self, case):
        src = LOCK_CASES[case].replace("{LOCKS}", "_TORCHLINT_LOCKS")
        findings = _lint(src)
        assert _rules(findings) == ["TL004"] * LOCK_WANT[case], findings

    @pytest.mark.parametrize("case", sorted(LOCK_CASES))
    def test_tl004_finds_jl004_lines(self, case):
        """Against the JAX package's jaxlint on the same sources."""
        ours = _lint(LOCK_CASES[case].replace("{LOCKS}", "_TORCHLINT_LOCKS"))
        theirs = jax_lint_source(
            textwrap.dedent(LOCK_CASES[case].replace("{LOCKS}", "_JAXLINT_LOCKS")), "pkg/cold.py"
        )
        assert [(f.line, f.col) for f in ours if f.rule == "TL004"] == [
            (f.line, f.col) for f in theirs if f.rule == "JL004"
        ]


class TestWaivers:
    def test_waiver_suppresses_finding(self):
        findings = _lint(
            """
            def readback(scores):
                return scores.cpu()  # torchlint: allow[TL001] reason=api returns host arrays
            """,
            path=HOT,
        )
        assert findings == []

    def test_own_line_waiver_covers_next_line(self):
        findings = _lint(
            """
            def readback(scores):
                # torchlint: allow[TL001] reason=api returns host arrays
                return scores.cpu()
            """,
            path=HOT,
        )
        assert findings == []

    def test_waiver_without_reason_is_tl000(self):
        findings = _lint(
            """
            def readback(scores):
                return scores.cpu()  # torchlint: allow[TL001]
            """,
            path=HOT,
        )
        assert "TL000" in _rules(findings)
        assert "TL001" in _rules(findings)  # and the sync is NOT waived

    def test_unused_waiver_is_tl000(self):
        findings = _lint(
            """
            def clean():
                return 1  # torchlint: allow[TL001] reason=nothing here
            """,
            path=HOT,
        )
        assert _rules(findings) == ["TL000"]
        assert "matches no finding" in findings[0].message

    def test_waiver_does_not_cover_other_rules(self):
        findings = _lint(
            """
            def readback(scores):
                return scores.cpu()  # torchlint: allow[TL004] reason=wrong rule
            """,
            path=HOT,
        )
        assert "TL001" in _rules(findings)

    def test_unknown_rule_and_jaxlint_rules_are_tl000(self):
        findings = _lint(
            """
            def readback(scores):
                return scores  # torchlint: allow[JL001] reason=the other lint's rule
            """,
            path=HOT,
        )
        assert _rules(findings) == ["TL000"]


class TestDogfood:
    @pytest.mark.parametrize("entry", [
        [sys.executable, "-m", "repro_torch.analysis.lint", "src/repro_torch"],
        [sys.executable, os.path.join("tools", "torchlint"), "src/repro_torch"],
    ], ids=["module", "tool"])
    def test_torchlint_src_exits_clean(self, entry):
        """The gate: the port's own tree has no unwaived finding, and every
        waiver carries a reason (TL000 otherwise)."""
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        proc = subprocess.run(entry, capture_output=True, text=True, timeout=120,
                              cwd=REPO, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_router_module_is_hot_and_clean(self):
        from repro_torch.analysis.lint import DEFAULT_HOT_MODULES

        rel = "repro_torch/runtime/router.py"
        assert rel in DEFAULT_HOT_MODULES
        with open(os.path.join(REPO, "src", rel)) as f:
            src = f.read()
        assert "self._cv = threading.Condition()" in src  # TL004 anchor
        assert lint_source(src, rel) == []

    @pytest.mark.parametrize("rel", ["repro_torch/runtime/trace.py", "repro_torch/runtime/export.py"])
    def test_observability_modules_are_hot_and_clean(self, rel):
        """The span ring and the exporter sit between dispatches: whole-file
        hot modules, stdlib only, clean without a waiver."""
        from repro_torch.analysis.lint import DEFAULT_HOT_MODULES

        assert rel in DEFAULT_HOT_MODULES
        with open(os.path.join(REPO, "src", rel)) as f:
            src = f.read()
        assert "import numpy" not in src and "import torch" not in src
        assert "torchlint: allow" not in src
        assert lint_source(src, rel) == []

    def test_hot_modules_exist_in_the_port(self):
        from repro_torch.analysis.lint import DEFAULT_HOT_MODULES

        for rel in DEFAULT_HOT_MODULES:
            assert os.path.exists(os.path.join(REPO, "src", rel)), rel

    def test_analysis_package_imports_without_torch(self):
        """``import repro_torch.analysis`` stays torch-free (the lint runs
        anywhere); the strict side loads torch on first use."""
        code = (
            "import sys; sys.modules['torch'] = None; sys.modules['numpy'] = None\n"
            "import repro_torch.analysis as a\n"
            "assert a.lint_source('x = 1\\n') == []\n"
            "try:\n    a.dispatch_guard\nexcept ImportError:\n    print('lazy')\n"
        )
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=60, env=env)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == "lazy"


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def dataset():
    ds = mnist_like(n_train=256, n_test=64, n_features=32, seed=0)
    x, layout = complementary_code(ds.x_train)
    return ds, np.asarray(x, np.float32), layout


def _build_net(layout, seed=0, **layer_kw):
    hidden = UnitLayout(4, 8)
    net = Network(seed=seed)
    net.add(StructuralPlasticityLayer(
        layout, hidden, fan_in=16, lam=0.05, init_jitter=1.0, gain=4.0, **layer_kw))
    net.add(DenseLayer(hidden, onehot_layout(10), lam=0.05, **layer_kw))
    return net


KW = dict(epochs_hidden=1, epochs_readout=1, batch_size=64)


def _states_equal(a, b):
    fa, fb = flat_from_network_state(a), flat_from_network_state(b)
    return fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)


# ------------------------------------------------------- strict primitives
class TestStrictPrimitives:
    def test_dispatch_guard_refuses_a_host_array_by_name(self):
        state = {"w": torch.ones(3), "traces": (torch.ones(2), np.ones(2))}
        with pytest.raises(HostTransferError, match=r"state\['traces'\]\[1\].*numpy"):
            with dispatch_guard(True, "cpu", {"state": state}):
                pass

    def test_dispatch_guard_refuses_an_off_device_tensor(self):
        with pytest.raises(HostTransferError, match="xs: a tensor on meta"):
            with dispatch_guard(True, "cpu", {"xs": torch.empty(2, device="meta")}):
                pass

    def test_dispatch_guard_allows_staged_inputs(self):
        with dispatch_guard(True, "cpu", {"xs": torch.ones(2), "n": 3, "none": None}):
            torch.ones(2).sum()

    def test_dispatch_guard_disabled_is_noop(self):
        with dispatch_guard(False, "cpu", {"xs": np.ones(2)}):
            pass

    def test_sync_verdict_belongs_to_the_guarded_thread(self):
        """A synchronising op reports through torch's sync-debug warning; the
        guard turns it into HostTransferError in the thread that holds the
        guard only.  A caller thread's read back while another thread's
        guard is open must not raise (the warning is emitted by hand here:
        the CPU has no sync debug mode)."""
        opened, done, outcome = threading.Event(), threading.Event(), {}

        def guarded():
            try:
                with dispatch_guard(True, "cpu"):
                    opened.set()
                    done.wait(timeout=30)
                    warnings.warn(SYNC_MESSAGE + " (emitted by the test)")
            except HostTransferError as e:
                outcome["guarded"] = str(e)

        t = threading.Thread(target=guarded)
        t.start()
        assert opened.wait(timeout=30)
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            warnings.warn(SYNC_MESSAGE + " (the caller's read back)")  # must not raise
        done.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert "host synchronisation inside a guarded dispatch" in outcome["guarded"]

    def test_guard_translates_the_error_mode(self):
        with pytest.raises(HostTransferError, match="host synchronisation"):
            with dispatch_guard(True, "cpu"):
                raise RuntimeError(SYNC_MESSAGE)
        with pytest.raises(ValueError):  # anything else passes untouched
            with dispatch_guard(True, "cpu"):
                raise ValueError("unrelated")

    def test_sentinel_baselines_then_raises_on_growth(self):
        f = Counted(lambda a: a * 2)
        s = RecompileSentinel()
        s.watch("f", f)
        f(torch.ones(4))
        s.check()
        f(torch.ones(4))  # the same signature: no growth
        s.check()
        f(torch.ones(8))  # shape change: growth
        with pytest.raises(RecompileError, match="'f' re-traced during probe"):
            s.check("probe")
        seen = []
        s.on_rebaseline = seen.append
        s.rebaseline()
        s.check()  # the intentional change adopted
        assert seen == [{"f": 2}]

    def test_signature_counts_numbers_by_type(self):
        f = Counted(lambda st, k: st)
        f({"w": torch.ones(2), "step": 1}, 3)
        f({"w": torch.ones(2), "step": 2}, 4)  # a host step mirror moves every call
        assert f._cache_size() == 1
        f({"w": torch.ones(2, dtype=torch.float64), "step": 2}, 4)
        assert f._cache_size() == 2

    def test_kernel_plans_are_charged_to_the_running_callable(self):
        """On the card the kernels record each launch plan on the innermost
        running callable; a second network's callable keeps its own."""
        first = Counted(lambda key: _build.record("masked_matmul.plan", key))
        other = Counted(lambda key: _build.record("masked_matmul.plan", key))
        s1, s2 = RecompileSentinel(), RecompileSentinel()
        s1.watch("epoch", first)
        s2.watch("epoch", other)
        first((128, 1568, 3000))
        s1.check()
        assert s1.sizes() == {"epoch": 1, "epoch>masked_matmul.plan": 1}
        other((64, 1568, 3000))
        other((32, 1568, 3000))
        s1.check()  # the other network's plans do not touch this one
        first((64, 1568, 3000))  # a new plan under the same signature
        with pytest.raises(RecompileError, match=r"epoch>masked_matmul.plan"):
            s1.check("fit")
        _build.record("masked_matmul.plan", (1, 1, 1))  # no callable running: dropped

    def test_finite_checker_names_the_leaf(self):
        check = finite_checker()
        check({"w": torch.ones(3)}, "clean")
        with pytest.raises(NonFiniteError, match=r"poisoned: non-finite values in \['b'\]"):
            check({"w": torch.ones(3), "b": torch.tensor([1.0, float("nan")])}, "poisoned")


# -------------------------------------------------- compile-once invariants
class TestCompileOnce:
    @pytest.mark.parametrize("engine", ["scan", "batch"])
    def test_fit_evaluate_rounds_compile_once(self, dataset, engine):
        """Two fit rounds + two evaluates: every callable the network owns
        meets one signature (the sentinel would raise otherwise)."""
        ds, x, layout = dataset
        c = _build_net(layout).compile(ExecutionConfig(device="cpu", engine=engine, strict=True))
        c.fit((x, ds.y_train), **KW)
        c.fit((x, ds.y_train), **KW)
        c.evaluate((x, ds.y_train))
        c.evaluate((x, ds.y_train))
        sizes = c._sentinel.sizes()
        assert sizes, "sentinel watched nothing"
        assert all(v <= 1 for v in sizes.values()), sizes
        assert c.plan.cache_sizes() and all(v == 1 for v in c.plan.cache_sizes().values())

    @pytest.mark.parametrize("readout", ["bcpnn", "sgd"])
    def test_strict_parity_with_default_mode(self, dataset, readout):
        """Strict mode observes only: the same state and accuracy bit for bit."""
        ds, x, layout = dataset
        a = _build_net(layout).compile(ExecutionConfig(device="cpu", strict=True))
        b = _build_net(layout).compile(ExecutionConfig(device="cpu"))
        for c in (a, b):
            c.fit((x, ds.y_train), readout=readout, **KW)
            c.partial_fit((x, ds.y_train), batch_size=64, readout=readout)
        assert _states_equal(a.state, b.state)
        assert a.evaluate((x, ds.y_train)) == b.evaluate((x, ds.y_train))


# ------------------------------------------------------- seeded violations
class TestSeededViolations:
    def test_shape_changing_call_raises(self, dataset):
        ds, x, layout = dataset
        c = _build_net(layout).compile(ExecutionConfig(device="cpu", strict=True))
        c.fit((x, ds.y_train), **KW)
        with pytest.raises(RecompileError, match="re-traced during partial_fit"):
            c.partial_fit((x, ds.y_train), batch_size=32)

    @pytest.mark.parametrize("move", ["numpy", "meta"])
    def test_off_device_state_raises(self, dataset, move):
        """A state leaf demoted to a host array (or another device; on the
        card, the CPU) trips the guard at the next dispatch, naming it,
        before any kernel or plain version runs."""
        ds, x, layout = dataset
        c = _build_net(layout).compile(ExecutionConfig(device="cpu", strict=True))
        c.fit((x, ds.y_train), **KW)
        s0 = c.state.layers[0]
        cij = s0.marginals.cij.numpy() if move == "numpy" else s0.marginals.cij.to("meta")
        c.state = c.state._replace(
            layers=(s0._replace(marginals=s0.marginals._replace(cij=cij)),) + c.state.layers[1:]
        )
        with pytest.raises(HostTransferError, match=r"state\.marginals\.cij"):
            c.partial_fit((x, ds.y_train), batch_size=64)

    def test_non_finite_update_raises(self, dataset):
        ds, x, layout = dataset
        c = _build_net(layout).compile(ExecutionConfig(device="cpu", strict=True))
        c.fit((x, ds.y_train), **KW)
        s0 = c.state.layers[0]
        w = s0.w.clone()
        w[0, 0] = float("nan")
        c.state = c.state._replace(layers=(s0._replace(w=w),) + c.state.layers[1:])
        with pytest.raises(NonFiniteError, match=r"hidden layer 0, epoch 0: non-finite values in \.marginals"):
            c.partial_fit((x, ds.y_train), batch_size=64)


# ----------------------------------------------------------- serving side
class TestStrictServing:
    def _reqs(self, cfg, lengths, base=0):
        from repro_torch.runtime import Request

        rng = np.random.default_rng(7)
        return [
            Request(rid=base + i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=5)
            for i, n in enumerate(lengths)
        ]

    def test_decode_rounds_compile_once_and_match(self):
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import build_model
        from repro_torch.runtime import ServiceConfig, serve_model

        cfg = get_smoke_config("yi-9b")
        model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        strict = serve_model(model, ServiceConfig(max_batch=2, max_seq=48, strict=True))
        plain = serve_model(model, ServiceConfig(max_batch=2, max_seq=48))
        out_s = strict.generate(self._reqs(cfg, (4, 11, 7)))
        out_p = plain.generate(self._reqs(cfg, (4, 11, 7)))
        for a, b in zip(out_s, out_p):
            np.testing.assert_array_equal(a.tokens, b.tokens)
        strict.generate(self._reqs(cfg, (4, 11, 7), base=10))  # nothing may re-trace
        sizes = strict.plan._sentinel.sizes()
        assert sizes["fused_step"] == 1
        assert all(v == 1 for n, v in sizes.items() if n.startswith("prefill["))

    def test_batched_plan_strict_predict(self, dataset):
        from repro_torch.runtime import ServiceConfig

        ds, x, layout = dataset
        c = _build_net(layout).compile(ExecutionConfig(device="cpu", strict=True))
        c.fit((x, ds.y_train), **KW)
        svc = c.serve(ServiceConfig(plan="batched", max_batch=64, strict=True))
        a = svc.predict(x[:64])
        b = svc.predict(x[:64])
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        sizes = svc.plan._sentinel.sizes()
        assert sizes["head"] == 1 and any(k.startswith("proj[") for k in sizes)

    def test_strict_plan_over_a_non_strict_deep_network_watches_its_projections(self, dataset):
        """A strict BatchedPlan over a deep network compiled without strict
        projects through the network's counted projections and its sentinel
        watches them, as the reference plan's registry holds the store's
        jitted projections; a predict on the network itself, not strict,
        still runs the bare projection and leaves their counts alone."""
        from repro_torch.runtime import ServiceConfig

        ds, x, layout = dataset
        net = Network(seed=0)
        net.add(StructuralPlasticityLayer(layout, UnitLayout(4, 8), fan_in=16, lam=0.05,
                                          init_jitter=1.0, gain=4.0))
        net.add(StructuralPlasticityLayer(UnitLayout(4, 8), UnitLayout(2, 8), fan_in=2, lam=0.05,
                                          init_jitter=1.0, gain=4.0))
        net.add(DenseLayer(UnitLayout(2, 8), onehot_layout(10), lam=0.05))
        c = net.compile(ExecutionConfig(device="cpu"))
        c.fit((x, ds.y_train), **KW)
        svc = c.serve(ServiceConfig(plan="batched", max_batch=64, strict=True))
        a = svc.predict(x[:64])
        b = svc.predict(x[64:128])
        assert a.shape == b.shape == (64, 10)
        sizes = svc.plan._sentinel.sizes()
        assert sizes["proj[0->2]"] == 1, sizes  # level 2: the two hidden layers
        watched = c.activations.projections()
        before = {k: fn._cache_size() for k, fn in watched.items()}
        c.predict(x[:48], batch_size=48)  # a new shape, not strict
        assert {k: fn._cache_size() for k, fn in watched.items()} == before

    def test_batched_async_engine_strict_matches_plain(self, dataset):
        from repro_torch.runtime import ServiceConfig

        ds, x, layout = dataset
        outs = {}
        for strict in (False, True):
            c = _build_net(layout).compile(ExecutionConfig(device="cpu", strict=strict))
            c.fit((x, ds.y_train), **KW)
            svc = c.serve(ServiceConfig(plan="batched", buckets=(4, 16), max_batch=16,
                                        strict=strict))
            svc.start(run=False)
            futures = [svc.submit(row) for row in x[:40]]
            svc.start()
            outs[strict] = np.stack([f.result(timeout=60) for f in futures])
            svc.drain_and_stop()
        np.testing.assert_array_equal(outs[True], outs[False])

    def test_streaming_plan_strict_matches_plain(self, dataset):
        from repro_torch.runtime import ServiceConfig

        ds, x, layout = dataset
        got = {}
        for strict in (False, True):
            c = _build_net(layout).compile(ExecutionConfig(device="cpu", strict=strict))
            svc = c.serve(ServiceConfig(plan="streaming", max_batch=8, strict=strict))
            for r in range(2):
                for row in x[r * 16:(r + 1) * 16]:
                    svc.feed(row)
                svc.flush()
            infers = np.stack([svc.infer(row) for row in x[:4]])
            if strict:
                sizes = svc.plan._sentinel.sizes()
                assert sizes == {"stream_train[8]": 1, "stream_infer[1]": 1}, sizes
            got[strict] = (infers, svc.plan.session.close())
        np.testing.assert_array_equal(got[True][0], got[False][0])
        for a, b in zip(got[True][1].marginals, got[False][1].marginals):
            assert torch.equal(a, b)

    def test_full_continual_lifecycle_strict_clean(self, dataset):
        """The reference's ``TestStrictMode::test_full_lifecycle_strict_clean``:
        updates, merges and interleaved inference under strict, the tier's
        callables registered; the acks equal a plain twin's."""
        from repro_torch.runtime import ContinualConfig, Feedback, ServiceConfig

        ds, x, layout = dataset
        cc = ContinualConfig(update_batch=4, update_budget=16, merge_every=2, drift_window=16,
                             drift_min_samples=8, drift_threshold=0.4, merge_strategy="replace")
        acks = {}
        for strict in (False, True):
            c = _build_net(layout).compile(ExecutionConfig(device="cpu", strict=strict))
            c.fit((x, ds.y_train), epochs_hidden=2, epochs_readout=2, batch_size=64)
            plan = c.serve(ServiceConfig(strict=strict, continual=cc)).plan
            out = []
            for k in range(24):  # updates + merges + interleaved inference
                out.append(plan.learn(Feedback(x[k], int(ds.y_train[k]))))
                if k % 3 == 0:
                    out.append(plan.infer(x[k]).numpy())
            acks[strict] = out
        reg = plan._strict_registry()
        assert {"continual_update", "continual_view", "continual_prefix"} <= set(reg)
        assert any(n.startswith("continual_merge[") for n in reg)
        for a, b in zip(acks[True], acks[False]):
            if isinstance(a, dict):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)

    def test_rebaseline_lands_in_the_journal(self, dataset):
        from repro_torch.runtime import ServiceConfig, TraceConfig

        ds, x, layout = dataset
        c = _build_net(layout).compile(ExecutionConfig(device="cpu"))
        svc = c.serve(ServiceConfig(plan="batched", max_batch=8, strict=True,
                                    trace=TraceConfig()))
        svc.predict(x[:8])
        svc.plan._sentinel.rebaseline()
        (_, _, event), = svc.tracer.events("recompile_rebaseline")
        assert event.sizes["head"] == 1


# ------------------------------------------------- profile_dir, use_kernels
class TestProfileDir:
    def test_profile_dir_writes_a_chrome_trace(self, dataset, tmp_path):
        ds, x, layout = dataset
        c = _build_net(layout).compile(ExecutionConfig(device="cpu", profile_dir=str(tmp_path)))
        c.fit((x, ds.y_train), **KW)
        assert os.path.dirname(c.last_profile) == str(tmp_path)
        with open(c.last_profile) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("ph") == "X" for e in events)
        first = c.last_profile
        c.fit((x, ds.y_train), **KW)
        assert c.last_profile != first and os.path.exists(first)


class TestUseKernels:
    def test_bind_layer_does_not_mutate_the_declarative_layer(self, dataset):
        _, _, layout = dataset
        layer = StructuralPlasticityLayer(layout, UnitLayout(4, 8), fan_in=16)
        bound = ExecutionConfig(device="cpu", use_kernels=False).bind_layer(layer)
        assert bound is not layer
        assert bound.spec.use_kernels is False
        assert layer.spec.use_kernels is None  # the declarative layer is untouched
        assert ExecutionConfig(device="cpu").bind_layer(layer) is layer

    @pytest.mark.parametrize("precision", [None, "bf20"])
    def test_every_setting_runs_the_plain_versions_on_the_cpu(self, dataset, precision):
        """No kernel runs on the CPU: use_kernels None, True and False give
        the same fit bit for bit."""
        ds, x, layout = dataset
        states = []
        for use in (None, True, False):
            c = _build_net(layout).compile(
                ExecutionConfig(device="cpu", use_kernels=use, precision=precision))
            c.fit((x, ds.y_train), **KW)
            states.append(c.state)
        assert _states_equal(states[0], states[1]) and _states_equal(states[0], states[2])

    def test_plain_route_is_explicit_off_the_cpu(self):
        """With use_kernels=False a tensor off the CPU takes the plain version
        on its own device (meta stands in for the card here); without it,
        it goes to the kernel or raises."""
        meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
        out = ops.masked_matmul(meta(4, 6), meta(6, 8), meta(8), use_kernels=False)
        assert out.device.type == "meta" and tuple(out.shape) == (4, 8)
        assert ops.hcu_softmax(meta(4, 8), 2, 4, use_kernels=False).device.type == "meta"
        with pytest.raises(ValueError, match="no kernel for tensors on meta"):
            ops.masked_matmul(meta(4, 6), meta(6, 8), meta(8))
        with pytest.raises(ValueError, match="several devices"):
            ops.masked_matmul(torch.ones(4, 6), meta(6, 8), None, use_kernels=False)


# ------------------------------------------ parity with the JAX package
def _jflat(layer_states):
    tree = {"layers": {str(i): s for i, s in enumerate(layer_states)}}
    return {
        path_key(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def test_strict_fit_matches_the_reference_strict_fit():
    """The port's strict fit from the JAX-initialised state, against the
    JAX package's ``ExecutionConfig(strict=True)`` fit on the same numpy
    data, at the whole-fit parity tolerance of the network tests."""
    ds = mnist_like(n_train=256, n_test=100, n_features=12, seed=0)
    x, _ = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    kw = dict(fan_in=6, lam=0.05, gain=4.0, init_jitter=1.0)
    fit_kw = dict(epochs_hidden=2, epochs_readout=2, batch_size=32)
    jnet = JNetwork(seed=0)
    jnet.add(JPlastic(JUnitLayout(12, 2), JUnitLayout(4, 8), **kw))
    jnet.add(JDense(JUnitLayout(4, 8), jonehot(10), lam=0.05))
    jc = jnet.compile(JExecutionConfig(engine="scan", strict=True))
    init = _jflat(jc.state.layers)
    jc.fit((x, ds.y_train), **fit_kw)
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(UnitLayout(12, 2), UnitLayout(4, 8), **kw))
    net.add(DenseLayer(UnitLayout(4, 8), onehot_layout(10), lam=0.05))
    c = net.compile(ExecutionConfig(device="cpu", strict=True))
    c.state = network_state_from_flat(init, c.layers)
    c.fit((x, ds.y_train), **fit_kw)
    port = flat_from_network_state(c.state)
    want = _jflat(jc.state.layers)
    assert sorted(port) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(port[k], np.asarray(v, np.float32), rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=k)
    # Predict on the training rows: both networks hit their cached
    # projection.  A dataset of another size would meet the projection at a
    # new shape after its baseline, which both packages' sentinels refuse.
    np.testing.assert_allclose(c.predict(x).numpy(), np.asarray(jc.predict(x)),
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    assert all(v <= 1 for v in c._sentinel.sizes().values())
    with pytest.raises(RecompileError, match="proj"):
        c.predict(xt)
    with pytest.raises(Exception, match="proj_scan"):
        jc.predict(xt)
