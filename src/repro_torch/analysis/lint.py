"""torchlint: the port's static analysis of its hot paths (the hot-path
guard, static side).

The port's value is that the BCPNN hot loops only enqueue work for the
card, and the failure modes that silently regress that are not syntax
errors: a host sync in an epoch loop or a serving dispatch, a kernel build
or a launch plan made afresh in a loop, a Python mutable reaching a cache
key or a compiled function's closure, an unlocked write to state the async
engine's executor thread shares.  This module is a pure-AST lint pass
(stdlib only: it imports neither torch nor numpy, so it runs anywhere)
with three repo-specific rules, the JAX package's ``repro/analysis/lint.py``
in torch terms:

TL001  host sync in compiled code or a hot module: ``.item()``,
       ``.cpu()``, ``.tolist()``, ``.numpy()``, ``.nonzero()``,
       ``.synchronize()``, ``.to("cpu")``, ``torch.cuda.synchronize``,
       ``torch.nonzero`` / ``torch.unique`` / ``torch.masked_select``, and
       ``float()`` / ``int()`` / ``bool()`` or ``np.asarray`` /
       ``np.array`` of a tensor are flagged (a) inside any function passed
       to ``torch.compile`` / ``torch.jit`` / ``torch.func`` transforms or
       decorated with them, and inside a ``with torch.cuda.graph(...)``
       capture, where they break the capture or sync per call, and (b)
       ANYWHERE in the designated hot modules (:data:`DEFAULT_HOT_MODULES`),
       so every host sync in the training and serving dispatch loops is
       removed or carries a waiver saying why it is load-bearing.  A tensor
       is recognised by a mention of ``torch`` in the argument (outside
       compiled code, where every non-static cast counts).
TL003  recompile hazards: a kernel library build (``_build.build_all`` /
       ``_build.function``, ``cpp_extension.load``), a launch-plan
       construction (``plan(...)``), a ``torch.cuda.CUDAGraph`` / graph
       capture or a ``torch.compile`` made inside a loop (a new plan,
       library, graph or compile cache each iteration); an unhashable
       literal (list/dict/set) passed to an ``lru_cache``d function of the
       module (it reaches the cache key and raises, or misses every call);
       a compiled function closing over an enclosing scope's mutable
       literal (a mutation re-guards and recompiles).
TL004  unlocked shared-state mutation: in a class that owns a
       ``threading.Lock`` / ``RLock`` / ``Condition``, any write to a
       ``self.*`` attribute outside ``__init__`` that is not lexically under
       ``with self.<lock>:``, the discipline ``repro_torch.runtime.metrics``
       follows, enforced everywhere the async engine's executor thread (or
       the Router's scheduler thread) can race a caller thread.  A class
       whose lock arrives indirectly (a constructor parameter, a shared
       bundle lock) registers it with a class attribute so coverage never
       silently lapses::

           class Counter:
               _TORCHLINT_LOCKS = ("_lock",)   # TL004 registration
               def __init__(self, lock=None):
                   self._lock = lock if lock is not None else threading.Lock()

       Methods named ``*_locked`` are exempt: the suffix is a naming
       contract (the CPython convention) that the CALLER holds the lock,
       the ``with`` block one frame up where a lexical check cannot see it.

The JAX package's JL002 (a buffer read after ``donate_argnums`` donated
it) has no counterpart: torch has no donation.  The port's ``donate=``
(``runtime/plans.py`` ``ScanPlan._stack``) reuses one epoch stack buffer
that only the plan holds; the next epoch's copy into it is enqueued on the
same stream after the previous epoch's kernels, so stream order makes the
reuse safe and no caller can read a buffer after it is reused.

Waivers
-------
The ONLY suppression mechanism is an inline waiver comment with a reason::

    first = int(torch.argmax(logits[0]))  # torchlint: allow[TL001] reason=steers admission

A waiver on its own line covers the next code line; several rules may be
listed (``allow[TL001,TL004]``).  A waiver without a reason, and a waiver
that matches no finding, are themselves findings (TL000): waivers never rot.

CLI: ``tools/torchlint [paths...]`` (or ``python -m repro_torch.analysis.lint``);
exits non-zero when findings remain.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import io
import os
import re
import sys
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES = {
    "TL000": "malformed or unused waiver",
    "TL001": "host sync on a hot path",
    "TL003": "recompile hazard",
    "TL004": "unlocked shared-state mutation",
}

# Modules whose WHOLE body is a hot path: every host sync here must be
# deliberate, so TL001 applies module-wide (not just inside compiled code).
# The JAX package's list (repro/analysis/lint.py), under repro_torch.
DEFAULT_HOT_MODULES: Tuple[str, ...] = (
    "repro_torch/runtime/service.py",
    "repro_torch/runtime/engine.py",
    "repro_torch/runtime/router.py",
    "repro_torch/runtime/continual.py",
    "repro_torch/runtime/trace.py",
    "repro_torch/runtime/export.py",
    "repro_torch/runtime/plans.py",
    "repro_torch/runtime/epoch_engine.py",
    "repro_torch/runtime/program.py",
    "repro_torch/core/compiled.py",
    "repro_torch/kernels/ops.py",
    "repro_torch/kernels/bcpnn_phase.py",
    # The LM zoo's decode step (captured in a CUDA graph on the card).
    "repro_torch/models/lm.py",
    "repro_torch/models/attention.py",
    "repro_torch/models/moe.py",
    "repro_torch/models/ssm.py",
)

# Dotted-call suffixes that compile or transform; their first positional
# argument runs as compiled code.
_TRACE_WRAPPERS = {
    "torch.compile",
    "torch.jit.script", "torch.jit.trace",
    "torch.vmap", "torch.func.vmap", "func.vmap",
    "torch.func.grad", "torch.func.grad_and_value",
    "torch.func.jacrev", "torch.func.jacfwd",
    "torch.cuda.make_graphed_callables",
}
# Context managers whose block is captured (a CUDA graph capture).
_CAPTURES = {"torch.cuda.graph"}

# Host-sync calls (TL001).
_SYNC_DOTTED = {
    "torch.cuda.synchronize", "cuda.synchronize",
    "torch.nonzero", "torch.unique", "torch.masked_select",
}
_NUMPY_CONVERT = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu", "nonzero", "synchronize"}
_CAST_BUILTINS = {"float", "int", "bool"}

# Recompile hazards when made inside a loop (TL003).
_BUILDERS = _TRACE_WRAPPERS | {
    "torch.cuda.CUDAGraph", "torch.cuda.graph",
    "build_all", "_build.build_all", "_build.function",
    "cpp_extension.load", "cpp_extension.load_inline",
    "plan",
}
_CACHE_DECORATORS = {"functools.lru_cache", "lru_cache", "functools.cache", "cache"}

_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
}

_MUTABLE_LITERALS = (
    ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp,
)

_WAIVER_RE = re.compile(
    r"#\s*torchlint:\s*allow\[([A-Za-z0-9,\s]+)\]\s*(?:reason=(.+))?$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclasses.dataclass
class _Waiver:
    line: int          # comment's own line
    covers: Set[int]   # code lines the waiver applies to
    rules: Set[str]
    reason: str
    used: bool = False


# --------------------------------------------------------------------------
# Small AST helpers.
# --------------------------------------------------------------------------
def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _matches(dotted: Optional[str], suffixes: Set[str]) -> bool:
    if dotted is None:
        return False
    return dotted in suffixes or any(
        dotted.endswith("." + s) for s in suffixes
    )


def _trace_call(call: ast.Call) -> Optional[ast.Call]:
    """The compile/transform call underlying ``call``: the direct form and
    ``functools.partial(torch.compile, ...)``."""
    dotted = _dotted(call.func)
    if _matches(dotted, _TRACE_WRAPPERS):
        return call
    if _matches(dotted, {"functools.partial", "partial"}) and call.args:
        inner = _dotted(call.args[0])
        if _matches(inner, _TRACE_WRAPPERS):
            return call
    return None


def _mentions_torch(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id in ("torch", "F")
        for n in ast.walk(node)
    )


_DTYPES = {
    "float32", "float", "float16", "half", "bfloat16", "float64", "double",
    "int8", "int16", "int32", "int64", "long", "uint8", "bool",
}


def _static_looking(node: ast.AST) -> bool:
    """Casts of shapes/lengths/constants/dtype tests are static: skip."""
    if isinstance(node, ast.Constant):
        return True
    torch_attrs = [
        n for n in ast.walk(node)
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) and n.value.id == "torch"
    ]
    if torch_attrs and all(n.attr in _DTYPES for n in torch_attrs) and not any(
        isinstance(n, ast.Call) for n in ast.walk(node)
    ):
        return True
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in ("shape", "ndim", "dtype"):
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == "len":
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr in (
            "numel", "dim", "size", "element_size", "stride",
        ):
            return True
    return False


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device("cpu"))``."""
    for a in call.args[:1] + [kw.value for kw in call.keywords if kw.arg == "device"]:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (isinstance(a, ast.Call) and _matches(_dotted(a.func), {"torch.device"})
                and a.args and isinstance(a.args[0], ast.Constant) and a.args[0].value == "cpu"):
            return True
    return False


class _Parents(ast.NodeVisitor):
    """parent map + per-node enclosing statement."""

    def __init__(self, tree: ast.AST):
        self.parent: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        while node in self.parent:
            node = self.parent[node]
            yield node


# --------------------------------------------------------------------------
# The per-file linter.
# --------------------------------------------------------------------------
class _FileLint:
    def __init__(self, src: str, path: str, hot: Sequence[str]):
        self.src = src
        self.path = path
        self.findings: List[Finding] = []
        self.tree = ast.parse(src, filename=path)
        self.parents = _Parents(self.tree)
        norm = path.replace(os.sep, "/")
        self.is_hot = any(norm.endswith(h) for h in hot)
        self.waivers = self._parse_waivers(src)

    # ------------------------------------------------------------- waivers
    def _parse_waivers(self, src: str) -> List[_Waiver]:
        waivers: List[_Waiver] = []
        code_tokens_on: Set[int] = set()
        comments: List[Tuple[int, str]] = []
        try:
            for tok in tokenize.generate_tokens(io.StringIO(src).readline):
                if tok.type == tokenize.COMMENT:
                    comments.append((tok.start[0], tok.string))
                elif tok.type not in (
                    tokenize.NL, tokenize.NEWLINE, tokenize.INDENT,
                    tokenize.DEDENT, tokenize.ENCODING, tokenize.ENDMARKER,
                ):
                    for ln in range(tok.start[0], tok.end[0] + 1):
                        code_tokens_on.add(ln)
        except tokenize.TokenError:
            return waivers
        for line, text in comments:
            m = _WAIVER_RE.search(text)
            if m is None:
                if re.search(r"torchlint\s*:", text):
                    self._emit("TL000", line, 0,
                               "unparseable torchlint comment (want "
                               "'# torchlint: allow[TLxxx] reason=...')")
                continue
            rules = {r.strip().upper() for r in m.group(1).split(",") if r.strip()}
            reason = (m.group(2) or "").strip()
            bad = rules - set(RULES)
            if bad:
                self._emit("TL000", line, 0,
                           f"waiver names unknown rule(s) {sorted(bad)}")
                continue
            if not reason:
                self._emit("TL000", line, 0,
                           "waiver without a reason= — document why the "
                           "sync/mutation is load-bearing")
                continue
            covers = {line}
            if line not in code_tokens_on:  # comment-only line: covers next
                covers.add(line + 1)
            waivers.append(_Waiver(line, covers, rules, reason))
        return waivers

    def _emit(self, rule: str, line: int, col: int, message: str) -> None:
        self.findings.append(Finding(self.path, line, col, rule, message))

    # ---------------------------------------------------------------- run
    def run(self) -> List[Finding]:
        traced = self._traced_regions()
        self._check_sync_calls(traced)
        self._check_builders_in_loops()
        self._check_cache_keys()
        self._check_closure_mutables(traced)
        self._check_lock_discipline()
        return self._apply_waivers()

    def _apply_waivers(self) -> List[Finding]:
        kept: List[Finding] = []
        for f in self.findings:
            if f.rule == "TL000":
                kept.append(f)
                continue
            waived = False
            for w in self.waivers:
                if f.line in w.covers and f.rule in w.rules:
                    w.used = True
                    waived = True
                    break
            if not waived:
                kept.append(f)
        for w in self.waivers:
            if not w.used:
                kept.append(Finding(
                    self.path, w.line, 0, "TL000",
                    f"waiver allow[{','.join(sorted(w.rules))}] matches no "
                    "finding — delete it",
                ))
        kept.sort(key=lambda f: (f.line, f.col, f.rule))
        return kept

    # ---------------------------------------------------- compiled regions
    def _traced_regions(self) -> Set[ast.AST]:
        """Function nodes (def/lambda) that run compiled, and the ``with``
        blocks of CUDA graph captures."""
        traced: Set[ast.AST] = set()

        def resolve_name(name: str, from_node: ast.AST) -> Optional[ast.AST]:
            # Nearest enclosing scope defining a function with this name.
            scopes = [self.tree] + [
                a for a in self.parents.ancestors(from_node)
                if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
            ]
            for scope in scopes:
                for child in ast.walk(scope):
                    if (isinstance(child, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                            and child.name == name):
                        return child
            return None

        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and _trace_call(node) is not None:
                args = node.args
                # partial(torch.compile, f, ...) puts the fn at index 1.
                if _matches(_dotted(node.func), {"functools.partial", "partial"}):
                    args = node.args[1:]
                if not args:
                    continue
                fn = args[0]
                if isinstance(fn, ast.Lambda):
                    traced.add(fn)
                elif isinstance(fn, (ast.Name, ast.Attribute)):
                    name = fn.id if isinstance(fn, ast.Name) else fn.attr
                    target = resolve_name(name, node)
                    if target is not None:
                        traced.add(target)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    d = dec.func if isinstance(dec, ast.Call) else dec
                    if _matches(_dotted(d), _TRACE_WRAPPERS) or (
                        isinstance(dec, ast.Call)
                        and _trace_call(dec) is not None
                    ):
                        traced.add(node)
            elif isinstance(node, ast.With):
                for item in node.items:
                    e = item.context_expr
                    if isinstance(e, ast.Call) and _matches(_dotted(e.func), _CAPTURES):
                        traced.add(node)
        return traced

    def _in_traced(self, node: ast.AST, traced: Set[ast.AST]) -> bool:
        if node in traced:
            return True
        return any(a in traced for a in self.parents.ancestors(node))

    # ------------------------------------------------------------- TL001
    def _check_sync_calls(self, traced: Set[ast.AST]) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            in_trace = self._in_traced(node, traced)
            if not in_trace and not self.is_hot:
                continue
            where = (
                "inside compiled code (breaks the capture or syncs per call)"
                if in_trace else "on a hot-path module"
            )
            dotted = _dotted(node.func)
            if _matches(dotted, _SYNC_DOTTED):
                self._emit("TL001", node.lineno, node.col_offset,
                           f"host sync `{dotted}` {where}")
                continue
            if _matches(dotted, _NUMPY_CONVERT):
                if node.args and (in_trace or _mentions_torch(node.args[0])):
                    self._emit("TL001", node.lineno, node.col_offset,
                               f"`{dotted}` of a tensor {where}")
                continue
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in _SYNC_METHODS and not node.args:
                    self._emit("TL001", node.lineno, node.col_offset,
                               f"host sync `.{attr}()` {where}")
                    continue
                if attr == "to" and _to_cpu(node):
                    self._emit("TL001", node.lineno, node.col_offset,
                               f"host sync `.to(\"cpu\")` {where}")
                    continue
            if (isinstance(node.func, ast.Name)
                    and node.func.id in _CAST_BUILTINS
                    and len(node.args) == 1):
                arg = node.args[0]
                if _static_looking(arg):
                    continue
                # In a hot module (but outside compiled code) only casts of
                # torch-valued expressions: host bookkeeping ints are fine.
                if in_trace or _mentions_torch(arg):
                    self._emit(
                        "TL001", node.lineno, node.col_offset,
                        f"`{node.func.id}()` of a tensor {where}",
                    )

    # ------------------------------------------------------------- TL003
    def _check_builders_in_loops(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if not _matches(dotted, _BUILDERS):
                continue
            for anc in self.parents.ancestors(node):
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)):
                    break  # loops outside the defining function don't apply
                if isinstance(anc, (ast.For, ast.While)):
                    self._emit(
                        "TL003", node.lineno, node.col_offset,
                        f"`{dotted}` made inside a loop — a new kernel build, "
                        "launch plan, graph or compile cache every iteration "
                        "(hoist it)",
                    )
                    break

    def _check_cache_keys(self) -> None:
        cached: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    d = dec.func if isinstance(dec, ast.Call) else dec
                    if _matches(_dotted(d), _CACHE_DECORATORS):
                        cached.add(node.name)
        if not cached:
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            name = dotted.rsplit(".", 1)[-1] if dotted else None
            if name not in cached:
                continue
            values = list(node.args) + [kw.value for kw in node.keywords]
            if any(isinstance(v, _MUTABLE_LITERALS) for v in values):
                self._emit(
                    "TL003", node.lineno, node.col_offset,
                    f"unhashable literal reaches the cache key of `{name}` — "
                    "every call raises or misses the cache",
                )

    def _check_closure_mutables(self, traced: Set[ast.AST]) -> None:
        for fn in traced:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                continue
            enclosing = next(
                (a for a in self.parents.ancestors(fn)
                 if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))),
                None,
            )
            if enclosing is None:
                continue
            bound = self._bound_names(fn)
            free = {
                n.id for n in ast.walk(fn)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                and n.id not in bound
            }
            for stmt in ast.walk(enclosing):
                if not isinstance(stmt, ast.Assign):
                    continue
                if not isinstance(stmt.value, _MUTABLE_LITERALS):
                    continue
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and t.id in free:
                        self._emit(
                            "TL003", fn.lineno, fn.col_offset,
                            f"compiled function closes over mutable `{t.id}` "
                            f"(bound line {stmt.lineno}) — a mutation re-guards "
                            "and recompiles it",
                        )

    @staticmethod
    def _bound_names(fn: ast.AST) -> Set[str]:
        bound: Set[str] = set()
        args = fn.args
        for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        ):
            bound.add(a.arg)
        if args.vararg:
            bound.add(args.vararg.arg)
        if args.kwarg:
            bound.add(args.kwarg.arg)
        for n in ast.walk(fn):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                bound.add(n.id)
            elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                bound.add(n.name)
        return bound

    # ------------------------------------------------------------- TL004
    def _check_lock_discipline(self) -> None:
        classes = {
            n.name: n for n in ast.walk(self.tree)
            if isinstance(n, ast.ClassDef)
        }
        lock_attrs: Dict[str, Set[str]] = {}

        def own_locks(cls: ast.ClassDef) -> Set[str]:
            attrs: Set[str] = set()
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                # Explicit registration: `_TORCHLINT_LOCKS = ("_lock", ...)`
                # as a class attribute, for locks that arrive indirectly (a
                # constructor parameter, a bundle-shared lock) where no
                # factory call is visible to the pattern below.
                if (len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == "_TORCHLINT_LOCKS"
                        and isinstance(node.value, (ast.Tuple, ast.List))):
                    for e in node.value.elts:
                        if isinstance(e, ast.Constant) and isinstance(
                            e.value, str
                        ):
                            attrs.add(e.value)
                    continue
                if not (isinstance(node.value, ast.Call)
                        and _matches(_dotted(node.value.func), _LOCK_FACTORIES)):
                    continue
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        attrs.add(t.attr)
            return attrs

        def all_locks(name: str, seen: Set[str]) -> Set[str]:
            if name in lock_attrs:
                return lock_attrs[name]
            if name in seen or name not in classes:
                return set()
            seen.add(name)
            cls = classes[name]
            attrs = set(own_locks(cls))
            for base in cls.bases:
                if isinstance(base, ast.Name):
                    attrs |= all_locks(base.id, seen)
            lock_attrs[name] = attrs
            return attrs

        for name, cls in classes.items():
            locks = all_locks(name, set())
            if not locks:
                continue
            for method in cls.body:
                if not isinstance(method, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                    continue
                if method.name in ("__init__", "__new__"):
                    continue
                if method.name.endswith("_locked"):
                    # Naming contract: a `*_locked` method documents that
                    # its CALLER holds the lock (the CPython convention);
                    # the with-block lives one frame up where the linter
                    # cannot see it.
                    continue
                self._check_method_writes(method, locks)

    def _check_method_writes(self, method: ast.AST, locks: Set[str]) -> None:
        for node in ast.walk(method):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            else:
                continue
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                if t.attr in locks:
                    continue
                if self._under_lock(node, locks):
                    continue
                self._emit(
                    "TL004", node.lineno, node.col_offset,
                    f"write to `self.{t.attr}` outside `with self."
                    f"{'/'.join(sorted(locks))}` in a lock-owning class — "
                    "the executor thread can race this",
                )

    def _under_lock(self, node: ast.AST, locks: Set[str]) -> bool:
        for anc in self.parents.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    e = item.context_expr
                    if (isinstance(e, ast.Attribute)
                            and isinstance(e.value, ast.Name)
                            and e.value.id == "self" and e.attr in locks):
                        return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
        return False


# --------------------------------------------------------------------------
# Public API + CLI.
# --------------------------------------------------------------------------
def lint_source(
    src: str, path: str = "<string>",
    hot: Sequence[str] = DEFAULT_HOT_MODULES,
) -> List[Finding]:
    """Lint one source string; ``path`` decides hot-module status."""
    try:
        return _FileLint(src, path, hot).run()
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, e.offset or 0, "TL000",
                        f"syntax error: {e.msg}")]


def lint_paths(
    paths: Sequence[str], hot: Sequence[str] = DEFAULT_HOT_MODULES,
) -> List[Finding]:
    """Lint files and directory trees (``*.py``)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files.extend(
                    os.path.join(root, n) for n in names if n.endswith(".py")
                )
        else:
            files.append(p)
    findings: List[Finding] = []
    for f in sorted(files):
        with open(f, encoding="utf-8") as fh:
            findings.extend(lint_source(fh.read(), f, hot))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torchlint", description="the port's static analysis of its hot paths"
    )
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument(
        "--hot", action="append", default=None,
        help="extra hot-path module suffix (repeatable); defaults to the "
        "serving/training dispatch modules",
    )
    args = ap.parse_args(argv)
    hot = list(DEFAULT_HOT_MODULES) + (args.hot or [])
    findings = lint_paths(args.paths, hot=hot)
    for f in findings:
        print(f.render())
    if findings:
        print(f"torchlint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
