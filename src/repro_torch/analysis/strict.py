"""Strict runtime verification: the dynamic side of the hot-path guard.

torchlint (:mod:`repro_torch.analysis.lint`) shows statically that no host
sync sits on a hot path; this module checks at run time what the lint
cannot see: that a guarded dispatch (an epoch, a projection chunk, a
serving head, a decode step) makes no host synchronisation and is handed
no tensor off the network's device, that no watched callable is dispatched
with a new input signature after its baseline (the port's counterpart of
a retrace), and that the BCPNN traces and weights stay finite.
``ExecutionConfig(strict=True)`` / ``ServiceConfig(strict=True)`` turn all
three on.  Everything here observes: a strict run's results are bit for
bit those of the same run without it.

Three failure classes, three exceptions (all :class:`StrictViolation`):

* :class:`HostTransferError`: inside :func:`dispatch_guard`, a
  synchronising CUDA operation (a ``.item()``, a ``.cpu()``, a blocking
  host-to-device copy, a boolean-mask index) ran in the guarded thread, or
  a leaf handed to the dispatch is a numpy array or a tensor on another
  device.  On a CUDA network that leaf would otherwise run the kernels'
  plain versions on the CPU, or fail deep in a kernel wrapper.
* :class:`RecompileError`: a watched callable (a :class:`Counted` wrapper)
  met a new input signature after its baseline, or a kernel launch inside
  it used a launch plan or library build it had not used before.
* :class:`NonFiniteError`: a NaN or Inf in a state tree, named by the
  leaf's path and the place of the check.
"""
from __future__ import annotations

import contextlib
import re
import threading
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build


class StrictViolation(RuntimeError):
    """Base class for every strict-mode failure."""


class HostTransferError(StrictViolation):
    """A host synchronisation or an off-device leaf inside a guarded dispatch."""


class RecompileError(StrictViolation):
    """A watched callable met a new input signature after its baseline."""


class NonFiniteError(StrictViolation):
    """NaN/Inf detected in a guarded state tree."""


# ------------------------------------------------------------------ trees
def walk(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for every tensor and numpy leaf of ``tree``, with
    paths in the JAX package's ``keystr`` style: ``.field`` for a
    NamedTuple, ``['key']`` for a dict, ``[i]`` for a list or tuple."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, value in zip(tree._fields, tree):
            yield from walk(value, f"{path}.{name}")
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from walk(value, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from walk(value, f"{path}[{i}]")


def signature(tree: Any) -> Any:
    """The hashable input signature of ``tree``: each tensor's shape,
    dtype and device, each numpy array's shape and dtype, the structure of
    NamedTuples, tuples, lists and dicts, and the type of every other
    leaf.  Python numbers count by type, never by value (a step counter's
    host mirror changes every call), as JAX traces a number inside a
    pytree; strings count by value."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, np.ndarray):
        return ("ndarray", tree.shape, tree.dtype.str)
    if isinstance(tree, dict):
        return ("dict", tuple((k, signature(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(signature(v) for v in tree))
    if isinstance(tree, str):
        return ("str", tree)
    return type(tree).__name__


# --------------------------------------------------------------- transfers
SYNC_MESSAGE = "called a synchronizing CUDA operation"
_SYNC_FILTER = ("always", re.compile(re.escape(SYNC_MESSAGE), re.I), Warning, None, 0)


class _Guards(threading.local):
    """This thread's open guards and the violation its hook saw last."""

    def __init__(self):
        self.depth = 0
        self.violation: Optional[str] = None


_local = _Guards()
# The sync debug mode is one setting of the process, so the guard keeps one
# count of the CUDA guards open in any thread: the first sets the mode to
# "warn", the last restores the mode it found.  The verdict is per thread:
# the warnings hook raises only in a thread with a guard open.
_mode_lock = threading.Lock()
_cuda_guards = 0
_saved_mode: Optional[int] = None
_next_showwarnmsg: Optional[Callable] = None


def _showwarnmsg(msg) -> None:
    """``warnings._showwarnmsg`` while the guard is installed: a sync
    warning in a guarded thread becomes a HostTransferError; one in
    another thread is dropped unless the caller had asked for sync
    warnings themselves; every other warning passes on."""
    text = str(msg.message)
    if text.startswith(SYNC_MESSAGE):
        if _local.depth > 0:
            _local.violation = text
            raise HostTransferError(
                f"host synchronisation inside a guarded dispatch: {text} (a .item(), "
                ".cpu(), .tolist(), a blocking host-to-device copy or a boolean-mask "
                "index); stage inputs before the guard and read results back after it"
            )
        if _saved_mode == 0 and (_cuda_guards > 0 or _mode_now() == 0):
            return  # the "warn" mode was the guard's, not the caller's
    _next_showwarnmsg(msg)


def _mode_now() -> int:
    """The sync debug mode now (a warning reaches Python when its op
    returns, after the guard that set the mode may have closed)."""
    return torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else 0


def _install_hook() -> None:
    """Route warnings through :func:`_showwarnmsg` and show every sync
    warning (a once-per-place filter would hide the second one)."""
    global _next_showwarnmsg
    if warnings._showwarnmsg is not _showwarnmsg:
        _next_showwarnmsg = warnings._showwarnmsg
        warnings._showwarnmsg = _showwarnmsg
    if not warnings.filters or warnings.filters[0] != _SYNC_FILTER:
        warnings.filterwarnings("always", message=re.escape(SYNC_MESSAGE), category=Warning)


def _enter(cuda: bool) -> None:
    global _cuda_guards, _saved_mode
    with _mode_lock:
        _install_hook()
        if cuda:
            if _cuda_guards == 0:
                _saved_mode = torch.cuda.get_sync_debug_mode()
                if _saved_mode == 0:
                    torch.cuda.set_sync_debug_mode("warn")
            _cuda_guards += 1
    _local.depth += 1


def _exit(cuda: bool) -> None:
    global _cuda_guards
    _local.depth -= 1
    if cuda:
        with _mode_lock:
            _cuda_guards -= 1
            if _cuda_guards == 0 and _saved_mode == 0:
                torch.cuda.set_sync_debug_mode(0)


def check_leaves(leaves: Dict[str, Any], device: Optional[torch.device]) -> None:
    """Raise HostTransferError naming the first numpy leaf, or the first
    tensor leaf off ``device`` (any device when it is None)."""
    for name, tree in leaves.items():
        for path, leaf in walk(tree, name):
            if isinstance(leaf, np.ndarray):
                raise HostTransferError(
                    f"{path}: a host numpy array {leaf.shape} handed to a guarded "
                    f"dispatch on {device}; stage it with an explicit copy first"
                )
            if device is not None and not _same_device(leaf.device, device):
                raise HostTransferError(
                    f"{path}: a tensor on {leaf.device} handed to a guarded "
                    f"dispatch on {device}; the kernels would not run on it"
                )


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


@contextlib.contextmanager
def dispatch_guard(
    enabled: bool = True, device=None, leaves: Optional[Dict[str, Any]] = None
) -> Iterator[None]:
    """Guard one dispatch: ``leaves`` (name -> tree) must be tensors on
    ``device``, and the guarded thread may not synchronise with the card.

    On a CUDA ``device`` the block runs under
    ``torch.cuda.set_sync_debug_mode("warn")`` with a warnings hook that
    raises :class:`HostTransferError` in this thread only, so a caller
    thread reading results back while an engine's thread dispatches is
    untouched; nested and concurrent guards restore the mode the first one
    found.  Wrap exactly the dispatch: stage inputs before the ``with``,
    read results back after it.  ``enabled=False`` is a no-op."""
    if not enabled:
        yield
        return
    dev = torch.device(device) if device is not None else None
    if leaves:
        check_leaves(leaves, dev)
    cuda = dev is not None and dev.type == "cuda"
    _enter(cuda)
    _local.violation = None
    try:
        yield
    except RuntimeError as e:
        _local.violation = None
        if isinstance(e, StrictViolation) or SYNC_MESSAGE not in str(e):
            raise
        raise HostTransferError(f"host synchronisation inside a guarded dispatch: {e}") from e
    finally:
        _exit(cuda)
    if _local.violation is not None:  # the hook raised, and torch swallowed it
        seen, _local.violation = _local.violation, None
        raise HostTransferError(f"host synchronisation inside a guarded dispatch: {seen}")


# -------------------------------------------------------------- recompiles
class Counted:
    """A callable with a trace-cache size: the number of distinct input
    signatures (:func:`signature`) it has been called with, JAX's
    ``_cache_size()`` in torch terms.  While it runs, the kernel launches
    made in its thread report to it (``kernels/_build.py:record``) the
    launch plans (``<kernel>.plan``, keyed by shape) and the library build
    (``kernels.build``) they used, so a plan built for a new shape, or a
    library loaded anew, is charged to the callable, and so to the network
    or service that owns it, whichever other network shares the process's
    plan caches."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._signatures: set = set()
        self._kernels: Dict[str, set] = {}

    def __call__(self, *args, **kwargs):
        self._signatures.add(signature((args, kwargs)))
        with _build.running(self):
            return self.fn(*args, **kwargs)

    def note(self, kind: str, key) -> None:
        self._kernels.setdefault(kind, set()).add(key)

    def _cache_size(self) -> int:
        return len(self._signatures)

    def kernel_sizes(self) -> Dict[str, int]:
        """Distinct launch plans and builds per kind used inside this callable."""
        return {kind: len(keys) for kind, keys in self._kernels.items()}


def counted(fn: Callable, enabled: bool = True) -> Callable:
    """``fn`` wrapped in :class:`Counted`, or ``fn`` itself when not
    ``enabled`` (strict off costs nothing per call)."""
    return Counted(fn) if enabled else fn


class RecompileSentinel:
    """Tracks the trace-cache sizes of watched callables and raises on
    growth past their baselines.

    ``watch(name, fn)`` is idempotent and cheap: call it with the current
    callable every time (registries grow: new layers, new prefill buckets,
    replaced epoch closures).  A replaced callable re-baselines; the same
    one growing raises :class:`RecompileError` at the next ``check()``.
    A :class:`Counted` callable also reports ``name>kind`` entries, its
    launch plans and builds per kind.  Baselines are taken at the first
    ``check()`` that sees an entry at 1 or more, so warm-up never counts.
    """

    def __init__(self) -> None:
        self._watched: Dict[str, Tuple[int, Any]] = {}  # name -> (id(fn), fn)
        self._baselines: Dict[str, int] = {}  # entry -> baseline size
        # Observability hook: called with the adopted sizes() after every
        # intentional rebaseline.  A tracing plan binds it (this module
        # does not import the trace module).
        self.on_rebaseline: Optional[Callable[[Dict[str, int]], None]] = None

    def watch(self, name: str, fn: Any) -> None:
        if fn is None or not hasattr(fn, "_cache_size"):
            return
        prev = self._watched.get(name)
        if prev is not None and prev[0] == id(fn):
            return
        self._watched[name] = (id(fn), fn)
        for entry in [e for e in self._baselines if e == name or e.startswith(name + ">")]:
            del self._baselines[entry]

    def watch_all(self, fns: Dict[str, Any], prefix: str = "") -> None:
        for name, fn in fns.items():
            self.watch(f"{prefix}{name}", fn)

    def sizes(self) -> Dict[str, int]:
        """Current sizes of every watched callable and its kernel entries."""
        out: Dict[str, int] = {}
        for name, (_, fn) in self._watched.items():
            out[name] = fn._cache_size()
            kernel_sizes = getattr(fn, "kernel_sizes", None)
            if kernel_sizes is not None:
                for kind, n in kernel_sizes().items():
                    out[f"{name}>{kind}"] = n
        return out

    def check(self, where: str = "") -> None:
        """Baseline the unbaselined warm entries; raise on growth."""
        for entry, size in self.sizes().items():
            baseline = self._baselines.get(entry)
            if baseline is None:
                if size >= 1:
                    self._baselines[entry] = size
                continue
            if size > baseline:
                ctx = f" during {where}" if where else ""
                raise RecompileError(
                    f"watched callable {entry!r} re-traced{ctx}: its cache grew "
                    f"{baseline} -> {size}.  A new input shape, dtype or structure (or, "
                    "after '>', a new kernel launch plan or library build) reached a "
                    "hot-path callable that is supposed to compile exactly once."
                )

    def rebaseline(self) -> None:
        """Adopt the current sizes as the new baselines (after an
        intentional shape change, e.g. reconfiguring a service)."""
        sizes = self.sizes()
        self._baselines = {entry: n for entry, n in sizes.items() if n >= 1}
        if self.on_rebaseline is not None:
            self.on_rebaseline(sizes)


# ------------------------------------------------------------ finite guard
def finite_checker() -> Callable:
    """A reusable finite-value guard over state trees.

    Returns ``check(tree, where="...")``: one ``isfinite(...).all()`` per
    floating leaf, stacked on the device, and one scalar read back (the
    index of the first bad leaf, or -1), so a clean state costs one small
    read.  Call it outside every guard: the read back synchronises.  It
    raises :class:`NonFiniteError` naming the leaf's path and ``where``."""

    def check(tree: Any, where: str = "state") -> None:
        items: List[Tuple[str, torch.Tensor]] = [
            (path, leaf) for path, leaf in walk(tree)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
        ]
        if not items:
            return
        ok = torch.stack([torch.isfinite(leaf).all() for _, leaf in items])
        first_bad = torch.where(ok.all(), -1, (~ok).to(torch.int32).argmax())
        index = int(first_bad)  # the check's one read back
        if index >= 0:
            raise NonFiniteError(f"{where}: non-finite values in {items[index][0]}")

    return check


__all__ = [
    "StrictViolation",
    "HostTransferError",
    "RecompileError",
    "NonFiniteError",
    "Counted",
    "counted",
    "dispatch_guard",
    "check_leaves",
    "RecompileSentinel",
    "finite_checker",
    "signature",
    "walk",
]
