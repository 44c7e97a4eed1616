"""Build, load and launch the CUDA sources under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``lib<name>.so`` (one ``nvcc`` per source, all started together),
for ``sm_90a``; the sources share headers (``csrc/*.cuh``).  The libraries
go to ``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by
a hash of every file under ``csrc/`` and the flags, and are loaded with
``ctypes``.  Importing this module builds nothing.

Dispatch (:func:`use_plain`) goes by the device of the inputs and by the
caller's explicit ``use_kernels`` choice; there is no fallback.  Every
launch and launch-plan lookup is reported (:func:`record`) to the watched
callable running in the calling thread, if any: strict mode's recompile
sentinel (``repro_torch.analysis.strict``) reads those reports to tell
which network's dispatch built a plan or loaded a library.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).with_name("csrc")
SOURCES = ("masked_matmul", "hcu_softmax", "bcpnn_update", "bcpnn_phase", "bf_round")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

_libs: Dict[str, ctypes.CDLL] = {}
_loaded_from: Optional[str] = None  # the build directory the libraries came from


class _Sites(threading.local):
    """The watched callables running in this thread, innermost last."""

    def __init__(self):
        self.stack: list = []


_sites = _Sites()


@contextlib.contextmanager
def running(site) -> Iterator[None]:
    """Report the launches made inside the block to ``site`` (an object
    with ``note(kind, key)``), in this thread only."""
    _sites.stack.append(site)
    try:
        yield
    finally:
        _sites.stack.pop()


def record(kind: str, key) -> None:
    """Tell the innermost watched callable of this thread (if any) that a
    launch used ``key`` of ``kind``: a launch plan's shape key, or the
    build directory its library was loaded from."""
    stack = _sites.stack
    if stack:
        stack[-1].note(kind, key)


def planned(kind: str, plan_fn: Callable, *key):
    """``plan_fn(*key)``, the shape-keyed launch plan, recorded as ``kind``."""
    record(kind, key)
    return plan_fn(*key)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


def build_dir() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        digest.update(path.relative_to(CSRC).as_posix().encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build_all() -> Dict[str, str]:
    """Compile every source not built yet and load all of them.

    Returns nvcc's output (with ptxas's register and shared-memory report)
    per source compiled in this call.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    try:
        for name in SOURCES:
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out_dir / f"lib{name}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs[name] = (proc, tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    global _loaded_from
    for name in SOURCES:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    _loaded_from = out_dir.name
    return logs


def function(lib: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``lib<lib>.so``, building at first use.

    Every entry point returns ``cudaGetLastError()`` after its launch.
    """
    if lib not in _libs:
        build_all()
    fn = getattr(_libs[lib], symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


F32 = (torch.float32,)
STATE = (torch.float32, torch.bfloat16)  # traces of the quantized state tier


def use_plain(
    name: str, *tensors, dtypes: Optional[Sequence[Tuple[torch.dtype, ...]]] = None,
    plain: bool = False,
) -> bool:
    """Dispatch by the device of the inputs (``None`` entries are skipped).

    True when the caller takes the plain version: every tensor lies on the
    CPU, or every tensor lies on one device and ``plain`` is set (the
    caller's explicit ``use_kernels=False``, which runs the plain versions
    on the card).  False when all lie on one CUDA device, contiguous and
    of a dtype the kernel takes: ``dtypes`` gives the allowed dtypes per
    argument (default: :data:`F32` for every one).  The caller then
    launches the kernel.  Anything else raises; there is no fallback.
    """
    if dtypes is None:
        dtypes = [F32] * len(tensors)
    if len(dtypes) != len(tensors):
        raise ValueError(f"{name}: {len(tensors)} tensors but {len(dtypes)} dtype entries")
    pairs = [(t, d) for t, d in zip(tensors, dtypes) if t is not None]
    ts = [t for t, _ in pairs]
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs lie on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu" or plain:
        return True
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for tensors on {device}")
    for t, allowed in pairs:
        if t.dtype not in allowed or not t.is_contiguous():
            want = " or ".join(str(d).replace("torch.", "") for d in allowed)
            raise ValueError(
                f"{name}: the kernel takes contiguous {want} tensors here, got "
                f"{t.dtype} of shape {tuple(t.shape)} (contiguous={t.is_contiguous()})"
            )
    return False


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the C entry point ``fn`` on ``device``'s current stream, with the
    stream appended to ``args``; raise if the launch was refused."""
    record("kernels.build", _loaded_from)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
