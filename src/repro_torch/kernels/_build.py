"""Build, load and launch the CUDA sources under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``lib<name>.so`` (one ``nvcc`` per source, all started together),
for ``sm_90a``; the sources share headers (``csrc/*.cuh``).  The libraries
go to ``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by
a hash of every file under ``csrc/`` and the flags, and are loaded with
``ctypes``.  Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).with_name("csrc")
SOURCES = ("masked_matmul", "hcu_softmax", "bcpnn_update", "bcpnn_phase", "bf_round")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

_libs: Dict[str, ctypes.CDLL] = {}


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
    for name in SOURCES:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
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


def on_cpu(name: str, *tensors, dtypes: Optional[Sequence[Tuple[torch.dtype, ...]]] = None) -> bool:
    """Dispatch by the device of the inputs (``None`` entries are skipped).

    True when every tensor lies on the CPU: the caller takes the plain
    version.  False when all lie on one CUDA device, contiguous and of a
    dtype the kernel takes: ``dtypes`` gives the allowed dtypes per
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
    if device.type == "cpu":
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
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
