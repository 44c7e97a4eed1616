"""Atomic checkpoints of trees of tensors, in the reference's file layout.

A checkpoint is a directory ``<dir>/step_<n>`` holding ``arrays.npz`` (one
array per leaf, keyed by its path, e.g. ``layers/0/marginals/cij``) and
``manifest.json`` (step, keys, shapes, logical dtypes and ``extra``
metadata), exactly as ``repro/checkpoint/store.py`` writes them, so a
checkpoint of either package loads into the other.

* **Atomic**: written to ``<dir>/tmp.<step>.<pid>`` and renamed to
  ``step_<n>`` when complete, so a killed job never leaves a half
  checkpoint behind.
* **Retention**: the newest ``retain`` checkpoints are kept; older ones are
  deleted after a successful write, never before.
* **bf16** (the quantized state tier): numpy has no bfloat16, so a bf16
  tensor is written as its ``uint16`` bits and the manifest records the
  logical dtype ``"bfloat16"``; loading views the bits back as a bf16
  tensor.  No ``ml_dtypes`` is needed on either side.
* **Async** (``AsyncCheckpointer``): the tree is copied to the host
  synchronously, then written on a worker thread, at most one write in
  flight; a failed write raises at the next ``wait()``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def path_key(path) -> str:
    """Flat key of a tree path: its parts joined with ``/``."""
    return "/".join(str(p) for p in path)


def _children(node):
    """(name, child) pairs of a tree node, or None for a leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # NamedTuple
        return list(zip(node._fields, node))
    if isinstance(node, dict):
        return sorted(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix=()) -> Dict[str, torch.Tensor]:
    """``path_key -> tensor`` for every tensor leaf of ``tree``.  ``None``
    is an empty subtree; any other leaf that is not a tensor raises."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {path_key(prefix): tree}
    children = _children(tree)
    if children is None:
        raise TypeError(f"{path_key(prefix)!r}: cannot checkpoint a {type(tree).__name__}")
    flat: Dict[str, torch.Tensor] = {}
    for name, child in children:
        flat.update(_flatten(child, prefix + (name,)))
    return flat


def _encode_tensor(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host numpy array for ``arrays.npz`` and the tensor's logical dtype
    name (a bf16 tensor becomes its ``uint16`` bits)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def decode_array(arr: np.ndarray, logical_dtype: Optional[str] = None) -> torch.Tensor:
    """A fresh CPU tensor from a stored array: ``uint16`` bits whose logical
    dtype is ``"bfloat16"`` (or an array of a 2-byte ``bfloat16`` dtype,
    as the reference holds them in memory) become a bf16 tensor."""
    logical = logical_dtype or str(arr.dtype)
    if logical == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _snapshot(tree, copy: bool = False) -> Dict[str, Tuple[np.ndarray, str]]:
    """Every leaf of ``tree`` on the host: ``path_key -> (array, logical
    dtype)``.  A CPU tensor's array shares its storage unless ``copy``."""
    out = {}
    for k, t in _flatten(tree).items():
        arr, dtype = _encode_tensor(t)
        out[k] = (np.array(arr) if copy and t.device.type == "cpu" else arr, dtype)
    return out


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    retain: int = 3,
    extra: Optional[dict] = None,
    _encoded: Optional[Dict[str, Tuple[np.ndarray, str]]] = None,
) -> str:
    """Write one checkpoint of ``tree`` (or of a host ``_snapshot`` of one)
    atomically; returns its final path.

    extra: JSON-serializable metadata stored in the manifest (for a whole
    network: the layer count and the host shuffle RNG state).
    """
    os.makedirs(directory, exist_ok=True)
    encoded = _encoded if _encoded is not None else _snapshot(tree)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **{k: arr for k, (arr, _) in encoded.items()})
    manifest = {
        "step": step,
        "keys": sorted(encoded),
        "shapes": {k: list(arr.shape) for k, (arr, _) in encoded.items()},
        "dtypes": {k: dtype for k, (_, dtype) in encoded.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic on POSIX
    _apply_retention(directory, retain)
    return final


def _apply_retention(directory: str, retain: int) -> None:
    for _, path in list_checkpoints(directory)[:-retain]:
        shutil.rmtree(path, ignore_errors=True)


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """(step, path) of every complete checkpoint in ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[Tuple[int, str]]:
    ckpts = list_checkpoints(directory)
    return ckpts[-1] if ckpts else None


def load_manifest(path: str) -> dict:
    """A checkpoint's manifest (keys, shapes, dtypes and extra metadata)."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def load_flat(path: str) -> Dict[str, torch.Tensor]:
    """Every array of a checkpoint as a CPU tensor of its logical dtype."""
    dtypes = load_manifest(path).get("dtypes") or {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: decode_array(z[k], dtypes.get(k)) for k in z.files}


def restore_into_template(
    flat: Dict[str, torch.Tensor], template: Any, prefix: str = "", device=None
) -> Any:
    """Rebuild ``template``'s tree from flat ``path_key``-keyed tensors.

    Every tensor leaf of the template is looked up under ``prefix`` + its
    key (missing keys raise ``KeyError``), its shape checked (``ValueError``)
    and placed on ``device`` (default: the template leaf's device), keeping
    the checkpoint's dtype.  Leaves that are not tensors are kept as they
    are in the template.
    """

    def rebuild(node, path):
        if isinstance(node, torch.Tensor):
            key = prefix + path_key(path)
            if key not in flat:
                raise KeyError(f"checkpoint missing {key!r}")
            t = flat[key]
            if tuple(t.shape) != tuple(node.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs template "
                    f"{tuple(node.shape)}"
                )
            return t.to(device if device is not None else node.device)
        children = _children(node)
        if children is None:
            return node
        rebuilt = [rebuild(child, path + (name,)) for name, child in children]
        if isinstance(node, dict):
            return dict(zip((name for name, _ in children), rebuilt))
        if hasattr(node, "_fields"):
            return type(node)(*rebuilt)
        return type(node)(rebuilt)

    return rebuild(template, ())


def restore_checkpoint(path: str, template: Any) -> Any:
    """Load the checkpoint at ``path`` into ``template``'s structure, each
    leaf on its template leaf's device: the reference's
    ``restore_checkpoint``, so a checkpoint of a train loop (``params/...``,
    ``opt/step``, ``opt/mu/...``) written by either package resumes in the
    other."""
    return restore_into_template(load_flat(path), template)


class AsyncCheckpointer:
    """Overlap disk writes with training; at most one write in flight."""

    def __init__(self, directory: str, retain: int = 3):
        self.directory = directory
        self.retain = retain
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None

    def save(self, step: int, tree: Any) -> None:
        """Wait for the write in flight, copy ``tree`` to the host (the
        caller may then change its tensors), and write it on a thread."""
        self.wait()
        encoded = _snapshot(tree, copy=True)

        def work():
            try:
                save_checkpoint(self.directory, step, None, self.retain, _encoded=encoded)
                self.last_saved = step
            except BaseException as e:  # noqa: BLE001 -- raised at wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
