"""The traffic kinds: one generator class a kind, in ``bench/kinds/<kind>.py``.

A traffic file names its ``kind``; :func:`load` finds the module of that
name, as :func:`bench.harness.readers.load` finds a metric's reader, and
returns the one class in it whose ``kind`` is the module's name.  A kind's
class is built as ``cls(cfg, traffic, seed, device)`` and declares what the
harness would otherwise have to guess:

* ``trace_key``: the traffic key that holds the traced window's units;
* ``kernels``: the port's kernels that its schedule lists and the trace
  summarises (their launches are held to ``ops.launch_counts()``);
* ``faults``: name -> a context manager that plants that fault in the
  program for a run (``bench/readings.py --faults``);
* ``check_units(units)``: the units ``bench/readings.py`` runs after set-up,
  given its ``--units``;
* ``control()``: the plain reference, one precision below the
  configuration's, put in the program's place: the stand-in that
  ``numbers(observed)`` judges;

and ``setup``, ``marks``, ``unit``, ``after_window``, ``totals``,
``launches``, ``release``, ``numbers`` and ``failed_units``, which
:mod:`bench.harness.runner` drives.  Adding a kind adds files only.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

from bench.harness import readers

_loaded: Dict[Path, type] = {}  # by the module's path: one class object a file


def load(directory: Path, kind: str) -> type:
    """The generator class of traffic ``kind``, from ``directory/<kind>.py``."""
    path = (Path(directory) / f"{kind}.py").resolve()
    if path not in _loaded:
        if not path.is_file():
            raise SystemExit(f"no traffic kind {kind!r}: looked for {path}")
        module = readers.load(path, prefix="bench_kind_")
        found = [v for v in vars(module).values()
                 if isinstance(v, type) and v.__module__ == module.__name__
                 and getattr(v, "kind", None) == kind]
        if len(found) != 1:
            raise SystemExit(f"{path} defines {len(found)} classes whose kind is {kind!r}, "
                             "want 1")
        _loaded[path] = found[0]
    return _loaded[path]

