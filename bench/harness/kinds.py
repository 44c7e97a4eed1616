"""The traffic kinds: one generator class a kind, in ``bench/kinds/<kind>.py``.

A traffic file names its ``kind``; :func:`load` finds the module of that
name, as :func:`bench.harness.readers.load` finds a metric's reader, and
returns the one class in it whose ``kind`` is the module's name.  A kind's
class is built as ``cls(cfg, traffic, seed, device)``.  Adding a kind adds
files only; its class declares everything below, and :func:`load` exits
naming the file and what its class lacks.

What :mod:`bench.harness.runner` (and ``bench/readings.py``) read
(:data:`RUNNER`):

* ``kind``: the module's name;
* ``trace_key``: the traffic key that holds the traced window's units;
* ``kernels``: the port's kernels that the trace summarises (their
  launches are held to ``ops.launch_counts()``);
* ``faults``: name -> a context manager that plants that fault in the
  program for a run (``bench/readings.py --faults``);
* ``setup()``, then ``marks`` (set by ``__init__``: ``(part, time)`` at the
  end of each part of set-up), ``unit()`` (one unit of the window, a dict
  the window's record keeps), ``after_window()``, ``totals(units)``,
  ``launches(units)`` (``(kernel, shape)`` pairs, each shape with
  ``cost()`` and ``precision``), ``release()``;
* ``numbers(observed=None)``: the compared numbers, of the program's run or
  of a stand-in's outputs; ``failed_units(limits)``;
* ``check_units(units)``: the units ``bench/readings.py`` runs after set-up,
  given its ``--units``;
* ``control()``: the plain reference, one precision below the
  configuration's, put in the program's place: the stand-in that
  ``numbers(observed)`` judges.

What the per-cell tests in ``bench/test_bench_*.py`` read (:data:`TESTS`),
so that a cell of a new kind brings its own:

* ``tiny(cfg, traffic) -> (cfg, traffic)``: copies of the cell's files cut
  to a size the CPU runs in about a second;
* ``compared``: the names of the numbers ``numbers()`` returns, which the
  cell's limits file names, no more and no fewer;
* ``control_key``, ``control_margin``: the number on which ``control()``
  reads at least ``control_margin`` times what the program reads (a test
  expectation, not a knob of the run);
* ``tiny_spans(cfg, traffic, units)``: the spans and counters a spans
  window of ``units`` units at the tiny size records, ``{"spans": {name:
  count}, "counters": {name: value}}`` (``"no_other_counters": True`` where
  those are all), or ``{}``, which holds the kind to the generic part only.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

from bench.harness import readers

RUNNER = ("kind", "trace_key", "kernels", "faults", "setup", "unit", "after_window", "totals",
          "launches", "release", "numbers", "failed_units", "check_units", "control")
TESTS = ("tiny", "compared", "control_key", "control_margin", "tiny_spans")

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
        missing = [a for a in RUNNER + TESTS if not hasattr(found[0], a)]
        if missing:
            raise SystemExit(f"{path}: class {found[0].__name__} lacks {', '.join(missing)} "
                             "(see bench/harness/kinds.py)")
        _loaded[path] = found[0]
    return _loaded[path]
