"""``train``: Listing 1 training repeated on one compiled network.

An iteration is ``fit((x, y), epochs_hidden, epochs_readout, batch_size,
shuffle=True)`` then ``evaluate((x_test, y_test))``.  Set-up runs the first
``check_steps`` iterations (they build and warm every kernel and shape the
window uses) and copies, as they run, what the check needs: the initial
state, the hidden state around one rewiring batch of each iteration, the
readout before and after its phase, the trained hidden layer, and the test
rows' classes.  Once the windows have closed it keeps the classes the
window's last iteration leaves and checks one more iteration the same way,
from the state the window trained.

The data is made on the device from the seed (``bench/harness/data.py``) and
the same tensors go to the program and to the check.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.harness import check, faults, program, schedule
from bench.harness.cells import sync
from bench.harness.data import Draw
from bench.reference import bcpnn as ref


class TrainCell:
    kind = "train"
    trace_key = "trace_iterations"
    kernels = schedule.KERNELS
    faults = {"half": faults.half, "unchanged": faults.unchanged, "answer": faults.answer}

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.net = cfg["network"]
        self.shapes = schedule.Shapes(self.net)
        d = cfg["data"]
        self.n_train, self.n_test = d["train_rows"], d["test_rows"]
        self.batch = min(traffic["batch_size"], self.n_train)
        self.per_epoch = self.n_train // self.batch
        self.hidden_per_iter = traffic["epochs_hidden"] * self.per_epoch
        self.epochs_per_iter = traffic["epochs_hidden"] + traffic["epochs_readout"]
        self.iterations = 0  # iterations trained since the network was compiled
        self.marks: List = []  # (name, time) at the end of each part of set-up

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        draw = Draw(self.cfg["data"], self.seed, self.device)
        self.x, self.y = draw.rows(self.n_train)
        self.xt, self.yt = draw.rows(self.n_test)
        self.yt_host = self.yt.cpu().numpy()
        sync(self.device)
        self.marks.append(("data", time.perf_counter()))
        self.compiled = program.build(self.cfg, self.seed, self.device,
                                      self.traffic["cache_activations"])
        state = self.compiled.state.layers
        self.init = (program.leaves(state[0], program.HIDDEN_KEYS),
                     program.leaves(state[1], program.READOUT_KEYS))
        self.marks.append(("build", time.perf_counter()))
        self.before: Dict[int, Dict] = {}  # hidden state copies around checked batches
        self.after: Dict[int, Dict] = {}
        self.checked: List[Dict] = []  # the checked iterations' copies and answers
        self.end: Optional[Dict] = None  # the state and answers the window left
        readout = self.init[1]
        for _ in range(self.traffic["check_steps"]):
            readout = self._checked_iteration(readout)
        sync(self.device)
        self.marks.append(("warm", time.perf_counter()))

    def checked_step(self, t: int) -> int:
        """The hidden batch checked first in iteration ``t``: its first
        rewiring batch (the next one is checked too)."""
        lo = t * self.hidden_per_iter
        return next((k for k in range(lo, lo + self.hidden_per_iter)
                     if k % self.shapes.every == 0), lo)

    def _checked_iteration(self, readout_before: Dict) -> Dict:
        """One iteration as the window runs it (fit, then evaluate), with the
        hidden state copied around its first rewiring batch and the next,
        and what the check compares kept: the trained hidden layer, the
        readout before and after its phase, and the test rows' classes."""
        t = self.iterations
        k = self.checked_step(t)
        tap = program.StepTap(self.compiled, (k, k + 1), start=t * self.hidden_per_iter)
        try:
            self.compiled.fit((self.x, self.y), **self._fit_kw())
        finally:
            tap.close()
        self.iterations += 1
        self.before.update(tap.before)
        self.after.update(tap.after)
        it = dict(t=t, steps=(k, k + 1), readout_before=readout_before, **self._snapshot())
        self.compiled.evaluate((self.xt, self.yt_host), batch_size=self.traffic["evaluate_chunk"])
        it["classes"] = self._classes()
        self.checked.append(it)
        return it["readout"]

    def _snapshot(self) -> Dict:
        state = self.compiled.state.layers
        return dict(hidden=program.leaves(state[0], ("w", "b", "hcu_mask")),
                    readout=program.leaves(state[1], program.READOUT_KEYS))

    def _classes(self) -> torch.Tensor:
        """The test rows' classes from the program's state: evaluate's scores
        again, from the store's projection of the test rows that the last
        evaluate made (only the head runs)."""
        scores = self.compiled.predict(self.xt, batch_size=self.traffic["evaluate_chunk"])
        return scores.argmax(-1).to(torch.uint8).cpu()

    def _fit_kw(self) -> Dict:
        t = self.traffic
        return dict(epochs_hidden=t["epochs_hidden"], epochs_readout=t["epochs_readout"],
                    batch_size=self.batch, shuffle=True)

    # -------------------------------------------------------------- window
    def unit(self) -> Dict:
        """One iteration: fit, then evaluate (which reads back to the host)."""
        res = self.compiled.fit((self.x, self.y), **self._fit_kw())
        self.compiled.evaluate((self.xt, self.yt_host), batch_size=self.traffic["evaluate_chunk"])
        self.iterations += 1
        return dict(history=res.history)

    def after_window(self) -> None:
        """Untimed, once the windows have closed: the classes that the
        window's last iteration leaves (from the projection its evaluate
        stored), then one more iteration, checked as set-up's are, from the
        state the window trained."""
        self.end = dict(self._snapshot(), classes=self._classes())
        self._checked_iteration(self.end["readout"])
        sync(self.device)

    def totals(self, units: int) -> Dict:
        return dict(samples=units * schedule.samples(self.traffic, self.n_train),
                    batches=units * schedule.training_batches(self.traffic, self.n_train))

    def launches(self, units: int):
        one = schedule.iteration(self.shapes, self.traffic, self.n_train, self.n_test)
        return one * units

    # --------------------------------------------------------------- check
    def release(self) -> None:
        """Drop the program (the check runs after its state is freed)."""
        del self.compiled

    def failed_units(self, limits: Dict) -> int:
        return 0  # the window's iterations are not compared one by one

    def check_units(self, units: int) -> int:
        """The readings run ``--units`` iterations of the window."""
        return units

    def orders(self) -> List[np.ndarray]:
        last = self.checked[-1]["t"] if self.checked else 0
        return ref.epoch_orders(self.seed, self.n_train, self.batch,
                                (last + 1) * self.epochs_per_iter)

    def rows_of(self, orders, k: int) -> torch.Tensor:
        """The rows of the ``k``-th hidden batch, from the reworked order."""
        t, j = divmod(k, self.hidden_per_iter)
        e, i = divmod(j, self.per_epoch)
        rows = orders[t * self.epochs_per_iter + e][i * self.batch:(i + 1) * self.batch]
        return self.x.index_select(0, torch.as_tensor(rows, device=self.device))

    def state_before(self, k: int) -> Dict[str, torch.Tensor]:
        return self.before[k] if k in self.before else self.after[k - 1]

    def numbers(self, observed=None) -> Dict[str, float]:
        """The compared numbers of the program's run (or of ``observed``, a
        stand-in's outputs with the same layout: the control's)."""
        obs = observed or self
        out = dict(init_gap=0.0, hidden_err=0.0, mask_cols=0, readout_err=0.0, answer_gap=0.0)
        want_h, want_r = ref.init_state(self.net, self.seed)
        out["init_gap"] = max(check.init_gap(self.init[0], want_h),
                              check.init_gap(self.init[1], want_r))
        del want_h
        orders = self.orders()
        chunk = self.traffic["evaluate_chunk"]
        hidden, readout = [], []
        for it, o in zip(self.checked, obs.checked):
            for step in it["steps"]:
                got, cols = check.hidden_step_numbers(self.net, self.state_before(step),
                                                      obs.after[step], step,
                                                      self.rows_of(orders, step))
                hidden.append(got)
                out["mask_cols"] += cols
            readout.append(check.readout_numbers(
                self.net, it["hidden"], it["readout_before"], o["readout"], self.x, self.y,
                orders[it["t"] * self.epochs_per_iter + self.traffic["epochs_hidden"]],
                self.batch, self.batch))
            want = check.reference_scores(self.net, it["hidden"], it["readout"], self.xt, chunk)
            out["answer_gap"] = max(out["answer_gap"], check.answer_gap(want, o["classes"]))
        if self.end is not None:
            want = check.reference_scores(self.net, self.end["hidden"], self.end["readout"],
                                          self.xt, chunk)
            out["answer_gap"] = max(out["answer_gap"], check.answer_gap(want, obs.end["classes"]))
        out["hidden_err"] = check.worst_ratio(hidden)
        out["readout_err"] = check.worst_ratio(readout)
        return out

    def control(self) -> SimpleNamespace:
        """What the TF32 reference puts out in the program's place, stage by
        stage from the same inputs as the program's stages (after set-up and
        the window): the stand-in ``observed`` that :meth:`numbers` judges."""
        dev = self.device
        orders = self.orders()
        after: Dict[int, Dict] = {}
        checked = []
        chunk = self.traffic["evaluate_chunk"]

        def classes(snap):  # the test rows' classes from the program's state
            h = {n: v.to(dev) for n, v in snap["hidden"].items()}
            r = {n: v.to(dev) for n, v in snap["readout"].items()}
            sc = ref.scores(self.net, r, ref.hidden_codes(self.net, h, self.xt, chunk))
            return sc.argmax(-1).to(torch.uint8).cpu()

        with ref.matmul_precision(True):
            for it in self.checked:
                for step in it["steps"]:
                    before = {n: v.to(dev) for n, v in self.state_before(step).items()}
                    out = ref.hidden_step(self.net, before, step, self.rows_of(orders, step))
                    after[step] = {n: v.cpu() for n, v in out.items()}
                h = {n: v.to(dev) for n, v in it["hidden"].items()}
                codes = ref.hidden_codes(self.net, h, self.x, self.batch)
                before = {n: v.to(dev) for n, v in it["readout_before"].items()}
                order = orders[it["t"] * self.epochs_per_iter + self.traffic["epochs_hidden"]]
                r = ref.readout_epoch(self.net, before, codes, self.y, order, self.batch)
                checked.append(dict(readout={n: v.cpu() for n, v in r.items()},
                                    classes=classes(it)))
            end = dict(classes=classes(self.end)) if self.end is not None else None
        return SimpleNamespace(after=after, checked=checked, end=end)
