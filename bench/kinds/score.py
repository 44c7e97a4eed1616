"""``score``: batch scoring, a closed loop with one client.

Set-up fits the readout on the frozen hidden layer (``epochs_hidden=0``)
and makes a pool of request batches; a request is ``predict(batch,
batch_size=chunk)`` then ``argmax(-1).cpu()``, the class ids on the host.

The data is made on the device from the seed (``bench/harness/data.py``) and
the same tensors go to the program and to the check.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List, Tuple

import torch

from bench.harness import check, faults, program, schedule
from bench.harness.cells import sync
from bench.harness.data import Draw
from bench.reference import bcpnn as ref


class ScoreCell:
    kind = "score"
    trace_key = "trace_requests"
    kernels = schedule.KERNELS
    faults = {"half": faults.half, "unchanged": faults.unchanged, "answer": faults.answer}
    compared = ("init_gap", "readout_err", "answer_gap")
    control_key, control_margin = "readout_err", 100.0

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.net = cfg["network"]
        self.shapes = schedule.Shapes(self.net)
        self.n_train = cfg["data"]["train_rows"]
        self.batch = min(traffic["fit_batch_size"], self.n_train)
        self.rows = traffic["request_rows"]
        self.served: List[torch.Tensor] = []  # every request's class ids, in order
        self.marks: List = []  # (name, time) at the end of each part of set-up

    @staticmethod
    def tiny(cfg: Dict, traffic: Dict) -> Tuple[Dict, Dict]:
        """The network and data cut to ``program.TINY_NET`` and ``TINY_DATA``;
        a pool of 4 requests of 100 rows in chunks of 32, 2 traced."""
        return program.tiny_config(cfg), dict(traffic, request_rows=100, predict_chunk=32,
                                              fit_batch_size=32, pool=4, trace_requests=2)

    @staticmethod
    def tiny_spans(cfg: Dict, traffic: Dict, units: int) -> Dict:
        """A spans window's requests at the tiny size: one ``predict`` span a
        request, one ``predict.chunk`` a chunk, and on the CPU, which has no
        gathered product, the hidden unit mask (2 x input features x hidden
        units, f32) expanded once a chunk: the only counter with the store
        off."""
        net = cfg["network"]
        chunks = units * -(-traffic["request_rows"] // traffic["predict_chunk"])
        mask_bytes = 2 * net["input_features"] * net["hidden_hcu"] * net["hidden_mcu"] * 4
        return dict(spans={"predict": units, "predict.chunk": chunks},
                    counters={"layer.unit_mask_bytes": chunks * mask_bytes},
                    no_other_counters=True)

    def setup(self) -> None:
        draw = Draw(self.cfg["data"], self.seed, self.device)
        self.x, self.y = draw.rows(self.n_train)
        pool = [draw.rows(self.rows)[0] for _ in range(self.traffic["pool"])]
        self.pool = pool
        sync(self.device)
        self.marks.append(("data", time.perf_counter()))
        self.compiled = program.build(self.cfg, self.seed, self.device,
                                      self.traffic["cache_activations"])
        self.init = (program.leaves(self.compiled.state.layers[0], program.HIDDEN_KEYS),
                     program.leaves(self.compiled.state.layers[1], program.READOUT_KEYS))
        self.marks.append(("build", time.perf_counter()))
        self.compiled.fit((self.x, self.y), epochs_hidden=0,
                          epochs_readout=self.traffic["fit_readout_epochs"],
                          batch_size=self.batch, shuffle=True)
        self.readout = program.leaves(self.compiled.state.layers[1], program.READOUT_KEYS)
        self.request(0)  # warms every shape a request uses
        self.served.clear()
        self.next = 0
        sync(self.device)
        self.marks.append(("warm", time.perf_counter()))

    def request(self, i: int) -> torch.Tensor:
        scores = self.compiled.predict(self.pool[i % len(self.pool)],
                                       batch_size=self.traffic["predict_chunk"])
        ids = scores.argmax(-1).cpu()
        self.served.append(ids.to(torch.uint8))
        return ids

    def unit(self) -> Dict:
        t0 = time.perf_counter()
        self.request(self.next)
        self.next += 1
        return dict(latency_s=time.perf_counter() - t0)

    def after_window(self) -> None:
        """Nothing: every request the windows served is compared."""

    def totals(self, units: int) -> Dict:
        return dict(rows=units * self.rows)

    def launches(self, units: int):
        one = schedule.predict(self.shapes, self.rows, self.traffic["predict_chunk"],
                               self.traffic["cache_activations"])
        return one * units

    def release(self) -> None:
        """Drop the program (the check runs after its state is freed)."""
        del self.compiled

    def reference_readout(self, tf32: bool = False):
        """The reference's own readout after set-up's fit, from the seed."""
        hidden, readout = ref.init_state(self.net, self.seed)
        hidden = {k: v.to(self.device) for k, v in hidden.items()}
        readout = {k: v.to(self.device) for k, v in readout.items()}
        order = ref.epoch_orders(self.seed, self.n_train, self.batch,
                                 self.traffic["fit_readout_epochs"])
        with ref.matmul_precision(tf32):
            codes = ref.hidden_codes(self.net, hidden, self.x, self.batch)
            for o in order:
                readout = ref.readout_epoch(self.net, readout, codes, self.y, o, self.batch)
        return hidden, readout

    def numbers(self, observed=None) -> Dict[str, float]:
        obs = observed or self
        want_h, want_r = ref.init_state(self.net, self.seed)
        out = dict(init_gap=max(check.init_gap(self.init[0], want_h),
                                check.init_gap(self.init[1], want_r)))
        del want_h, want_r
        hidden, readout = self.reference_readout()
        out["readout_err"] = check.change_err(
            {k: v.to(self.device) for k, v in obs.readout.items()}, readout,
            {k: v.to(self.device) for k, v in self.init[1].items()}, program.READOUT_KEYS)
        chunk = self.traffic["predict_chunk"]
        n_pool = len(self.pool)
        self.request_gaps = torch.zeros(len(obs.served), dtype=torch.float64)
        for slot in range(n_pool):
            answers = obs.served[slot::n_pool]
            if not answers:
                continue
            with ref.matmul_precision(False):
                want = ref.scores(self.net, readout,
                                  ref.hidden_codes(self.net, hidden, self.pool[slot], chunk))
            self.request_gaps[slot::n_pool] = check.answer_gaps(want, torch.stack(answers)).cpu()
        out["answer_gap"] = float(self.request_gaps.max()) if len(obs.served) else 0.0
        return out

    def failed_units(self, limits: Dict) -> int:
        """Requests with an answer beyond the ``answer_gap`` limit."""
        return int((self.request_gaps > limits.get("answer_gap", 0.0)).sum())

    def check_units(self, units: int) -> int:
        """The readings serve one request of each batch of the pool."""
        return self.traffic["pool"]

    def control(self) -> SimpleNamespace:
        """What the TF32 reference puts out in the program's place from the
        same inputs (after set-up): the stand-in ``observed`` that
        :meth:`numbers` judges."""
        hidden, readout = self.reference_readout(tf32=True)
        served = []
        with ref.matmul_precision(True):
            for xb in self.pool:
                s = ref.scores(self.net, readout, ref.hidden_codes(
                    self.net, hidden, xb, self.traffic["predict_chunk"]))
                served.append(s.argmax(-1).to(torch.uint8).cpu())
        return SimpleNamespace(readout={k: v.cpu() for k, v in readout.items()}, served=served)
