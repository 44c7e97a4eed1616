"""DEPRECATED per-slot serving loop: superseded by the service subsystem.

The port of ``repro/runtime/serve_loop.py``.  New code goes through the
unified serving API (:mod:`repro_torch.runtime.service`)::

    from repro_torch.runtime import ServiceConfig, serve_model
    service = serve_model(model, ServiceConfig(max_batch=4, max_seq=256))
    done = service.generate(requests)

:class:`ServeSession` is kept as the *numerical reference* for the fused
slot-batched :class:`~repro_torch.runtime.service.DecodePlan`: it prefills
each admitted request alone at its exact length and advances one slot per
call per step (one ``decode_step`` a slot a token, each token read back to
the host), which the parity tests hold token for token against the fused
plan's single step.  ``Request`` / ``Completion`` live in the service
module and are re-exported here.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.runtime.service import Completion, Request, pad_cache_like

__all__ = ["Completion", "Request", "ServeSession"]


class ServeSession:
    """Slot-based batched generation over a ``CausalLM`` (per-slot
    reference).

    .. deprecated::
       Use ``serve_model(model, ServiceConfig(...))``: its DecodePlan
       advances all slots in one fused step.
    """

    def __init__(self, model, max_batch: int = 4, max_seq: int = 256):
        warnings.warn(
            "ServeSession is deprecated: route serving through "
            "serve_model(model, ServiceConfig(...)); its fused slot-batched "
            "DecodePlan advances all slots in one step",
            DeprecationWarning,
            stacklevel=2,
        )
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self._cache_template = model.cache_shapes(1, max_seq)

    @torch.inference_mode()
    def generate(self, requests: List[Request]) -> List[Completion]:
        """Process a list of requests with continuous slot reuse."""
        dev = self.model.device
        pending = list(requests)[::-1]  # pop() admits in order
        active: List[Optional[Dict]] = [None] * self.max_batch
        done: List[Completion] = []

        while pending or any(a is not None for a in active):
            # Admission: fill free slots (one exact-length prefill a request).
            for slot in range(self.max_batch):
                if active[slot] is None and pending:
                    req = pending.pop()
                    prompt = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :], device=dev)
                    logits, cache = self.model.prefill({"tokens": prompt})
                    active[slot] = {
                        "req": req,
                        "cache": pad_cache_like(cache, self._cache_template),
                        "cur_len": len(req.prompt),
                        "tokens": [int(torch.argmax(logits[0]))],
                        "steps": 1,
                    }

            # One decode step per active slot.
            for slot in range(self.max_batch):
                st = active[slot]
                if st is None:
                    continue
                req = st["req"]
                if (
                    len(st["tokens"]) >= req.max_new_tokens
                    or (req.eos_id is not None and st["tokens"][-1] == req.eos_id)
                    or st["cur_len"] + 1 >= self.max_seq
                ):
                    done.append(Completion(
                        rid=req.rid, tokens=np.asarray(st["tokens"], np.int32),
                        prefill_len=len(req.prompt), steps=st["steps"]))
                    active[slot] = None
                    continue
                tok = torch.tensor([[st["tokens"][-1]]], dtype=torch.int32, device=dev)
                cur = torch.tensor(st["cur_len"], dtype=torch.int32, device=dev)
                logits, st["cache"] = self.model.decode_step(st["cache"], tok, cur)
                st["tokens"].append(int(torch.argmax(logits[0])))
                st["cur_len"] += 1
                st["steps"] += 1
        return done
