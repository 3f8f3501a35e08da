"""Batched decode serving engine (counterpart of ``repro/serve/engine.py``).

Continuous-batching style loop over a fixed slot pool: each slot holds one
request's position; finished slots are refilled from a queue.  The KV
cache is one set of tensors sized [L, B_slots, ...] on the parameters'
device, and every tick is one ``Model.decode`` call for all slots.

Ticks are synchronous across slots, as in the reference: every slot's k/v
is written at ``cache_len = pos.max()`` and roped at that position, so a
slot refilled while another is further along writes its prompt at the
other's position and attends over the stale cache entries before it.
Refilling a slot resets its position, not its SSM state: a refilled slot
starts from the state the previous request left, and an idle slot decodes
token 0 into its state.  (ROADMAP §C records both as reference
observations; the port keeps them.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serve.sampler import SamplerConfig, sample


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, model: Model, params, *, slots: int, max_seq: int,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0):
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.slots = slots
        self.max_seq = max_seq
        self.sampler = sampler
        self.cache = model.init_decode_state(slots, max_seq,
                                             device=self.device)
        self.pos = np.zeros(slots, np.int32)
        self.active: list[Optional[Request]] = [None] * slots
        self.queue: list[Request] = []
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _fill_slots(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self.active[s] = req
                self.pos[s] = 0

    def step(self) -> int:
        """One engine tick: decode one token for every active slot.

        Prompts are consumed token-by-token (teacher-forced prefill through
        the decode path, as in the reference)."""
        self._fill_slots()
        if not any(self.active):
            return 0
        tokens = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            p = self.pos[s]
            if p < len(req.prompt):
                tokens[s, 0] = req.prompt[p]
            else:
                tokens[s, 0] = req.out[-1] if req.out else 0
        # engine steps are synchronous across slots: cache_len is the max
        # position (slots at earlier positions simply ignore the extra kv)
        cache_len = int(self.pos.max())
        with torch.no_grad():
            logits, self.cache = self.model.decode(
                self.params, self.cache,
                torch.from_numpy(tokens).to(self.device), cache_len)
            nxt = sample(logits, self.generator, self.sampler).cpu().numpy()
        n_active = 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            n_active += 1
            self.pos[s] += 1
            if self.pos[s] >= len(req.prompt):
                req.out.append(int(nxt[s]))
                if len(req.out) >= req.max_new \
                        or self.pos[s] >= self.max_seq - 1:
                    req.done = True
                    self.active[s] = None
        return n_active

    def run(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and not any(self.active):
                break
            self.step()
