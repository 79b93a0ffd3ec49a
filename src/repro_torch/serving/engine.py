"""Continuous-batching serving engine.

The port of `repro.serving.engine`: a fixed pool of batch slots over one
shared KV cache; requests join free slots as they arrive (their prompt
streams into their own slot, one token a tick), every tick advances ALL
slots by one token through `transformer.decode_step`, and finished slots
are recycled without disturbing their neighbours. The scheduler is the
reference's, line for line, in host Python.

Correctness relies on two properties of `transformer.decode_step`'s
cache, as in the reference:
  * attention masks kv positions above a slot's pos, so rows left by a
    slot's previous occupant are invisible (a rolling cache overwrites
    them before it reads them);
  * the SSM state integrates history, so admitting a request zeroes its
    slot's `ssm_h` and `ssm_conv` along with its pos.
The cache is updated in place by each step (the reference donates it to
its jitted step instead). An encoder-only config has no decode step and
raises.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import torch

from ..configs.registry import ArchConfig
from ..models import transformer as T

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    # filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    _remaining: deque = dataclasses.field(default_factory=deque, repr=False)


class ServingEngine:
    """Slot-based continuous batching over a single shared cache, on the
    device that holds `params`."""

    def __init__(self, cfg: ArchConfig, params: dict, *, slots: int = 4,
                 max_len: int = 256,
                 sampler: Optional[Callable] = None):
        if not cfg.decode_capable:
            raise ValueError(f"{cfg.name} has no decode step")
        self.cfg, self.params = cfg, params
        self.slots, self.max_len = slots, max_len
        self.device = params["embed"].device
        self.cache = T.init_cache(cfg, slots, max_len, device=self.device)
        self._free: deque[int] = deque(range(slots))
        self._live: dict[int, Request] = {}
        self._queue: deque[Request] = deque()
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self.ticks = 0

    def submit(self, req: Request) -> None:
        req._remaining = deque(req.prompt)
        self._queue.append(req)

    def _reset_slot(self, slot: int) -> None:
        with torch.inference_mode():
            self.cache["pos"][slot] = 0
            for key in ("ssm_h", "ssm_conv"):
                if key in self.cache:     # the state integrates history: zero it
                    self.cache[key][:, slot] = 0

    def _admit(self) -> None:
        while self._queue and self._free:
            slot = self._free.popleft()
            req = self._queue.popleft()
            req.slot = slot
            self._live[slot] = req
            self._reset_slot(slot)

    def _finish(self, slot: int) -> None:
        self._live[slot].done = True
        del self._live[slot]
        self._free.append(slot)

    def tick(self) -> int:
        """Advance every live slot one token (prompt ingest or decode).
        Returns the number of live slots after recycling."""
        self._admit()
        if not self._live:
            return 0
        tokens = [0] * self.slots
        ingesting = [False] * self.slots
        for slot, req in self._live.items():
            if req._remaining:
                ingesting[slot] = True
                tokens[slot] = req._remaining.popleft()
            else:
                tokens[slot] = req.output[-1] if req.output \
                    else (req.prompt[-1] if req.prompt else 0)
        logits, self.cache = T.decode_step(
            self.params, self.cache,
            torch.tensor(tokens, dtype=torch.int32, device=self.device), self.cfg)
        nxt = self.sampler(logits).tolist()
        pos = self.cache["pos"].tolist()
        for slot in list(self._live):
            req = self._live[slot]
            if ingesting[slot] and req._remaining:
                continue                      # still streaming the prompt
            req.output.append(int(nxt[slot]))
            if len(req.output) >= req.max_new_tokens \
                    or pos[slot] >= self.max_len - 1:
                self._finish(slot)
        self.ticks += 1
        return len(self._live)

    def run_until_done(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            self._admit()
            if not self._live and not self._queue:
                return
            self.tick()
        raise RuntimeError("serving did not drain")
