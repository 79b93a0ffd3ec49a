"""Admission control for the online inverse service.

An unbounded FIFO in front of a fixed slot pool is the classic overload
failure: under sustained pressure every request's latency grows without
bound and nobody gets a useful answer. This module gives `SpinService`
an explicit SLA posture instead:

  * **bounded queue** — `max_queue` caps pending requests. At the bound
    the service SHEDS load: the new request is either admitted by
    evicting a strictly lower-priority queued solve (the victim gets a
    typed `Rejection(reason="shed")` verdict) or rejected itself with
    `AdmissionRejected(reason="queue_full")`. Never a silent hang —
    every outcome is a typed verdict, at submission time.
  * **per-matrix fairness** — `per_matrix_quota` caps one matrix's share
    of the queue (`reason="tenant_quota"`), so a hot tenant saturating
    its own quota cannot starve other matrices out of admission.
  * **deadlines** — a request carrying `deadline_s` (relative to
    submission) that expires while queued is shed with
    `reason="deadline"` instead of occupying a slot it can no longer
    use; the verdict is stamped the moment the scheduler would otherwise
    have admitted it.
  * **priority ordering** — admission drains the queue highest-priority
    first *across* matrices while preserving per-matrix FIFO (the
    consistency model's barrier semantics). The per-matrix guarantee is
    enforced by clamping each request's effective priority to the
    minimum of every earlier same-matrix request: within one matrix,
    effective priorities are non-increasing along submission order, so a
    stable sort can never reorder them.

The module is pure policy — data classes and queue transforms; the
service owns all state mutation.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

__all__ = ["Rejection", "AdmissionRejected", "AdmissionConfig",
           "effective_priorities", "order_for_admission", "shed_victim"]


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Typed verdict attached to every rejected/shed request.

    reason: "queue_full" | "tenant_quota" | "deadline" | "shed"
    """

    reason: str
    detail: str = ""


class AdmissionRejected(RuntimeError):
    """Raised at submission when the request itself is not admitted.

    Carries the typed `Rejection` as `.rejection` so callers can branch
    on `reason` (retry later, drop, escalate priority) without string
    matching the message.
    """

    def __init__(self, rejection: Rejection):
        super().__init__(f"request rejected ({rejection.reason}): "
                         f"{rejection.detail}")
        self.rejection = rejection


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """The service's admission posture. Defaults = legacy behavior
    (unbounded queue, no quotas) so existing callers are untouched."""

    max_queue: Optional[int] = None         # total queued requests bound
    per_matrix_quota: Optional[int] = None  # per-matrix queued bound

    def __post_init__(self):
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.per_matrix_quota is not None and self.per_matrix_quota < 1:
            raise ValueError("per_matrix_quota must be >= 1, got "
                             f"{self.per_matrix_quota}")


def effective_priorities(queue) -> list[int]:
    """Per-request priority clamped to the min of earlier same-matrix ones.

    The clamp is what makes cross-matrix priority ordering compatible
    with per-matrix FIFO: a high-priority request behind a low-priority
    update on the SAME matrix inherits the lower value, so a stable sort
    keeps it behind the barrier it must not overtake.
    """
    floor: dict[str, int] = {}
    out = []
    for req in queue:
        p = min(int(getattr(req, "priority", 0)),
                floor.get(req.matrix_id, 2**31))
        floor[req.matrix_id] = p
        out.append(p)
    return out


def order_for_admission(queue) -> deque:
    """The admission pass order: effective priority desc, FIFO within.

    Stable, so equal priorities keep strict submission order — with no
    priorities in play the pass IS the legacy FIFO pass.
    """
    eff = effective_priorities(queue)
    order = sorted(range(len(eff)), key=lambda i: (-eff[i], i))
    items = list(queue)
    return deque(items[i] for i in order)


def shed_victim(queue, incoming_priority: int):
    """The queued solve to evict for an incoming higher-priority request.

    Lowest priority first; among equals the most recently submitted (it
    has waited least, so shedding it wastes the least invested latency).
    Only solve-shaped requests (`rhs` attribute) are candidates — updates
    are state mutations and are never shed. None when no queued request
    has strictly lower priority than the incoming one.
    """
    victim, victim_key = None, None
    for idx, req in enumerate(queue):
        if not hasattr(req, "rhs"):
            continue
        p = int(getattr(req, "priority", 0))
        if p >= incoming_priority:
            continue
        key = (p, -idx)                  # lowest priority, then latest
        if victim_key is None or key < victim_key:
            victim, victim_key = req, key
    return victim
