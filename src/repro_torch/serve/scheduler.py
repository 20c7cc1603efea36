"""Request scheduling for the continuous-batching engine.

Two host-side pieces:

- :class:`RequestScheduler` — a FIFO admission queue plus per-request
  lifecycle state (QUEUED → RUNNING → DONE) and monotonic lifecycle
  timestamps (submit → admit → prefill_done → first_token → finish), so
  benchmarks can report per-request, per-phase latency percentiles. The
  scheduler is the single choke point for lifecycle transitions, so it is
  also where the per-request trace spans are emitted: every transition
  both stamps the request and (when a :class:`~repro_torch.obs.trace.Tracer` is
  attached) records the matching async trace event with the *same*
  timestamp.
- :class:`AdmissionController` — the serving mirror of the paper's SEBS
  batch schedule. Instead of growing the *training* batch ``bₛ = b₁ρˢ`` per
  stage, it grows the *active decode slot budget* geometrically under
  sustained load. Per-token scheduling/dispatch overhead then amortizes over
  the widening slot ring exactly the way per-update communication amortizes
  over the widening train batch, and — like the training-side
  ``StageController`` — each stage corresponds to exactly one compiled
  decode variant (the engine keys its jit cache on the stage's slot width).

All clock reads go through the injected ``clock`` seam (a callable
*reference*, ``time.perf_counter`` by default), so engines can substitute
the tracer's clock — or a fake counter in tests — and lint rule R103's
no-ambient-wallclock check stays clean.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.schedules import SEBS, Schedule
from repro_torch.obs.trace import NULL_TRACER, Tracer

QUEUED, RUNNING, DONE = "queued", "running", "done"


def _phase(t0: float, t1: float) -> float:
    """Duration between two lifecycle stamps; NaN while either is unset
    (0.0) — an unstamped phase must poison averages loudly, not silently
    contribute a huge bogus number."""
    if t0 == 0.0 or t1 == 0.0:
        return float("nan")
    return t1 - t0


@dataclass
class Request:
    """One generation request. ``prompt`` is a (P,) int32 token array;
    ``temperature == 0`` means greedy; ``top_k == 0`` means full vocab.
    ``memory`` carries per-request encoder input (1, T, d) for
    encoder-decoder models (whisper). ``tag`` is a free-form request class
    ("interactive", "batch", a tenant id) that trace tooling groups
    percentiles by."""

    id: int
    prompt: np.ndarray
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    memory: Optional[Any] = None
    tag: str = ""
    state: str = QUEUED
    generated: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0  # popped from the queue into a RUNNING slot
    t_prefill_done: float = 0.0  # prompt fully computed: prefill→decode handoff
    t_first_token: float = 0.0  # first generated token sampled (TTFT stamp)
    t_finish: float = 0.0

    @property
    def latency(self) -> float:
        """Submit→finish wall time. NaN until the request is DONE — a
        queued/running request has ``t_finish == 0.0`` and the raw
        difference would be a large negative number that silently poisons
        any latency average."""
        if self.state != DONE:
            return float("nan")
        return self.t_finish - self.t_submit

    @property
    def queue_s(self) -> float:
        """Submit→admit wait. NaN until admitted (requeue un-stamps)."""
        return _phase(self.t_submit, self.t_admit)

    @property
    def prefill_s(self) -> float:
        """Admit→prefill_done compute time. NaN until the handoff."""
        return _phase(self.t_admit, self.t_prefill_done)

    @property
    def ttft_s(self) -> float:
        """Submit→first-token — the SLO-grade time-to-first-token."""
        return _phase(self.t_submit, self.t_first_token)

    @property
    def decode_s(self) -> float:
        """First-token→finish decode time. NaN until DONE."""
        if self.state != DONE:
            return float("nan")
        return _phase(self.t_first_token, self.t_finish)

    def tokens(self) -> np.ndarray:
        """Prompt + generated tokens, the (P + new,) result row."""
        return np.concatenate(
            [np.asarray(self.prompt, np.int32), np.asarray(self.generated, np.int32)]
        )


class RequestScheduler:
    """FIFO queue + lifecycle bookkeeping. Pure host-side Python."""

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        tracer: Optional[Tracer] = None,
    ):
        self._next_id = 0
        self._queue: deque[Request] = deque()
        self.requests: Dict[int, Request] = {}
        self._running = 0
        self._clock = clock
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def submit(
        self,
        prompt,
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        top_k: int = 0,
        memory=None,
        tag: str = "",
    ) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        assert max_new_tokens >= 1
        req = Request(
            id=self._next_id,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            temperature=float(temperature),
            top_k=int(top_k),
            memory=memory,
            tag=tag,
            t_submit=self._clock(),
        )
        self._next_id += 1
        self._queue.append(req)
        self.requests[req.id] = req
        self.tracer.begin_request(
            req.id,
            ts=req.t_submit,
            prompt_len=int(prompt.size),
            max_new_tokens=int(max_new_tokens),
            tag=tag,
        )
        return req.id

    def pop_waiting(self) -> Optional[Request]:
        if not self._queue:
            return None
        req = self._queue.popleft()
        req.state = RUNNING
        req.t_admit = self._clock()
        self._running += 1
        self.tracer.mark_request(req.id, "admit", ts=req.t_admit)
        return req

    def finish(self, req: Request) -> None:
        req.state = DONE
        req.t_finish = self._clock()
        self._running -= 1
        self.tracer.end_request(req.id, ts=req.t_finish, tokens=len(req.generated))

    def prefill_done(self, req: Request) -> None:
        """Timestamp the prefill→decode handoff of a RUNNING request (the
        disaggregated engine calls this when the page block is streamed);
        the request stays RUNNING until decode finishes it. Idempotent —
        only the first call stamps (engines hit multiple bookkeeping paths
        for the same transition)."""
        assert req.state == RUNNING
        if req.t_prefill_done != 0.0:
            return
        req.t_prefill_done = self._clock()
        self.tracer.mark_request(req.id, "prefill_done", ts=req.t_prefill_done)

    def first_token(self, req: Request) -> None:
        """Timestamp the first generated token (TTFT). Idempotent, and
        legal on a request being finished in the same transition (single
        token requests complete without a decode tick)."""
        assert req.state in (RUNNING, DONE)
        if req.t_first_token != 0.0:
            return
        req.t_first_token = self._clock()
        self.tracer.mark_request(req.id, "first_token", ts=req.t_first_token)

    def requeue(self, req: Request) -> None:
        """Return a just-popped request to the queue head (admission found no
        pages for it this tick; FIFO order is preserved). The admit stamp is
        cleared — the request is back to waiting, and its eventual
        ``queue_s`` must cover the whole wait."""
        assert req.state == RUNNING
        req.state = QUEUED
        req.t_admit = 0.0
        self._running -= 1
        self._queue.appendleft(req)
        self.tracer.mark_request(req.id, "requeue")

    @property
    def num_waiting(self) -> int:
        return len(self._queue)

    @property
    def num_running(self) -> int:
        return self._running

    @property
    def demand(self) -> int:
        """Requests wanting a slot right now (running + queued)."""
        return self._running + len(self._queue)

    def has_work(self) -> bool:
        return self.demand > 0


@dataclass
class Transfer:
    """One finished prefill in flight between submeshes: the host manifest
    (a :class:`~repro_torch.serve.pages.PageExport`), the device-side page block
    already ``device_put`` toward the decode submesh (jax transfers are
    async — enqueueing at prefill completion overlaps the copy with further
    prefill and decode work), and the owning request."""

    export: Any
    block: Any
    request: Request


class TransferQueue:
    """Tick-level FIFO between the prefill and decode workers.

    The prefill worker pushes a :class:`Transfer` the moment a prompt's
    last chunk completes; the decode worker admits from the head whenever
    it has a free slot *and* its pool can place the pages. Admission is
    strictly in completion order — a transfer the decode pool cannot place
    yet blocks the queue (it retries every tick), preserving the FIFO
    fairness of the single-mesh engine. ``total`` counts lifetime pushes
    for the engine's stats."""

    def __init__(self) -> None:
        self._q: deque[Transfer] = deque()
        self.total = 0

    def push(self, transfer: Transfer) -> None:
        self._q.append(transfer)
        self.total += 1

    def peek(self) -> Optional[Transfer]:
        return self._q[0] if self._q else None

    def pop(self) -> Transfer:
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)


def _ladder_from_schedule(schedule: Schedule, max_slots: int) -> List[int]:
    """Per-stage batch sizes of ``schedule``, clamped to ``max_slots`` and
    truncated once the cap is reached (further stages change nothing).
    Consecutive equal widths collapse into one rung (non-integer ρ can round
    two stages to the same batch; a duplicate rung would stall the ramp for
    a patience window and double-count a compiled decode variant)."""
    ladder: List[int] = []
    samples = 0
    while True:
        info = schedule.info(samples)
        width = max(1, min(max_slots, info.batch_size))
        if not ladder or width > ladder[-1]:
            ladder.append(width)
        if ladder[-1] >= max_slots or info.samples_end >= schedule.total_samples:
            return ladder
        samples = info.samples_end


class AdmissionController:
    """Stagewise slot-budget ramp b₁ → b₁ρ → b₁ρ² → … → max_slots.

    The budget ladder is read off a :class:`~repro_torch.core.schedules.Schedule`
    (default: a SEBS instance with the requested ``b1``/``rho``), so the
    serving ramp and the training batch schedule share one geometric law.
    The stage advances only after ``patience`` consecutive observations of
    demand exceeding the current budget — "sustained load" — so a transient
    burst doesn't trigger a fresh decode compile.
    """

    def __init__(
        self,
        b1: int = 1,
        rho: float = 2.0,
        max_slots: int = 8,
        patience: int = 2,
        schedule: Optional[Schedule] = None,
    ):
        assert max_slots >= 1 and b1 >= 1 and patience >= 1
        if schedule is None and (b1 >= max_slots or rho <= 1.0):
            # no ramp possible: budget already at cap, or no growth factor —
            # a flat single-stage ladder (SEBS itself requires rho > 1)
            self.ladder = [min(b1, max_slots)]
        else:
            if schedule is None:
                # enough stages for b₁ρˢ to reach max_slots (stage budgets
                # are a dummy: only per-stage batch sizes are consumed here)
                stages = 1 + math.ceil(math.log(max_slots / b1) / math.log(rho))
                schedule = SEBS(b1=b1, C1=1, rho=rho, num_stages=stages, eta=0.0)
            self.ladder = _ladder_from_schedule(schedule, max_slots)
        self.schedule = schedule
        self.max_slots = max_slots
        self.patience = patience
        self.stage = 0
        self._pressure = 0

    @property
    def num_stages(self) -> int:
        return len(self.ladder)

    def reset(self) -> None:
        """Return the ramp to stage 0 with no accumulated pressure — the
        public warm-run seam: benchmarks re-time an engine whose compiled
        decode variants are warm but whose admission history must not leak
        into the measured run."""
        self.stage = 0
        self._pressure = 0

    def budget(self) -> int:
        return self.ladder[self.stage]

    def observe(self, demand: int) -> int:
        """Feed one scheduler tick's demand; returns the (possibly newly
        enlarged) slot budget."""
        if demand > self.budget() and self.stage + 1 < len(self.ladder):
            self._pressure += 1
            if self._pressure >= self.patience:
                self.stage += 1
                self._pressure = 0
        else:
            self._pressure = 0
        return self.budget()
