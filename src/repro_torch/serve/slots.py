"""Slot-ring state for continuous batching.

A *slot* is one row of the fixed-shape decode batch and its row of the
KV/state cache. :class:`SlotManager` tracks which request occupies each
slot, its decode depth (the cache position the next token will be written
to), and its sampling parameters, and materializes the per-step device
inputs (token / position / active-mask / temperature / top-k arrays) for
``build_slot_decode_step``.

All bookkeeping is host-side numpy; the arrays are tiny (one scalar per
slot) and re-uploaded each tick. The heavy state — the KV cache — lives on
device and is only touched through the model's ``cache_insert`` helper at
admission and the jitted decode step in between.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.serve.pages import AdmissionPlan
from repro_torch.serve.scheduler import Request


@dataclass
class Slot:
    request: Optional[Request] = None
    pos: int = 0  # cache position of the token currently being fed

    @property
    def free(self) -> bool:
        return self.request is None


class SlotManager:
    def __init__(self, num_slots: int):
        self.slots: List[Slot] = [Slot() for _ in range(num_slots)]
        self.tokens = np.zeros((num_slots,), np.int32)  # current input token

    @property
    def width(self) -> int:
        return len(self.slots)

    def grow(self, num_slots: int) -> None:
        """Stage ramp: widen the ring (existing occupancy is preserved)."""
        assert num_slots >= self.width
        extra = num_slots - self.width
        self.slots.extend(Slot() for _ in range(extra))
        self.tokens = np.concatenate([self.tokens, np.zeros((extra,), np.int32)])

    def free_indices(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.free]

    def active_indices(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.free]

    def num_active(self) -> int:
        return sum(not s.free for s in self.slots)

    def admit(self, i: int, req: Request, first_token: int) -> None:
        """Occupy slot ``i``: the request's prompt cache has been inserted
        and ``first_token`` (sampled from the prefill logits) is the next
        decode input at depth ``len(prompt)``."""
        assert self.slots[i].free
        self.slots[i] = Slot(request=req, pos=len(req.prompt))
        self.tokens[i] = first_token
        req.generated.append(int(first_token))

    def release(self, i: int) -> None:
        self.slots[i] = Slot()
        self.tokens[i] = 0

    # -- per-step device inputs ---------------------------------------------
    def positions(self) -> np.ndarray:
        return np.asarray([s.pos for s in self.slots], np.int32)

    def active_mask(self) -> np.ndarray:
        return np.asarray([not s.free for s in self.slots], bool)

    def temperatures(self) -> np.ndarray:
        return np.asarray(
            [0.0 if s.free else s.request.temperature for s in self.slots], np.float32
        )

    def top_ks(self) -> np.ndarray:
        return np.asarray(
            [0 if s.free else s.request.top_k for s in self.slots], np.int32
        )

    def advance(self, next_tokens: np.ndarray) -> List[int]:
        """Apply one decode tick's sampled tokens. Returns the slot indices
        whose requests just finished (caller releases them after collecting
        results)."""
        finished = []
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            req = slot.request
            tok = int(next_tokens[i])
            req.generated.append(tok)
            slot.pos += 1
            self.tokens[i] = tok
            if len(req.generated) >= req.max_new_tokens:
                finished.append(i)
        return finished


# ---------------------------------------------------------------------------
# paged slot ring
# ---------------------------------------------------------------------------


@dataclass
class PagedSlot:
    """A slot of the paged ring. ``fill`` counts prompt positions whose KV /
    state have been computed (or reused); the slot is *prefilling* until
    ``fill == len(prompt)`` and its first generated token was sampled."""

    request: Optional[Request] = None
    plan: Optional[AdmissionPlan] = None
    fill: int = 0  # prompt positions done (incl. reused prefix)
    pos: int = 0  # cache position of the token currently being fed (decode)
    decoding: bool = False  # first output sampled; feeding generated tokens
    published: bool = False  # full prompt pages registered in the radix index

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefilling(self) -> bool:
        return self.request is not None and not self.decoding

    @property
    def prompt_remaining(self) -> int:
        return len(self.request.prompt) - self.fill


class PagedSlotManager:
    """Slot ring over the page pool. The page table is a dense
    ``(num_slots, max_pages)`` int32 array re-uploaded each tick; freed rows
    are zeroed so inactive lanes read/write only the scratch page 0.

    Unlike :class:`SlotManager`, admission does not carry a prefilled cache:
    a slot is admitted with an :class:`~repro_torch.serve.pages.AdmissionPlan`
    (pages + reused-prefix length) and filled in place — chunk steps for the
    bulk, teacher-forced decode ticks for the tail.
    """

    def __init__(self, num_slots: int, max_pages: int, chunk_floor: int = 1):
        self.max_pages = max_pages
        # prompt tails shorter than ``chunk_floor`` (the smallest chunk
        # bucket) are teacher-forced through decode ticks; larger remainders
        # wait for chunk-prefill steps
        self.chunk_floor = chunk_floor
        self.slots: List[PagedSlot] = [PagedSlot() for _ in range(num_slots)]
        self.tokens = np.zeros((num_slots,), np.int32)
        self.page_table = np.zeros((num_slots, max_pages), np.int32)

    def _teacher_forcing(self, s: PagedSlot) -> bool:
        return s.prefilling and 0 < s.prompt_remaining < self.chunk_floor

    def grow(self, num_slots: int) -> None:
        """Stage ramp: widen the ring (host arrays only — the device-side
        recurrent state is allocated at max width up front)."""
        assert num_slots >= self.width
        extra = num_slots - self.width
        self.slots.extend(PagedSlot() for _ in range(extra))
        self.tokens = np.concatenate([self.tokens, np.zeros((extra,), np.int32)])
        self.page_table = np.concatenate(
            [self.page_table, np.zeros((extra, self.max_pages), np.int32)]
        )

    @property
    def width(self) -> int:
        return len(self.slots)

    def free_indices(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.free]

    def num_active(self) -> int:
        return sum(not s.free for s in self.slots)

    def prefilling_indices(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.prefilling]

    def admit(self, i: int, req: Request, plan: AdmissionPlan) -> None:
        assert self.slots[i].free
        self.slots[i] = PagedSlot(request=req, plan=plan, fill=plan.reuse_len)
        self.tokens[i] = 0
        row = np.zeros((self.max_pages,), np.int32)
        row[: len(plan.pages)] = plan.pages
        self.page_table[i] = row

    def release(self, i: int) -> None:
        self.slots[i] = PagedSlot()
        self.tokens[i] = 0
        self.page_table[i] = 0

    def start_decoding(self, i: int, first_token: int) -> None:
        """Prefill complete: ``first_token`` (sampled from the last prompt
        token's logits) becomes the next decode input at depth
        ``len(prompt)``."""
        slot = self.slots[i]
        assert slot.prefilling and slot.fill == len(slot.request.prompt)
        slot.decoding = True
        slot.pos = len(slot.request.prompt)
        self.tokens[i] = first_token
        slot.request.generated.append(int(first_token))

    # -- per-tick device inputs ---------------------------------------------
    # A prefilling slot with 0 < prompt_remaining rides the decode tick
    # teacher-forced: it feeds its next prompt token at position ``fill``.
    def feed_tokens(self) -> np.ndarray:
        out = self.tokens.copy()
        for i, s in enumerate(self.slots):
            if self._teacher_forcing(s):
                out[i] = int(s.request.prompt[s.fill])
        return out

    def positions(self) -> np.ndarray:
        return np.asarray(
            [s.fill if s.prefilling else s.pos for s in self.slots], np.int32
        )

    def active_mask(self) -> np.ndarray:
        """Lanes that must advance this tick: decoding slots, plus
        prefilling slots teacher-forcing their sub-chunk prompt tail."""
        return np.asarray(
            [
                (not s.free) and (s.decoding or self._teacher_forcing(s))
                for s in self.slots
            ],
            bool,
        )

    def temperatures(self) -> np.ndarray:
        return np.asarray(
            [0.0 if s.free else s.request.temperature for s in self.slots], np.float32
        )

    def top_ks(self) -> np.ndarray:
        return np.asarray(
            [0 if s.free else s.request.top_k for s in self.slots], np.int32
        )

    def advance(self, next_tokens: np.ndarray) -> List[int]:
        """Apply one tick. Decoding slots append their sample; teacher-forced
        slots consume one prompt token (the sample is kept only when that was
        the *last* prompt token — it is the first generated token). Returns
        slot indices whose requests just finished."""
        finished = []
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            req = slot.request
            if slot.prefilling:
                if not self._teacher_forcing(slot):
                    continue  # waiting on chunk steps; did not ride this tick
                slot.fill += 1
                if slot.prompt_remaining == 0:
                    self.start_decoding(i, int(next_tokens[i]))
                    if len(req.generated) >= req.max_new_tokens:
                        finished.append(i)
                continue
            tok = int(next_tokens[i])
            req.generated.append(tok)
            slot.pos += 1
            self.tokens[i] = tok
            if len(req.generated) >= req.max_new_tokens:
                finished.append(i)
        return finished
