"""Serving engines.

- :class:`ServeEngine`: the static-batch baseline: one fixed batch of
  same-length prompts, prefilled together and decoded greedily in lockstep
  over a dense cache.
- :class:`ContinuousBatchingEngine`: requests enter a FIFO queue, are
  prefilled one at a time and inserted into a freed row of the live dense
  cache mid-decode-loop (``LanguageModel.cache_insert``), and a fixed-shape
  decode tick advances every slot at its own depth with per-slot sampling
  parameters; the ring widths it has decoded at, one a stage of the ramp,
  in ``decode_widths``.
- :class:`PagedContinuousBatchingEngine`, over a paged cache, below.

The paged engine admits requests from the FIFO queue
(:mod:`repro_torch.serve.scheduler`) into free slots of a fixed ring with
an admission plan over the page pool (:mod:`repro_torch.serve.pages`),
prefills them in fixed-size chunks interleaved with decode ticks, and
decodes one token per tick at each slot's own depth. In both continuous
engines the active slot budget ramps stagewise (b₁ρˢ) under sustained
load, the serving mirror of SEBS's stagewise batch enlargement.

An encoder-decoder model (whisper) needs each request's audio: ``memory``
(the request's ``audio_embeds``, (1, T, d), or the static batch's (B, T,
d)), and each engine raises the JAX engines' ``ValueError`` without it. An
engine encodes a request's audio once, at its prefill (the continuous
engine) or at its admission (the paged one), into a row of a (slots, T, d)
buffer in ``compute_dtype`` that every later step of the request reads;
the cross-attention's K and V are projected from that row at each step.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.lm import LanguageModel
from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serve.pages import (
    PagePool,
    RadixPrefixIndex,
    plan_admission,
    publish_prefix,
    release_pages,
)
from repro_torch.serve.scheduler import DONE, AdmissionController, RequestScheduler
from repro_torch.serve.slots import PagedSlotManager, SlotManager
from repro_torch.serve.step import (
    build_chunk_prefill_step,
    build_paged_decode_step,
    build_slot_decode_step,
    gumbel_noise,
    sample_tokens,
)


def _engine_device(device, params) -> torch.device:
    """The engine's device, once CUDA is known to be there (when asked for)
    and ``params`` are known to lie on it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the engine runs on cuda by default, and CUDA is not available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    table = params["embed"]["table"]
    if table.device.type != device.type:
        raise ValueError(f"params are on {table.device}, the engine on {device}")
    return device


def _put(array: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def _audio(memory, device) -> torch.Tensor:
    """A request's (or batch's) audio embeddings as a tensor on ``device``:
    a tensor as it is, an array through numpy."""
    if isinstance(memory, torch.Tensor):
        return memory.to(device)
    return _put(np.asarray(memory), device)


def _memory_buffer(model: LanguageModel, rows: int, device):
    """Zeroed (rows, encoder_seq, d) memory rows in ``compute_dtype`` for an
    encoder-decoder model, else None."""
    cfg = model.cfg
    if not cfg.is_encoder_decoder:
        return None
    return torch.zeros((rows, cfg.encoder_seq, cfg.d_model), dtype=getattr(torch, cfg.compute_dtype),
                       device=device)


def _require_memory(model: LanguageModel, memory, what: str) -> None:
    if model.cfg.is_encoder_decoder and memory is None:
        raise ValueError(f"encoder-decoder model requires {what}audio memory")


class ServeEngine:
    """Static batch: ``generate(prompts)`` prefills the (B, P) prompts
    together and decodes greedily in lockstep over a dense cache of
    ``cache_len`` positions, on ``device``, where ``params`` lie."""

    def __init__(self, model: LanguageModel, params, cache_len: int = 256, device="cuda"):
        self.device = _engine_device(device, params)
        self.model = model
        self.params = params
        self.cache_len = cache_len

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16, memory=None) -> np.ndarray:
        """prompts: (B, P) int. Greedy decode. Returns (B, P+new) int32. An
        encoder-decoder model takes the batch's audio embeddings as
        ``memory`` (B, T, d), encoded once for the prefill and every decode
        step."""
        b, p = prompts.shape
        if p + max_new_tokens > self.cache_len:
            raise ValueError(f"prompt {p} + {max_new_tokens} new tokens exceed cache_len {self.cache_len}")
        _require_memory(self.model, memory, "")
        vocab = self.model.cfg.vocab_size
        tokens = _put(np.asarray(prompts, np.int32), self.device)
        cache = self.model.init_cache(b, self.cache_len, device=self.device)
        if memory is not None:
            memory = self.model._encode(self.params, {"audio_embeds": _audio(memory, self.device)})
        logits, cache = self.model.prefill(self.params, {"tokens": tokens}, cache, memory=memory)
        out = [tokens]
        token = torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None].to(torch.int32)
        for i in range(max_new_tokens):
            out.append(token)
            if i == max_new_tokens - 1:
                break
            logits, cache = self.model.decode_step(self.params, token, cache, p + i, memory=memory)
            token = torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None].to(torch.int32)
        return torch.cat(out, dim=1).cpu().numpy()


class ContinuousBatchingEngine:
    """Continuous batching over a dense cache, with a stagewise admission
    ramp.

    Usage: ``submit()`` any number of requests (mixed prompt lengths,
    per-request ``max_new_tokens`` / ``temperature`` / ``top_k``), then
    ``run()`` to completion. ``run`` returns ``{request_id: (P+new,) tokens}``.

    ``b1``/``rho``/``max_slots``/``patience`` parameterize the admission
    ramp; the default ``b1=None`` starts at ``max_slots`` (no ramp). With
    ``b1 < max_slots`` the slot ring starts narrow and is enlarged
    geometrically only under sustained queue pressure (the dense cache
    grows with it); ``decode_widths`` holds the widths the decode tick has
    run at, one a stage (the JAX engine compiles a decode variant for each).

    The engine runs on ``device`` and takes ``params`` there. Prefill goes
    through the flash forward and sampling through the fused sampler (the
    kernels on a CUDA device); sampling noise comes from one
    ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(
        self,
        model: LanguageModel,
        params,
        cache_len: int = 256,
        max_slots: int = 8,
        b1: Optional[int] = None,
        rho: float = 2.0,
        patience: int = 2,
        admission: Optional[AdmissionController] = None,
        seed: int = 0,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        device="cuda",
    ):
        self.device = _engine_device(device, params)
        self.model = model
        self.params = params
        self.cache_len = cache_len
        self.admission = admission or AdmissionController(
            b1=b1 if b1 is not None else max_slots, rho=rho, max_slots=max_slots, patience=patience,
        )
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self._clock = self.tracer.clock
        self.scheduler = RequestScheduler(clock=self._clock, tracer=self.tracer)
        self._decode = build_slot_decode_step(model)
        self.decode_widths: set = set()  # ring widths the decode tick has run at
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats: Dict[str, Any] = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> Dict[str, Any]:
        return {
            "ticks": 0,
            "decoded_tokens": 0,
            "peak_width": 0,
            # bounded: a long-lived engine ticks indefinitely
            "stage_history": deque(maxlen=4096),
            # wall time of each decode tick, dispatch to tokens on the host
            "decode_tick_s": deque(maxlen=4096),
        }

    def reset_stats(self) -> None:
        """Zero every counter for a fresh measurement window, in place. The
        decode variants and the admission ramp are untouched."""
        self.stats.clear()
        self.stats.update(self._fresh_stats())

    # -- request intake ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16, temperature: float = 0.0,
               top_k: int = 0, memory=None, tag: str = "") -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens > self.cache_len:
            raise ValueError(f"prompt {prompt.size} + {max_new_tokens} new tokens "
                             f"exceed cache_len {self.cache_len}")
        _require_memory(self.model, memory, "per-request ")
        return self.scheduler.submit(
            prompt, max_new_tokens, temperature=temperature, top_k=top_k, memory=memory, tag=tag
        )

    # -- device-state plumbing ----------------------------------------------
    def _grow_cache(self, cache, new_width: int):
        # the old ring is one wide "slot" written at row 0 of the wider cache
        grown = self.model.init_cache(new_width, self.cache_len, device=self.device)
        return self.model.cache_insert(grown, cache, 0)

    def _prefill_request(self, req):
        """Batch-1 prefill of one admitted request. Returns the sampled first
        token, the request's batch-1 cache, ready for ``cache_insert``, and
        its encoder memory row (an encoder-decoder model's; else None)."""
        cache = self.model.init_cache(1, self.cache_len, device=self.device)
        memory_row = None
        if self.model.cfg.is_encoder_decoder:
            memory_row = self.model._encode(self.params, {"audio_embeds": _audio(req.memory, self.device)})
        logits, cache = self.model.prefill(self.params, {"tokens": _put(req.prompt[None, :], self.device)},
                                          cache, memory=memory_row)
        logits = logits[:, -1, : self.model.cfg.vocab_size].float().contiguous()
        first = sample_tokens(
            logits,
            gumbel_noise(logits.shape, self._generator),
            torch.tensor([req.temperature], dtype=torch.float32, device=self.device),
            torch.tensor([req.top_k], dtype=torch.int32, device=self.device),
        )
        return int(first[0]), cache, memory_row

    # -- the serve loop ------------------------------------------------------
    @torch.inference_mode()
    def run(self) -> Dict[int, np.ndarray]:
        """Drive admission + decode until every submitted request is done.
        Returns results for the requests completed during THIS call."""
        completed: Dict[int, np.ndarray] = {}
        width = self.admission.budget()
        slots = SlotManager(width)
        cache = self.model.init_cache(width, self.cache_len, device=self.device)
        memory_buf = _memory_buffer(self.model, width, self.device)

        while self.scheduler.has_work():
            # 1. stagewise ramp: enlarge the ring under sustained pressure
            budget = self.admission.observe(self.scheduler.demand)
            if budget > width:
                cache = self._grow_cache(cache, budget)
                slots.grow(budget)
                if memory_buf is not None:
                    grown = _memory_buffer(self.model, budget, self.device)
                    grown[:width].copy_(memory_buf)
                    memory_buf = grown
                width = budget
            self.stats["peak_width"] = max(self.stats["peak_width"], width)

            # 2. admit queued requests into freed slots (mid-decode-loop
            #    cache insertion)
            for i in slots.free_indices():
                req = self.scheduler.pop_waiting()
                if req is None:
                    break
                first, slot_cache, memory_row = self._prefill_request(req)
                cache = self.model.cache_insert(cache, slot_cache, i)
                if memory_row is not None:
                    memory_buf[i].copy_(memory_row[0])
                slots.admit(i, req, first)
                # dense prefill is synchronous: handoff and first token land
                # together at admission
                self.scheduler.prefill_done(req)
                self.scheduler.first_token(req)
                if len(req.generated) >= req.max_new_tokens:
                    self.scheduler.finish(req)
                    completed[req.id] = req.tokens()
                    slots.release(i)
            if not slots.num_active():
                continue

            # 3. one fixed-shape decode tick over the whole ring
            t_tick = self._clock()
            self.decode_widths.add(width)
            nxt, cache, _ = self._decode(
                self.params,
                _put(slots.tokens[:, None], self.device),
                cache,
                _put(slots.positions(), self.device),
                _put(slots.active_mask(), self.device),
                _put(slots.temperatures(), self.device),
                _put(slots.top_ks(), self.device),
                self._generator,
                memory=memory_buf,
            )
            n_active = slots.num_active()
            self.stats["ticks"] += 1
            self.stats["decoded_tokens"] += n_active
            self.stats["stage_history"].append(self.admission.stage)
            nxt = nxt.cpu().numpy()  # block: the tick's tokens reach the host
            t_now = self._clock()
            self.stats["decode_tick_s"].append(t_now - t_tick)
            self.tracer.complete("serve.decode_tick", t_tick, t_now, width=width, decoded=n_active)
            if self.tracer.enabled:
                self.tracer.counter(
                    "serve.queue", waiting=self.scheduler.num_waiting, running=self.scheduler.num_running,
                )
                self.tracer.counter("serve.admission", stage=self.admission.stage, budget=width)
            self.metrics.histogram("serve.decode_tick_s").observe(t_now - t_tick)
            self.metrics.counter("serve.decoded_tokens").inc(n_active)
            self.metrics.counter("serve.ticks").inc()

            # 4. bookkeeping: collect finished requests, free their slots
            for i in slots.advance(nxt):
                req = slots.slots[i].request
                self.scheduler.finish(req)
                completed[req.id] = req.tokens()
                slots.release(i)
        return completed

    def latencies(self) -> Dict[int, float]:
        """Per-request wall-clock latency (submit → finish) for DONE requests."""
        return {rid: req.latency for rid, req in self.scheduler.requests.items() if req.state == DONE}


class PagedContinuousBatchingEngine:
    """Continuous batching over a paged KV cache with radix prefix sharing.

    - **Memory**: attention KV lives in a :class:`~repro_torch.serve.pages.PagePool`
      of ``page_size``-token pages; a slot holds a page *table*, not a dense
      ``cache_len`` row, so resident KV scales with live tokens (high-water
      mark reported by :meth:`memory_stats`).
    - **Prefix sharing**: prompts sharing a prefix alias the same published,
      immutable pages through a :class:`~repro_torch.serve.pages.RadixPrefixIndex`
      (token-granular: the divergence page is copy-on-written).
    - **Chunked prefill**: a prompt is computed in fixed-size chunks (the
      sizes in ``prefill_chunks``), at most one chunk per engine tick,
      interleaved with decode ticks so long prompts don't stall running
      requests. The sub-chunk tail rides the regular decode tick
      teacher-forced.

    The engine runs on ``device`` and takes ``params`` there. On a CUDA
    device its attention and sampling always go through the paged-decode
    kernels (there is no switch). Sampling noise comes from one
    ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(
        self,
        model: LanguageModel,
        params,
        cache_len: int = 256,
        max_slots: int = 8,
        b1: Optional[int] = None,
        rho: float = 2.0,
        patience: int = 2,
        admission: Optional[AdmissionController] = None,
        seed: int = 0,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        prefix_cache: bool = True,
        prefill_chunks=(32,),
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        device="cuda",
    ):
        self.device = _engine_device(device, params)
        self.model = model
        self.params = params
        self.cache_len = cache_len
        self.page_size = page_size
        self.max_pages = -(-cache_len // page_size)  # logical pages per slot
        # default pool: dense-equivalent capacity (+ scratch page 0)
        self.num_pages = num_pages if num_pages is not None else 1 + max_slots * self.max_pages
        self.pool = PagePool(self.num_pages, page_size)
        self.prefix_sharing = bool(prefix_cache) and self._sharing_supported(model)
        self.index = RadixPrefixIndex(self.pool) if self.prefix_sharing else None
        self.prefill_chunks = tuple(sorted(set(int(c) for c in prefill_chunks)))
        if not self.prefill_chunks or min(self.prefill_chunks) < 1:
            raise ValueError(f"prefill_chunks must be sizes >= 1, got {prefill_chunks}")
        self.max_slots = max_slots
        self.admission = admission or AdmissionController(
            b1=b1 if b1 is not None else max_slots, rho=rho, max_slots=max_slots, patience=patience,
        )
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self._clock = self.tracer.clock
        self.scheduler = RequestScheduler(clock=self._clock, tracer=self.tracer)
        # device state: the paged KV pools, allocated once and updated in place
        self.cache_dtype = torch.bfloat16
        self.cache = model.init_paged_cache(
            self.num_pages, page_size, max_slots, dtype=self.cache_dtype, device=self.device
        )
        self._decodes: Dict[int, Any] = {}  # ring width -> paged decode tick
        self._chunk_step = build_chunk_prefill_step(model)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._chunk_rr = 0  # round-robin cursor over prefilling slots
        self.stats: Dict[str, Any] = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> Dict[str, Any]:
        return {
            "ticks": 0,
            "decoded_tokens": 0,
            "peak_width": 0,
            # bounded: a long-lived engine ticks indefinitely
            "stage_history": deque(maxlen=4096),
            "prefill_chunks": 0,
            "prefill_tokens_computed": 0,
            "prefix_tokens_reused": 0,
            "prompt_tokens_total": 0,
            "cow_copies": 0,
            # wall time per tick from the first prefill-chunk dispatch to the
            # decode tokens landing on host, for ticks that decoded >= 1 real
            # (non-teacher-forced) token
            "decode_tick_s": deque(maxlen=4096),
        }

    def reset_stats(self) -> None:
        """Zero every counter and rebase the page pool's high-water mark, so
        the next ``memory_stats()`` reports the peak of the new window.
        Published prefix pages are kept."""
        self.stats.clear()
        self.stats.update(self._fresh_stats())
        self.pool.peak_used = self.pool.used

    @staticmethod
    def _sharing_supported(model: LanguageModel) -> bool:
        cfg = model.cfg
        mixers = {b.mixer for s in cfg.segments for b in s.body}
        return not cfg.is_encoder_decoder and not cfg.num_vision_tokens and mixers <= {"attn", "swa"}

    # -- request intake ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16, temperature: float = 0.0,
               top_k: int = 0, memory=None, tag: str = "") -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens > self.cache_len:
            raise ValueError(f"prompt {prompt.size} + {max_new_tokens} new tokens "
                             f"exceed cache_len {self.cache_len}")
        _require_memory(self.model, memory, "per-request ")
        return self.scheduler.submit(
            prompt, max_new_tokens, temperature=temperature, top_k=top_k, memory=memory, tag=tag
        )

    def _decode_for(self, width: int):
        if width not in self._decodes:
            self._decodes[width] = build_paged_decode_step(self.model, width)
        return self._decodes[width]

    def _put(self, array: np.ndarray) -> torch.Tensor:
        return _put(array, self.device)

    # -- admission -----------------------------------------------------------
    def _admit(self, slots: PagedSlotManager, i: int, req, memory_buf):
        """Plan request ``req``'s pages and admit it into slot ``i``, its
        audio encoded into row ``i`` of ``memory_buf`` (an encoder-decoder
        model's). Returns the plan, or None when the pool cannot hold it."""
        total = len(req.prompt) + req.max_new_tokens
        plan = plan_admission(self.pool, self.index, req.prompt, total, share=self.prefix_sharing)
        if plan is None:
            return None
        if plan.cow_src is not None:
            # copy-on-write: duplicate the divergence page, reuse its first
            # reuse_len % page_size positions, overwrite from there on
            self.cache = self.model.paged_copy_page(self.cache, plan.cow_src, plan.new_pages[0])
            self.stats["cow_copies"] += 1
        self.cache = self.model.paged_zero_state_row(self.cache, i)
        if memory_buf is not None:
            row = self.model._encode(self.params, {"audio_embeds": _audio(req.memory, self.device)})
            memory_buf[i].copy_(row[0])
        slots.admit(i, req, plan)
        self.stats["prefix_tokens_reused"] += plan.reuse_len
        self.stats["prompt_tokens_total"] += len(req.prompt)
        return plan

    def _sample_first(self, req, logits):
        """The request's first token, from its last prompt logits: through
        the same sampler (the kernel, on a CUDA device) as the decode tick."""
        logits = logits[:, -1, : self.model.cfg.vocab_size].float().contiguous()
        first = sample_tokens(
            logits,
            gumbel_noise(logits.shape, self._generator),
            torch.tensor([req.temperature], dtype=torch.float32, device=self.device),
            torch.tensor([req.top_k], dtype=torch.int32, device=self.device),
        )
        return int(first[0])

    def _finish(self, slots: PagedSlotManager, i: int, completed):
        req = slots.slots[i].request
        release_pages(self.pool, slots.slots[i].plan.pages)
        # a request finishing in the same tick it started decoding (tail
        # path, max_new_tokens == 1) reaches here before the bookkeeping
        # loop stamped its handoff; both stamps are idempotent
        self.scheduler.prefill_done(req)
        self.scheduler.first_token(req)
        self.scheduler.finish(req)
        completed[req.id] = req.tokens()
        slots.release(i)

    def _maybe_publish(self, slots: PagedSlotManager, i: int):
        slot = slots.slots[i]
        if self.index is None or slot.published or not slot.decoding:
            return
        publish_prefix(self.index, slot.request.prompt, slot.plan.pages)
        slot.published = True

    # -- the serve loop ------------------------------------------------------
    @torch.inference_mode()
    def run(self) -> Dict[int, np.ndarray]:
        """Drive admission + chunked prefill + decode until every submitted
        request is done. Returns results completed during THIS call."""
        completed: Dict[int, np.ndarray] = {}
        width = self.admission.budget()
        slots = PagedSlotManager(width, self.max_pages, chunk_floor=min(self.prefill_chunks))
        memory_buf = _memory_buffer(self.model, self.max_slots, self.device)

        while self.scheduler.has_work():
            # 1. stagewise ramp (host-side only: device state is full-width)
            budget = self.admission.observe(self.scheduler.demand)
            if budget > width:
                slots.grow(budget)
                width = budget
            self.stats["peak_width"] = max(self.stats["peak_width"], width)

            # 2. admit queued requests into freed slots; a request that finds
            #    no pages (even after LRU eviction) waits for releases
            admitted = 0
            for i in slots.free_indices():
                req = self.scheduler.pop_waiting()
                if req is None:
                    break
                if self._admit(slots, i, req, memory_buf) is None:
                    self.scheduler.requeue(req)
                    break
                admitted += 1
            if slots.num_active() == 0:
                if admitted == 0 and self.scheduler.has_work():
                    raise RuntimeError(
                        f"page pool ({self.pool.capacity} pages of {self.page_size}) "
                        "cannot fit the next request even after eviction"
                    )
                if not self.scheduler.has_work():
                    break

            # 3. one prefill chunk (round-robin over prefilling slots, so a
            #    long prompt neither stalls decode nor starves other
            #    prefills of their chunk turn)
            t_tick = self._clock()
            prefilling = slots.prefilling_indices()
            self._chunk_rr += 1
            turn = self._chunk_rr % max(len(prefilling), 1)
            for i in prefilling[turn:] + prefilling[:turn]:
                slot = slots.slots[i]
                bucket = max((c for c in self.prefill_chunks if c <= slot.prompt_remaining), default=None)
                if bucket is None:
                    continue  # sub-chunk tail: teacher-forced by the tick below
                req = slot.request
                logits, self.cache = self._chunk_step(
                    self.params,
                    self._put(req.prompt[slot.fill : slot.fill + bucket][None, :]),
                    self.cache,
                    slot.fill,
                    i,
                    self._put(slots.page_table[i : i + 1]),
                    memory=None if memory_buf is None else memory_buf[i : i + 1],
                )
                slot.fill += bucket
                self.stats["prefill_chunks"] += 1
                self.stats["prefill_tokens_computed"] += bucket
                if slot.prompt_remaining == 0:
                    slots.start_decoding(i, self._sample_first(req, logits))
                    self.scheduler.prefill_done(req)
                    self.scheduler.first_token(req)
                    self._maybe_publish(slots, i)
                    if len(req.generated) >= req.max_new_tokens:
                        self._finish(slots, i, completed)
                break

            # 4. one fixed-shape decode tick: decoding slots advance one
            #    token, prefilling slots teacher-force their prompt tail
            active = slots.active_mask()
            if not active.any():
                continue
            n_forced = sum(1 for i in range(width) if active[i] and slots.slots[i].prefilling)
            nxt, self.cache = self._decode_for(width)(
                self.params,
                self._put(slots.feed_tokens()[:, None]),
                self.cache,
                self._put(slots.positions()),
                self._put(slots.page_table),
                self._put(active),
                self._put(slots.temperatures()),
                self._put(slots.top_ks()),
                self._generator,
                memory=memory_buf,
            )
            n_decoded = int(active.sum()) - n_forced
            self.stats["ticks"] += 1
            self.stats["decoded_tokens"] += n_decoded
            self.stats["prefill_tokens_computed"] += n_forced
            self.stats["stage_history"].append(self.admission.stage)
            nxt = nxt.cpu().numpy()  # block: the tick's tokens reach the host
            if n_decoded > 0:
                t_now = self._clock()
                self.stats["decode_tick_s"].append(t_now - t_tick)
                self.tracer.complete(
                    "serve.decode_tick", t_tick, t_now, width=width, decoded=n_decoded, forced=n_forced,
                )
                self.metrics.histogram("serve.decode_tick_s").observe(t_now - t_tick)
            if self.tracer.enabled:
                self.tracer.counter("serve.pool", used=self.pool.used, capacity=self.pool.capacity)
                self.tracer.counter(
                    "serve.queue", waiting=self.scheduler.num_waiting, running=self.scheduler.num_running,
                )
                self.tracer.counter("serve.admission", stage=self.admission.stage, budget=width)
                self.tracer.counter(
                    "serve.prefix",
                    reused=self.stats["prefix_tokens_reused"],
                    total=self.stats["prompt_tokens_total"],
                )
            self.metrics.counter("serve.decoded_tokens").inc(n_decoded)
            self.metrics.counter("serve.ticks").inc()
            self.metrics.gauge("serve.pool_used").set(self.pool.used)

            # 5. bookkeeping: newly-decoding slots timestamp their handoff
            #    and publish their prefix, finished requests release pages
            for i in slots.advance(nxt):
                self._maybe_publish(slots, i)
                self._finish(slots, i, completed)
            for i in range(width):
                slot = slots.slots[i]
                if slot.free:
                    continue
                if slot.decoding and slot.request.t_prefill_done == 0.0:
                    # tail-path handoff: advance() appended the first token
                    # inside this tick
                    self.scheduler.prefill_done(slot.request)
                    self.scheduler.first_token(slot.request)
                self._maybe_publish(slots, i)
        return completed

    # -- reporting -----------------------------------------------------------
    def latencies(self) -> Dict[int, float]:
        return {rid: req.latency for rid, req in self.scheduler.requests.items() if req.state == DONE}

    def memory_stats(self) -> Dict[str, Any]:
        """KV memory accounting: the paged high-water mark vs what a dense
        cache pins for the same ring."""
        per_page = self.model.paged_kv_bytes_per_page(self.page_size, self.cache_dtype)
        dense_rows = max(self.stats["peak_width"], 1)
        return {
            "page_size": self.page_size,
            "pages_capacity": self.pool.capacity,
            "pages_peak": self.pool.peak_used,
            "kv_bytes_peak": self.pool.peak_used * per_page,
            "kv_bytes_dense_equiv": dense_rows * self.max_pages * per_page,
            "prefix_hit_rate": (
                self.stats["prefix_tokens_reused"] / max(self.stats["prompt_tokens_total"], 1)
            ),
        }
