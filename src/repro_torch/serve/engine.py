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
- :class:`DisaggregatedEngine`: the paged engine split into a prefill and a
  decode worker, each with its own page pool, on two devices or one, with
  finished prefills streamed across as page blocks.

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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.models.lm import LanguageModel
from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serve.pages import (
    PagePool,
    RadixPrefixIndex,
    export_pages,
    import_pages,
    plan_admission,
    publish_prefix,
    release_pages,
)
from repro_torch.serve.scheduler import DONE, AdmissionController, RequestScheduler, Transfer, TransferQueue
from repro_torch.serve.slots import PagedSlotManager, SlotManager
from repro_torch.serve.step import (
    build_chunk_prefill_step,
    build_page_export_step,
    build_page_import_step,
    build_paged_decode_step,
    build_slot_decode_step,
    gumbel_noise,
    sample_tokens,
)
from repro_torch.utils.tree import tree_leaves, tree_map


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
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)  # repro-lint: disable=R105 -- host input to a worker's device, not pool state


def _audio(memory, device) -> torch.Tensor:
    """A request's (or batch's) audio embeddings as a tensor on ``device``:
    a tensor as it is, an array through numpy."""
    if isinstance(memory, torch.Tensor):
        return memory.to(device)  # repro-lint: disable=R105 -- a request's audio input to the engine's device
    return _put(np.asarray(memory), device)


def _memory_buffer(model: LanguageModel, rows: int, device):
    """Zeroed (rows, encoder_seq, d) memory rows in ``compute_dtype`` for an
    encoder-decoder model, else None."""
    cfg = model.cfg
    if not cfg.is_encoder_decoder:
        return None
    return torch.zeros((rows, cfg.encoder_seq, cfg.d_model), dtype=getattr(torch, cfg.compute_dtype),
                       device=device)


def _first_token(model: LanguageModel, req, logits, generator: torch.Generator) -> int:
    """A request's first token, from its last prompt logits (on the
    generator's device): through the same sampler (the kernel, on a CUDA
    device) as the decode tick."""
    logits = logits[:, -1, : model.cfg.vocab_size].float().contiguous()
    first = sample_tokens(
        logits,
        gumbel_noise(logits.shape, generator),
        torch.tensor([req.temperature], dtype=torch.float32, device=logits.device),
        torch.tensor([req.top_k], dtype=torch.int32, device=logits.device),
    )
    return int(first[0])


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
        return torch.cat(out, dim=1).cpu().numpy()  # repro-lint: disable=R105 -- generated tokens read on the host


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
    run at, one a stage. The engine builds a decode step for each width it
    reaches (``_decodes``); ``decode_compiles`` counts the steps built, under
    the JAX engine's name, which counts the decode variants it compiles.

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
        self._decodes: Dict[int, Any] = {}  # ring width -> slot decode tick
        self.decode_compiles = 0  # decode steps built, one a width reached
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

    @property
    def decode_widths(self) -> set:
        """The ring widths the decode tick has run at."""
        return set(self._decodes)

    def _decode_for(self, width: int):
        if width not in self._decodes:
            self._decodes[width] = build_slot_decode_step(self.model)
            self.decode_compiles += 1
        return self._decodes[width]

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
        return _first_token(self.model, req, logits, self._generator), cache, memory_row

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
            nxt, cache, _ = self._decode_for(width)(
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
            # block: the tick's tokens reach the host
            nxt = nxt.cpu().numpy()  # repro-lint: disable=R105 -- sampled tokens read on the host
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

        if sanitize.enabled():
            sanitize.audit_engine_compiles(self, where="(run end)")
            sanitize.audit_tracer(self.tracer, where="(run end)")
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

    The engine builds a decode step for each ring width it reaches
    (``_decodes``) and a chunk step for each chunk size it uses
    (``_chunk_steps``); ``decode_compiles`` and ``prefill_compiles`` count
    the steps built, under the JAX engine's names (there, the executables
    compiled). With ``REPRO_SANITIZE=1`` the page pool is audited after
    every admission, publish and release, and the step caches and the
    tracer at the end of each ``run()`` (:mod:`repro_torch.analysis.sanitize`).

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
        self._chunk_steps: Dict[int, Any] = {}  # chunk size -> prefill step
        self.decode_compiles = 0  # steps built, under the JAX engine's names
        self.prefill_compiles = 0
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
            self.decode_compiles += 1
        return self._decodes[width]

    def _chunk_for(self, size: int):
        if size not in self._chunk_steps:
            self._chunk_steps[size] = build_chunk_prefill_step(self.model)
            self.prefill_compiles += 1
        return self._chunk_steps[size]

    def _put(self, array: np.ndarray) -> torch.Tensor:
        return _put(array, self.device)

    # -- sanitizer seam ------------------------------------------------------
    def _audit_pages(self, slots: PagedSlotManager, where: str) -> None:
        """REPRO_SANITIZE=1 hook: exact refcount reconstruction after every
        pool-mutating transition (admit / publish / finish)."""
        if sanitize.enabled():
            plans = [s.plan for s in slots.slots if not s.free]
            sanitize.audit_page_pool(self.pool, self.index, plans, where=where)

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
        self._audit_pages(slots, where=f"after admit(slot {i})")
        return plan

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
        self._audit_pages(slots, where=f"after release(slot {i})")

    def _maybe_publish(self, slots: PagedSlotManager, i: int):
        slot = slots.slots[i]
        if self.index is None or slot.published or not slot.decoding:
            return
        publish_prefix(self.index, slot.request.prompt, slot.plan.pages)
        slot.published = True
        self._audit_pages(slots, where=f"after publish(slot {i})")

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
                logits, self.cache = self._chunk_for(bucket)(
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
                    slots.start_decoding(i, _first_token(self.model, req, logits, self._generator))
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
            # block: the tick's tokens reach the host
            nxt = nxt.cpu().numpy()  # repro-lint: disable=R105 -- sampled tokens read on the host
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

        if sanitize.enabled():
            sanitize.audit_engine_compiles(self, where="(run end)")
            sanitize.audit_tracer(self.tracer, where="(run end)")
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


class _DisaggWorker:
    """Shared shape of the two disaggregated workers: a private page pool
    (and radix index), params and a paged cache on the worker's device, and
    the step caches the sanitizer audits. ``audit_engine_compiles``
    duck-types against these attributes; ``admission`` bounds the worker's
    tick widths: the engine's SEBS controller for the decode worker, a
    single-rung ladder at the fixed ring width for the prefill worker's tail
    tick. ``decode_compiles`` and ``prefill_compiles`` count the steps
    built, under the JAX workers' names (there, the executables compiled)."""

    def __init__(self, model: LanguageModel, params, device, admission: AdmissionController,
                 num_pages: int, page_size: int, prefix_cache: bool, state_batch: int, seed: int):
        self.model = model
        self.params = params
        self.device = device
        self.admission = admission
        self.pool = PagePool(num_pages, page_size)
        self.index = RadixPrefixIndex(self.pool) if prefix_cache else None
        self.cache = model.init_paged_cache(num_pages, page_size, state_batch, dtype=torch.bfloat16,
                                            device=device)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._decodes: Dict[int, Any] = {}
        self._chunk_steps: Dict[int, Any] = {}
        self.prefill_chunks: Tuple[int, ...] = ()
        self.decode_compiles = 0
        self.prefill_compiles = 0

    def put(self, array: np.ndarray) -> torch.Tensor:
        return _put(array, self.device)

    def audit_pages(self, slots: PagedSlotManager, where: str) -> None:
        """REPRO_SANITIZE=1 hook: exact refcount reconstruction for THIS
        worker's pool after every pool-mutating transition."""
        if sanitize.enabled():
            plans = [s.plan for s in slots.slots if not s.free]
            sanitize.audit_page_pool(self.pool, self.index, plans, where=where)


class _PrefillWorker(_DisaggWorker):
    """Prefill half: chunked prefill at its own ring width and chunk sizes,
    and the page export. Prompt tails shorter than the smallest chunk ride
    the worker's own teacher-forced tick: the paged decode step of the
    single-device engine's tail path, built once at the fixed prefill ring
    width. The worker's ladder is the single rung ``[ring]``, so the step
    audit bounds it to exactly that one tick."""

    def __init__(self, model: LanguageModel, params, device, ring: int, num_pages: int, page_size: int,
                 prefix_cache: bool, prefill_chunks, seed: int):
        super().__init__(model, params, device, AdmissionController(b1=ring, max_slots=ring), num_pages,
                         page_size, prefix_cache, ring, seed)
        self.ring = ring
        self.prefill_chunks = tuple(sorted(set(int(c) for c in prefill_chunks)))
        if not self.prefill_chunks or min(self.prefill_chunks) < 1:
            raise ValueError(f"prefill_chunks must be sizes >= 1, got {prefill_chunks}")
        self.export = build_page_export_step(model)

    def chunk_for(self, size: int):
        if size not in self._chunk_steps:
            self._chunk_steps[size] = build_chunk_prefill_step(self.model)
            self.prefill_compiles += 1
        return self._chunk_steps[size]

    def tick(self):
        """The tail tick, at the prefill ring width."""
        if self.ring not in self._decodes:
            self._decodes[self.ring] = build_paged_decode_step(self.model, self.ring)
            self.decode_compiles += 1
        return self._decodes[self.ring]


class _DecodeWorker(_DisaggWorker):
    """Decode half: pure fixed-shape decode ticks behind the SEBS admission
    ladder, and the page import that adopts streamed prefills.
    ``prefill_chunks`` stays ``()`` and ``_chunk_steps`` stays ``{}`` by
    construction: the REPRO_SANITIZE step audit *enforces* that this worker
    never builds a chunk-prefill step."""

    def __init__(self, model: LanguageModel, params, device, admission: AdmissionController,
                 num_pages: int, page_size: int, prefix_cache: bool, max_slots: int, seed: int):
        super().__init__(model, params, device, admission, num_pages, page_size, prefix_cache, max_slots,
                         seed)
        self.import_ = build_page_import_step(model)

    def decode_for(self, width: int):
        if width not in self._decodes:
            self._decodes[width] = build_paged_decode_step(self.model, width)
            self.decode_compiles += 1
        return self._decodes[width]


class DisaggregatedEngine:
    """Disaggregated prefill/decode serving on two devices (or both workers
    on one).

    Splits :class:`PagedContinuousBatchingEngine` into two workers, each on
    its own device (:func:`repro_torch.launch.mesh.make_disagg_submeshes`
    carves two disjoint device groups; a worker takes its group's lead
    device):

    - the **prefill worker** runs chunked prefill at its own ring width
      (``prefill_slots``) and chunk sizes against a private
      :class:`~repro_torch.serve.pages.PagePool`, so long prompts no longer
      share a tick with decode;
    - the **decode worker** runs pure fixed-shape decode ticks behind the
      SEBS admission ladder against its own pool, and builds *no*
      chunk-prefill step.

    A finished prefill streams to the decode device as a
    :class:`~repro_torch.serve.scheduler.Transfer`: the prompt's pages and
    the recurrent-state row are copied into a pool-size-free block
    (``step.build_page_export_step``), moved to the decode device in
    :meth:`_stream`, the engine's one transfer between the devices, and
    adopted into the decode pool by
    :func:`~repro_torch.serve.pages.import_pages`: page ids remapped,
    refcounts re-established in the destination pool, and the prompt's full
    pages re-published to the decode-side radix index. A transfer whose
    full-page prefix is already resident decode-side adopts those pages by
    reference (their lanes are not written).

    Greedy output equals the single-device paged engine's given the same
    ``prefill_chunks``: a chunk's KV equals the decode path's per token,
    prompt tails take the same teacher-forced tick (at the prefill ring
    width; the tick's rows are independent), streamed pages and state rows
    are bit-exact copies, and greedy sampling is an argmax, indifferent to
    the engines' different use of the sampling noise. Encoder-decoder models
    are not supported; recurrent-state families are (the state row rides the
    block).

    A worker whose device (``prefill_device``, ``decode_device``) is left
    None takes ``device``'s: on "cuda" the first two visible cards, or both
    the one card there is (two pools, two caches and the export / move / import
    seam all the same), on "cpu" the CPU. Params are moved to each worker's
    device; on one device both workers share the same tensors. On a CUDA
    device attention and sampling go through the paged-decode kernels (there
    is no switch). Sampling noise comes from a ``torch.Generator`` on each
    worker's device seeded with ``seed`` (one, shared, when both workers
    share a device). With ``REPRO_SANITIZE=1`` each worker's pool is audited
    after every admission, export, adoption and release, and both workers'
    step caches and the tracer at the end of each ``run()``.
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
        prefill_slots: int = 2,
        prefill_pages: Optional[int] = None,
        prefill_device=None,
        decode_device=None,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        device="cuda",
    ):
        if model.cfg.is_encoder_decoder:
            raise NotImplementedError(
                "disaggregated serving does not support encoder-decoder models: "
                "per-request encoder memory is dense per-slot state and does "
                "not page-stream"
            )
        self.model = model
        self.cache_len = cache_len
        self.page_size = page_size
        self.max_pages = -(-cache_len // page_size)
        self.max_slots = max_slots
        self.prefill_slots = int(prefill_slots)
        if self.prefill_slots < 1:
            raise ValueError(f"prefill_slots must be >= 1, got {prefill_slots}")
        if prefill_device is None or decode_device is None:
            device = _engine_device(device, params)
            if device.type == "cuda":
                cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            else:
                cards = [device]
            if prefill_device is None:
                prefill_device = cards[0]
            if decode_device is None:
                decode_device = cards[1] if len(cards) > 1 else cards[0]
        self.prefill_device = _engine_device(prefill_device, params)
        self.decode_device = torch.device(decode_device)
        self.prefix_sharing = bool(prefix_cache) and PagedContinuousBatchingEngine._sharing_supported(model)
        self.admission = admission or AdmissionController(
            b1=b1 if b1 is not None else max_slots, rho=rho, max_slots=max_slots, patience=patience,
        )
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self._clock = self.tracer.clock
        self.scheduler = RequestScheduler(clock=self._clock, tracer=self.tracer)
        self.transfers = TransferQueue()
        # independent pools: decode sized like the single-device engine,
        # prefill sized to its own (smaller) ring, prompts only
        self.num_pages = num_pages if num_pages is not None else 1 + max_slots * self.max_pages
        self.prefill_pages = (prefill_pages if prefill_pages is not None
                              else 1 + self.prefill_slots * self.max_pages)
        # every placement across devices happens here and in _stream; a worker's
        # weights are the given tensors where they lie on its device already (as
        # jax.device_put makes no copy on the same device), so two workers on one
        # card share one set of weights, and copies on another
        self.prefill = _PrefillWorker(
            model, tree_map(lambda leaf: leaf.to(self.prefill_device), params), self.prefill_device,
            self.prefill_slots, self.prefill_pages, page_size, self.prefix_sharing, prefill_chunks, seed,
        )
        self.decode = _DecodeWorker(
            model, tree_map(lambda leaf: leaf.to(self.decode_device), params), self.decode_device, self.admission,
            self.num_pages, page_size, self.prefix_sharing, max_slots, seed,
        )
        if self.decode_device == self.prefill_device:
            self.decode.generator = self.prefill.generator  # one noise stream a device
        self._chunk_rr = 0
        self.stats: Dict[str, Any] = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> Dict[str, Any]:
        stats = PagedContinuousBatchingEngine._fresh_stats()
        stats.update(transfers=0, pages_streamed=0, pages_adopted=0, seam_bytes=0)
        return stats

    def reset_stats(self) -> None:
        """Zero every counter and rebase BOTH pools' high-water marks (see
        :meth:`PagedContinuousBatchingEngine.reset_stats`)."""
        self.stats.clear()
        self.stats.update(self._fresh_stats())
        self.prefill.pool.peak_used = self.prefill.pool.used
        self.decode.pool.peak_used = self.decode.pool.used

    # steps built, shaped like the single-device engine's counters: decode
    # steps live on the decode worker, chunk steps on the prefill worker
    @property
    def decode_compiles(self) -> int:
        return self.decode.decode_compiles

    @property
    def prefill_compiles(self) -> int:
        return self.prefill.prefill_compiles

    # -- request intake ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16, temperature: float = 0.0, top_k: int = 0,
               tag: str = "") -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens > self.cache_len:
            raise ValueError(f"prompt {prompt.size} + {max_new_tokens} new tokens "
                             f"exceed cache_len {self.cache_len}")
        return self.scheduler.submit(prompt, max_new_tokens, temperature=temperature, top_k=top_k, tag=tag)

    # -- the streaming seam --------------------------------------------------
    def _stream(self, block):
        """The one runtime transfer between the workers: move an exported
        page block to the decode device. On another card the copy is
        enqueued on the current stream and overlaps the host's next work;
        the import reads it behind it in stream order. The seam bytes are
        counted here (on one device nothing moves: the block is already a
        copy). The span measures the enqueue, not the arrival."""
        nbytes = sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(block))
        self.stats["seam_bytes"] += nbytes
        self.metrics.counter("serve.seam_bytes").inc(nbytes)
        with self.tracer.span("serve.stream", bytes=nbytes):
            out = tree_map(lambda leaf: leaf.to(self.decode_device, non_blocking=True), block)
        if self.tracer.enabled:
            self.tracer.counter("serve.seam", cum_bytes=self.stats["seam_bytes"])
        return out

    def _sample_first(self, req, logits):
        """The request's first token, sampled on the prefill device."""
        return _first_token(self.model, req, logits, self.prefill.generator)

    # -- prefill side --------------------------------------------------------
    def _admit_prefill(self, pslots: PagedSlotManager, i: int, req, plan):
        if plan.cow_src is not None:
            self.prefill.cache = self.model.paged_copy_page(self.prefill.cache, plan.cow_src,
                                                            plan.new_pages[0])
            self.stats["cow_copies"] += 1
        self.prefill.cache = self.model.paged_zero_state_row(self.prefill.cache, i)
        pslots.admit(i, req, plan)
        self.stats["prefix_tokens_reused"] += plan.reuse_len
        self.stats["prompt_tokens_total"] += len(req.prompt)
        self.prefill.audit_pages(pslots, where=f"after prefill admit(slot {i})")

    def _chunk_tick(self, pslots: PagedSlotManager, completed) -> None:
        """One chunk per prefilling slot per engine tick (round-robin start,
        so no slot starves inside the ring). Each slot takes the largest
        chunk size that fits its remaining prompt; a sub-chunk tail is left
        for :meth:`_tail_tick`. A prompt that completes exactly on a chunk is
        sampled from the chunk's logits and handed off before the next
        slot's chunk runs."""
        prefilling = pslots.prefilling_indices()
        if not prefilling:
            return
        self._chunk_rr += 1
        off = self._chunk_rr % len(prefilling)
        for i in prefilling[off:] + prefilling[:off]:
            slot = pslots.slots[i]
            bucket = max((c for c in self.prefill.prefill_chunks if c <= slot.prompt_remaining), default=None)
            if bucket is None:
                continue  # sub-chunk tail: teacher-forced by _tail_tick
            req = slot.request
            logits, self.prefill.cache = self.prefill.chunk_for(bucket)(
                self.prefill.params,
                self.prefill.put(req.prompt[slot.fill : slot.fill + bucket][None, :]),
                self.prefill.cache,
                slot.fill,
                i,
                self.prefill.put(pslots.page_table[i : i + 1]),
            )
            slot.fill += bucket
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens_computed"] += bucket
            if slot.prompt_remaining == 0:
                self._handoff(pslots, i, self._sample_first(req, logits), completed)

    def _tail_tick(self, pslots: PagedSlotManager, completed) -> None:
        """One teacher-forced tick over the prefill ring for prompt tails
        shorter than the smallest chunk: the single-device engine's tail
        path, at the fixed prefill ring width. A lane consuming its LAST
        prompt token keeps the tick's sample as the request's first
        generated token and is handed off; every prefill-side sample before
        that is discarded."""
        active = pslots.active_mask()
        if not active.any():
            return
        n_forced = int(active.sum())
        nxt, self.prefill.cache = self.prefill.tick()(
            self.prefill.params,
            self.prefill.put(pslots.feed_tokens()[:, None]),
            self.prefill.cache,
            self.prefill.put(pslots.positions()),
            self.prefill.put(pslots.page_table),
            self.prefill.put(active),
            self.prefill.put(pslots.temperatures()),
            self.prefill.put(pslots.top_ks()),
            self.prefill.generator,
        )
        self.stats["prefill_tokens_computed"] += n_forced
        for i in pslots.advance(nxt.cpu().numpy()):  # repro-lint: disable=R105 -- sampled tokens read on the host
            # prompt done AND max_new_tokens == 1: finished without ever
            # touching the seam (advance appended the first token already)
            slot = pslots.slots[i]
            req = slot.request
            if self.prefill.index is not None:
                publish_prefix(self.prefill.index, req.prompt, slot.plan.pages)
            release_pages(self.prefill.pool, slot.plan.pages)
            self.scheduler.prefill_done(req)
            self.scheduler.first_token(req)
            self.scheduler.finish(req)
            completed[req.id] = req.tokens()
            pslots.release(i)
            self.prefill.audit_pages(pslots, where=f"after prefill finish(slot {i})")
        for i, slot in enumerate(pslots.slots):
            if slot.free or not slot.decoding:
                continue
            # newly decoding = prompt completed this tick: reclaim the first
            # token advance() appended (the decode worker re-appends it at
            # adoption) and hand the slot off
            first = slot.request.generated.pop()
            self._handoff(pslots, i, first, completed)

    def _handoff(self, pslots: PagedSlotManager, i: int, first: int, completed):
        """Prompt fully computed and ``first`` sampled (not yet appended):
        publish the prefix prefill-side, then stream the slot's pages to the
        decode worker, or, for single-token requests, complete right here
        without touching the seam."""
        slot = pslots.slots[i]
        req = slot.request
        if self.prefill.index is not None:
            publish_prefix(self.prefill.index, req.prompt, slot.plan.pages)
        if req.max_new_tokens <= 1:
            req.generated.append(int(first))
            release_pages(self.prefill.pool, slot.plan.pages)
            self.scheduler.prefill_done(req)
            self.scheduler.first_token(req)
            self.scheduler.finish(req)
            completed[req.id] = req.tokens()
            pslots.release(i)
            self.prefill.audit_pages(pslots, where=f"after prefill finish(slot {i})")
            return
        export = export_pages(slot.plan, req.prompt, page_size=self.page_size, first_token=first)
        ids = np.zeros((self.max_pages,), np.int64)
        ids[: len(export.pages)] = export.pages
        block = self.prefill.export(self.prefill.cache, self.prefill.put(ids), i)
        self.transfers.push(Transfer(export=export, block=self._stream(block), request=req))
        self.scheduler.prefill_done(req)
        # the first token was sampled from the final chunk's logits just
        # now: TTFT is the handoff, not the (later) decode-side adoption
        self.scheduler.first_token(req)
        self.stats["transfers"] += 1
        self.stats["pages_streamed"] += len(export.pages)
        # the prefill pages are released at once: the block is a copy, so
        # the next admission may overwrite these pages (and zero the state
        # row) while the transfer still waits at the seam; published pages
        # live on under the prefill index for later prefix hits
        release_pages(self.prefill.pool, slot.plan.pages)
        pslots.release(i)
        self.prefill.audit_pages(pslots, where=f"after export(slot {i})")

    # -- decode side ---------------------------------------------------------
    def _adopt(self, dslots: PagedSlotManager, i: int, transfer, imp) -> None:
        """Adopt a streamed prefill into decode slot ``i``: scatter the block
        into the decode pool at the remapped page ids (lanes the local
        prefix index already holds, and padding, are not written), install
        the state row, and re-publish the prompt's full pages to the
        decode-side index so later transfers with the same prefix adopt by
        reference instead of writing bytes again."""
        req = transfer.request
        export = transfer.export
        ids = np.zeros((self.max_pages,), np.int64)
        for j, src in enumerate(export.pages):
            if src in imp.remap:
                ids[j] = imp.remap[src]
        self.decode.cache = self.decode.import_(self.decode.cache, transfer.block, ids, i)
        dslots.admit(i, req, imp.plan)
        slot = dslots.slots[i]
        slot.fill = len(req.prompt)  # nothing left to prefill: KV arrived by stream
        dslots.start_decoding(i, export.first_token)
        if self.decode.index is not None:
            publish_prefix(self.decode.index, req.prompt, imp.plan.pages)
            slot.published = True
        self.stats["pages_adopted"] += imp.adopted
        self.decode.audit_pages(dslots, where=f"after adopt(slot {i})")

    def _finish_decode(self, dslots: PagedSlotManager, i: int, completed) -> None:
        slot = dslots.slots[i]
        req = slot.request
        release_pages(self.decode.pool, slot.plan.pages)
        self.scheduler.finish(req)
        completed[req.id] = req.tokens()
        dslots.release(i)
        self.decode.audit_pages(dslots, where=f"after decode release(slot {i})")

    # -- the serve loop ------------------------------------------------------
    @torch.inference_mode()
    def run(self) -> Dict[int, np.ndarray]:
        """Drive both workers until every submitted request is done. Each
        engine tick: ramp the decode ladder, admit prompts into the prefill
        ring, adopt queued transfers into freed decode slots, run one
        fixed-shape decode tick TO COMPLETION (tokens on the host), and only
        then run one chunk per prefilling slot and the tail tick
        (completions stream across, adopted next tick), so a decode token
        never waits behind a prompt chunk. Returns results completed during
        THIS call."""
        completed: Dict[int, np.ndarray] = {}
        width = self.admission.budget()
        dslots = PagedSlotManager(width, self.max_pages)
        pslots = PagedSlotManager(self.prefill_slots, self.max_pages,
                                  chunk_floor=min(self.prefill.prefill_chunks))

        while self.scheduler.has_work():
            # 1. decode-side stagewise ramp (host arrays only)
            budget = self.admission.observe(self.scheduler.demand)
            if budget > width:
                dslots.grow(budget)
                width = budget
            self.stats["peak_width"] = max(self.stats["peak_width"], width)

            # 2. prefill admission: FIFO into the prefill ring, decoupled
            #    from the decode ladder
            prefill_admitted = 0
            for i in pslots.free_indices():
                req = self.scheduler.pop_waiting()
                if req is None:
                    break
                plan = plan_admission(self.prefill.pool, self.prefill.index, req.prompt,
                                      len(req.prompt),  # prefill holds prompt pages only
                                      share=self.prefix_sharing)
                if plan is None:
                    self.scheduler.requeue(req)
                    break
                self._admit_prefill(pslots, i, req, plan)
                prefill_admitted += 1
            # the queue head found no prefill pages with the ring empty: no
            # prefill-side release is pending and the unshared replan already
            # evicted the whole index, so no later tick can do better
            if prefill_admitted == 0 and pslots.num_active() == 0 and self.scheduler.num_waiting > 0:
                raise RuntimeError(
                    f"prefill page pool ({self.prefill.pool.capacity} pages of "
                    f"{self.page_size}) cannot fit the next request even "
                    "after eviction"
                )

            # 3. decode admission: adopt blocks streamed by PREVIOUS ticks,
            #    strictly FIFO; a transfer the pool cannot place yet blocks
            #    the queue head and retries next tick, after decode releases
            decode_admitted = 0
            for i in dslots.free_indices():
                transfer = self.transfers.peek()
                if transfer is None:
                    break
                req = transfer.request
                imp = import_pages(self.decode.pool, self.decode.index, transfer.export,
                                   len(req.prompt) + req.max_new_tokens, share=self.prefix_sharing)
                if imp is None:
                    break
                self.transfers.pop()
                self._adopt(dslots, i, transfer, imp)
                decode_admitted += 1
            if decode_admitted == 0 and dslots.num_active() == 0 and len(self.transfers) > 0:
                raise RuntimeError(
                    f"decode page pool ({self.decode.pool.capacity} pages of "
                    f"{self.page_size}) cannot fit the next streamed transfer "
                    "even after eviction"
                )

            # 4. one pure decode tick, run to completion BEFORE any prefill
            #    work: no lane is teacher-forced, and the tick's tokens reach
            #    the host before a single prompt chunk is launched
            active = dslots.active_mask()
            if active.any():
                t_tick = self._clock()
                nxt, self.decode.cache = self.decode.decode_for(width)(
                    self.decode.params,
                    self.decode.put(dslots.feed_tokens()[:, None]),
                    self.decode.cache,
                    self.decode.put(dslots.positions()),
                    self.decode.put(dslots.page_table),
                    self.decode.put(active),
                    self.decode.put(dslots.temperatures()),
                    self.decode.put(dslots.top_ks()),
                    self.decode.generator,
                )
                n_decoded = int(active.sum())
                self.stats["ticks"] += 1
                self.stats["decoded_tokens"] += n_decoded
                self.stats["stage_history"].append(self.admission.stage)
                # block: tokens on the host, before any prefill
                nxt = nxt.cpu().numpy()  # repro-lint: disable=R105 -- sampled tokens read on the host
                t_now = self._clock()
                self.stats["decode_tick_s"].append(t_now - t_tick)
                self.tracer.complete("serve.decode_tick", t_tick, t_now, width=width, decoded=n_decoded)
                self.metrics.histogram("serve.decode_tick_s").observe(t_now - t_tick)
                self.metrics.counter("serve.decoded_tokens").inc(n_decoded)
                self.metrics.counter("serve.ticks").inc()
                # 5. finished requests release their decode-pool pages
                for i in dslots.advance(nxt):
                    self._finish_decode(dslots, i, completed)
            if self.tracer.enabled:
                self.tracer.counter("serve.pool", decode_used=self.decode.pool.used,
                                    prefill_used=self.prefill.pool.used)
                self.tracer.counter("serve.queue", waiting=self.scheduler.num_waiting,
                                    running=self.scheduler.num_running, transfers=len(self.transfers))
                self.tracer.counter("serve.admission", stage=self.admission.stage, budget=width)
                self.tracer.counter("serve.prefix", reused=self.stats["prefix_tokens_reused"],
                                    total=self.stats["prompt_tokens_total"])

            # 6. chunk steps, then one teacher-forced tick for sub-chunk
            #    prompt tails; completions export and stream (adopted at the
            #    next tick's step 3, behind the decode tokens already out)
            self._chunk_tick(pslots, completed)
            self._tail_tick(pslots, completed)

        if sanitize.enabled():
            sanitize.audit_engine_compiles(self.prefill, where="(run end, prefill)")
            sanitize.audit_engine_compiles(self.decode, where="(run end, decode)")
            sanitize.audit_tracer(self.tracer, where="(run end)")
        return completed

    # -- reporting -----------------------------------------------------------
    def latencies(self) -> Dict[int, float]:
        return {rid: req.latency for rid, req in self.scheduler.requests.items() if req.state == DONE}

    def memory_stats(self) -> Dict[str, Any]:
        """Two-pool KV accounting: peaks are per worker (on two devices,
        summing them would compare them with a dense one-device slab);
        dense-equivalent and hit rate follow the single-device definitions."""
        per_page = self.model.paged_kv_bytes_per_page(self.page_size, torch.bfloat16)
        dense_rows = max(self.stats["peak_width"], 1)
        return {
            "page_size": self.page_size,
            "pages_capacity": self.decode.pool.capacity,
            "pages_peak": self.decode.pool.peak_used,
            "prefill_pages_capacity": self.prefill.pool.capacity,
            "prefill_pages_peak": self.prefill.pool.peak_used,
            "kv_bytes_peak": max(self.prefill.pool.peak_used, self.decode.pool.peak_used) * per_page,
            "kv_bytes_dense_equiv": dense_rows * self.max_pages * per_page,
            "prefix_hit_rate": self.stats["prefix_tokens_reused"] / max(self.stats["prompt_tokens_total"], 1),
        }
