"""Continuous-batching serving engine: chunked prefill + paged KV cache with
page-budget scheduling (torch port of ``repro.serve.engine``).

The scheduler keeps a fixed batch of slots full over two step functions:

* **prefill (mixed) ticks** — while any slot holds unconsumed prompt
  tokens, one tick pushes a chunk of up to ``prefill_chunk`` tokens per
  prefilling slot through ``serve/decode.prefill_step``, while slots that
  are already decoding ride the same tick as length-1 chunks. A P-token
  prompt warms its cache in ⌈P/prefill_chunk⌉ ticks; the last chunk's
  final-position logits give the first sampled token.
* **decode ticks** — one token for every slot through ``serve_step``,
  whose paged read is the split-KV kernel pair.

Memory is governed by a **page budget** (serve/cache.py pools) under one of
two admission policies:

* ``admission="optimistic"`` (default with chunked prefill) — a request
  admits as soon as the free list covers its first chunk; pages are then
  allocated right before each tick writes into them. On exhaustion the
  engine **preempts the youngest slot**: its pages return to the free list
  and its request requeues at the front with its generated tokens as a
  resumable prefix (greedy decode replays it exactly). Only strictly
  younger slots are preempted on behalf of an older one; if even that
  cannot cover a slot's next write (``hold_pages``), the slot **stalls**
  for the tick (lens 0 through the mixed tick).
* ``admission="reserve"`` — the worst case ⌈(prompt+max_new)/page_size⌉ is
  reserved up front and admission blocks FIFO until it fits; the only
  policy for ``prefill_mode="stepwise"``, whose batched decode tick cannot
  stall one slot.

**Prefix caching** (``prefix_cache=True``, paged + chunked): full pages of
each slot's written token stream are published to a content-addressed
:class:`~repro_torch.serve.cache.PrefixCache`; admission maps the longest
cached run straight into the new slot's page table (skipping those prefill
ticks). Writes never target a shared page: ``_grow`` copies on write the
one reachable case (a fully covered prompt replaying its last token).
Under page pressure the engine sheds cold cache entries before preempting
anyone. ``Request.on_token`` streams each emitted token.

Request lifecycle: deadlines (``Request.deadline_s``, a TTL from
submission, against an injectable ``clock``), ``cancel(uid)``, drain
(``request_drain()`` or SIGTERM/SIGINT with ``handle_signals=True``), and
quarantine of non-finite logits (requeue once, fail on the second strike).
``check()`` audits the allocator, per-slot page ownership and the device
page table against each other.

``quant="int8"|"fp8"`` calibrates the parameters once at construction
(``core/quant.quantize_params``): every ket factor stack (embedding, head,
ket linears) is served from the wire format through the dequant-fused
kernel legs.

Not ported yet: the retry → degrade ladder of the JAX engine's model call
and its fault-injector hooks (the durability slice). Degrading would swap
the card's kernels for their plain versions and hide a kernel failure, so
a model call here runs once and a failure propagates as
:class:`EngineStepError`.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import dequantize_params, quantize_params
from repro_torch.fault import PreemptionHandler, StragglerWatchdog
from repro_torch.kernels import autotune
from repro_torch.models import model as MD
from repro_torch.serve.cache import (PAGED_KINDS, TRASH_PAGE, PageAllocator,
                                     PrefixCache, copy_page, logical_pages,
                                     pages_needed, reset_slot)

__all__ = ["Request", "ServingEngine", "DrainResult", "EngineStepError",
           "quantize_params", "dequantize_params"]


class EngineStepError(RuntimeError):
    """A model call failed; the original exception is its ``__cause__``."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None  # TTL from submission; None = none
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    finished_at: Optional[float] = None
    status: str = "new"  # new | queued | running | done | failed
    fail_reason: Optional[str] = None
    preemptions: int = 0
    # quarantine strikes: one requeue is forgiven, the second fails
    nonfinite_strikes: int = 0
    # streaming: fired synchronously with each emitted token id (replayed
    # tokens after a preemption are not fired again); a raising callback
    # fails the request with reason "callback_error: ..."
    on_token: Optional[Callable[[int], None]] = None
    first_token_at: Optional[float] = None
    prefix_hit_pages: int = 0  # cached pages mapped at (re)admission

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first emitted token (None until one is emitted)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


@dataclasses.dataclass(frozen=True)
class DrainResult:
    """Outcome of ``run_until_drained``: if the tick budget ran out with
    work in flight, ``drained`` is False and ``stranded`` names the
    requests left behind."""

    ticks: int
    drained: bool
    stranded: tuple[int, ...] = ()


class ServingEngine:
    """Continuous batching over ``batch_slots`` slots on ``device`` (default
    ``"cuda"``, which raises without a card; ``"cpu"`` runs the plain
    versions). ``params`` must already lie on ``device``.

    ``greedy=False`` samples from the softmax with a ``torch.Generator``
    seeded from ``seed``; it cannot reproduce the JAX engine's
    ``jax.random`` stream, so only greedy outputs compare across the two.
    """

    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 8,
                 max_len: int = 512, greedy: bool = True, seed: int = 0,
                 quant: str = "none", cache_mode: str = "paged",
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_mode: str = "chunked",
                 admission: str = "optimistic",
                 prefix_cache: bool = False,
                 clock: Optional[Callable[[], float]] = None,
                 handle_signals: bool = False,
                 watchdog_factor: float = 10.0,
                 device="cuda"):
        if cache_mode not in ("paged", "dense"):
            raise ValueError(cache_mode)
        if prefill_mode not in ("chunked", "stepwise"):
            raise ValueError(prefill_mode)
        if admission not in ("optimistic", "reserve"):
            raise ValueError(admission)
        self.device = resolve_device(device)
        # post-training calibration: ket factors to the wire format, once;
        # a no-op for "none" and for already-quantized factors
        self.params = quantize_params(params, quant)
        self.B = batch_slots
        self.max_len = max_len
        self.greedy = greedy
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache_mode = cache_mode
        self.prefill_mode = prefill_mode
        self.page_size = page_size or cfg.page_size
        self.prefill_chunk = max(1, prefill_chunk or cfg.prefill_chunk)

        if cache_mode == "paged":
            if num_pages is None:  # full capacity: every slot can reach max_len
                num_pages = batch_slots * logical_pages(max_len, self.page_size) + 1
            self.allocator: Optional[PageAllocator] = PageAllocator(num_pages)
            self.cache = MD.init_cache(cfg, batch_slots, max_len, paged=True,
                                       num_pages=num_pages, page_size=self.page_size,
                                       device=self.device)
        else:
            self.allocator = None
            self.cache = MD.init_cache(cfg, batch_slots, max_len, device=self.device)
        self._needs_pages = (self.allocator is not None
                             and any(k in PAGED_KINDS for k in cfg.layer_pattern))
        # optimistic admission needs per-slot stalls, which only the ragged
        # mixed tick can express; without pages there is nothing to run out of
        if prefill_mode == "stepwise" or not self._needs_pages:
            admission = "reserve"
        self.admission = admission

        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache:
            if (not self._needs_pages or prefill_mode != "chunked"
                    or any(k not in PAGED_KINDS for k in cfg.layer_pattern)):
                raise ValueError(
                    "prefix_cache requires paged cache_mode, chunked prefill, "
                    f"and a fully-paged layer pattern (got {cfg.layer_pattern})")
            self.prefix_cache = PrefixCache(self.allocator, self.page_size)

        # pin the split count of the paged decode read once, from the
        # engine's read shape (pages at max_len, slot count), so every decode
        # step of this engine uses one value
        if self._needs_pages and cfg.decode_kv_splits is None:
            cfg = dataclasses.replace(cfg, decode_kv_splits=autotune.heuristic_kv_splits(
                self.page_size, cfg.q_heads_per_kv, cfg.head_dim,
                logical_pages(max_len, self.page_size), batch=batch_slots,
                backend=autotune.backend_of(self.device)))
        self.cfg = cfg

        # slot bookkeeping (host side)
        self.slot_req: list[Optional[Request]] = [None] * batch_slots
        self.slot_pending: list[deque] = [deque() for _ in range(batch_slots)]
        self.slot_pages: list[list[int]] = [[] for _ in range(batch_slots)]
        # tokens written into the slot's cache so far (mirrors cache["step"])
        self.slot_pos: list[int] = [0] * batch_slots
        # prefix-cache bookkeeping: leading pages of the slot that are shared
        # (read-only until copy-on-write), the chained keys covering the
        # slot's written stream, and the keys this slot published
        self.slot_shared_n: list[int] = [0] * batch_slots
        self.slot_keys: list[list[bytes]] = [[] for _ in range(batch_slots)]
        self.slot_inserted: list[list[bytes]] = [[] for _ in range(batch_slots)]
        # admission sequence number: smallest = oldest (preemption victims
        # are always the youngest)
        self.slot_seq: list[int] = [0] * batch_slots
        self._admit_seq = 0
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self.failed: list[Request] = []
        self._cur_tokens = np.zeros((batch_slots,), np.int32)
        self.prefill_ticks = 0
        self.decode_ticks = 0
        self.stalled_ticks = 0
        self._busy_s = 0.0
        self._tick = 0

        self._clock = clock or time.time
        self.watchdog = StragglerWatchdog(factor=watchdog_factor)
        self._preempt_handler = PreemptionHandler() if handle_signals else None
        self._draining = False
        self._held_pages: list[int] = []
        self._last_drain: Optional[DrainResult] = None
        self.preemptions = 0
        self.quarantines = 0
        self.cow_copies = 0
        self.prefix_hit_pages_total = 0
        # immutable failure record: (uid, reason) per _fail call
        self._fail_log: list[tuple[int, str]] = []

    # ------------------------------------------------------------------
    # submission + lifecycle
    # ------------------------------------------------------------------
    def submit(self, req: Request):
        if not req.prompt:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        if req.eos_id is not None and req.eos_id < 0:
            raise ValueError(f"eos_id must be a token id (>= 0), got {req.eos_id}")
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {req.deadline_s}")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({len(req.prompt)}) + max_new({req.max_new_tokens}) "
                f"exceeds max_len={self.max_len}")
        if self._needs_pages and self._pages_worst_case(req) > self.allocator.capacity:
            raise ValueError(
                f"request needs {self._pages_worst_case(req)} pages but the pool "
                f"only has {self.allocator.capacity}: it could never admit")
        if (any(r.uid == req.uid for r in self.queue)
                or any(r is not None and r.uid == req.uid for r in self.slot_req)):
            raise ValueError(f"uid {req.uid} is already live (queued or in-flight)")
        # a resubmitted Request must not carry stale lifecycle state
        req.output = []
        req.status = "new"
        req.fail_reason = None
        req.finished_at = None
        req.preemptions = 0
        req.nonfinite_strikes = 0
        req.first_token_at = None
        req.prefix_hit_pages = 0
        req.submitted_at = self._clock()
        req.status = "queued"
        self.queue.append(req)

    def cancel(self, uid: int) -> bool:
        """Fail one request (queued or in-flight) with reason "cancelled"."""
        for req in self.queue:
            if req.uid == uid:
                self.queue.remove(req)
                self._fail(req, "cancelled")
                return True
        for s in range(self.B):
            req = self.slot_req[s]
            if req is not None and req.uid == uid:
                self._fail(req, "cancelled", slot=s)
                return True
        return False

    def request_drain(self):
        """Stop admitting; ``run_until_drained`` finishes in-flight work and
        fails the rest with reason "drained" (the SIGTERM path)."""
        self._draining = True

    def _pages_worst_case(self, req: Request) -> int:
        return pages_needed(len(req.prompt) + req.max_new_tokens, self.page_size)

    def _resume_prompt(self, req: Request) -> list[int]:
        """The prefix a (re)admitted request must prefill: its prompt plus
        everything already generated."""
        return list(req.prompt) + list(req.output)

    def _set_ptab(self, s: int, start: int, pages: list[int]) -> None:
        if pages:
            self.cache["ptab"][s, start:start + len(pages)] = torch.tensor(
                pages, dtype=torch.int32)

    # ------------------------------------------------------------------
    # admission + page growth + preemption
    # ------------------------------------------------------------------
    def _admit(self):
        if self._draining:
            return
        ps = self.page_size
        for s in range(self.B):
            if self.slot_req[s] is not None or not self.queue:
                continue
            req = self.queue[0]
            prefix = self._resume_prompt(req)
            # map the longest run of cached pages covering the page-aligned
            # prefix and skip their prefill ticks
            hits: list[int] = []
            keys: list[bytes] = []
            if self.prefix_cache is not None:
                keys = self.prefix_cache.page_keys(prefix)
                hits = self.prefix_cache.lookup(keys)  # acquires one ref each
                if self.admission == "reserve" and hits:
                    # reserve mode has no copy-on-write: keep the prefix's
                    # last token out of shared pages
                    cap = (len(prefix) - 1) // ps
                    if len(hits) > cap:
                        self.allocator.release(hits[cap:])
                        hits = hits[:cap]
            h = len(hits)
            # fully covered prompt: replay only its last token, whose write
            # copies the final shared page on write in _grow
            start = min(h * ps, len(prefix) - 1)
            pages: list[int] = list(hits)
            if self._needs_pages:
                if self.admission == "reserve":
                    want = self._pages_worst_case(req) - h
                else:
                    first = min(self.prefill_chunk, len(prefix) - start)
                    want = pages_needed(start + first, ps) - h
                want = max(0, want)
                got = self.allocator.alloc(want)
                if got is None and self.prefix_cache is not None:
                    # shed cold cache entries before blocking admission
                    self.prefix_cache.evict(want - self.allocator.free_count)
                    got = self.allocator.alloc(want)
                if got is None:
                    if hits:
                        self.allocator.release(hits)  # undo the lookup refs
                    return  # page budget exhausted: block FIFO (no skipping)
                pages += got
            self.queue.popleft()
            self._admit_seq += 1
            self.slot_req[s] = req
            self.slot_seq[s] = self._admit_seq
            self.slot_pages[s] = pages
            self.slot_pos[s] = start
            self.slot_shared_n[s] = h
            self.slot_keys[s] = keys[:h]
            self.slot_inserted[s] = []
            req.status = "running"
            req.prefix_hit_pages = h
            self.prefix_hit_pages_total += h
            # cache isolation: zero the slot's dense state, step and ptab row
            reset_slot(self.cache, s)
            if "ptab" in self.cache:
                self._set_ptab(s, 0, pages)
            if start:
                # skipped prefill: reads and writes resume past the shared pages
                self.cache["step"][s] = start
            if self.prefill_mode == "chunked":
                self.slot_pending[s] = deque(prefix[start:])
                self._cur_tokens[s] = 0
            else:  # stepwise: the first prompt token feeds the next decode tick
                self.slot_pending[s] = deque(prefix)
                self._cur_tokens[s] = self.slot_pending[s].popleft()

    def _tokens_this_tick(self, s: int) -> int:
        if self.slot_pending[s]:
            n = len(self.slot_pending[s])
            return min(self.prefill_chunk, n) if self.prefill_mode == "chunked" else 1
        return 1  # decoding: one token

    def _acquire_pages(self, s: int, need: int) -> Optional[list[int]]:
        """Allocate under pressure on behalf of slot ``s``: shed cold
        prefix-cache entries first, then preempt strictly younger slots,
        else give up (the caller stalls)."""
        while not self.allocator.can_alloc(need):
            if (self.prefix_cache is not None and
                    self.prefix_cache.evict(need - self.allocator.free_count)):
                continue
            victim = self._youngest_live_slot(younger_than=self.slot_seq[s])
            if victim is None:
                break
            self._preempt(victim, "page_pressure")
        return self.allocator.alloc(need)

    def _grow(self) -> set[int]:
        """Optimistic mode: make sure every live slot owns, exclusively, the
        pages its next tick writes into: copy on write any shared page in
        the write path, then grow, preempting strictly younger slots on
        exhaustion. Returns the slots that must stall this tick."""
        stalled: set[int] = set()
        if self.admission != "optimistic":
            return stalled
        order = sorted((s for s in range(self.B) if self.slot_req[s] is not None),
                       key=lambda s: self.slot_seq[s])
        for s in order:
            if self.slot_req[s] is None:
                continue  # preempted by an older slot earlier in this pass
            wp = self.slot_pos[s] // self.page_size
            if wp < self.slot_shared_n[s]:
                # the next write lands in a shared page (only ever the last
                # one): allocate a private page, copy the pool rows, repoint
                got = self._acquire_pages(s, 1)
                if got is None:
                    stalled.add(s)
                    continue
                new = got[0]
                old = self.slot_pages[s][wp]
                copy_page(self.cache, old, new)
                self.slot_pages[s][wp] = new
                self.cache["ptab"][s, wp] = new
                self.allocator.release([old])  # drop this slot's shared ref
                self.slot_shared_n[s] = wp
                self.cow_copies += 1
            need = pages_needed(self.slot_pos[s] + self._tokens_this_tick(s),
                                self.page_size) - len(self.slot_pages[s])
            if need <= 0:
                continue
            got = self._acquire_pages(s, need)
            if got is None:
                stalled.add(s)  # external pressure: wait, don't corrupt
                continue
            base = len(self.slot_pages[s])
            self.slot_pages[s].extend(got)
            self._set_ptab(s, base, got)
        return stalled

    def _youngest_live_slot(self, younger_than: int) -> Optional[int]:
        cands = [s for s in range(self.B)
                 if self.slot_req[s] is not None and self.slot_seq[s] > younger_than]
        return max(cands, key=lambda s: self.slot_seq[s]) if cands else None

    def _release_slot(self, s: int):
        self.slot_req[s] = None
        self.slot_pending[s].clear()
        self.slot_pos[s] = 0
        self._cur_tokens[s] = 0
        self.slot_shared_n[s] = 0
        self.slot_keys[s] = []
        self.slot_inserted[s] = []
        if self.slot_pages[s]:
            # one reference per page: pages the prefix cache (or another
            # sharing slot) still references stay outstanding
            self.allocator.release(self.slot_pages[s])
            self.slot_pages[s] = []
        if "ptab" in self.cache:
            # point the idle slot at the trash page now: its writes must not
            # land in pages a future request may own
            self.cache["ptab"][s] = TRASH_PAGE

    def _preempt(self, s: int, reason: str):
        """Evict slot ``s`` and requeue its request at the front of the
        queue with its generated tokens as a resumable prefix."""
        req = self.slot_req[s]
        assert req is not None
        req.preemptions += 1
        req.status = "queued"
        self.preemptions += 1
        self._release_slot(s)
        self.queue.appendleft(req)

    def _retire(self, s: int, req: Request):
        req.finished_at = self._clock()
        req.status = "done"
        self.done.append(req)
        self._release_slot(s)

    def _fail(self, req: Request, reason: str, slot: Optional[int] = None):
        req.status = "failed"
        req.fail_reason = reason
        req.finished_at = self._clock()
        self.failed.append(req)
        self._fail_log.append((req.uid, reason))
        if slot is not None:
            self._release_slot(slot)

    def _quarantine(self, s: int):
        """Non-finite logits for an emitting slot: requeue once (the prefix
        replays through a reset cache), fail on the second strike. The
        garbage token is never emitted."""
        req = self.slot_req[s]
        self.quarantines += 1
        if self.prefix_cache is not None and self.slot_inserted[s]:
            # pages this slot published may hold garbage K/V: pull them
            for k in self.slot_inserted[s]:
                self.prefix_cache.invalidate(k)
            self.slot_inserted[s] = []
        if req.nonfinite_strikes >= 1:
            self._fail(req, "nonfinite_logits", slot=s)
            return
        req.nonfinite_strikes += 1
        req.preemptions += 1
        req.status = "queued"
        self._release_slot(s)
        self.queue.appendleft(req)

    def _expire(self):
        now = self._clock()

        def expired(req: Request) -> bool:
            return (req.deadline_s is not None
                    and now - req.submitted_at > req.deadline_s)

        for req in [r for r in self.queue if expired(r)]:
            self.queue.remove(req)
            self._fail(req, "deadline")
        for s in range(self.B):
            req = self.slot_req[s]
            if req is not None and expired(req):
                self._fail(req, "deadline", slot=s)

    # ------------------------------------------------------------------
    # page pressure hooks
    # ------------------------------------------------------------------
    def hold_pages(self, n: int) -> int:
        """Take up to ``n`` pages from the free list (external pressure: a
        co-tenant, a shrinking pool). Returns how many were taken."""
        if self.allocator is None or n <= 0:
            return 0
        got = self.allocator.alloc(min(n, self.allocator.free_count))
        if not got:
            return 0
        self._held_pages.extend(got)
        return len(got)

    def release_held(self) -> int:
        """Return every held page to the free list."""
        n = len(self._held_pages)
        if n:
            self.allocator.free(self._held_pages)
            self._held_pages = []
        return n

    # ------------------------------------------------------------------
    # ticks
    # ------------------------------------------------------------------
    def _model_call(self, what: str, fn, *args):
        """Run one model call once; a failure propagates, never degrades."""
        try:
            with torch.no_grad():
                return fn(self.params, self.cfg, self.cache, *args)
        except Exception as e:
            raise EngineStepError(f"{what} failed at tick {self._tick - 1}: {e!r}") from e

    def _emit(self, s: int, req: Request, tok: int):
        """Record one sampled token; retire on EOS / max-new (counting the
        request's total output, which may span preemptions)."""
        if req.first_token_at is None:
            req.first_token_at = self._clock()
        req.output.append(tok)
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception as e:  # noqa: BLE001 — user code, never fatal
                self._fail(req, f"callback_error: {e!r}", slot=s)
                return
        finished = (len(req.output) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id))
        if finished:
            self._retire(s, req)
        else:
            self._cur_tokens[s] = tok

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.greedy:
            return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].to(
            torch.int32).cpu().numpy()

    def _guarded_emit(self, logits: torch.Tensor, emitting: list[int]):
        """Sample and emit for ``emitting`` slots, quarantining any slot whose
        logits row is not finite (the max over the vocab catches NaN and
        ±inf in one (B,) transfer)."""
        nxt = self._sample(logits)
        finite = torch.isfinite(logits.amax(dim=-1)).cpu().numpy()
        for s in emitting:
            req = self.slot_req[s]
            if req is None:
                continue
            if not finite[s]:
                self._quarantine(s)
            else:
                self._emit(s, req, int(nxt[s]))

    def _prefill_tick(self, stalled: set[int] = frozenset()):
        """Mixed tick: prefilling slots consume up to C prompt tokens; slots
        already decoding ride along as length-1 chunks. Stalled slots keep
        lens 0, so their cache state does not advance."""
        C = self.prefill_chunk
        toks = np.zeros((self.B, C), np.int32)
        lens = np.zeros((self.B,), np.int32)
        was_decoding = [False] * self.B
        for s in range(self.B):
            if self.slot_req[s] is None or s in stalled:
                continue
            if self.slot_pending[s]:
                n = min(C, len(self.slot_pending[s]))
                for i in range(n):
                    toks[s, i] = self.slot_pending[s].popleft()
                lens[s] = n
            else:
                was_decoding[s] = True
                toks[s, 0] = self._cur_tokens[s]
                lens[s] = 1
        if not lens.any():  # every live slot stalled: no model call
            self.stalled_ticks += 1
            return
        logits, self.cache = self._model_call(
            "prefill_step", MD.prefill_chunk_fn, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(lens).to(self.device))
        self.prefill_ticks += 1
        emitting = []
        for s in range(self.B):
            req = self.slot_req[s]
            if req is None or lens[s] == 0:
                continue  # idle or stalled slot
            self.slot_pos[s] += int(lens[s])
            if not was_decoding[s] and self.slot_pending[s]:
                continue  # still mid-prompt: logits row not meaningful yet
            emitting.append(s)
        self._guarded_emit(logits, emitting)

    def _decode_tick(self):
        toks = torch.from_numpy(self._cur_tokens.copy()).to(self.device)
        logits, self.cache = self._model_call("serve_step", MD.serve_step_fn, toks)
        self.decode_ticks += 1
        emitting = []
        for s in range(self.B):
            req = self.slot_req[s]
            if req is None:
                continue
            self.slot_pos[s] += 1
            if self.slot_pending[s]:
                # stepwise prefill: feed the next prompt token, ignore sample
                self._cur_tokens[s] = self.slot_pending[s].popleft()
                continue
            emitting.append(s)
        self._guarded_emit(logits, emitting)

    def step(self):
        """One engine tick: one model call for the whole batch (or a pure
        bookkeeping tick when everything live is stalled)."""
        t0 = time.time()
        tick = self._tick
        self._tick += 1
        if self._preempt_handler is not None and self._preempt_handler.preempted:
            self._draining = True
        self._expire()
        self._admit()
        stalled = self._grow()
        live = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not live:
            self.stalled_ticks += 1  # queue blocked on pages, or empty
        else:
            prefilling = any(self.slot_pending[s] for s in live)
            if self.prefill_mode == "chunked" and (prefilling or stalled):
                self._prefill_tick(stalled)
            else:
                self._decode_tick()
            if self.prefix_cache is not None:
                self._publish_full_pages()
        dt = time.time() - t0
        self._busy_s += dt
        self.watchdog.observe(tick, dt)

    def _publish_full_pages(self):
        """Post-tick: hash every newly completed page of each live slot into
        the prefix cache. The tokens written at positions ``[0, slot_pos)``
        are ``(prompt + output)[:slot_pos]``, so the keys come from the
        request itself. A page is published once full; full pages are never
        written again, so cached content is frozen."""
        ps = self.page_size
        for s in range(self.B):
            req = self.slot_req[s]
            if req is None:
                continue
            full = min(self.slot_pos[s] // ps, len(self.slot_pages[s]))
            if len(self.slot_keys[s]) >= full:
                continue
            stream = list(req.prompt) + list(req.output)
            while len(self.slot_keys[s]) < full:
                j = len(self.slot_keys[s])
                prev = self.slot_keys[s][-1] if j else None
                key = PrefixCache.chain_key(prev, stream[j * ps:(j + 1) * ps])
                self.slot_keys[s].append(key)
                if self.prefix_cache.insert(key, self.slot_pages[s][j]):
                    self.slot_inserted[s].append(key)

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def run_until_drained(self, max_ticks: int = 10_000) -> DrainResult:
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            if self._draining and not any(r is not None for r in self.slot_req):
                break  # drained: only queued (never admitted) work remains
            self.step()
            ticks += 1
        if self._draining:
            while self.queue:
                self._fail(self.queue.popleft(), "drained")
        stranded = tuple(r.uid for r in self.queue) + tuple(
            r.uid for r in self.slot_req if r is not None)
        res = DrainResult(ticks=ticks, drained=not self.has_work(), stranded=stranded)
        self._last_drain = res
        return res

    # ------------------------------------------------------------------
    # invariants + stats
    # ------------------------------------------------------------------
    def check(self):
        """Invariant audit, after any tick:

        * allocator: free ∪ outstanding partitions the pool, refcounts ≥ 1;
        * one reference per (slot, page) mapping, per held page and per
          prefix-cache entry reproduces the allocator's refcounts exactly;
        * slot page lists never hold the trash page or a page twice; a page
          a slot may still write (not full, not shared) has one reference;
        * the device page table mirrors the host lists: live rows are their
          slot's pages then trash, idle rows all trash;
        * every live slot owns the pages its written tokens occupy.
        """
        if self.allocator is not None:
            self.allocator.check()
            refs: Counter[int] = Counter()
            writable: set[int] = set()
            for s in range(self.B):
                pages = self.slot_pages[s]
                assert TRASH_PAGE not in pages, f"slot {s} owns the trash page"
                assert len(set(pages)) == len(pages), \
                    f"slot {s} maps a page twice: {pages}"
                refs.update(pages)
                if self.slot_req[s] is None:
                    assert not pages, f"idle slot {s} still holds pages"
                else:
                    assert len(pages) >= pages_needed(self.slot_pos[s],
                                                      self.page_size), \
                        (s, self.slot_pos[s], pages)
                    for j, p in enumerate(pages):
                        if (j >= self.slot_shared_n[s]
                                and (j + 1) * self.page_size > self.slot_pos[s]):
                            writable.add(p)
            refs.update(self._held_pages)
            cache_pages: frozenset[int] = frozenset()
            if self.prefix_cache is not None:
                cache_pages = self.prefix_cache.pages
                refs.update(cache_pages)
            outstanding = self.allocator.outstanding
            assert set(refs) == set(outstanding), \
                (set(refs) ^ set(outstanding))
            for p, n in refs.items():
                assert self.allocator.refcount(p) == n, \
                    (p, n, self.allocator.refcount(p))
            for p in writable:
                assert refs[p] == 1 and p not in cache_pages, \
                    f"writable page {p} is shared (refs={refs[p]})"
        if "ptab" in self.cache:
            ptab = self.cache["ptab"].cpu().numpy()
            for s in range(self.B):
                k = len(self.slot_pages[s])
                assert list(ptab[s, :k]) == self.slot_pages[s], \
                    (s, ptab[s], self.slot_pages[s])
                assert (ptab[s, k:] == TRASH_PAGE).all(), (s, ptab[s])

    def page_stats(self) -> dict:
        if self.allocator is None:
            return {"free_pages": None, "page_capacity": None, "held_pages": 0}
        return {"free_pages": self.allocator.free_count,
                "page_capacity": self.allocator.capacity,
                "held_pages": len(self._held_pages)}

    def stats(self) -> dict:
        # percentiles of observed samples (method="higher"), so p95 == max on
        # tiny n rather than an interpolated latency no request saw
        def pct(xs, q):
            return float(np.percentile(xs, q, method="higher")) if xs else None

        lat = [r.finished_at - r.submitted_at for r in self.done if r.finished_at]
        flat = [r.finished_at - r.submitted_at for r in self.failed
                if r.finished_at is not None]
        ttft = [r.ttft_s for r in self.done if r.ttft_s is not None]
        toks = sum(len(r.output) for r in self.done)
        prompt_toks = sum(len(r.prompt) for r in self.done)
        busy = max(self._busy_s, 1e-9)
        last = self._last_drain
        out = {
            "completed": len(self.done),
            "failed": len(self.failed),
            "fail_reasons": dict(self._fail_log),
            "fail_log": list(self._fail_log),
            "queued": len(self.queue),
            "in_flight": sum(r is not None for r in self.slot_req),
            "stranded": 0 if last is None or last.drained else len(last.stranded),
            "generated_tokens": toks,
            "prompt_tokens": prompt_toks,
            "p50_latency_s": pct(lat, 50),
            "p95_latency_s": pct(lat, 95),
            "failed_p50_latency_s": pct(flat, 50),
            "failed_p95_latency_s": pct(flat, 95),
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p95_s": pct(ttft, 95),
            "tokens_per_sec": toks / busy,
            "prompt_tokens_per_sec": prompt_toks / busy,
            "prefill_ticks": self.prefill_ticks,
            "decode_ticks": self.decode_ticks,
            "stalled_ticks": self.stalled_ticks,
            "ticks": self.prefill_ticks + self.decode_ticks,
            "preemptions": self.preemptions,
            # the retry/degrade ladder is not ported: no retries, never degraded
            "retries": 0,
            "quarantines": self.quarantines,
            "cow_copies": self.cow_copies,
            "prefix_hit_pages": self.prefix_hit_pages_total,
            "degraded": False,
            "step_p50_s": None,
            "step_p95_s": None,
            "stragglers": 0,
        }
        out.update(self.watchdog.stats())
        out.update(self.page_stats())
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.stats())
        return out
