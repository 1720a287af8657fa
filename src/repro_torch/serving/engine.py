"""Continuous batching over the paged KV cache (``repro.serving.engine``).

One engine iteration (:meth:`ServeEngine.step`) admits waiting requests
into free slots — one flash-prefill sweep per admitted prompt (K1 + K2),
scattered into freshly allocated slabs — then decodes every active slot
together: one batched paged-decode launch (K5) per layer covers all of
them through a stacked ``(max_slots, width)`` page table, with greedy
argmax on the device and ONE host transfer per iteration.

The stacked table always has ``max_slots`` rows, trimmed to the widest
live slot's page count, and each slot pins one row for its whole
residency (lowest free row at admission).  A row whose slot is inactive
is dead by runtime data alone (position -1), and its entries are zeros.
Here the table is a runtime int32 tensor the kernel loads, so a new page
or a new occupancy recompiles nothing (in the reference it is static
executor metadata and re-keys the jitted step).

Under page pressure the engine preempts: the youngest other running
sequence is evicted (slabs freed, request re-queued with its tokens so
far) and re-prefills when re-admitted — recompute preemption.

Families without a paged view serve through contiguous per-slot caches,
carried forward from each slot's prefill: the ssm family (Mamba-2: the conv
tail and the SSD state) and dense models that are not paged-capable
(multi-head attention, G = 1, e.g. stablelm-1.6b: their K/V padded to
``max_len``).  Each slot decodes alone, one ``decode_step`` per slot, with
the greedy argmax on the device and still ONE host transfer per iteration
after every slot has launched; each slot's next input token stays on the
device.  ``batched=False`` on a paged-capable model takes the same
per-slot loop through ``decode_step_paged``: one K5 launch (at one slot)
per layer and slot, each slot reading its own page table.  The hybrid
and moe families raise ``NotImplementedError``: the reference's engine
cannot serve them either, having no forward->decode cache re-layout for
them (``greedy_generate`` is their generation entry).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.serving.cache import OutOfPages, PagePool, pages_needed


@dataclass
class Request:
    """One generation request and its lifecycle metrics (caller clock)."""
    rid: int
    prompt: tuple
    max_new: int
    submit_t: float = 0.0
    admit_t: Optional[float] = None
    first_tok_t: Optional[float] = None
    done_t: Optional[float] = None
    evictions: int = 0


@dataclass
class _Slot:
    req: Request
    tokens: list            # prompt + emitted tokens, in order
    n_emitted: int = 0
    slabs: list = field(default_factory=list)     # the page table
    row: int = -1                                 # stacked-table row
    cache: Optional[dict] = None                  # contiguous families
    #: the last argmax, (1,) on the device: the prefill's first token, then
    #: (per-slot decode) each decode step's, fed to the next step
    next_token: Optional[torch.Tensor] = None


def _paged_capable(cfg: ArchConfig) -> bool:
    """The paged path covers dense GQA/MQA-grouped decode (g >= 2), as in
    the reference."""
    return (cfg.family == "dense" and cfg.attention != "mla"
            and cfg.n_heads // cfg.n_kv_heads >= 2)


class ServeEngine:
    """Continuous-batching scheduler over one model (``params`` from
    ``transformer.init_lm`` or ``convert.params_from_numpy``).

    ``max_len`` bounds any sequence (prompt + generated); ``pool_pages``
    sizes the shared slab pool; ``page=None`` derives the page size on the
    H100 table (``ops.default_decode_page``); ``dtype`` is the pool's
    (default: the parameters').  The pool and page apply to the paged
    (grouped dense) path only.  ``batched``: None or True decodes every
    paged slot in one launch, False one slot at a time; True on a model
    that is not paged-capable raises.  The caller supplies timestamps
    (``now``) so latency metrics use one clock.  ``device`` defaults to
    ``"cuda"``.
    """

    def __init__(self, cfg: ArchConfig, params, *,
                 max_slots: int = 2, max_len: int = 256,
                 pool_pages: Optional[int] = None,
                 page: Optional[int] = None, dtype=None,
                 eos_id: Optional[int] = None,
                 batched: Optional[bool] = None, device="cuda"):
        self.device = resolve_device(device)
        self.paged = _paged_capable(cfg)
        if cfg.family == "hybrid":
            raise NotImplementedError(
                "the hybrid family has no prefill-to-decode cache re-layout "
                "in the reference (its ring caches and grouped layers; "
                "src/repro/models/transformer.py:540-559), so ServeEngine "
                "cannot serve it there either; generate with "
                "repro_torch.train.serve_step.greedy_generate, which ingests "
                "the prompt token by token")
        if cfg.family == "moe":
            raise NotImplementedError(
                "family 'moe' has no forward->decode cache re-layout in the "
                "reference (src/repro/models/transformer.py:542-560 returns "
                "None), so ServeEngine cannot serve it there either "
                "(src/repro/serving/engine.py:222-229); generate with "
                "repro_torch.train.serve_step.greedy_generate, which ingests "
                "the prompt token by token")
        if not self.paged and not transformer.has_prefill_decode_relayout(
                cfg):
            raise NotImplementedError(
                f"family {cfg.family!r}/{cfg.attention!r} serves through "
                f"contiguous per-slot caches, which the port has for the "
                f"dense (full attention) and ssm families only (ROADMAP.md, "
                f"Queue 1)")
        if batched and not self.paged:
            raise ValueError(
                f"batched decode needs the paged path; family "
                f"{cfg.family!r} with {cfg.n_heads} heads over "
                f"{cfg.n_kv_heads} KV heads serves contiguous")
        self.batched = self.paged and batched is not False
        self.cfg = cfg
        self.params = params
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.page = self.pool = None
        if self.paged:
            if dtype is None:
                dtype = params["embed"]["table"].dtype
            if page is None:
                g = cfg.n_heads // max(1, cfg.n_kv_heads)
                page = min(ops.default_decode_page(
                    self.max_len, cfg.n_kv_heads, max(2, g), cfg.head_dim_,
                    dtype=dtype), self.max_len)
            self.page = int(page)
            if pool_pages is None:
                pool_pages = self.max_slots * pages_needed(self.max_len,
                                                           self.page)
            self.pool = PagePool(cfg, pool_pages, self.page, dtype,
                                 self.device)
        #: decode steps since construction: one per iteration that decoded
        #: on the batched path (each launches K5 once per layer), one per
        #: slot and iteration on the per-slot paths
        self.kernel_calls = 0
        #: device -> host transfers since construction: one per admitted
        #: prompt (its first token) and one per decode iteration
        self.host_transfers = 0
        self._waiting: list[Request] = []
        self._slots: list[_Slot] = []
        self._done: dict[int, Request] = {}
        self._out: dict[int, list] = {}
        self._next_rid = 0

    # -- public API --------------------------------------------------------

    def submit(self, prompt, max_new: int, now: float = 0.0) -> int:
        """Queue a request; returns its id."""
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if self.cfg.family == "ssm" and len(prompt) < self.cfg.conv_width - 1:
            # the reference's apply_mamba2 then returns a conv tail of
            # fewer than conv_width - 1 rows, which decode_mamba2 cannot
            # extend (repro/models/ssm.py, the cache of apply_mamba2)
            raise ValueError(
                f"prompt of {len(prompt)} tokens is shorter than "
                f"conv_width - 1 = {self.cfg.conv_width - 1}: the Mamba-2 "
                f"prefill's conv tail would be too short to decode from")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} exceeds "
                f"max_len {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._waiting.append(Request(rid, prompt, int(max_new),
                                     submit_t=now))
        self._out[rid] = []
        return rid

    def step(self, now: float = 0.0) -> list[tuple[int, int]]:
        """One engine iteration: admit, then decode every active slot: in
        one batched step, or one step a slot.  Returns the ``(rid, token)``
        pairs emitted."""
        with torch.inference_mode():
            emitted = self._admit(now)
            if self.batched:
                emitted.extend(self._decode_batched(now))
            else:
                emitted.extend(self._decode_sequential(now))
        return emitted

    @property
    def idle(self) -> bool:
        return not self._waiting and not self._slots

    def run(self, now: float = 0.0) -> dict:
        """Step until idle; returns ``{rid: {"tokens", "request"}}``."""
        while not self.idle:
            self.step(now)
        return self.results()

    def results(self) -> dict:
        return {rid: {"tokens": list(self._out[rid]), "request": req}
                for rid, req in self._done.items()}

    # -- scheduling --------------------------------------------------------

    def _int32(self, x) -> torch.Tensor:
        """A host list as an int32 tensor on the engine's device."""
        return torch.tensor(x, dtype=torch.int32, device=self.device)

    def _to_host(self, t: torch.Tensor) -> list:
        """The engine's only device -> host read."""
        self.host_transfers += 1
        return t.tolist()

    def _admit(self, now: float) -> list[tuple[int, int]]:
        emitted = []
        while self._waiting and len(self._slots) < self.max_slots:
            req = self._waiting[0]
            try:
                slot = self._start(req, now)
            except OutOfPages:
                if not self._evict(protect=None):
                    break               # nothing evictable; wait
                continue
            self._waiting.pop(0)
            self._slots.append(slot)
            tok = self._emit(slot, self._to_host(slot.next_token)[0], now)
            emitted.append((req.rid, tok))
            self._retire_if_done(slot, now)
        return emitted

    def _start(self, req: Request, now: float) -> _Slot:
        """Prefill the request's tokens-so-far into a fresh slot."""
        tokens = list(req.prompt) + list(self._out[req.rid])
        slot = _Slot(req=req, tokens=tokens,
                     n_emitted=len(self._out[req.rid]))
        s0 = len(tokens)
        if self.batched:
            used = {s.row for s in self._slots}
            slot.row = min(i for i in range(self.max_slots) if i not in used)
        if self.paged:
            slot.slabs = self.pool.alloc(pages_needed(s0, self.page))
        logits, cache = transformer.prefill(
            self.params, self.cfg,
            torch.tensor([tokens], dtype=torch.long, device=self.device))
        if self.paged:
            self.pool.write_prefill(cache, slot.slabs, s0)
        else:
            slot.cache = transformer.prefill_cache_to_decode(
                self.cfg, cache, self.max_len)
        slot.next_token = torch.argmax(logits[0]).reshape(1)
        if req.admit_t is None:
            req.admit_t = now
        return slot

    def _decode_batched(self, now: float) -> list[tuple[int, int]]:
        """Decode every active slot in one batched step.

        Page allocation for all slots happens first (it may evict: a
        victim drops out of this iteration's batch).  The stacked table is
        then rebuilt from live state: each live slot's slabs fill its
        pinned row, zero-padded to the widest live slot; dead rows are
        zeros with position -1.  Greedy argmax runs on the device; the
        ``(max_slots,)`` token vector is the one host transfer."""
        live = []
        for slot in list(self._slots):
            if slot not in self._slots:   # evicted by an earlier ensure
                continue
            try:
                self._ensure_pages(slot, len(slot.tokens))
            except OutOfPages:
                continue                  # pool saturated; retry next step
            live.append(slot)
        live = [s for s in live if s in self._slots]
        if not live:
            return []
        by_row = {s.row: s for s in live}
        width = max(len(s.slabs) for s in live)
        toks, poss, rows = [], [], []
        for i in range(self.max_slots):
            slot = by_row.get(i)
            if slot is not None:
                rows.append(slot.slabs + [0] * (width - len(slot.slabs)))
                toks.append(slot.tokens[-1])
                poss.append(len(slot.tokens) - 1)
            else:
                rows.append([0] * width)
                toks.append(0)
                poss.append(-1)
        logits = transformer.decode_step_paged_batched(
            self.params, self.cfg, self._int32(toks), self._int32(poss),
            self.pool.pools, tables=self._int32(rows), page=self.page)
        self.kernel_calls += 1
        next_toks = self._to_host(torch.argmax(logits, dim=-1))
        emitted = []
        for slot in live:
            tok = self._emit(slot, int(next_toks[slot.row]), now)
            self._retire_if_done(slot, now)
            emitted.append((slot.req.rid, tok))
        return emitted

    def _decode_sequential(self, now: float) -> list[tuple[int, int]]:
        """The per-slot paths (contiguous caches, or ``batched=False`` on
        the paged path): one decode step per slot, fed the slot's last
        token where it already lies on the device; the greedy argmax stays
        on the device and the stacked tokens cross to the host once, after
        every slot has launched.  A paged slot first grows its page table
        (which may evict a later slot: it drops out of this iteration)."""
        live = []
        for slot in list(self._slots):
            if slot not in self._slots:   # evicted by an earlier ensure
                continue
            pos = self._int32([len(slot.tokens) - 1])
            if self.paged:
                try:
                    self._ensure_pages(slot, len(slot.tokens))
                except OutOfPages:
                    continue              # pool saturated; retry next step
                logits = transformer.decode_step_paged(
                    self.params, self.cfg, slot.next_token, pos,
                    self.pool.pools, table=self._int32(slot.slabs),
                    page=self.page)
            else:
                logits, slot.cache = transformer.decode_step(
                    self.params, self.cfg, slot.next_token, pos, slot.cache)
            slot.next_token = torch.argmax(logits, dim=-1)
            self.kernel_calls += 1
            live.append(slot)
        if not live:
            return []
        toks = self._to_host(torch.cat([s.next_token for s in live]))
        emitted = []
        for slot, tok in zip(live, toks):
            if slot not in self._slots:
                # evicted after its launch by a later slot's allocation:
                # drop the token; greedy decode recomputes it identically
                # on re-admission
                continue
            tok = self._emit(slot, int(tok), now)
            self._retire_if_done(slot, now)
            emitted.append((slot.req.rid, tok))
        return emitted

    def _emit(self, slot: _Slot, tok: int, now: float) -> int:
        if slot.req.first_tok_t is None:
            slot.req.first_tok_t = now
        slot.tokens.append(tok)
        slot.n_emitted += 1
        self._out[slot.req.rid].append(tok)
        return tok

    def _retire_if_done(self, slot: _Slot, now: float) -> None:
        done = (slot.n_emitted >= slot.req.max_new or
                (self.eos_id is not None and
                 slot.tokens[-1] == self.eos_id) or
                len(slot.tokens) >= self.max_len)
        if done and slot in self._slots:
            slot.req.done_t = now
            if self.paged:
                self.pool.free(slot.slabs)
            self._slots.remove(slot)
            self._done[slot.req.rid] = slot.req

    def _ensure_pages(self, slot: _Slot, tokens_needed: int) -> None:
        """Grow the slot's page table to cover ``tokens_needed`` rows,
        evicting other slots under pressure."""
        while len(slot.slabs) < pages_needed(tokens_needed, self.page):
            try:
                slot.slabs.extend(self.pool.alloc(1))
            except OutOfPages:
                if not self._evict(protect=slot):
                    raise

    def _evict(self, protect: Optional[_Slot]) -> bool:
        """Preempt the youngest running slot (recompute on re-admission).
        Returns False when nothing is evictable."""
        victims = [s for s in self._slots if s is not protect and s.slabs]
        if not victims:
            return False
        victim = victims[-1]              # youngest admitted
        self.pool.free(victim.slabs)
        victim.slabs = []
        self._slots.remove(victim)
        victim.req.evictions += 1
        self._waiting.insert(0, victim.req)
        return True
