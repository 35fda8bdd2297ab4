"""Greedy continuous-batching serving engine (single device, slot-based).

Counterpart of the greedy core of ``torch_bnb_fp4_tpu/serve/engine.py``:

  * one batched decode over ``max_batch`` fixed slots, each slot with its own
    cache offset (``KVCache.length`` is per sequence), run ``n`` steps per
    tick as a Python loop with ONE host fetch of the tokens per tick;
  * prefill runs per request at batch 1 on a small cache of the prompt's
    32-row bucket, and its KV rows are copied into the slot;
  * chunked prefill (``prefill_chunk``): a pending prompt goes through that
    small cache one chunk per tick, interleaved with the decode ticks, so a
    long prompt delays each tick by one chunk instead of its whole prefill;
    it is copied into its slot once, when complete;
  * sliding-window layers keep rolling rings of ``ring_rows`` rows
    (``sliding_kv``, with chunked prefill: its writes are ring-aligned);
  * the host loop only moves token ids and bookkeeping.

KV writes are in place (``index_put_`` / ``copy_`` on the engine's cache
tensors); the JAX engine donates its cache to functional programs instead.
A finished slot's stale rows need no clearing: the next prefill overwrites
rows [0, Lp) and resets the length, and attention masks past the length.

Not yet ported (setting them raises ``NotImplementedError``): sampling,
logprobs, admission budgets, batch buckets, the fp8 KV cache, speculative
decoding, prefix caching and the retired-prefix store, warmup, LoRA adapters
and multi-device meshes.  A request that asks for sampling or an adapter is a
bad request (``ValueError``), as on the JAX package's greedy engine.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from collections import deque

import numpy as np
import torch

from ..models import transformer as T

log = logging.getLogger("torch_bnb_fp4_tpu_torch.serve")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 64
    eos_id: int | None = None
    stop_ids: list[int] | None = None  # extra stop tokens; finish_reason "stop"
    # per-request sampling / adapter overrides: a greedy engine accepts
    # temperature 0 and top_p 1, which change nothing, and rejects the rest
    # with ValueError, as the JAX engine does
    temperature: float | None = None
    top_p: float | None = None
    adapter: str | None = None


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: list[int]
    prompt_len: int
    finish_reason: str  # "eos" | "stop" | "length" | "abort"
    ttft_s: float = 0.0  # submit -> first token (queue wait + prefill), host clock
    total_s: float = 0.0  # submit -> completion
    logprobs: list[float] | None = None  # per-token logprobs: not yet ported, always None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine settings.  ``max_batch``, ``max_len``, ``inner_steps``, ``seed``,
    ``prefill_chunk`` (0 = whole-prompt prefill; else a multiple of 32) and
    ``sliding_kv`` (rings on sliding-window layers; takes effect only with
    chunked prefill) are ported; every other field keeps the JAX engine's name
    and default and raises when set to anything else."""

    max_batch: int = 8  # decode slots
    max_len: int = 2048  # per-slot KV capacity
    inner_steps: int = 8  # decode steps per host round trip (bucketed to 2^k)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: int = 0
    admit_budget: int = 0
    prefill_chunk: int = 0
    batch_buckets: bool = False
    kv_dtype: str = "bfloat16"
    spec_tokens: int = 0
    spec_ngram: int = 3
    prefix_cache: bool = False
    prefix_store: int = 0
    sliding_kv: bool = True
    logprobs: bool = False

    _PORTED = ("max_batch", "max_len", "inner_steps", "seed", "prefill_chunk", "sliding_kv")

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name not in self._PORTED and getattr(self, f.name) != f.default:
                raise NotImplementedError(f"EngineConfig.{f.name} is not yet ported (greedy core only)")
        if self.max_batch < 1 or self.max_len < 2 or self.inner_steps < 1:
            raise ValueError(f"need max_batch >= 1, max_len >= 2, inner_steps >= 1, got {self}")
        if self.prefill_chunk < 0 or self.prefill_chunk % 32:
            raise ValueError(f"prefill_chunk must be a multiple of 32, got {self.prefill_chunk}")


class Engine:
    """Single-device greedy continuous-batching engine over ``params``.

    ``on_token``: optional callback ``(uid, token_id)`` for every emitted
    token (the streaming hook)."""

    def __init__(self, params: T.ModelParams, cfg: T.ModelConfig, ecfg: EngineConfig, on_token=None):
        self.params, self.cfg, self.ecfg, self.on_token = params, cfg, ecfg, on_token
        self.device = params.embed.device
        b = ecfg.max_batch
        # rings only when every multi-row cache write is chunk-aligned
        self._ring_chunk = (ecfg.prefill_chunk if ecfg.sliding_kv and ecfg.prefill_chunk
                            and any(cfg.layer_sliding_window(i) is not None for i in range(cfg.n_layers)) else 0)
        self.cache = T.KVCache.zeros(cfg, b, ecfg.max_len, write_chunk=self._ring_chunk, device=self.device)
        self.slot_req: list[Request | None] = [None] * b
        self.slot_tokens: list[list[int]] = [[] for _ in range(b)]
        self.slot_t0: list[float] = [0.0] * b  # first-token wall time per slot
        self.slot_cur = np.zeros(b, np.int64)  # current token per slot
        self._submit_t: dict[int, float] = {}
        self.pending: deque[Request] = deque()
        self.completions: list[Completion] = []
        self._completed = 0
        self._steps = 0
        self._tokens_out = 0
        self._t0 = time.perf_counter()
        # per-decoded-token tick latency (whole step() wall time incl. any
        # admission prefills, over the inner depth), trailing window
        self.step_times: deque[float] = deque(maxlen=4096)
        self._mask_dev: torch.Tensor | None = None  # active-slot mask, rebuilt on admit/retire
        # in-flight chunked admission: req, slot, small cache, tokens done, bucket
        self._pf: dict | None = None

    # -- device work -------------------------------------------------------

    @torch.no_grad()
    def _decode_fn(self, tokens: torch.Tensor, active: torch.Tensor, n: int) -> torch.Tensor:
        """``n`` batched greedy decode steps; idle slots first get length 0 so
        their write offset never creeps toward max_len (their tokens are
        garbage the host ignores).  Returns (B, n) int32 on the device."""
        cache = T.KVCache(k=self.cache.k, v=self.cache.v,
                          length=torch.where(active, self.cache.length, torch.zeros_like(self.cache.length)))
        tok, toks = tokens, []
        for _ in range(n):
            logits, cache = T.forward(self.params, self.cfg, tok[:, None], cache)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            toks.append(tok)
        self.cache = cache
        return torch.stack(toks, dim=1)

    @torch.no_grad()
    def _prefill_fn(self, tokens: torch.Tensor, slot: int, true_len: int) -> torch.Tensor:
        """Batch-1 prefill of a bucket-padded prompt (1, Lp_pad) on a small
        cache, spliced into ``slot``; rows past ``true_len`` are garbage that
        kv_valid masks.  The lm_head runs on the true last position only.
        Returns the first token (device scalar)."""
        lp_pad = tokens.shape[1]
        small = T.KVCache.zeros(self.cfg, 1, lp_pad, device=self.device)
        logits, small = T.forward(self.params, self.cfg, tokens, small, last_index=true_len - 1)
        self._splice_fn(small, slot, true_len)
        return torch.argmax(logits[0, -1], dim=-1)

    @torch.no_grad()
    def _chunk_fn(self, tokens: torch.Tensor, small: T.KVCache, last_index: int) -> tuple[torch.Tensor, T.KVCache]:
        """One prefill chunk on the private batch-1 cache: its KV lands at
        small.length, which advances; ``last_index`` is the chunk-local
        position of the prompt's true last token (only the final chunk's token
        is used).  Returns (token as a device scalar, cache)."""
        logits, small = T.forward(self.params, self.cfg, tokens, small, last_index=last_index)
        return torch.argmax(logits[0, -1], dim=-1), small

    def _splice_fn(self, small: T.KVCache, slot: int, true_len: int) -> None:
        """Copy a completed prefill's KV rows into ``slot``, layer by layer:
        ``sm.shape[1]`` rows each (a ring layer of the small cache may hold
        fewer rows than the prompt's bucket).  Slot s holds the same position
        in both caches: either the small layer never wrapped, or it has the big
        layer's ring size.  Rows past ``true_len`` are masked by kv_valid."""
        for big, sm in zip(self.cache.k + self.cache.v, small.k + small.v):
            big[slot, : sm.shape[1]].copy_(sm[0])
        self.cache.length[slot] = true_len

    # -- host API ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError("empty prompt (need at least one token to prefill)")
        if len(req.prompt) >= self.ecfg.max_len:
            raise ValueError(f"prompt len {len(req.prompt)} >= max_len {self.ecfg.max_len}")
        if not all(0 <= t < self.cfg.vocab_size for t in req.prompt):
            # torch indexing raises on the engine thread, failing every request in flight
            raise ValueError(f"prompt token ids must be in [0, {self.cfg.vocab_size})")
        t = req.temperature
        if t is not None:
            if not isinstance(t, (int, float)) or isinstance(t, bool) or not math.isfinite(t) or t < 0:
                raise ValueError(f"temperature must be a finite number >= 0, got {t!r}")
            if t > 0:
                raise ValueError("the engine is greedy (sampling is not yet ported); a per-request temperature "
                                 "cannot enable sampling")
        tp = req.top_p
        if tp is not None:
            if not isinstance(tp, (int, float)) or isinstance(tp, bool) or not (0.0 < tp <= 1.0):
                raise ValueError(f"top_p must be in (0, 1], got {tp!r}")
            if tp < 1.0:
                raise ValueError("the engine has no nucleus path (sampling is not yet ported); a per-request "
                                 "top_p cannot enable it")
        if req.adapter is not None:
            raise ValueError(f"unknown adapter {req.adapter!r} (engine has []; LoRA adapters are not yet ported)")
        self._submit_t[req.uid] = time.perf_counter()
        self.pending.append(req)

    def abort(self, uid: int) -> bool:
        """Cancel a request wherever it is (queued, mid-chunked-prefill, or
        decoding).  A request that already produced tokens completes with
        finish_reason "abort" and the tokens so far; a queued one completes
        empty.  Returns False if the uid is unknown (e.g. already finished).
        Host-side only: the freed slot just stops being fed."""
        for i, r in enumerate(self.pending):
            if r.uid == uid:
                del self.pending[i]
                self._complete_empty(r)
                return True
        if self._pf is not None and self._pf["req"].uid == uid:
            r = self._pf["req"]
            self._pf = None  # its small cache is dropped; the slot was never bound
            self._complete_empty(r)
            return True
        for i, r in enumerate(self.slot_req):
            if r is not None and r.uid == uid:
                self._retire(i, "abort")
                return True
        return False

    def _complete_empty(self, req: Request) -> None:
        t = self._submit_t.pop(req.uid, time.perf_counter())
        self._completed += 1
        self.completions.append(Completion(uid=req.uid, tokens=[], prompt_len=len(req.prompt), finish_reason="abort",
                                           ttft_s=0.0, total_s=time.perf_counter() - t))

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _bucket(self, lp: int) -> int:
        """Prefill length bucket: 32-row steps, clamped to the cache."""
        return min((lp + 31) // 32 * 32, self.ecfg.max_len)

    def _bind(self, slot: int, req: Request, first: int) -> None:
        """Start decoding ``req`` in ``slot`` from its first token."""
        self.slot_req[slot] = req
        self.slot_tokens[slot] = [first]
        self.slot_cur[slot] = first
        self.slot_t0[slot] = time.perf_counter()
        self._mask_dev = None
        if self.on_token is not None:
            self.on_token(req.uid, first)

    def _admit(self) -> None:
        for slot in self._free_slots():
            if not self.pending:
                break
            req = self.pending.popleft()
            lp = len(req.prompt)
            padded = np.zeros((1, self._bucket(lp)), np.int32)
            padded[0, :lp] = req.prompt
            first = int(self._prefill_fn(torch.from_numpy(padded).to(self.device), slot, lp))
            self._bind(slot, req, first)
            log.debug("admit uid=%d slot=%d prompt_len=%d", req.uid, slot, lp)

    def _admit_chunked(self) -> None:
        """Advance the in-flight prefill by ONE chunk (starting the next
        pending request when idle): each tick pays at most one chunk."""
        c = self.ecfg.prefill_chunk
        if self._pf is None:
            slots = self._free_slots()
            if not self.pending or not slots:
                return
            req = self.pending.popleft()
            lp_pad = self._bucket(len(req.prompt))
            # the small cache covers the whole bucket (ring layers keep fewer rows)
            small = T.KVCache.zeros(self.cfg, 1, lp_pad, write_chunk=self._ring_chunk, device=self.device)
            self._pf = dict(req=req, slot=slots[0], small=small, done=0, lp_pad=lp_pad)
        pf = self._pf
        req, lp = pf["req"], len(pf["req"].prompt)
        lo = pf["done"]
        hi = min(lo + c, pf["lp_pad"])
        toks = np.zeros((1, hi - lo), np.int32)
        real = req.prompt[lo:hi]
        toks[0, : len(real)] = real
        first, pf["small"] = self._chunk_fn(torch.from_numpy(toks).to(self.device), pf["small"], min(lp, hi) - 1 - lo)
        pf["done"] = hi
        if hi < lp:
            return  # more chunks to go; decode proceeds this tick
        self._splice_fn(pf["small"], pf["slot"], lp)
        self._bind(pf["slot"], req, int(first))
        log.debug("admit(chunked) uid=%d slot=%d prompt_len=%d chunks=%d", req.uid, pf["slot"], lp, -(-lp // c))
        self._pf = None

    def _retire(self, slot: int, reason: str) -> None:
        req = self.slot_req[slot]
        now = time.perf_counter()
        t_sub = self._submit_t.pop(req.uid, now)
        self._completed += 1
        self.completions.append(Completion(
            uid=req.uid, tokens=self.slot_tokens[slot], prompt_len=len(req.prompt), finish_reason=reason,
            ttft_s=self.slot_t0[slot] - t_sub, total_s=now - t_sub))
        self.slot_req[slot] = None
        self.slot_tokens[slot] = []
        self._mask_dev = None

    def step(self) -> int:
        """One tick: admit pending requests, retire finished slots, run up to
        ``inner_steps`` batched decode steps.  Returns the active slot count."""
        t_tick = time.perf_counter()
        if self.ecfg.prefill_chunk:
            self._admit_chunked()
        else:
            self._admit()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            toks = self.slot_tokens[i]
            if req.eos_id is not None and toks and toks[-1] == req.eos_id:
                self._retire(i, "eos")
            elif req.stop_ids and toks and toks[-1] in req.stop_ids:
                self._retire(i, "stop")
            elif len(toks) >= req.max_new_tokens or len(req.prompt) + len(toks) >= self.ecfg.max_len:
                self._retire(i, "length")
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        # inner depth: bounded by the tightest remaining cache capacity only
        # (a slot's own budget does not shrink it: tokens past it are dropped
        # below), bucketed to a power of two
        cap = min(self.ecfg.max_len - (len(self.slot_req[i].prompt) + len(self.slot_tokens[i])) for i in active)
        budget = min(self.ecfg.inner_steps, cap)
        n = 1
        while 2 * n <= budget:
            n *= 2
        if self._mask_dev is None:
            mask = np.zeros(self.ecfg.max_batch, bool)
            mask[active] = True
            self._mask_dev = torch.from_numpy(mask).to(self.device)
        tokens = torch.from_numpy(self.slot_cur.astype(np.int32)).to(self.device)
        toks = self._decode_fn(tokens, self._mask_dev, n).cpu().numpy()  # the tick's one host fetch
        self.step_times.append((time.perf_counter() - t_tick) / n)
        self._steps += n
        for i in active:
            req = self.slot_req[i]
            for t in toks[i]:
                t = int(t)
                self.slot_tokens[i].append(t)
                self._tokens_out += 1
                if self.on_token is not None:
                    self.on_token(req.uid, t)
                if (req.eos_id is not None and t == req.eos_id) or (req.stop_ids and t in req.stop_ids):
                    break  # tokens decoded past EOS/stop are dropped
                if len(self.slot_tokens[i]) >= req.max_new_tokens:
                    break  # tokens past the request budget are dropped too
            self.slot_cur[i] = self.slot_tokens[i][-1]
        return len(active)

    def stats(self) -> dict:
        """Serving metrics: tok/s, occupancy, per-token tick latency, TTFT."""
        dt = time.perf_counter() - self._t0
        done = self.completions
        st = np.asarray(self.step_times) if self.step_times else np.zeros(1)
        return dict(
            step_p50_s=float(np.percentile(st, 50)),
            step_p99_s=float(np.percentile(st, 99)),
            completions=self._completed,
            decode_steps=self._steps,
            tokens_out=self._tokens_out,
            tok_per_s=self._tokens_out / dt if dt > 0 else 0.0,
            avg_batch_occupancy=self._tokens_out / max(self._steps, 1),
            decode_batch=self.ecfg.max_batch,
            active_slots=sum(r is not None for r in self.slot_req),
            pending=len(self.pending),
            kv_cache_bytes=sum(a.numel() * a.element_size() for a in self.cache.k + self.cache.v),
            mean_ttft_s=sum(c.ttft_s for c in done) / len(done) if done else 0.0,
            mean_tpot_s=(sum((c.total_s - c.ttft_s) / max(len(c.tokens) - 1, 1) for c in done) / len(done)
                         if done else 0.0),
        )

    def run(self, requests: list[Request]) -> dict[int, Completion]:
        """Serve a list of requests to completion; returns uid -> Completion."""
        for r in requests:
            self.submit(r)
        while self.pending or self._pf is not None or any(r is not None for r in self.slot_req):
            if self.step() == 0 and not self.pending and self._pf is None:
                break
        return {c.uid: c for c in self.completions}
