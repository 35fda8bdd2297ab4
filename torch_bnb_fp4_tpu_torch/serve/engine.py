"""Continuous-batching serving engine (slot-based; one device, or one rank
of a tensor/data-parallel mesh).

Counterpart of ``torch_bnb_fp4_tpu/serve/engine.py`` (every ``EngineConfig``
field, per-request LoRA adapters and meshes):

  * one batched decode over ``max_batch`` fixed slots (or, with
    ``batch_buckets``, over the smallest power-of-two prefix of them that
    covers the active ones), each slot with its own cache offset
    (``KVCache.length`` is per sequence), ``n`` steps per tick with ONE host
    fetch of the tokens per tick;
  * on the card every decode tick replays a CUDA graph, one per (batch
    bucket, power-of-two depth n) and per (bucket, s) for speculation,
    captured at first use (:meth:`Engine.warmup` moves every capture before
    serving), as the JAX engine runs one jitted program per shape.  A
    captured function reads and writes only the engine's static device
    buffers: the tokens, the active mask, per-slot temperature, top_p and
    adapter index, the cache and its lengths in, the tokens, logprobs and
    draft counts out.
    Host code updates those buffers in place and never rebinds them.  On the
    CPU the same functions run eagerly;
  * sampling (temperature, top-k, top-p, min-p; per-request temperature and
    top_p) draws Gumbel-max noise from the engine's ``torch.Generator``,
    seeded from ``EngineConfig.seed`` and registered with every graph, so a
    replay draws fresh noise; a greedy engine runs pure argmax;
  * prefill runs eagerly per request at batch 1 on a small cache of the
    prompt's 32-row bucket (or one ``prefill_chunk`` per tick), and its KV
    rows are copied into the slot; prefix caching forks a donor's rows (a
    live slot, or a retired request kept in ``prefix_store`` extra cache
    rows) instead of recomputing them;
  * speculative decoding drafts ``spec_tokens`` by prompt lookup in a
    device-resident token history and verifies them in one (B, k+1) forward
    (greedy: exact match; sampling: rejection sampling);
  * sliding-window layers keep rolling rings of ``ring_rows`` rows
    (``sliding_kv``, with chunked prefill and without speculation);
  * ``kv_dtype="float8_e4m3fn"`` stores the cache in e4m3 (written through
    ``models.transformer.kv_cast``);
  * with ``adapter_ids`` (from ``models.lora.attach_multi_lora``) each
    request names its adapter; the slot's index rides in a static device
    buffer beside temperature and top_p, so an adapter change is a buffer
    write and never a new graph.  Prefix donors and store entries are keyed
    by adapter index: KV rows computed under one adapter are never forked
    into a request under another (the JAX engine matches by tokens alone;
    ROADMAP R7).

  * with a ``mesh`` (``parallel.make_mesh``; params from
    ``parallel.shard_params``) every rank runs this same host loop in
    lockstep on identical submissions.  Decode slots shard over the data
    axis: global slot i lives on data replica ``i % n_data`` at local row
    ``i // n_data`` (so a batch bucket, a power of two times n_data, is a
    local prefix of every replica), and the retired-prefix store rows
    follow the same map.  Each rank's cache holds its replica's rows and its
    model index's KV heads.  Prefill runs at batch 1 alike on every data
    replica and its KV lands only in the owning replica's rows; a row that
    moves between replicas (compaction, the prefix store) or is forked from
    another replica's row travels by one broadcast over the data group.
    Sampling reads the full-vocabulary logits (gathered over the model
    group); the generator is seeded alike on every rank and draws the noise
    of the whole batch, each replica keeping its rows, so its draws are a
    single-device engine's.  The tick's host fetch gathers tokens, counts
    and logprobs over the data group, so every rank's host state agrees.
    With a mesh the engine decodes eagerly (see :meth:`Engine._capture`).

KV writes are in place (``index_put_`` / ``copy_`` on the engine's cache
tensors); the JAX engine donates its cache to functional programs instead.
A finished slot's stale rows need no clearing: the next prefill overwrites
rows [0, Lp) and resets the length, and attention masks past the length.
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
from ..ops import kernels as K
from ..utils.profiling import span

log = logging.getLogger("torch_bnb_fp4_tpu_torch.serve")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 64
    eos_id: int | None = None
    stop_ids: list[int] | None = None  # extra stop tokens; finish_reason "stop"
    # per-request sampling overrides (None = the engine's): temperature needs
    # a sampling engine (EngineConfig.temperature > 0), top_p one with a
    # nucleus path (EngineConfig.top_p < 1); temperature 0 makes just this
    # request greedy.
    temperature: float | None = None
    top_p: float | None = None
    # LoRA adapter name (an engine built with attach_multi_lora's adapter_ids);
    # None = the base model
    adapter: str | None = None
    # host clock (time.perf_counter) at which the request arrived, e.g. when a
    # server received it; None = when submit() takes it
    arrival: float | None = None


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: list[int]
    prompt_len: int
    finish_reason: str  # "eos" | "stop" | "length" | "abort"
    ttft_s: float = 0.0  # arrival -> first token (queue wait + prefill), host clock
    total_s: float = 0.0  # arrival -> completion
    queue_s: float = 0.0  # arrival -> admission (taken off the queue), or -> abort while queued
    # per-token log_softmax of the raw logits (EngineConfig.logprobs only)
    logprobs: list[float] | None = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine settings, with the JAX engine's names, defaults and meaning
    (see ``torch_bnb_fp4_tpu/serve/engine.py``).  Invalid values raise
    ``ValueError`` with the JAX engine's messages."""

    max_batch: int = 8  # decode slots
    max_len: int = 2048  # per-slot KV capacity
    inner_steps: int = 8  # decode steps per host round trip (bucketed to 2^k)
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = off
    top_p: float = 1.0  # 1 = off
    min_p: float = 0.0  # 0 = off
    seed: int = 0
    admit_budget: int = 0  # prefills admitted per tick (0 = unlimited)
    prefill_chunk: int = 0  # 0 = whole-prompt prefill; else a multiple of 32
    batch_buckets: bool = False  # decode over the smallest power-of-two slot prefix
    kv_dtype: str = "bfloat16"  # or "float8_e4m3fn"
    spec_tokens: int = 0  # prompt-lookup draft length (0 = no speculation)
    spec_ngram: int = 3
    prefix_cache: bool = False
    prefix_store: int = 0  # retired-prefix rows (requires prefix_cache)
    sliding_kv: bool = True  # rings on sliding-window layers (chunked prefill, no speculation)
    logprobs: bool = False

    def __post_init__(self):
        if self.max_batch < 1 or self.max_len < 2 or self.inner_steps < 1:
            raise ValueError(f"need max_batch >= 1, max_len >= 2, inner_steps >= 1, got {self}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.temperature < 0.0 or self.top_k < 0:
            raise ValueError("temperature/top_k must be >= 0")
        if not (0.0 <= self.min_p < 1.0):
            raise ValueError(f"min_p must be in [0, 1), got {self.min_p}")
        if self.prefill_chunk < 0 or self.prefill_chunk % 32:
            raise ValueError(f"prefill_chunk must be a multiple of 32, got {self.prefill_chunk}")
        if self.admit_budget < 0 or self.spec_tokens < 0 or self.prefix_store < 0:
            raise ValueError("admit_budget, spec_tokens and prefix_store must be >= 0")
        if self.spec_tokens:
            if self.spec_ngram < 1:
                raise ValueError(f"spec_ngram must be >= 1, got {self.spec_ngram}")
            if self.max_len <= self.spec_ngram:
                raise ValueError("max_len must exceed spec_ngram")
        if self.prefix_store and not self.prefix_cache:
            raise ValueError("prefix_store requires prefix_cache=True")
        dt = getattr(torch, self.kv_dtype, None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f"kv_dtype must name a torch float dtype, got {self.kv_dtype!r}")


# -- sampling, logprobs, drafts and verification: plain torch on tensors -------


def _per_row(v, logits: torch.Tensor) -> torch.Tensor:
    """A scalar or per-row value shaped to broadcast against ``logits``
    (..., V): trailing singleton dims up to the vocab axis, as JAX's
    ``_filtered_logits`` reshapes ``temp`` and ``top_p``."""
    v = torch.as_tensor(v, dtype=torch.float32, device=logits.device)
    return v.reshape(v.shape + (1,) * (logits.ndim - v.ndim - 1))[..., None]


def filtered_logits(ecfg: EngineConfig, logits: torch.Tensor, temp=None, top_p=None) -> torch.Tensor:
    """Temperature/top-k/top-p/min-p filtered logits over (..., V), in f32:
    the distribution :func:`select` samples from and :func:`spec_verify`
    accepts against (JAX's ``Engine._filtered_logits``).  The masks are
    value-based, as JAX's: top-k keeps values >= the k-th (ties kept), top-p
    drops probabilities below the smallest one whose exclusive cumulative
    mass (sorted descending) is < top_p, min-p drops those below min_p times
    the max; filtered tokens are -inf.  ``temp``/``top_p`` broadcast
    against the leading dims (None: the engine's)."""
    scaled = logits.float() / torch.clamp(_per_row(ecfg.temperature if temp is None else temp, logits), min=1e-6)
    if ecfg.top_k > 0:
        kth = torch.topk(scaled, ecfg.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    if ecfg.top_p < 1.0:
        tp = _per_row(ecfg.top_p if top_p is None else top_p, logits)
        probs = torch.softmax(scaled, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        keep = torch.cumsum(sp, dim=-1) - sp < tp
        pmin = torch.where(keep, sp, torch.inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(probs < pmin, -torch.inf, scaled)
    if ecfg.min_p > 0.0:
        probs = torch.softmax(scaled, dim=-1)
        floor = ecfg.min_p * probs.amax(dim=-1, keepdim=True)
        scaled = torch.where(probs < floor, -torch.inf, scaled)
    return scaled


def _uniform(shape, gen: torch.Generator, device, shard: tuple[int, int] | None) -> torch.Tensor:
    """Uniforms of ``shape`` from ``gen``.  ``shard`` (index, count): the rows
    (leading axis) are data shard ``index`` of ``count``, interleaved (local
    row j is global row ``j * count + index``): the uniforms of all ``count``
    shards are drawn and this shard's rows kept, so every rank's generator
    advances alike and the draws equal an unsharded batch's."""
    if shard is None:
        return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    i, n = shard
    u = torch.rand((shape[0] * n, *shape[1:]), generator=gen, device=device, dtype=torch.float32)
    return u.reshape(shape[0], n, *shape[1:])[:, i]


def categorical(logits: torch.Tensor, gen: torch.Generator, shard: tuple[int, int] | None = None) -> torch.Tensor:
    """One draw per row of softmax(``logits``) over the last axis, by
    Gumbel-max as ``jax.random.categorical`` draws (uniforms from ``gen``,
    clamped away from 0 as JAX's are); int32.  No host sync.  ``shard``: see
    :func:`_uniform`."""
    u = _uniform(logits.shape, gen, logits.device, shard)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def select(ecfg: EngineConfig, logits: torch.Tensor, gen: torch.Generator | None, temp=None,
           top_p=None, shard: tuple[int, int] | None = None) -> torch.Tensor:
    """Next tokens (B,) int32 from (B, V) logits (JAX's ``Engine._select``):
    argmax on a greedy engine (temperature 0: ``gen`` is not used); else a
    draw from :func:`filtered_logits`, with rows whose own temperature is 0
    taking the argmax.  ``shard``: the rows are a data shard
    (:func:`_uniform`)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if ecfg.temperature <= 0.0:
        return greedy
    t = torch.full((logits.shape[0],), ecfg.temperature, device=logits.device) if temp is None else temp
    sampled = categorical(filtered_logits(ecfg, logits, t, top_p), gen, shard)
    return torch.where(t > 0.0, sampled, greedy)


def logprob_of(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """log_softmax of the raw (..., V) logits (f32) at ``tok`` (...,)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, tok.long()[..., None])[..., 0]


def prompt_lookup_draft(hist: torch.Tensor, hlen: torch.Tensor, *, k: int, n: int) -> torch.Tensor:
    """``k`` draft tokens per row of ``hist`` (B, H) int32 with lengths
    ``hlen`` (B,), by prompt lookup (JAX's ``prompt_lookup_draft``, batched):
    the EARLIEST earlier occurrence of each row's trailing ``n``-gram, and the
    tokens that followed it, read cyclically with the period between the two
    occurrences.  No match (or hlen < n): arbitrary ids from the row.  Fixed
    shapes, no host sync."""
    b, h = hist.shape
    dev = hist.device
    start = torch.clamp(hlen - n, min=0, max=h - n)  # dynamic_slice clamps its start
    pat = torch.gather(hist, 1, start[:, None].long() + torch.arange(n, device=dev)[None, :])
    j_hi = h - n  # candidate starts j in [0, j_hi)
    match = torch.ones((b, j_hi), dtype=torch.bool, device=dev)
    for t in range(n):
        match &= hist[:, t : t + j_hi] == pat[:, t : t + 1]
    jidx = torch.arange(j_hi, dtype=torch.int32, device=dev)[None, :]
    match &= jidx < (hlen - n)[:, None]  # strictly before the trailing gram itself
    j = torch.where(match, jidx, j_hi).amin(dim=1)
    j = torch.where(j < j_hi, j, 0)
    p = torch.clamp(hlen - n - j, min=1)
    idx = j[:, None] + n + torch.remainder(torch.arange(k, dtype=torch.int32, device=dev)[None, :], p[:, None])
    return torch.gather(hist, 1, torch.clamp(idx, 0, h - 1).long())


def spec_verify(ecfg: EngineConfig, logits: torch.Tensor, draft: torch.Tensor, gen: torch.Generator | None,
                temp=None, top_p=None, shard: tuple[int, int] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Verify drafts (B, k) against (B, k+1, V) logits; returns (emitted
    (B, k+1) int32, emit counts (B,) int32), JAX's ``Engine._spec_verify``:
    greedy rows accept the longest prefix matching the argmax, then emit the
    argmax correction; sampling rows accept draft x_j with probability
    p_j(x_j) under :func:`filtered_logits`, correct the first rejection by a
    draw from p_m without x_m, and earn a bonus draw from p_k when all are
    accepted, so each emitted token is distributed as plain sampling's.
    ``shard``: the rows are a data shard (:func:`_uniform`)."""
    b, k1, _ = logits.shape
    k = k1 - 1
    dev = logits.device
    draft = draft.long()
    choice = torch.argmax(logits, dim=-1)  # (B, k+1)
    if ecfg.temperature <= 0.0:
        m = torch.cumprod((choice[:, :-1] == draft).long(), dim=1).sum(dim=1)
    else:
        t = torch.full((b,), ecfg.temperature, device=dev) if temp is None else temp
        f = filtered_logits(ecfg, logits, t[:, None], None if top_p is None else top_p[:, None])
        probs = torch.softmax(f, dim=-1)
        p_draft = torch.gather(probs[:, :-1], 2, draft[:, :, None])[..., 0]  # (B, k)
        u = _uniform((b, k), gen, dev, shard)
        ok = torch.where(t[:, None] > 0.0, u < p_draft, choice[:, :-1] == draft)
        m = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        f_res = f.clone()
        f_res[:, :k].scatter_(2, draft[:, :, None], -torch.inf)  # the bonus row k stays whole
        choice = torch.where(t[:, None] > 0.0, categorical(f_res, gen, shard).long(), choice)
    t_idx = torch.arange(k + 1, device=dev)[None, :]
    corr = torch.gather(choice, 1, m[:, None])
    dpad = torch.cat([draft, torch.zeros((b, 1), dtype=torch.long, device=dev)], dim=1)
    emitted = torch.where(t_idx < m[:, None], dpad, corr)
    return emitted.to(torch.int32), (m + 1).to(torch.int32)


class _Graph:
    """A captured device program and the launches its capture counted: each
    replay adds them to ``ops.kernels``' counts, so ``launch_counts()``
    reports what the card ran."""

    def __init__(self, graph, launches: dict[str, int]):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        K.add_launch_counts(self.launches)


class Engine:
    """Single-device continuous-batching engine over ``params``.

    ``on_token``: optional callback ``(uid, token_id)`` for every emitted
    token (the streaming hook).

    ``step_logits``: None, or a caller's f32 (inner_steps, max_batch, vocab)
    buffer, set before the first decode tick, into which every decode step
    writes its last-position logits (row j of a tick = its step j;
    ``last_decode_steps`` says how many rows the last tick wrote): a
    diagnostic that works under graph replay, where a wrapper around the
    forward runs only at capture.

    ``last_prefill``: the last tick's prefill passes, one
    ``(uid, rows, cached, real)`` each: the rows the pass ran (the prompt's
    32-row bucket, a chunk, or a prefix-cache suffix chunk), the positions
    already cached before it, and the prompt tokens among its rows.

    While a ``torch.profiler`` records, :meth:`step` marks its phases as
    ``engine.admit`` (holding one ``engine.prefill`` per prefill pass, through
    :meth:`_bind`'s host fetch of the first token it yields), ``engine.retire``,
    ``engine.decode``, ``engine.fetch`` and ``engine.deliver``
    (``utils.profiling.span``).

    ``adapter_ids``: the name -> index map of ``models.lora.attach_multi_lora``
    when ``params`` carry per-request adapter stacks (``MultiLoRALinear``);
    requests then pick an adapter by name (``Request.adapter``).  Params and
    ids travel together, as in the JAX engine.

    ``mesh``: a ``parallel.Mesh``; ``params`` are then this rank's shards
    (``parallel.shard_params``), and every rank builds the engine and calls
    ``submit``/``abort``/``step`` alike (``serve/multihost.py``).
    ``max_batch`` and ``max_batch + prefix_store`` must divide over the data
    axis."""

    def __init__(self, params: T.ModelParams, cfg: T.ModelConfig, ecfg: EngineConfig, on_token=None,
                 adapter_ids: dict[str, int] | None = None, mesh=None):
        self.params, self.cfg, self.ecfg, self.on_token, self.mesh = params, cfg, ecfg, on_token, mesh
        self.adapter_ids = dict(adapter_ids) if adapter_ids else None
        self._mlora = self.adapter_ids is not None
        if self._mlora != T.has_multi_lora(params):
            raise ValueError("params and adapter_ids disagree: pass BOTH results of attach_multi_lora (params and "
                             "ids) or neither")
        b, ml = ecfg.max_batch, ecfg.max_len
        # data replicas and this rank's index among them; its model group (None at tp = 1)
        self._nd, self._di, self._group = 1, 0, None
        self._cache_cfg = cfg  # the geometry of this rank's caches (its KV heads)
        if mesh is not None:
            if b % mesh.n_data:
                raise ValueError(f"max_batch {b} must divide over data axis {mesh.n_data}")
            if (b + ecfg.prefix_store) % mesh.n_data:
                raise ValueError(f"max_batch + prefix_store ({b} + {ecfg.prefix_store}) must divide over data axis "
                                 f"{mesh.n_data}")
            if params.embed.device != mesh.device:
                raise ValueError(f"params live on {params.embed.device}, the mesh's device is {mesh.device} "
                                 "(parallel.shard_params)")
            self._nd, self._di = mesh.n_data, mesh.data_index
            self._group = mesh.model_group if mesh.n_model > 1 else None
            self._cache_cfg = dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // mesh.n_model)
        self.device = dev = params.embed.device
        bl = b // self._nd  # this rank's decode slots
        self._kv_dtype = getattr(torch, ecfg.kv_dtype)
        # rings only when every multi-row cache write is chunk-aligned: chunked
        # prefill without speculation (spec writes k+1 rows anywhere)
        self._ring_chunk = (ecfg.prefill_chunk if ecfg.sliding_kv and ecfg.prefill_chunk and not ecfg.spec_tokens
                            and any(cfg.layer_sliding_window(i) is not None for i in range(cfg.n_layers)) else 0)
        # retired-prefix store rows live past the decode slots in the same cache tensors
        self.cache = T.KVCache.zeros(self._cache_cfg, (b + ecfg.prefix_store) // self._nd, ml, dtype=self._kv_dtype,
                                     write_chunk=self._ring_chunk, device=dev)
        self._ring_min = self.cache.min_rows if self._ring_chunk else None
        self._store: list[dict] = []  # LRU of stored prefixes: dicts(row, tokens, aidx); index 0 = LRU
        # host-side slot state
        self.slot_req: list[Request | None] = [None] * b
        self.slot_tokens: list[list[int]] = [[] for _ in range(b)]
        self.slot_lps: list[list[float]] = [[] for _ in range(b)]
        self.slot_t0: list[float] = [0.0] * b  # first-token wall time per slot
        self.slot_cur = np.zeros(b, np.int64)  # current token per slot
        self.slot_temp = np.full(b, ecfg.temperature, np.float32)
        self.slot_tp = np.full(b, ecfg.top_p, np.float32)
        self.slot_aidx = np.zeros(b, np.int32)  # per-slot adapter index (0 = the base model)
        self._arrival: dict[int, float] = {}  # uid -> host clock of arrival, until completion
        self._queue_s: dict[int, float] = {}  # uid -> arrival to admission, from admission to completion
        self.pending: deque[Request] = deque()
        self.completions: list[Completion] = []
        self._completed = 0
        self._steps = 0
        self._tokens_out = 0
        self._t0 = time.perf_counter()
        # per-decoded-token tick latency (whole step() wall time incl. any
        # admission prefills, over the inner depth), trailing window
        self.step_times: deque[float] = deque(maxlen=4096)
        # traces[kind] += 1 for each program's first run (on the card: each
        # graph captured, each eager prefill shape run); flat after warmup()
        self.traces = {"decode": 0, "prefill": 0, "fork": 0}
        self._programs: set = set()
        self._spec_emitted = 0
        self._spec_slot_forwards = 0
        self._prefix_hits = 0
        self._prefix_tokens = 0
        self._last_decode_batch = b
        self.last_decode_steps = 0
        self.last_prefill: list[tuple[int, int, int, int]] = []
        self._pf: dict | None = None  # in-flight chunked admission
        self._slots_dirty = True  # active mask / temp / top_p / adapter changed: re-upload before the next tick
        self._hist_dirty = True  # slot set changed: rebuild the speculation history
        self.step_logits: torch.Tensor | None = None
        # static device buffers of the decode programs, over this rank's slots (updated in place, never rebound)
        self._tok = torch.zeros(bl, dtype=torch.int32, device=dev)
        self._active = torch.zeros(bl, dtype=torch.bool, device=dev)
        self._temp = torch.full((bl,), ecfg.temperature, dtype=torch.float32, device=dev)
        self._top_p = torch.full((bl,), ecfg.top_p, dtype=torch.float32, device=dev)
        self._aidx = torch.zeros(bl, dtype=torch.int32, device=dev)
        steps = ecfg.inner_steps
        self._out_tok = torch.zeros((steps, bl), dtype=torch.int32, device=dev)
        self._out_lp = torch.zeros((steps, bl), dtype=torch.float32, device=dev)
        k1 = ecfg.spec_tokens + 1
        if ecfg.spec_tokens:
            # token history per slot, plus one sink column that takes the writes of rejected positions
            self._hist = torch.zeros((bl, ml + 2), dtype=torch.int32, device=dev)
            self._hlen = torch.zeros(bl, dtype=torch.int32, device=dev)
            self._spec_tok = torch.zeros((steps, bl, k1), dtype=torch.int32, device=dev)
            self._spec_cnt = torch.zeros((steps, bl), dtype=torch.int32, device=dev)
            self._spec_lp = torch.zeros((steps, bl, k1), dtype=torch.float32, device=dev)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(ecfg.seed)
        self._graphs: dict[tuple, _Graph] = {}
        self._pool = self._side = None  # the graphs' shared memory pool and capture stream (card only)

    # -- device programs ---------------------------------------------------

    def _forward(self, tokens: torch.Tensor, cache: T.KVCache, aidx: torch.Tensor | None, **kw):
        """``T.forward`` on the engine's params; ``aidx`` (B,) int32 reaches
        the adapter stacks of a multi-LoRA engine and is dropped otherwise.
        With a mesh: this rank's shards, the logits gathered over the model
        group to the full vocabulary."""
        logits, cache = T.forward(self.params, self.cfg, tokens, cache, adapter_idx=aidx if self._mlora else None,
                                  group=self._group, **kw)
        if self._group is not None:
            from ..parallel.tp import gather_vocab

            logits = gather_vocab(logits, self.mesh)
        return logits, cache

    def _shard(self) -> tuple[int, int] | None:
        """(data index, data replicas) of this rank's decode rows for the
        sampling draws; None without data sharding."""
        return (self._di, self._nd) if self._nd > 1 else None

    def _mine(self, a):
        """This rank's entries of a per-slot host array (slots i with
        i % n_data == its data index, in local row order)."""
        return a[self._di :: self._nd]

    def _host_fetch(self, x: torch.Tensor, axis: int) -> np.ndarray:
        """Device -> host for engine bookkeeping: ``x`` holds this rank's
        decode rows along ``axis``; with data replicas their rows are
        gathered over the data group and put back in global slot order, so
        every rank sees every slot (the JAX engine's ``_host_fetch``)."""
        if self._nd == 1:
            return x.cpu().numpy()
        from ..parallel.tp import all_gather

        g = all_gather(x.unsqueeze(axis + 1), self.mesh.data_group, dim=axis + 1)  # (..., bl, n_data, ...)
        return g.reshape(*x.shape[:axis], -1, *x.shape[axis + 1 :]).cpu().numpy()

    def _sub_cache(self, bp: int) -> T.KVCache:
        """This rank's rows of the first ``bp`` slots of the cache (views:
        writes land in place); idle slots get length 0 so their write offset
        never creeps toward max_len (their tokens are garbage the host
        ignores)."""
        c, bl = self.cache, bp // self._nd
        return T.KVCache(k=[a[:bl] for a in c.k], v=[a[:bl] for a in c.v],
                         length=torch.where(self._active[:bl], c.length[:bl], torch.zeros_like(c.length[:bl])))

    @torch.no_grad()
    def _decode_fn(self, bp: int, n: int) -> None:
        """``n`` batched decode steps over slots [0, bp) (JAX's ``_decode_fn``):
        reads the static tokens, mask, temp, top_p and cache; writes the
        tokens (and logprobs) of step j to row j of the output buffers and the
        new lengths into the cache in place."""
        bl = bp // self._nd
        sub = self._sub_cache(bp)
        tok, temp, top_p = self._tok[:bl], self._temp[:bl], self._top_p[:bl]
        for j in range(n):
            logits, sub = self._forward(tok[:, None], sub, self._aidx[:bl])
            lg = logits[:, -1]
            tok = select(self.ecfg, lg, self._gen, temp, top_p, self._shard())
            self._out_tok[j, :bl].copy_(tok)
            if self.ecfg.logprobs:
                self._out_lp[j, :bl].copy_(logprob_of(lg, tok))
            if self.step_logits is not None:
                self.step_logits[j, :bl].copy_(lg)
        self.cache.length[:bl].copy_(sub.length)

    @torch.no_grad()
    def _spec_fn(self, bp: int, s: int) -> None:
        """``s`` speculative steps over slots [0, bp) (JAX's ``_spec_fn``): per
        step, draft k tokens by prompt lookup in the device-resident history,
        run current + draft as one (bp, k+1) forward, verify, emit the
        accepted drafts and one correction; rejected rows roll back by length
        alone.  Writes step si's tokens, counts (and logprobs) to row si of
        the output buffers, and advances the history, lengths and cache in
        place."""
        k, n = self.ecfg.spec_tokens, self.ecfg.spec_ngram
        bl = bp // self._nd
        sub = self._sub_cache(bp)
        hist, hlen = self._hist[:bl], self._hlen[:bl]
        h = hist.shape[1] - 1  # the last column is the sink
        cur, temp, top_p = self._tok[:bl], self._temp[:bl], self._top_p[:bl]
        t_idx = torch.arange(k + 1, dtype=torch.int32, device=self.device)[None, :]
        for si in range(s):
            draft = prompt_lookup_draft(hist[:, :h], hlen, k=k, n=n)
            logits, sub = self._forward(torch.cat([cur[:, None], draft], dim=1), sub, self._aidx[:bl])
            emitted, emit = spec_verify(self.ecfg, logits, draft, self._gen, temp, top_p, self._shard())
            sub = T.KVCache(k=sub.k, v=sub.v, length=sub.length - (k + 1) + emit)
            pos = torch.where(t_idx < emit[:, None], torch.clamp(hlen[:, None] + t_idx, max=h), h)
            hist.scatter_(1, pos.long(), emitted)
            hlen.add_(emit)
            cur = torch.gather(emitted, 1, (emit - 1)[:, None].long())[:, 0]
            self._spec_tok[si, :bl].copy_(emitted)
            self._spec_cnt[si, :bl].copy_(emit)
            if self.ecfg.logprobs:
                self._spec_lp[si, :bl].copy_(logprob_of(logits, emitted))
        self.cache.length[:bl].copy_(sub.length)

    def _program(self, kind: str, key: tuple) -> None:
        """Count ``key``'s first run in ``traces[kind]``."""
        if key not in self._programs:
            self._programs.add(key)
            self.traces[kind] += 1

    def _run(self, key: tuple, fn) -> None:
        """Run device program ``fn`` (it reads and writes the static buffers
        only): on the card by replaying its CUDA graph, captured at first use;
        on the CPU, and with a mesh, eagerly."""
        self._program("decode", key)
        if self.device.type != "cuda" or self.mesh is not None:
            fn()
            return
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(fn)
        g.replay()

    def _capture(self, fn) -> _Graph:
        """Capture ``fn`` into a CUDA graph, after one eager run on the capture
        stream (kernel builds, allocator growth, per-stream scratch) whose
        state changes are undone: the lengths (and speculation history) are
        restored, and its writes past the lengths are overwritten by the
        replay before any query sees them.  All graphs share one memory pool.
        A capture that fails raises; without a mesh the engine never decodes
        eagerly on the card.  With a mesh it decodes eagerly and captures
        nothing: gloo collectives cannot be captured in a CUDA graph, and
        capture over NCCL needs a card per rank (ROADMAP)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
        saved = [self.cache.length.clone()]
        if self.ecfg.spec_tokens:
            saved += [self._hist.clone(), self._hlen.clone()]
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(self._side)
        for dst, src in zip([self.cache.length, self._hist, self._hlen] if self.ecfg.spec_tokens
                            else [self.cache.length], saved):
            dst.copy_(src)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        before = K.launch_counts()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._side):
            fn()
        launched = {name: n - before[name] for name, n in K.launch_counts().items() if n != before[name]}
        K.add_launch_counts(launched, times=-1)  # a capture runs nothing; each replay adds them
        return _Graph(graph, launched)

    def _row_tensors(self, req: Request, slot: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Record a request's sampling overrides and adapter on its slot;
        returns the (1,) temperature, top_p and adapter index of its prefill
        (JAX's ``_resolve_sampling``)."""
        t = self.ecfg.temperature if req.temperature is None else req.temperature
        p = self.ecfg.top_p if req.top_p is None else req.top_p
        aid = 0 if req.adapter is None else self.adapter_ids[req.adapter]
        self.slot_temp[slot] = t
        self.slot_tp[slot] = p
        self.slot_aidx[slot] = aid
        self._slots_dirty = True
        self._hist_dirty = True
        return (torch.tensor([t], dtype=torch.float32, device=self.device),
                torch.tensor([p], dtype=torch.float32, device=self.device),
                torch.tensor([aid], dtype=torch.int32, device=self.device))

    @torch.no_grad()
    def _first_token(self, logits, temp, top_p) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The prompt's first token (and its logprob) from its last-position
        logits (1, 1, V): the draw of JAX's ``_prefill_fn`` / ``_chunk_fn``."""
        lg = logits[:, -1]
        first = select(self.ecfg, lg, self._gen, temp, top_p)
        return first[0], (logprob_of(lg, first)[0] if self.ecfg.logprobs else None)

    @torch.no_grad()
    def _prefill_fn(self, tokens: torch.Tensor, slot: int, true_len: int, temp, top_p, aidx=None):
        """Batch-1 prefill of a bucket-padded prompt (1, Lp_pad) on a small
        cache, spliced into ``slot``; rows past ``true_len`` are garbage that
        kv_valid masks.  The lm_head runs on the true last position only.
        Returns (first token, its logprob or None), on the device."""
        lp_pad = tokens.shape[1]
        self._program("prefill", ("prefill", lp_pad))
        small = T.KVCache.zeros(self._cache_cfg, 1, lp_pad, dtype=self._kv_dtype, device=self.device)
        logits, small = self._forward(tokens, small, aidx, last_index=true_len - 1)
        self._splice_fn(small, slot, true_len)
        return self._first_token(logits, temp, top_p)

    @torch.no_grad()
    def _chunk_fn(self, tokens: torch.Tensor, small: T.KVCache, last_index: int, lp_pad: int, temp, top_p,
                  aidx=None):
        """One prefill chunk on the private batch-1 cache (of the prompt's
        bucket ``lp_pad``): its KV lands at small.length, which advances;
        ``last_index`` is the chunk-local position of the prompt's true last
        token (only the final chunk's draw is used).  Returns (token, logprob
        or None, cache)."""
        self._program("prefill", ("chunk", tokens.shape[1], lp_pad))
        logits, small = self._forward(tokens, small, aidx, last_index=last_index)
        return (*self._first_token(logits, temp, top_p), small)

    def _row(self, row: int) -> tuple[int, int]:
        """(data replica, local row) of global cache row ``row``."""
        return row % self._nd, row // self._nd

    def _splice_fn(self, small: T.KVCache, slot: int, true_len: int) -> None:
        """Copy a completed prefill's KV rows into ``slot``, layer by layer:
        ``sm.shape[1]`` rows each (a ring layer of the small cache may hold
        fewer rows than the prompt's bucket).  Slot s holds the same position
        in both caches: either the small layer never wrapped, or it has the big
        layer's ring size.  Rows past ``true_len`` are masked by kv_valid.
        With data replicas only the slot's owner writes (every replica ran
        the prefill alike)."""
        d, r = self._row(slot)
        if d != self._di:
            return
        for big, sm in zip(self.cache.k + self.cache.v, small.k + small.v):
            big[r, : sm.shape[1]].copy_(sm[0])
        self.cache.length[r] = true_len

    def _bcast_row(self, row: int, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """``tensors``, as the owner of global row ``row`` holds them,
        broadcast over the data group to every replica (the owner's own
        tensors are returned as they are; the others receive into fresh
        ones)."""
        from ..parallel.tp import broadcast_

        d = self._row(row)[0]
        if d != self._di:
            tensors = [torch.empty_like(t) for t in tensors]
        return [broadcast_(t.contiguous(), self.mesh.data_rank(d), self.mesh.data_group) for t in tensors]

    def _move_fn(self, src: int, dst: int) -> None:
        """Relocate one cache row's KV and length ``src`` -> ``dst`` (batch
        compaction, the prefix store): one row copy per layer; the src rows
        are left stale.  Across data replicas the row is broadcast from its
        owner and the destination's owner writes it."""
        (ds, rs), (dd, rd) = self._row(src), self._row(dst)
        c = self.cache
        if ds == dd:
            if ds == self._di:
                for a in c.k + c.v:
                    a[rd].copy_(a[rs])
                c.length[rd] = c.length[rs]
            return
        got = self._bcast_row(src, [a[rs] for a in c.k + c.v] + [c.length[rs : rs + 1]])
        if dd == self._di:
            for a, t in zip(c.k + c.v, got):
                a[rd].copy_(t)
            c.length[rd] = got[-1][0]

    def _fork_fn(self, src: int, length: int, lp_pad: int) -> T.KVCache:
        """A private batch-1 cache for a prompt of bucket ``lp_pad`` holding
        row ``src``'s leading KV rows, write offset ``length`` (prefix
        caching): rows [0, length) are the donor's shared-prefix KV, rows
        beyond are garbage the suffix chunks overwrite or kv_valid masks.
        Per layer the copy is the small cache's row count for this bucket.
        With data replicas the donor's owner broadcasts it to every replica
        (the suffix prefill runs alike on all of them)."""
        self._program("fork", ("fork", lp_pad))
        _, r = self._row(src)
        n = self.cfg.n_layers
        rows = [T.ring_rows(lp_pad, self.cfg.layer_sliding_window(i), self._ring_chunk) for i in range(n)]
        parts = [a[r : r + 1, :rows[i % n]].clone() for i, a in enumerate(self.cache.k + self.cache.v)]
        if self._nd > 1:
            parts = self._bcast_row(src, parts)
        return T.KVCache(k=parts[:n], v=parts[n:], length=torch.tensor([length], dtype=torch.int32, device=self.device))

    # -- prefix cache --------------------------------------------------------

    @staticmethod
    def _lcp(a: list[int], b: list[int]) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    def _slot_cached_seq(self, i: int) -> list[int]:
        """Tokens whose KV rows slot ``i`` holds: prompt plus every emitted
        token but the newest (not fed back yet)."""
        return self.slot_req[i].prompt + self.slot_tokens[i][:-1]

    def _find_prefix_donor(self, prompt: list[int], grain: int, aid: int = 0) -> tuple[int, int] | None:
        """Longest-shared-prefix donor among the active slots and store
        entries of adapter index ``aid``: (cache row, reuse) with reuse a
        multiple of ``grain``, capped at len(prompt) - 1; None under one
        grain.  Ring caches: the donor must not have wrapped and the reuse
        must fit the smallest ring.  A store hit moves to the MRU end.  KV
        rows hold the adapter's K/V projections, so a donor under another
        adapter (the JAX engine does not ask) is no donor (ROADMAP R7)."""
        best: tuple[int, int] | None = None
        hit_store = -1
        cands = [(i, self._slot_cached_seq(i)) for i, r in enumerate(self.slot_req)
                 if r is not None and self.slot_aidx[i] == aid]
        cands += [(e["row"], e["tokens"]) for e in self._store if e["aidx"] == aid]
        for row, seq in cands:
            if self._ring_min is not None and len(seq) > self._ring_min:
                continue  # donor rows may have wrapped: early KV evicted
            reuse = min(self._lcp(prompt, seq), len(prompt) - 1) // grain * grain
            if self._ring_min is not None:
                reuse = min(reuse, self._ring_min // grain * grain)
            if reuse >= grain and (best is None or reuse > best[1]):
                best = (row, reuse)
                hit_store = (next((j for j, e in enumerate(self._store) if e["row"] == row), -1)
                             if row >= self.ecfg.max_batch else -1)
        if best is not None and hit_store >= 0:
            self._store.append(self._store.pop(hit_store))
        return best

    def _store_prefix(self, slot: int) -> None:
        """Move a retiring slot's KV rows into a store row (LRU-evicting), so
        later admissions fork them after the donor is gone.  Entries record
        their adapter index, and cover or extend only entries of the same
        one (ROADMAP R7).  Unlike the JAX engine, a sequence an entry already
        covers touches that entry (moves it to MRU; ROADMAP R4)."""
        grain = self.ecfg.prefill_chunk or 32
        seq = self._slot_cached_seq(slot)
        aid = int(self.slot_aidx[slot])
        if len(seq) < grain:
            return
        if self._ring_min is not None and len(seq) > self._ring_min:
            return  # wrapped ring: early rows evicted, useless as a donor
        replace_idx = None
        for j, e in enumerate(self._store):
            if e["aidx"] != aid:
                continue
            n = self._lcp(seq, e["tokens"])
            if n == len(seq):
                self._store.append(self._store.pop(j))  # covered: touch it (R4)
                return
            if n == len(e["tokens"]):
                replace_idx = j  # this sequence extends an existing entry
        if replace_idx is not None:
            row = self._store.pop(replace_idx)["row"]
        elif len(self._store) < self.ecfg.prefix_store:
            row = self.ecfg.max_batch + len(self._store)
        else:
            row = self._store.pop(0)["row"]  # LRU eviction
        self._move_fn(slot, row)
        self._store.append(dict(row=row, tokens=seq, aidx=aid))
        log.debug("prefix store: slot %d -> row %d (%d tokens)", slot, row, len(seq))

    # -- batch buckets -------------------------------------------------------

    def _batch_bucket(self, need: int) -> int:
        """Smallest power of two times the data-axis size >= ``need``, at most
        max_batch (slots shard over data, so a bucket splits evenly over the
        replicas)."""
        b = self._nd
        while b < need:
            b *= 2
        return min(b, self.ecfg.max_batch)

    def _batch_buckets(self) -> list[int]:
        if not self.ecfg.batch_buckets:
            return [self.ecfg.max_batch]
        out, b = [], self._nd
        while b < self.ecfg.max_batch:
            out.append(b)
            b *= 2
        return out + [self.ecfg.max_batch]

    def _compact(self) -> None:
        """Move the highest active slot down into a free low slot whenever that
        shrinks the decode bucket (one KV row move)."""
        while True:
            act = [i for i, r in enumerate(self.slot_req) if r is not None]
            if not act:
                return
            hi = max(act)
            reserved = {self._pf["slot"]} if self._pf is not None else set()
            free = [i for i in range(hi) if self.slot_req[i] is None and i not in reserved]
            if not free or self._batch_bucket(hi + 1) <= self._batch_bucket(len(act) + len(reserved)):
                return
            dst = free[0]
            self._move_fn(hi, dst)
            for attr in ("slot_req", "slot_tokens", "slot_t0", "slot_lps"):
                getattr(self, attr)[dst] = getattr(self, attr)[hi]
            self.slot_req[hi] = None
            self.slot_tokens[hi] = []
            self.slot_lps[hi] = []
            for arr in (self.slot_cur, self.slot_temp, self.slot_tp, self.slot_aidx):
                arr[dst] = arr[hi]
            self._slots_dirty = True
            self._hist_dirty = True
            log.debug("compact slot %d -> %d", hi, dst)

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
            if t > 0 and self.ecfg.temperature <= 0:
                raise ValueError("engine is compiled greedy (EngineConfig.temperature == 0); a per-request "
                                 "temperature cannot enable sampling — start the engine/server with temperature > 0")
        tp = req.top_p
        if tp is not None:
            if not isinstance(tp, (int, float)) or isinstance(tp, bool) or not (0.0 < tp <= 1.0):
                raise ValueError(f"top_p must be in (0, 1], got {tp!r}")
            if tp < 1.0 and self.ecfg.top_p >= 1.0:
                raise ValueError("engine compiled without a nucleus path (EngineConfig.top_p == 1.0); a "
                                 "per-request top_p cannot enable it — start the engine/server with top_p < 1")
        if req.adapter is not None and (not self.adapter_ids or req.adapter not in self.adapter_ids):
            known = sorted(self.adapter_ids) if self.adapter_ids else []
            raise ValueError(f"unknown adapter {req.adapter!r} (engine has {known}); build the engine with "
                             "attach_multi_lora's adapter_ids")
        self._arrival[req.uid] = time.perf_counter() if req.arrival is None else req.arrival
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
        now = time.perf_counter()
        t = self._arrival.pop(req.uid, now)
        self._completed += 1
        self.completions.append(Completion(uid=req.uid, tokens=[], prompt_len=len(req.prompt), finish_reason="abort",
                                           ttft_s=0.0, total_s=now - t, queue_s=self._queue_s.pop(req.uid, now - t)))

    def _dequeue(self) -> Request:
        """Take the next request off the queue, recording its wait."""
        req = self.pending.popleft()
        self._queue_s[req.uid] = time.perf_counter() - self._arrival[req.uid]
        return req

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _bucket(self, lp: int) -> int:
        """Prefill length bucket: 32-row steps, clamped to the cache."""
        return min((lp + 31) // 32 * 32, self.ecfg.max_len)

    def _bind(self, slot: int, req: Request, first, lp0) -> None:
        """Start decoding ``req`` in ``slot`` from its first token (the tick's
        host fetch of the prefill's draw)."""
        first = int(first)
        self.slot_req[slot] = req
        self.slot_tokens[slot] = [first]
        self.slot_lps[slot] = [float(lp0)] if self.ecfg.logprobs else []
        self.slot_cur[slot] = first
        self.slot_t0[slot] = time.perf_counter()
        self._slots_dirty = True
        self._hist_dirty = True
        if self.on_token is not None:
            self.on_token(req.uid, first)

    def _chunk_tokens(self, prompt: list[int], lo: int, hi: int) -> torch.Tensor:
        toks = np.zeros((1, hi - lo), np.int32)
        real = prompt[lo:hi]
        toks[0, : len(real)] = real
        return torch.from_numpy(toks).to(self.device)

    def _admit(self) -> None:
        admitted = 0
        for slot in self._free_slots():
            if not self.pending or (self.ecfg.admit_budget and admitted >= self.ecfg.admit_budget):
                break
            req = self._dequeue()
            lp = len(req.prompt)
            lp_pad = self._bucket(lp)
            rows = self._row_tensors(req, slot)
            aid = int(self.slot_aidx[slot])
            donor = self._find_prefix_donor(req.prompt, 32, aid) if self.ecfg.prefix_cache else None
            if donor is not None:
                # fork the donor's shared-prefix KV, prefill only the suffix in 32-token chunks
                dslot, reuse = donor
                small = self._fork_fn(dslot, reuse, lp_pad)
                lo = reuse
                while lo < lp:
                    hi = min(lo + 32, lp_pad)
                    with span("engine.prefill"):
                        first, lp0, small = self._chunk_fn(self._chunk_tokens(req.prompt, lo, hi), small,
                                                           min(lp, hi) - 1 - lo, lp_pad, *rows)
                        self.last_prefill.append((req.uid, hi - lo, lo, min(lp, hi) - lo))
                        if hi >= lp:
                            self._splice_fn(small, slot, lp)
                            self._bind(slot, req, first, lp0)
                    lo = hi
                self._prefix_hits += 1
                self._prefix_tokens += reuse
                log.debug("admit(prefix) uid=%d slot=%d donor=%d reused=%d/%d", req.uid, slot, dslot, reuse, lp)
            else:
                with span("engine.prefill"):
                    first, lp0 = self._prefill_fn(self._chunk_tokens(req.prompt, 0, lp_pad), slot, lp, *rows)
                    self.last_prefill.append((req.uid, lp_pad, 0, lp))
                    self._bind(slot, req, first, lp0)
            admitted += 1
            log.debug("admit uid=%d slot=%d prompt_len=%d", req.uid, slot, lp)

    def _admit_chunked(self) -> None:
        """Advance the in-flight prefill by ONE chunk (starting the next
        pending request when idle): each tick pays at most one chunk."""
        c = self.ecfg.prefill_chunk
        if self._pf is None:
            slots = self._free_slots()
            if not self.pending or not slots:
                return
            req = self._dequeue()
            lp_pad = self._bucket(len(req.prompt))
            done = 0
            rows = self._row_tensors(req, slots[0])
            aid = int(self.slot_aidx[slots[0]])
            donor = self._find_prefix_donor(req.prompt, c, aid) if self.ecfg.prefix_cache else None
            if donor is not None:
                # start at the donated prefix (a chunk multiple, so chunk widths stay the same)
                dslot, done = donor
                small = self._fork_fn(dslot, done, lp_pad)
                self._prefix_hits += 1
                self._prefix_tokens += done
                log.debug("admit(prefix) uid=%d donor=%d reused=%d/%d", req.uid, dslot, done, len(req.prompt))
            else:
                # the small cache covers the whole bucket (ring layers keep fewer rows)
                small = T.KVCache.zeros(self._cache_cfg, 1, lp_pad, dtype=self._kv_dtype, write_chunk=self._ring_chunk,
                                        device=self.device)
            self._pf = dict(req=req, slot=slots[0], small=small, done=done, lp_pad=lp_pad, rows=rows)
        pf = self._pf
        req, lp = pf["req"], len(pf["req"].prompt)
        lo = pf["done"]
        hi = min(lo + c, pf["lp_pad"])
        with span("engine.prefill"):
            first, lp0, pf["small"] = self._chunk_fn(self._chunk_tokens(req.prompt, lo, hi), pf["small"],
                                                     min(lp, hi) - 1 - lo, pf["lp_pad"], *pf["rows"])
            self.last_prefill.append((req.uid, hi - lo, lo, min(lp, hi) - lo))
            pf["done"] = hi
            if hi < lp:
                return  # more chunks to go; decode proceeds this tick
            self._splice_fn(pf["small"], pf["slot"], lp)
            self._bind(pf["slot"], req, first, lp0)
        log.debug("admit(chunked) uid=%d slot=%d prompt_len=%d chunks=%d", req.uid, pf["slot"], lp, -(-lp // c))
        self._pf = None

    def _retire(self, slot: int, reason: str) -> None:
        req = self.slot_req[slot]
        if self.ecfg.prefix_store:
            self._store_prefix(slot)
        now = time.perf_counter()
        t_arr = self._arrival.pop(req.uid, now)
        self._completed += 1
        self.completions.append(Completion(
            uid=req.uid, tokens=self.slot_tokens[slot], prompt_len=len(req.prompt), finish_reason=reason,
            ttft_s=self.slot_t0[slot] - t_arr, total_s=now - t_arr, queue_s=self._queue_s.pop(req.uid, 0.0),
            logprobs=self.slot_lps[slot] if self.ecfg.logprobs else None))
        self.slot_req[slot] = None
        self.slot_tokens[slot] = []
        self.slot_lps[slot] = []
        self._slots_dirty = True
        self._hist_dirty = True

    def _upload_slots(self, active: list[int]) -> None:
        """The active mask, temperatures, top_p and adapter indices of this
        rank's slots into their static buffers (only when the slot set or a
        slot's values changed)."""
        if not self._slots_dirty:
            return
        mask = np.zeros(self.ecfg.max_batch, bool)
        mask[active] = True
        for buf, a in ((self._active, mask), (self._temp, self.slot_temp), (self._top_p, self.slot_tp),
                       (self._aidx, self.slot_aidx)):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(self._mine(a))))
        self._slots_dirty = False

    def _upload_hist(self, active: list[int]) -> None:
        """Rebuild the device-resident speculation history from host state
        (only when the slot set changed)."""
        if not self._hist_dirty:
            return
        hist = np.zeros((self.ecfg.max_batch, self._hist.shape[1]), np.int32)
        hlen = np.zeros(self.ecfg.max_batch, np.int32)
        for i in active:
            seq = self.slot_req[i].prompt + self.slot_tokens[i]
            hist[i, : len(seq)] = seq
            hlen[i] = len(seq)
        self._hist.copy_(torch.from_numpy(np.ascontiguousarray(self._mine(hist))))
        self._hlen.copy_(torch.from_numpy(np.ascontiguousarray(self._mine(hlen))))
        self._hist_dirty = False

    def step(self) -> int:
        """One tick: admit pending requests, retire finished slots, run up to
        ``inner_steps`` batched decode steps (or speculative steps).  Returns
        the active slot count."""
        t_tick = time.perf_counter()
        self.last_decode_steps = 0
        self.last_prefill = []
        with span("engine.admit"):
            if self.ecfg.prefill_chunk:
                self._admit_chunked()
            else:
                self._admit()
        with span("engine.retire"):
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
        if not any(r is not None for r in self.slot_req):
            return 0
        k = self.ecfg.spec_tokens
        with span("engine.decode"):
            if self.ecfg.batch_buckets:
                self._compact()
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            # inner depth: bounded by the tightest remaining cache capacity only
            # (a slot's own budget does not shrink it: tokens past it are dropped
            # below), bucketed to a power of two
            cap = min(self.ecfg.max_len - (len(self.slot_req[i].prompt) + len(self.slot_tokens[i])) for i in active)
            budget = min(self.ecfg.inner_steps, cap)
            n = 1
            while 2 * n <= budget:
                n *= 2
            bp = self._batch_bucket(max(active) + 1) if self.ecfg.batch_buckets else self.ecfg.max_batch
            self._last_decode_batch = bp
            self._upload_slots(active)
            bl = bp // self._nd
            self._tok[:bl].copy_(torch.from_numpy(self._mine(self.slot_cur[:bp]).astype(np.int32)))
            spec = bool(k) and cap >= k + 1
            if spec:
                # speculative path: s verify forwards per tick, each emitting
                # 1..k+1 tokens per slot; worst-case growth s*(k+1) fits capacity
                s = 1
                while 2 * s <= self.ecfg.inner_steps and 2 * s * (k + 1) <= cap:
                    s *= 2
                self._upload_hist(active)
                self._run(("spec", bp, s, self.step_logits is not None), lambda: self._spec_fn(bp, s))
            else:
                self._run(("decode", bp, n, self.step_logits is not None), lambda: self._decode_fn(bp, n))
        with span("engine.fetch"):  # the tick's host fetch
            if spec:
                toks = self._host_fetch(self._spec_tok[:s, :bl], 1)
                cnts = self._host_fetch(self._spec_cnt[:s, :bl], 1)
                lpf = self._host_fetch(self._spec_lp[:s, :bl], 1) if self.ecfg.logprobs else None
            else:
                toks = self._host_fetch(self._out_tok[:n, :bl], 1)
                lpf = self._host_fetch(self._out_lp[:n, :bl], 1) if self.ecfg.logprobs else None
        with span("engine.deliver"):
            lps = None
            if spec:
                per_slot = {i: [int(t) for si in range(s) for t in toks[si, i, : cnts[si, i]]] for i in active}
                if lpf is not None:
                    lps = {i: [float(x) for si in range(s) for x in lpf[si, i, : cnts[si, i]]] for i in active}
                emitted = sum(len(v) for v in per_slot.values())
                self._spec_emitted += emitted
                self._spec_slot_forwards += s * len(active)
                self.step_times.append((time.perf_counter() - t_tick) / max(emitted / len(active), 1.0))
                self._steps += s
            else:
                per_slot = {i: [int(t) for t in toks[:, i]] for i in active}
                if lpf is not None:
                    lps = {i: [float(x) for x in lpf[:, i]] for i in active}
                self.step_times.append((time.perf_counter() - t_tick) / n)
                self._steps += n
                self.last_decode_steps = n
            for i in active:
                req = self.slot_req[i]
                for j, t in enumerate(per_slot[i]):
                    self.slot_tokens[i].append(t)
                    if lps is not None:
                        self.slot_lps[i].append(lps[i][j])
                    self._tokens_out += 1
                    if self.on_token is not None:
                        self.on_token(req.uid, t)
                    if (req.eos_id is not None and t == req.eos_id) or (req.stop_ids and t in req.stop_ids):
                        break  # tokens decoded past EOS/stop are dropped
                    if len(self.slot_tokens[i]) >= req.max_new_tokens:
                        break  # tokens past the request budget are dropped too
                self.slot_cur[i] = self.slot_tokens[i][-1]
        return len(active)

    @torch.no_grad()
    def warmup(self, max_prompt_len: int | None = None, prompt_lens=None) -> dict:
        """Run every serving program once before serving, so that no request
        pays a capture, a kernel build or allocator growth: the prefill of
        every 32-row bucket covering ``prompt_lens`` (or all up to
        ``max_prompt_len``; in chunked mode every chunk of each bucket), the
        forks and suffix chunks of the prefix cache, and the decode programs
        of every power-of-two depth <= inner_steps (and every speculation
        depth s) for every batch bucket, captured as CUDA graphs on the card.
        The engine must be idle: the runs scribble on slot 0 and idle slots.
        With a mesh every rank warms up alike (its runs are collective).
        Returns the trace counters (JAX's ``Engine.warmup``)."""
        if any(r is not None for r in self.slot_req) or self._pf is not None:
            raise RuntimeError("warmup() must run before serving (cache is scribbled)")
        if prompt_lens is None:
            if max_prompt_len is None:
                raise ValueError("warmup needs max_prompt_len or prompt_lens")
            prompt_lens = range(1, max_prompt_len + 1, 32)
        buckets = sorted({self._bucket(lp) for lp in prompt_lens})
        dev = self.device
        t1 = torch.full((1,), self.ecfg.temperature, dtype=torch.float32, device=dev)
        p1 = torch.full((1,), self.ecfg.top_p, dtype=torch.float32, device=dev)
        a1 = torch.zeros(1, dtype=torch.int32, device=dev)
        c = self.ecfg.prefill_chunk
        for lp_pad in buckets:
            if c:
                small = T.KVCache.zeros(self._cache_cfg, 1, lp_pad, dtype=self._kv_dtype, write_chunk=self._ring_chunk,
                                        device=dev)
                for lo in range(0, lp_pad, c):
                    hi = min(lo + c, lp_pad)
                    _, _, small = self._chunk_fn(torch.zeros((1, hi - lo), dtype=torch.int32, device=dev), small, 0,
                                                 lp_pad, t1, p1, a1)
                self._splice_fn(small, 0, 1)
            else:
                self._prefill_fn(torch.zeros((1, lp_pad), dtype=torch.int32, device=dev), 0, 1, t1, p1, a1)
        if self.ecfg.prefix_cache:
            for lp_pad in buckets:
                small = self._fork_fn(0, 0, lp_pad)
                if not c:  # suffix widths are 32 except a max_len-clamped bucket's tail
                    for w in sorted({min(32, lp_pad)} | ({lp_pad % 32} if lp_pad % 32 else set())):
                        _, _, small = self._chunk_fn(torch.zeros((1, w), dtype=torch.int32, device=dev), small, 0,
                                                     lp_pad, t1, p1, a1)
        self._upload_slots([])
        logits_flag = self.step_logits is not None
        for bp in self._batch_buckets():
            n = 1
            while n <= self.ecfg.inner_steps:
                self._run(("decode", bp, n, logits_flag), lambda: self._decode_fn(bp, n))
                n *= 2
            if self.ecfg.spec_tokens:
                s, k1 = 1, self.ecfg.spec_tokens + 1
                while s <= self.ecfg.inner_steps and s * k1 <= self.ecfg.max_len:
                    self._run(("spec", bp, s, logits_flag), lambda: self._spec_fn(bp, s))
                    s *= 2
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log.info("warmup: %d prefill buckets, %d decode programs", len(buckets), self.traces["decode"])
        # throughput metrics start when serving starts
        self.step_times.clear()
        self._t0 = time.perf_counter()
        return dict(self.traces)

    def stats(self) -> dict:
        """Serving metrics, with the JAX engine's keys: tok/s, occupancy,
        per-token tick latency, TTFT, speculation and prefix-cache counters,
        KV bytes."""
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
            decode_batch=self._last_decode_batch,
            active_slots=sum(r is not None for r in self.slot_req),
            pending=len(self.pending),
            spec_tokens_per_forward=(self._spec_emitted / self._spec_slot_forwards
                                     if self._spec_slot_forwards else 0.0),
            prefix_hits=self._prefix_hits,
            prefix_tokens_reused=self._prefix_tokens,
            prefix_store_entries=len(self._store),
            kv_cache_bytes=sum(a.numel() * a.element_size() for a in self.cache.k + self.cache.v),  # this rank's
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
