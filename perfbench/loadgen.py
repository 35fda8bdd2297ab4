"""The load generator and the record of a run.

A traffic file gives the loop (``open``: Poisson arrivals at the cell's
``rate``; ``closed``: ``clients`` that each send their next request when the
last completes), the distributions of prompt and output lengths, and
``block``.  Every block of that many requests holds the same lengths and
gaps, the stratified quantiles of the distributions, in an order drawn from
the seed: every seed offers the same work, so seeds differ in order, not in
load.  Token ids are uniform over the vocabulary, from the seed.

The driver feeds the engine through ``Engine.submit`` and ``Engine.step``
and timestamps every token (``on_token``).  Arrivals start ``ramp_s`` before
the window opens, so the batch is at steady state when it opens; after it
closes, the requests due in the window are drained (an open loop keeps
arriving meanwhile) for at most ``drain_s``.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import numpy as np

clock = time.perf_counter


def quantile(dist: dict, p: float) -> int:
    """The ``p`` quantile of a length distribution, rounded and clipped:
    ``lognormal`` (median, sigma, min, max) or ``uniform`` (min, max)."""
    if dist["dist"] == "lognormal":
        v = math.exp(math.log(dist["median"]) + dist["sigma"] * statistics.NormalDist().inv_cdf(p))
    elif dist["dist"] == "uniform":
        v = dist["min"] + (dist["max"] - dist["min"]) * p
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return int(min(max(round(v), dist["min"]), dist["max"]))


def block_values(dist: dict, n: int) -> list[int]:
    return [quantile(dist, (j + 0.5) / n) for j in range(n)]


@dataclasses.dataclass
class Req:
    uid: int
    prompt: list[int]
    n_out: int
    due: float = 0.0  # host clock at which it was due (open loop: the schedule)
    times: list = dataclasses.field(default_factory=list)  # host clock of each token
    tokens: list = dataclasses.field(default_factory=list)
    done: float | None = None  # host clock of its completion
    reason: str = ""

    @property
    def t_first(self) -> float | None:
        return self.times[0] if self.times else None


class Schedule:
    """Requests in blocks of stratified lengths (and, for an open loop,
    gaps), each block's order drawn from the seed."""

    def __init__(self, traffic: dict, seed: int, vocab: int, rate: float | None = None):
        self.vocab = vocab
        self.rng = np.random.default_rng([seed % 2**63, 0])
        n = traffic["block"]
        self._prompt = block_values(traffic["prompt_len"], n)
        self._out = block_values(traffic["output_len"], n)
        self._gap = [-math.log(1.0 - (j + 0.5) / n) / rate for j in range(n)] if rate else [0.0] * n
        self._queue: list[tuple[int, int, float]] = []
        self._uid = 0

    def next(self) -> tuple[Req, float]:
        """The next request and its gap after the previous arrival."""
        if not self._queue:
            n = len(self._prompt)
            p, o, g = (self.rng.permutation(n) for _ in range(3))
            self._queue = [(self._prompt[p[j]], self._out[o[j]], self._gap[g[j]]) for j in range(n)]
            self._queue.reverse()
        lp, lo, gap = self._queue.pop()
        prompt = self.rng.integers(0, self.vocab, size=lp).tolist()
        self._uid += 1
        return Req(uid=self._uid, prompt=prompt, n_out=lo), gap


@dataclasses.dataclass
class Tick:
    t0: float
    t1: float
    prefill: list  # per prefill pass: (the program's rows, [(cached positions, new rows)])
    prefill_tokens: int  # prompt tokens this tick prefilled
    decode_steps: int
    decode_m: int  # rows of each decode pass as the program runs it
    decode_seqs: list  # per served request: (cached positions before the first step, its steps)
    in_slice: bool = False
    queued: int = 0  # requests waiting for a slot after the tick


@dataclasses.dataclass
class Record:
    """What a run observed: its requests and ticks, the window, the traced
    slice and the launches counted over it."""

    reqs: list
    ticks: list
    open: float
    close: float
    slice: object = None  # devtrace.Slice
    slice_launches: dict | None = None
    setup_s: float = 0.0

    def in_window(self, t: float | None) -> bool:
        return t is not None and self.open <= t < self.close

    @property
    def window_s(self) -> float:
        return self.close - self.open

    @property
    def due_in_window(self) -> list:
        return [r for r in self.reqs if self.in_window(r.due)]


class Driver:
    """Drives one engine with one schedule; ``run()`` returns the Record.
    ``profiler`` (``harness.Profiler``) covers the window's last
    ``trace_slice_s`` seconds."""

    def __init__(self, engine, spec, schedule: Schedule, seconds: float, request_cls, profiler=None):
        self.e, self.spec, self.sched, self.seconds = engine, spec, schedule, seconds
        self.request_cls, self.profiler = request_cls, profiler
        eng = spec.traffic["engine"]
        self.max_len, self.chunk, self.max_batch = eng["max_len"], eng.get("prefill_chunk", 0), eng["max_batch"]
        self.reqs: dict[int, Req] = {}
        self.inflight: set[int] = set()
        self.ticks: list[Tick] = []
        self._done_seen = len(engine.completions)  # an engine driven before keeps its old completions
        engine.on_token = self.on_token

    @property
    def tracing(self) -> bool:
        return self.profiler is not None and self.profiler.on

    def on_token(self, uid: int, tok: int) -> None:
        r = self.reqs[uid]
        r.times.append(clock())
        r.tokens.append(int(tok))

    def submit(self, r: Req, due: float) -> None:
        r.due = due
        self.reqs[r.uid] = r
        self.inflight.add(r.uid)
        self.e.submit(self.request_cls(uid=r.uid, prompt=r.prompt, max_new_tokens=r.n_out))

    def _pf(self):
        """The engine's in-flight chunked prefill: (uid, rows done, bucket)."""
        pf = getattr(self.e, "_pf", None)
        return None if pf is None else (pf["req"].uid, pf["done"], pf["lp_pad"])

    def _bucket(self, lp: int) -> int:
        return min((lp + 31) // 32 * 32, self.max_len)

    def tick(self) -> list[Req]:
        """One ``Engine.step``, recorded; returns the requests it completed."""
        import torch

        before = {u: len(self.reqs[u].tokens) for u in self.inflight}
        pf0 = self._pf() if self.chunk else None
        t0 = clock()
        if self.tracing:
            with torch.profiler.record_function("perfbench.tick"):
                self.e.step()
        else:
            self.e.step()
        t1 = clock()
        admitted = [u for u in self.inflight if before[u] == 0 and self.reqs[u].tokens]
        prefill, ptoks = [], 0
        if self.chunk:
            pf1 = self._pf()
            if pf0 is not None:  # the in-flight prompt advanced by one chunk (and may have finished)
                cur = pf0
            elif pf1 is not None:  # a prompt started and is not finished
                cur = (pf1[0], 0, pf1[2])
            else:  # a prompt started and finished in one chunk, or nothing was prefilled
                cur = (admitted[0], 0, self._bucket(len(self.reqs[admitted[0]].prompt))) if admitted else None
            if cur is not None:
                uid, lo, lp_pad = cur
                hi = pf1[1] if pf1 is not None and pf1[0] == uid else min(lo + self.chunk, lp_pad)
                real = max(0, min(len(self.reqs[uid].prompt), hi) - lo)
                prefill.append((hi - lo, [(lo, real)]))
                ptoks += real
        else:
            for u in admitted:
                lp = len(self.reqs[u].prompt)
                prefill.append((self._bucket(lp), [(0, lp)]))
                ptoks += lp
        seqs = []
        for u in before:
            r = self.reqs[u]
            have = before[u] or (1 if u in admitted else 0)
            steps = len(r.tokens) - have
            if have and steps > 0:
                seqs.append((len(r.prompt) + have - 1, steps))
        self.ticks.append(Tick(t0, t1, prefill, ptoks, self.e.last_decode_steps,
                               getattr(self.e, "_last_decode_batch", self.max_batch), seqs,
                               in_slice=self.tracing, queued=len(self.e.pending)))
        done = []
        for c in self.e.completions[self._done_seen :]:
            r = self.reqs[c.uid]
            r.done, r.reason = t1, c.finish_reason
            self.inflight.discard(c.uid)
            done.append(r)
        self._done_seen = len(self.e.completions)
        return done

    def _trace_edges(self, now: float, close: float) -> None:
        """Start the profiler ``trace_slice_s`` before the close, stop it at
        the first tick boundary after the close."""
        p = self.profiler
        if p is None or p.launches is not None:
            return
        if not p.on and now >= close - self.spec.traffic["trace_slice_s"]:
            p.start()
        elif p.on and now >= close:
            p.stop()

    def run(self) -> Record:
        tr = self.spec.traffic
        t0 = clock()
        open_ = t0 + tr["ramp_s"]
        close = open_ + self.seconds
        drain_end = close + tr["drain_s"]

        def window_done():
            return all(r.done is not None for r in self.reqs.values() if open_ <= r.due < close)

        if tr["loop"] == "open":
            nxt, gap = self.sched.next()
            due = t0 + gap
            while True:
                now = clock()
                while due <= now and due < drain_end:
                    self.submit(nxt, due)
                    nxt, gap = self.sched.next()
                    due += gap
                self._trace_edges(now, close)
                if now >= close and (window_done() or now >= drain_end):
                    break
                if self.inflight:
                    self.tick()
                else:
                    time.sleep(max(0.0, min(due - now, 0.01)))
        elif tr["loop"] == "closed":
            for _ in range(tr["clients"]):
                self.submit(self.sched.next()[0], t0)
            while True:
                now = clock()
                self._trace_edges(now, close)
                if now >= close and (window_done() or now >= drain_end):
                    break
                for _ in self.tick():
                    if clock() < close:
                        self.submit(self.sched.next()[0], clock())
        else:
            raise ValueError(f"unknown loop {tr['loop']!r}")
        for uid in list(self.inflight):  # later arrivals still in flight: the engine ends idle
            self.e.abort(uid)
        return Record(reqs=list(self.reqs.values()), ticks=self.ticks, open=open_, close=close)
