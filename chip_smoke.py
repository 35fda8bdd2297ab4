#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. card name and power limit; build every CUDA kernel from csrc/ (nvcc,
     one process per source, in parallel) and print the build time, and each
     source's registers per instantiation and spills; count the warpgroup-MMA
     instructions in the SASS of the redesigned kernels (cuobjdump -sass:
     HGMMA in K7, in K2/K3 with their K8 forms and in K9b, IGMMA in K4/K8 and
     K5) and fail if any is 0; K4's and K5's registers per thread at launch
     and K2/K3's and K9b's dynamic shared memory per block (read from the
     kernels' own layouts, <= 227 KB);
  2. K1: all 256 bytes x {exact, zramp, ramp, lut(NF4)} through the CUDA test
     kernel vs the plain version, bit-exact; timed on a gate|up-sized matrix;
  3. K2/K3/K4 vs their plain versions at the Mistral-7B fused shapes
     (qkv 4096->6144, o 4096->4096, gate_up 4096->28672, down 14336->4096)
     and every kernel instance phases 5 and 6 run: M in {1, 4, 8} (decode at
     batch 1, 4 and 8) and {32, 64, 128} (prefill buckets and final chunks)
     for K2, 160 and 224 for K3, 256 (every prefill chunk), 320, 704 and 6016
     (a whole 6000-token prompt) for K4; and at the seven unfused shapes phase
     7 serves, K2 at M in {4, 64, 128}, K3 at 160 and K4 at 256; kernel time,
     bound, plain time and a dense bf16 torch.matmul of the same shape as the
     yardstick, each line with its grid (column tiles x K splits (x M tiles))
     and launches per call;
  3b. K7 (flash attention) vs its plain version with the kernel's blocks and
     key split (ops/attention.py::kernel_split), |do| <= 2^-7 * max|o| of
     each (query, head) row, in five cases: (a) a 256-query Mistral chunk over
     a 4352-row ring of 6000 positions (split), (b) a causal 6016-token
     Mistral prompt (not split), (c) Gemma-2 (D 256, softcap, scale 1/16),
     (d) TinyLlama at batch 2 with mixed valid lengths, (e) blocks whose rows
     see no key (zeros); kernel time, bound, plain time, the port's dense
     path and one scaled_dot_product_attention call (the yardstick, timed by
     CUDA-graph replay as K7 is, its eager time beside it); then a
     dense-vs-K7 grid of Lq x Lk at the Mistral heads;
  4. a 2-layer model at full Mistral-7B width from seeded weights, on the
     card (kernels) and on the CPU (plain versions): 300- and 1024-token
     prompts (the 1024 one takes the flash route: K7 on the card, its plain
     version on the CPU) and 4 decode steps each, logits within the stated
     tolerance;
  5. the main path: the full 32-layer Mistral-7B geometry (synth_params,
     fused) served by the Engine (max_batch 8, max_len 1024, inner_steps 8)
     with 6 requests (prompts 20..700 tokens, 32 new tokens each) plus a
     batch-1 generate; every kernel's launch count must be > 0.  The
     engine's logits for the 20-token request are held against generate's at
     every step up to the first token where the two differ (if any), which
     must be a near-tie.  Then batch-1 decode tok/s of the FP4 model beside
     its dense bf16 twin;
  6. the long-prompt path: the 32-layer Mistral-7B geometry served by the
     Engine with chunked prefill (max_batch 4, max_len 8192, chunk 256) on
     4352-row sliding-window rings: prompts of 100, 300, 4500 and 6000
     tokens, 32 new tokens each; the short requests must gain tokens on the
     ticks that run a long prompt's chunk, and K7 and K4 must both launch.
     The 6000-token request is served again with full 8192-row caches and as
     one whole-prompt prefill (Lq = Lk = 6016: K7, and K4 at M = 6016); each
     run's logits are held against the ring run's as in phase 5.
  3c. K6 (pair-K dequantize) vs its plain version, bit-exact, on the four
     fused shapes at f32 and bf16 out and on the seven unfused shapes at f32
     out (the shadow build); K5 (the int8-shadow GEMM) vs its plain
     version, one bf16 ulp, on the fused shapes at M = 256 and 6016 and on the
     seven unfused shapes the CLI serves at M = 256; kernel time, bound, plain
     time, a dense bf16 torch.matmul and (K5) one torch._int_mm of the same
     int8 product as yardsticks; each line with its grid and launches per
     call;
  7. the served prefill-shadow path: the 32-layer Mistral-7B geometry
     (unfused) written as a packed checkpoint under build/, then served by
     ``python -m torch_bnb_fp4_tpu_torch.serve --ckpt DIR --prefill-shadow
     --prefill-chunk 256`` in a child process over HTTP: prompts of 100, 300
     (streaming) and 4500 tokens at once, /v1/stats and /health, a streaming
     4500-token request aborted on its first event, one short request after
     it, SIGINT and exit code 0.  The same requests are replayed in this
     process on load_checkpoint + attach_prefill_shadow: tokens equal the
     HTTP ones, K2, K3, K5, K6 and K7 launch and K4 does not (in both
     processes); the shadowed logits are held against the unshadowed engine's
     (which launches K4) as in phase 5.  Then one 256-row chunk
     alone, without and with shadows in turns, eager and as a CUDA graph.
  3d. K8, the expert forms of K2/K3/K4, on stacks of 8 experts at the
     Mixtral-8x7B shapes (gate|up fused 4096->28672 and unfused 4096->14336,
     down 14336->4096), the expert index in device memory, experts 0 and 7:
     bit-equal to the 2-D kernel on packed[e] and within K2/K3/K4's
     tolerances of the plain version; K2 form at M in {1, 8, 64, 128}, K3 at
     160, K4 at 256; kernel time, bound, plain time, dense bf16 yardstick;
  8. Mixtral-8x7B (sparse MoE) on one card: (c) a 2-layer cut at full width
     on the card and on the CPU, a 300-token prompt and 4 decode steps,
     logits within phase 4's tolerance, each layer's MoE on the CPU given the
     card's input equal to the card's output within 2^-7, and any routing
     difference a near-tie (2nd-3rd probability margin < 1e-2, at most 1% of
     the decisions); (a) the full 32-layer model
     (synth_params, fused) served by the Engine (max_batch 4, max_len 8192,
     chunk 256) with prompts of 100, 300 and 4500 tokens: every K8 form and
     K7 launch; (b) a batch-8 generate (all-experts decode, K2 form at M =
     8); (d) a batch-1 decode step under set_sync_debug_mode("error"),
     replayed as a CUDA graph with the eager logits, eager and card-alone
     ms against the byte bound, and the batch-8 step likewise; (e) a 4-layer
     full-width checkpoint served by the CLI with --prefill-shadow over
     HTTP, tokens equal to an in-process replay, K8 and K5 launching.
  3e. K9a/K9b, the split-K kernels, vs their plain versions at the Mistral
     split-K shapes (4096->4096, 4096->1024, 4096->14336, 14336->4096), FP4
     and NF4 tables: K9a bit-exact at f32 and bf16 out; K9b with bf16 x at M
     in {1, 4, 64, 128, 256} (|dy| <= 2^-7 max|y|), f32 x at M in {1, 64}
     (1e-5), f16 x bit-equal to the bf16 call with f16 out; a k_shards=4
     w_down through apply_linear (x read in place) against its k_shards=1
     packing; kernel time, bound, plain time and a dense bf16 torch.matmul
     yardstick, each bf16 line with its grid and launches per call;
  9. the split-K path on the Mistral-7B geometry: (a) synth_params(layout=
     "splitk", tp=4) at full width and depth (wo/w_down K-sharded, unfused)
     served by the Engine (max_batch 4, max_len 2048, chunk 256) with prompts
     of 100, 300 and 1000 tokens: K9b launches; (b) a batch-1 generate and
     one decode step under set_sync_debug_mode("error"), replayed as a CUDA
     graph with the eager logits, eager and card-alone ms against the byte
     bound; (c) a 2-layer cut on the card and on the CPU, logits within 2e-2
     of max and 3e-2 rel L2; (d) a 4-layer bnb-exact NF4 checkpoint built
     with from_bnb_state(layout="splitk") from seeded flat bytes, served by
     the CLI with --prefill-shadow over HTTP, tokens equal to an in-process
     replay, K9b launching and K5 not; K9a's dequantize_weight of one layer
     bit-exact with the numpy golden.
Prints the kernel table as one JSON line, then the final status line.
Kernel times are CUDA-graph replays timed with CUDA events (the card's own
time, without the Python wrappers' launch cost, which is printed beside them
as eager_us); serving times are host clocks around synchronized work.
"""

from __future__ import annotations

import dataclasses
import json
import math
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

SHAPES = (("qkv", 4096, 6144), ("o", 4096, 4096), ("gate_up", 4096, 28672), ("down", 14336, 4096))
L2_BYTES = 50 * 2**20
PROMPTS = (20, 100, 200, 300, 500, 700)
NEW_TOKENS = 32
LONG_PROMPTS = (100, 300, 4500, 6000)  # phase 6
SERVED_PROMPTS = (100, 300, 4500)  # phase 7, sent together; then an aborted 4500 and a short one
# phases 3 and 3c: the shapes the CLI's unfused checkpoint gives the kernels (name, K, N, linears per layer)
UNFUSED_SHAPES = (("wq|wo", 4096, 4096, 2), ("wk|wv", 4096, 1024, 2), ("w_gate|w_up", 4096, 14336, 2),
                  ("w_down", 14336, 4096, 1))
FUSED_SHAPES = tuple((nm, k, n, 1) for nm, k, n in SHAPES)
# phase 3: (kernel, M, the run whose launch count its kernels-JSON row reports):
# phase 5's engine and generate ("main": decode at batch 8 and 1, prefill
# buckets), phase 6's ring run ("ring": decode at batch 4, the 256-row chunks,
# the final 64- and 160-row chunks of the 300- and 4500-token prompts; 128 rows
# end the 100- and 6000-token ones), its whole-prompt run ("whole"), and phase
# 7's replays on the unfused checkpoint: the shadowed one ("served": decode at
# batch 4, the 128-row prompt of 100 tokens, the 64-row final chunks of the 300-
# and 50-token prompts, the 160-row final chunk of the 4500-token one; its
# 256-row chunks take K5) and the unshadowed one ("unshadowed": K4 at 256)
PK_INSTANCES = (("K2", 1, "main"), ("K2", 8, "main"), ("K2", 32, "main"), ("K2", 128, "main"), ("K3", 224, "main"),
                ("K4", 320, "main"), ("K4", 704, "main"), ("K2", 4, "ring"), ("K2", 64, "ring"), ("K3", 160, "ring"),
                ("K4", 256, "ring"), ("K4", 6016, "whole"), ("K2", 4, "served"), ("K2", 64, "served"),
                ("K2", 128, "served"), ("K3", 160, "served"), ("K4", 256, "unshadowed"))
UNFUSED_RUNS = ("served", "unshadowed")
# phase 3c: K5's (shapes, M): the fused shapes at a 256-row chunk and a whole 6000-token prompt (off the
# served path), the unfused shapes the CLI serves with shadows at 256
K5_INSTANCES = (("fused", 256), ("fused", 6016), ("unfused", 256))
# phases 3d and 8: Mixtral-8x7B's experts (name, K, N, matmuls per expert): gate|up fused as the engine
# serves synth_params(fuse=True), unfused as the CLI loads a checkpoint
MOE_EXPERTS = 8
MOE_FUSED_SHAPES = (("gate|up", 4096, 28672, 1), ("down", 14336, 4096, 1))
MOE_UNFUSED_SHAPES = (("gate|up", 4096, 14336, 2), ("down", 14336, 4096, 1))
# phase 3d: (K8 form, M, the run whose launch count its kernels-JSON row reports): phase 8a's engine
# ("moe": per-token decode at M = 1, the 128-row prompt of 100 tokens, the 64-row final chunk of the
# 300-token prompt, the 160-row final chunk and the 256-row chunks of the 4500-token one, every chunk
# all-experts), 8b's batch-8 generate ("moe_b8": all-experts decode at M = 8) and 8e's in-process replay
# of the served 4-layer checkpoint ("moe_served", unfused: the same M but 8 and 160)
EXPERT_INSTANCES = (("K2", 1, "moe"), ("K2", 64, "moe"), ("K2", 128, "moe"), ("K3", 160, "moe"), ("K4", 256, "moe"),
                    ("K2", 8, "moe_b8"), ("K2", 1, "moe_served"), ("K2", 64, "moe_served"),
                    ("K2", 128, "moe_served"), ("K4", 256, "moe_served"))
MOE_PROMPTS = (100, 300, 4500)  # phase 8a
MOE_SERVED_PROMPTS = (100, 300)  # phase 8e, sent together; then an aborted 300 and a short one
# phases 3e and 9: the split-K model is unfused (UNFUSED_SHAPES).  K9b's M and the phase-9 run whose
# launches its kernels-JSON row reports: 9b's batch-1 generate ("splitk_b1"), 9a's engine ("splitk":
# decode at batch 4, the 128-row prompt of 100 tokens, 256-row chunks, the 64-row final chunk of 300)
SPLITK_INSTANCES = ((1, "splitk_b1"), (4, "splitk"), (64, "splitk"), (128, "splitk"), (256, "splitk"))
SPLITK_PROMPTS = (100, 300, 1000)  # phase 9a
SPLITK_SERVED_PROMPTS = (100, 300)  # phase 9d, sent together; then an aborted 300 and a short one
# phase 3b: (case, what, B, Lq, Lk, Hq, Hk, D, lens, q_offset, window, softcap, scale)
FLASH_CASES = (
    ("a", "Mistral chunk: 256 queries, 4352-row ring of 6000 positions, window 4096",
     1, 256, 4352, 32, 8, 128, 6000, None, 4096, None, None),
    ("b", "Mistral whole prompt: causal 6016 x 6016, 6000 valid, window 4096",
     1, 6016, 6016, 32, 8, 128, 6000, 0, 4096, None, None),
    ("c", "Gemma-2: 512 x 2048, 16/8 heads, D 256, softcap 50, scale 1/16, window 4096",
     1, 512, 2048, 16, 8, 256, 2048, None, 4096, 50.0, 1.0 / 16),
    ("d", "TinyLlama: batch 2, 512 x 2048, 32/4 heads, D 64, valid 2048 and 1300",
     2, 512, 2048, 32, 4, 64, [2048, 1300], None, None, None, None),
    ("e", "masked rows: 512 x 2048 Mistral heads, the first 64 queries before every key",
     1, 512, 2048, 32, 8, 128, 2048, -64, None, None, None),
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def tensor_bytes(obj) -> int:
    """Bytes of every tensor held by ``obj`` (params, a layer, a linear)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(tensor_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 0


def attention_err(got, want):
    """(max|do|, worst |do| / max|o| of its (query, head) row): K7's error
    measured against each output row's own scale, so that rows which see
    thousands of keys (small |o|) are held as tightly as rows which see few;
    a row that sees no key must be exactly 0 on both sides."""
    d = (got.float() - want.float()).abs()
    row = want.float().abs().amax(-1, keepdim=True)
    return d.max().item(), (d / row.clamp_min(2.0**-126)).max().item()


def hold_runs(tag, names, ref_lg, ref_tokens, lg, tokens):
    """Hold run ``lg``'s logits (one (vocab,) row per emitted token) against
    ``ref_lg`` at every step up to the first token where the two runs differ
    (their contexts agree until then): max|d| <= 6e-2 * max|logit| and rel L2
    <= 3e-2.  The first differing token must be a near-tie: each run's
    winner leads the other's by at most 2^-7 * max|logit| (bf16 resolution)."""
    n = min(len(ref_tokens), len(tokens))
    j = next((t for t, (a, b) in enumerate(zip(ref_tokens[:n], tokens[:n])) if a != b), None)
    last = n - 1 if j is None else j
    worst_d = worst_rel = 0.0
    for t in range(last + 1):
        e, g = lg[t], ref_lg[t]
        d, rel = (e - g).abs().max().item(), ((e - g).norm() / g.norm()).item()
        check(d <= 6e-2 * g.abs().max().item() and rel <= 3e-2, f"{tag} logits at step {t}: max|d| {d}, rel L2 {rel}")
        worst_d, worst_rel = max(worst_d, d), max(worst_rel, rel)
    same = sum(a == b for a, b in zip(ref_tokens, tokens))
    print(f"{tag} {names[1]} vs {names[0]}: {same}/{n} tokens equal; logits over steps 0..{last}: "
          f"worst max|d| {worst_d:.4g}, worst rel L2 {worst_rel:.3g}")
    if j is not None:
        e, g, a, b = lg[j], ref_lg[j], ref_tokens[j], tokens[j]
        tie = 2.0**-7 * g.abs().max().item()
        m_ref, m_run = (g[a] - g[b]).item(), (e[b] - e[a]).item()
        print(f"{tag} first differing token at step {j}: {names[0]} {a} leads {names[1]}'s {b} by {m_ref:.4g} in "
              f"its logits, {names[1]}'s by {m_run:.4g} in its own; max|d| there {(e - g).abs().max().item():.4g}, "
              f"near-tie limit 2^-7*max|logit| = {tie:.4g}")
        check(m_ref <= tie and m_run <= tie, f"{tag} step {j}: not a near-tie ({m_ref}, {m_run} > {tie})")


class Recorder:
    """Wraps ``T.forward`` while ``eng`` serves: keeps, on the device, the
    last-position logits of every batch-1 call (prefill chunks or a whole
    prompt) with the uid of the chunked prefill in flight (None for a
    whole-prompt prefill) and CUDA events around the call, and the logits
    of request ``uid``'s row in every batched decode call."""

    def __init__(self, T, eng, uid):
        self.T, self.eng, self.uid, self.forward = T, eng, uid, T.forward
        self.prefill, self.decode = [], []  # (uid, rows, logits, start, end); logits

    def __enter__(self):
        self.T.forward = self._call
        return self

    def __exit__(self, *exc):
        self.T.forward = self.forward

    def _call(self, p, c, tokens, cache, **kw):
        import torch

        if tokens.shape[0] == 1:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            lg, cache = self.forward(p, c, tokens, cache, **kw)
            ev[1].record()
            uid = self.eng._pf["req"].uid if self.eng._pf is not None else None
            self.prefill.append((uid, tokens.shape[1], lg[0, -1].float().clone(), *ev))
            return lg, cache
        lg, cache = self.forward(p, c, tokens, cache, **kw)
        slot = next((i for i, r in enumerate(self.eng.slot_req) if r is not None and r.uid == self.uid), None)
        if slot is not None:
            self.decode.append(lg[slot, -1].float().clone())
        return lg, cache

    def logits(self, n):
        """Request ``uid``'s logits for its first ``n`` tokens, on the CPU: its
        last prefill chunk, or else the first whole-prompt prefill (requests
        are admitted in order, so the one held here is submitted first), then
        its decode rows."""
        chunks = [r[2] for r in self.prefill if r[0] == self.uid]
        first = chunks[-1] if chunks else next(r[2] for r in self.prefill if r[0] is None)
        return [first.cpu()] + [x.cpu() for x in self.decode[: n - 1]]


def engine_vs_generate(T, Engine, params, cfg, ecfg, reqs, eng_tokens, gen_tokens, dev):
    """Hold the engine's logits for request 0 (served in slot 0 beside the
    other requests) against batch-1 ``generate``'s with :func:`hold_runs`.
    The engine is rerun under a :class:`Recorder`; generate's steps are
    replayed fed its own tokens."""
    import torch

    eng = Engine(params, cfg, ecfg)
    with Recorder(T, eng, reqs[0].uid) as rec:
        rerun = eng.run(reqs)[reqs[0].uid].tokens
    eng_lg = rec.logits(NEW_TOKENS)
    check(rerun == eng_tokens, "engine rerun gave other tokens for the 20-token prompt")
    check([int(v.argmax()) for v in eng_lg] == eng_tokens, "recorded engine logits do not give its tokens")

    gen_lg, prompt = [], reqs[0].prompt
    cache = T.KVCache.zeros(cfg, 1, len(prompt) + NEW_TOKENS, device=dev)
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    with torch.no_grad():
        for t in gen_tokens:
            lg, cache = T.forward(params, cfg, toks, cache, last_only=True)
            gen_lg.append(lg[0, -1].float().cpu())
            toks = torch.tensor([[t]], dtype=torch.int32, device=dev)
    check([int(v.argmax()) for v in gen_lg] == gen_tokens, "replayed generate logits do not give its tokens")
    hold_runs("[5]", ("batch-1 generate", "engine (20-token prompt)"), gen_lg, gen_tokens, eng_lg, eng_tokens)


def http_post(url, body, path="/v1/completions"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def http_get(url, path):
    with urllib.request.urlopen(url + path, timeout=600) as r:
        return json.loads(r.read())


def http_stream(url, body, on_event=None):
    """The server-sent events of a streaming completion, in order."""
    req = urllib.request.Request(url + "/v1/completions", data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            line = line.strip()
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
                if on_event is not None:
                    on_event(events[-1])
    return events


def serve_over_http(root, ckpt, prompts, aborted_prompt, short_prompt, log_path):
    """Phase 7's HTTP half: start the CLI on the checkpoint in a child
    process, send ``prompts`` at once (the second one streaming), read
    /v1/stats and /health, abort a streaming ``aborted_prompt`` request on its
    first event, serve ``short_prompt``, then SIGINT.  Returns (tokens of each
    prompt, short tokens, the child's final /v1/stats, seconds to the serving
    line).  The child is killed in ``finally`` if it is still running."""
    cmd = [sys.executable, "-m", "torch_bnb_fp4_tpu_torch.serve", "--ckpt", str(ckpt), "--prefill-shadow",
           "--max-batch", "4", "--max-len", "8192", "--prefill-chunk", "256", "--port", "0"]
    with open(log_path, "w") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            lines = queue.Queue()
            threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
            line = lines.get(timeout=600)
            check(line.startswith("serving on http://"), f"the server printed {line!r}")
            url, startup_s = line.split()[-1], time.perf_counter() - t0
            out = {}

            def go(i):
                body = {"prompt": prompts[i], "max_tokens": NEW_TOKENS}
                out[i] = http_stream(url, body)[-1]["done"] if i == 1 else http_post(url, body)

            threads = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            check(sorted(out) == list(range(len(prompts))), "phase 7: a request over HTTP did not complete")
            for i, c in out.items():
                check(len(c["tokens"]) == NEW_TOKENS and c["finish_reason"] == "length", f"phase 7 request {i}: {c}")
            stats, health = http_get(url, "/v1/stats"), http_get(url, "/health")
            check(health == {"status": "ok"} and stats["completions"] == len(prompts), f"phase 7 stats {stats}")
            aborted = {}

            def on_event(e):
                if set(e) == {"uid"}:
                    aborted.update(http_post(url, {"uid": e["uid"]}, path="/v1/abort"))

            done = http_stream(url, {"prompt": aborted_prompt, "max_tokens": NEW_TOKENS}, on_event)[-1]["done"]
            check(aborted.get("aborted") is True and done["finish_reason"] == "abort" and done["tokens"] == [],
                  f"phase 7: the aborted request ended {done} (abort answer {aborted})")
            short = http_post(url, {"prompt": short_prompt, "max_tokens": NEW_TOKENS})
            check(len(short["tokens"]) == NEW_TOKENS, f"phase 7 short request after the abort: {short}")
            stats = http_get(url, "/v1/stats")
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
            check(rc == 0, f"the server exited with {rc} on SIGINT")
        except BaseException:
            err.flush()
            print("[7] server log (tail):\n" + Path(log_path).read_text()[-4000:], file=sys.stderr)
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [out[i]["tokens"] for i in range(len(prompts))], short["tokens"], stats, startup_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "torch_bnb_fp4_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: run from a checkout of the repository (torch_bnb_fp4_tpu_torch/ not found)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torch_bnb_fp4_tpu_torch.ops import _build
    from torch_bnb_fp4_tpu_torch.ops import format as fmt
    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.utils import profiling as P

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # -- phase 1: build --------------------------------------------------------
    t0 = time.perf_counter()
    for src in _build.SOURCES:
        _build.kernel(src)
    build_dir = _build.build_all()
    print(f"[1] built {len(_build.SOURCES)} CUDA sources in {time.perf_counter() - t0:.1f} s")
    for src, log in _build.build_log.items():
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines() if "Used " in ln]
        spills = sum("0 bytes spill" not in ln for ln in log.splitlines() if "spill stores" in ln)
        print(f"    {src}: registers per instantiation {sorted(set(regs))}, instantiations with spills {spills}")
    # the redesigned kernels must issue warpgroup MMAs: HGMMA (bf16) in K7, K2/K3 (with their K8 forms) and K9b,
    # IGMMA (int8) in K4/K8 and K5
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    gmma = {}
    for src, op in (("flash_attention.cu", "HGMMA"), ("matmul_pk_w4a8.cu", "IGMMA"), ("matmul_pk.cu", "HGMMA"),
                    ("matmul_pk_minner.cu", "HGMMA"), ("matmul_w8.cu", "IGMMA"), ("matmul_splitk.cu", "HGMMA")):
        sass = subprocess.run([cuobjdump, "-sass", str(build_dir / (Path(src).stem + ".so"))], capture_output=True,
                              text=True, check=True).stdout
        gmma[src] = (op, sum(op in ln for ln in sass.splitlines()))
    print("[1] warpgroup-MMA instructions in the SASS: " +
          ", ".join(f"{src} {op} {n}" for src, (op, n) in gmma.items()))
    for src, (op, n) in gmma.items():
        check(n > 0, f"{src}: no {op} instruction in its SASS")
    # the setmaxnreg split of K4's and K5's loop (consumers 176, producers 80) is met only at 128 registers per
    # thread
    k4_regs = {v: K.w4a8_kernel_regs(v) for v in fmt.PAIRK_VARIANTS} | {"w8": K.w8_kernel_regs()}
    print(f"[1] K4 (variants) and K5 (w8) registers per thread at launch: {k4_regs} (their setmaxnreg split needs "
          f"{K.K4_THREAD_REGS})")
    for v, r in k4_regs.items():
        check(r == K.K4_THREAD_REGS, f"K4/K5 {v}: launched at {r} registers per thread, not {K.K4_THREAD_REGS}")
    # K2/K3's and K9b's dynamic shared memory, as their kernels lay it out, within the 227 KB a block may take
    smem = ({f"K2 rows {r}": K.pk_tile_smem("K2", r) for r in K.K2_ROWS} | {"K3": K.pk_tile_smem("K3")}
            | {f"K9b rows {r} cols {c}": K.splitk_tile_smem(r, c) for r in K.K9B_ROWS for c in (128, 256)}
            | {"K9b rows 128": K.splitk_tile_smem(128)})
    print(f"[1] K2/K3/K9b dynamic shared memory per block (bytes): {smem}")
    for what, b in smem.items():
        check(0 < b <= 227 * 1024, f"{what}: {b} bytes of shared memory per block")

    kernels_json = []

    def timed(fn, *args, rep):  # eager, back to back: what a Python caller sees (ms)
        return P.time_fn(fn, *args, rep=rep, warmup=2) * 1e3

    def device_ms(fn, *args, rep):  # replayed from a CUDA graph: the kernel's own time (ms)
        return P.time_graph(fn, *args, rep=rep) * 1e3

    gen = torch.Generator(device=dev)

    def operands(m, k, n, seed, copies):
        gen.manual_seed(seed)
        packed = [torch.randint(0, 256, (k // 2, n), generator=gen, dtype=torch.uint8, device=dev)
                  for _ in range(copies)]
        scale = [(torch.rand((k // 64, n), generator=gen, device=dev) + 0.5) * (0.01 / 192.0)
                 for _ in range(copies)]
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        return x, packed, scale

    def cycler(fn):
        """Call ``fn(i)`` on copy i mod n: the weights of successive calls do
        not sit in L2, as in a decode step that reads every layer once."""
        state = {"i": 0}

        def run(n):
            state["i"] = (state["i"] + 1) % n
            return fn(state["i"])

        return run

    # -- phase 2: K1 -------------------------------------------------------------
    lut_nf4 = K.make_pairk_lut(fmt.NF4_CODE, dev)
    all_bytes = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(2, 128).to(dev)
    for variant in ("exact", "zramp", "ramp", "lut"):
        lut = lut_nf4 if variant == "lut" else None
        got = K.decode_pairs(all_bytes, variant, lut)
        want = K.decode_pairs_plain(all_bytes, variant, lut)
        check(torch.equal(got, want), f"K1 {variant} not bit-exact")
    n_copies = 3
    _, pk_list, _ = operands(1, 4096, 28672, 1, n_copies)
    k1_ms = device_ms(cycler(lambda i: K.decode_pairs(pk_list[i], "ramp")), n_copies, rep=20)
    k1_plain_ms = timed(lambda: K.decode_pairs_plain(pk_list[0], "ramp"), rep=3)
    k1_bytes = pk_list[0].numel() * 5  # u8 in, one 32-bit word (two bf16) out per byte
    k1_bound, k1_by = P.bound_s(k1_bytes, 6 * pk_list[0].numel(), P.H100_F32_FLOPS)
    print(f"[2] K1 bit-exact on all 256 bytes x 4 variants; ramp decode of 4096x28672: {k1_ms * 1e3:.1f} us "
          f"(bound {k1_bound * 1e6:.1f} us by {k1_by}), plain {k1_plain_ms * 1e3:.1f} us")
    del pk_list

    # -- phase 3: K2/K3/K4 at the Mistral fused shapes ------------------------------
    def kernel_calls(kname, x, packed, scale, k, experts=None):
        """(kernel on weight copy i, plain version on copy i (default 0),
        activation bytes).  With ``experts`` (K8), ``packed`` and ``scale``
        are one stack and "copy i" is its expert ``experts[i]``, an index in
        device memory."""
        if kname == "K4":
            bk = K.a8_block_k(k, torch.float32)
            x8, rs = K.quantize_activations(x, bk)
            fn, fn_plain, lead = K.matmul_pk_w4a8, K.matmul_pk_w4a8_plain, (x8, rs)
            kw, in_bytes = dict(out_dtype=torch.bfloat16, variant="ramp", a8_block_k=bk), x8.numel() + rs.numel() * 4
        else:
            fn, fn_plain = ((K.matmul_pk, K.matmul_pk_plain) if kname == "K2" else
                            (K.matmul_pk_minner, K.matmul_pk_minner_plain))
            lead, kw, in_bytes = (x,), dict(variant="ramp"), x.numel() * 2

        def on_copy(f):
            def call(i=0):
                if experts is None:
                    return f(*lead, packed[i], scale[i], **kw)
                return f(*lead, packed, scale, expert=experts[i], **kw)
            return call

        return on_copy(fn), on_copy(fn_plain), in_bytes

    def grid_text(kname, m, k, n):
        """The launch of a K2/K3/K4 instance: its grid and launches per call."""
        sms = K._sm_count(dev)
        if kname == "K4":
            split = K.w4a8_split(m, k, n, K.a8_block_k(k, torch.float32), sms)
            return f"grid {-(-m // K.K4_TILE)} x {n // K.K4_TILE} x {split}, {1 if split == 1 else 2} launch(es) per call"
        plan = (K.k2_plan if kname == "K2" else K.k3_plan)(m, k, n, sms)
        return (f"grid {plan.n_tiles} x {plan.ksplit}" + (f" x {plan.m_tiles}" if plan.m_tiles > 1 else "")
                + f" ({plan.rows} x {plan.cols} tiles, {k // 64 // plan.ksplit} quant blocks per split), 1 launch per call")

    print("[3] kernel  shape        M    us      GB/s    bound_us  by          eager_us   plain_us   bf16_matmul_us"
          "  max_abs_err   (us: CUDA-graph replay; eager_us: back-to-back Python calls)")
    rows = {}
    for kname, m, run in PK_INSTANCES:
        tot = dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0, bf16_ms=0.0, err=0.0)
        for sname, k, n, count in UNFUSED_SHAPES if run in UNFUSED_RUNS else FUSED_SHAPES:
            w_bytes = k * n // 2 + (k // 64) * n * 4
            copies = max(1, math.ceil(2.5 * L2_BYTES / w_bytes))
            x, packed, scale = operands(m, k, n, seed=k + n + m, copies=copies)
            call, plain, in_bytes = kernel_calls(kname, x, packed, scale, k)
            y = call(0)
            y_ref = plain()
            torch.cuda.synchronize()
            err = (y.float() - y_ref.float()).abs().max().item()
            ref_max = y_ref.float().abs().max().item()
            if kname == "K4":  # exact int dots on both sides: one bf16 ulp
                ulp = torch.exp2(torch.floor(torch.log2(y_ref.float().abs().clamp_min(1e-30))) - 7)
                check(bool(((y.float() - y_ref.float()).abs() <= ulp * 1.0001).all()),
                      f"K4 {sname} M={m} off by more than one bf16 ulp")
            else:  # bf16 output rounding + f32 summation order
                check(err <= 2.0**-7 * ref_max, f"{kname} {sname} M={m}: err {err} > 2^-7 * {ref_max}")
            check(bool(torch.isfinite(y).all()), f"{kname} {sname} non-finite output")
            rep = 100 if m < 64 else 30
            ms = device_ms(cycler(call), copies, rep=rep)
            eager_ms = timed(cycler(call), copies, rep=rep)
            plain_ms = timed(plain, rep=3)
            wd = [torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(max(1, math.ceil(2.5 * L2_BYTES / (2 * k * n))))]
            bf16_ms = device_ms(cycler(lambda i, x=x, wd=wd: torch.matmul(x, wd[i])), len(wd), rep=rep)
            del wd
            nbytes = w_bytes + in_bytes + m * n * 2
            ops = 2 * m * k * n
            bnd, by = P.pk_matmul_bound_s(m, k, n, x_bytes=in_bytes, out_bytes=2, a8=kname == "K4")
            print(f"    {kname:6} {sname:11} {m:4} {ms * 1e3:8.1f} {nbytes / (ms * 1e-3) / 1e9:7.0f} "
                  f"{bnd * 1e6:9.1f}  {by:10} {eager_ms * 1e3:8.1f} {plain_ms * 1e3:10.1f} {bf16_ms * 1e3:12.1f}"
                  f"   {err:.3g}" + (f"   (x{count} per layer)" if count > 1 else "") + "   " + grid_text(kname, m, k, n))
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes", nbytes), ("ops", ops),
                           ("bf16_ms", bf16_ms)):
                tot[key] += count * v
            tot["err"] = max(tot["err"], err)
            del x, packed, scale
        rows[(kname, m, run)] = tot
    # K4 at K-tiles that are not 1024 rows: with bf16 scales, the whole K of Gemma-2's / Qwen2's 3584-wide
    # layers and of Qwen2's w_down (18944)
    for k, n in ((3584, 3584), (18944, 3584)):
        x, packed, scale = operands(256, k, n, seed=k, copies=1)
        scale = scale[0].to(torch.bfloat16)
        bk = K.a8_block_k(k, torch.bfloat16)
        x8, rs = K.quantize_activations(x, bk)
        kw = dict(out_dtype=torch.bfloat16, variant="ramp", a8_block_k=bk)
        y = K.matmul_pk_w4a8(x8, rs, packed[0], scale, **kw).float()
        y_ref = K.matmul_pk_w4a8_plain(x8, rs, packed[0], scale, **kw).float()
        ulp = torch.exp2(torch.floor(torch.log2(y_ref.abs().clamp_min(1e-30))) - 7)
        check(bool(((y - y_ref).abs() <= ulp * 1.0001).all()), f"K4 K={k} a8_block_k={bk}: off by more than one ulp")
        print(f"[3] K4 at M=256, K={k}, N={n}, bf16 scales (a8_block_k {bk}): within one bf16 ulp of its plain version")
        del x, packed, scale, x8, rs, y, y_ref
    torch.cuda.empty_cache()

    # -- phase 3b: K7 flash attention ----------------------------------------------------
    import torch.nn.functional as F

    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.ops import attention as A
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_attention, synth_dense_linear, synth_params

    def sdpa(q, k, v, mask, scale):  # the yardstick: one PyTorch call, never used by the port
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                              attn_mask=mask[:, 0], scale=scale, enable_gqa=True)

    print("[3b] case  us        bound_us  by          plain_ms   dense_us   sdpa_us    sdpa_eager_us  max_abs_err  "
          "(of max|o|; worst |do| / max|o| of its row)  (us, sdpa_us: CUDA-graph replay)")
    flash_rows = {}
    for case, what, b, lq, lk, hq, hk, d, lens, q_off, window, cap, scale in FLASH_CASES:
        ops = synth_attention(b, lq, lk, hq, hk, d, lens=lens, q_offset=q_off, seed=lq + lk + d, device=dev)
        q, k, v, qpos, valid, kpos = ops
        got = A.flash_attention(*ops, window, scale, cap)
        split = A.kernel_split(b, lq, lk, hq, hk, K._sm_count(dev), d)
        plain = lambda: A.flash_attention_plain(*ops, window, scale, cap,  # noqa: E731
                                                block_q=A.kernel_blocks(hq, hk, d)[0], block_k=A.BLOCK_K,
                                                split=split)
        want = plain()
        torch.cuda.synchronize()
        (err, row_err), ref_max = attention_err(got, want), want.float().abs().max().item()
        check(bool(torch.isfinite(got).all()), f"K7 case {case}: non-finite output")
        check(row_err <= 2.0**-7, f"K7 case {case}: |do| / max|o| of its row reaches {row_err} > 2^-7")
        if case == "e":
            check(not got[:, :64].any() and got[:, 64:].abs().max().item() > 0,
                  "K7 case e: rows that see no key must be exactly 0, the others not")
        ms = device_ms(lambda: A.flash_attention(*ops, window, scale, cap), rep=10)
        plain_ms = timed(plain, rep=2)
        mask = T.attention_mask(qpos, kpos, valid, window)
        dense_ms = timed(lambda: T._attention_chunked(q, k, v, ~mask, scale, cap), rep=3)
        sdpa_ms = device_ms(lambda: sdpa(q, k, v, mask, scale), rep=10)  # replayed, as K7 is
        sdpa_eager_ms = timed(lambda: sdpa(q, k, v, mask, scale), rep=3)
        pairs = P.visible_pairs(qpos, valid, kpos, window)
        bnd, by = P.attention_bound_s(q, k, pairs)
        flash_rows[case] = dict(what=what, ms=ms, plain_ms=plain_ms, dense_ms=dense_ms, library_ms=sdpa_ms,
                                library_eager_ms=sdpa_eager_ms, bound_ms=bnd * 1e3, bound_by=by, max_abs_err=err,
                                row_err=row_err, pairs=pairs, split=split)
        print(f"     ({case})  {ms * 1e3:8.1f} {bnd * 1e6:9.1f}  {by:10} {plain_ms:9.1f} {dense_ms * 1e3:10.1f} "
              f"{sdpa_ms * 1e3:10.1f} {sdpa_eager_ms * 1e3:10.1f}   {err:.3g} ({ref_max:.3g}; {row_err:.3g})   "
              f"{what}; split {split}; {pairs} visible pairs, {4 * d * hq * pairs / (ms * 1e-3) / 1e12:.0f} TFLOP/s")
        del ops, q, k, v, got, want, mask
    torch.cuda.empty_cache()
    print("[3b] dense-vs-K7 grid at the Mistral heads (32/8, D 128, window 4096; us: dense / K7, dense/K7)")
    grid = {}
    for lq in (128, 256, 512):
        cells = []
        for lk in (1024, 2048, 4352, 8192):
            q, k, v, qpos, valid, kpos = synth_attention(1, lq, lk, 32, 8, 128, lens=lk, seed=lq + lk, device=dev)
            blocked = ~T.attention_mask(qpos, kpos, valid, 4096)
            k7 = device_ms(lambda: A.flash_attention(q, k, v, qpos, valid, kpos, 4096), rep=20)
            dn = timed(lambda: T._attention_chunked(q, k, v, blocked), rep=5)
            grid[(lq, lk)] = (dn, k7)
            cells.append(f"Lk {lk}: {dn * 1e3:7.1f} / {k7 * 1e3:7.1f} ({dn / k7:.2f}x)")
        print(f"     Lq {lq:4}  " + "   ".join(cells))
    del q, k, v, blocked
    torch.cuda.empty_cache()

    # -- phase 3c: K6 and K5, the int8 prefill shadow -----------------------------------------
    print("[3c] kernel  out   shape          M     us        bound_us  by          plain_ms   bf16_matmul_us  "
          "int_mm_us   max_abs_err   (us: CUDA-graph replay)")
    shadow_rows = {}
    # K6: f32 out builds the shadow (phase 7's attach runs it on the unfused shapes); bf16 is dequantize_weight's
    k6_instances = (("fused", torch.float32, FUSED_SHAPES), ("fused", torch.bfloat16, FUSED_SHAPES),
                    ("unfused", torch.float32, UNFUSED_SHAPES))
    for kind, out_dtype, shapes in k6_instances:
        oname = {torch.float32: "f32", torch.bfloat16: "bf16"}[out_dtype]
        tot = dict(ms=0.0, plain_ms=0.0, bound=0.0, by={}, err=0.0, bf16_ms=None, int_mm_ms=None)
        for sname, k, n, count in shapes:
            w_bytes = k * n // 2 + (k // 64) * n * 4
            copies = max(1, math.ceil(2.5 * L2_BYTES / w_bytes))
            _, packed, scale = operands(1, k, n, seed=k + n + 3, copies=copies)
            call = cycler(lambda i: K.dequantize_tpu_pk(packed[i], scale[i], out_dtype=out_dtype, variant="ramp"))
            got = K.dequantize_tpu_pk(packed[0], scale[0], out_dtype=out_dtype, variant="ramp")
            want = K.dequantize_pk_plain(packed[0], scale[0], out_dtype=out_dtype, variant="ramp")
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K6 {sname} out {out_dtype} not bit-exact")
            del got, want
            ms = device_ms(call, copies, rep=10)
            plain_ms = timed(lambda: K.dequantize_pk_plain(packed[0], scale[0], out_dtype=out_dtype, variant="ramp"),
                             rep=2)
            bnd, by = P.dequant_pk_bound_s(k, n, 4, torch.empty((), dtype=out_dtype).element_size())
            print(f"    K6     {oname:5} {sname:12} {'-':>6} {ms * 1e3:9.1f} {bnd * 1e6:9.1f}  {by:10} "
                  f"{plain_ms:9.2f}   {'-':>14} {'-':>10}   0 (bit-exact)" + (f"   (x{count} per layer)" if count > 1 else ""))
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound"] += count * bnd
            tot["by"][by] = tot["by"].get(by, 0.0) + count * bnd
            del packed, scale
            torch.cuda.empty_cache()
        shadow_rows[("K6", kind, oname)] = tot
    for kind, m in K5_INSTANCES:
        shapes = UNFUSED_SHAPES if kind == "unfused" else FUSED_SHAPES
        tot = dict(ms=0.0, plain_ms=0.0, bound=0.0, by={}, err=0.0, bf16_ms=0.0, int_mm_ms=0.0)
        for sname, k, n, count in shapes:
            bk = 1024
            w_bytes = k * n
            copies = max(1, math.ceil(2.5 * L2_BYTES / w_bytes))
            x, packed, scale = operands(m, k, n, seed=k + n + m, copies=copies)
            shadows = [K.make_int8_shadow(packed[i], scale[i], variant="ramp", block_k=bk) for i in range(copies)]
            del packed, scale
            x8, rs = K.quantize_activations(x, bk)
            call = lambda i, x8=x8, rs=rs, sh=shadows: K.matmul_w8_int8(  # noqa: E731
                x8, rs, sh[i][0], sh[i][1], out_dtype=torch.bfloat16, block_k=bk)
            plain = lambda x8=x8, rs=rs, sh=shadows: K.matmul_w8_plain(  # noqa: E731
                x8, rs, sh[0][0], sh[0][1], out_dtype=torch.bfloat16, block_k=bk)
            y, y_ref = call(0), plain()
            torch.cuda.synchronize()
            err = (y.float() - y_ref.float()).abs().max().item()
            ulp = torch.exp2(torch.floor(torch.log2(y_ref.float().abs().clamp_min(1e-30))) - 7)
            check(bool(((y.float() - y_ref.float()).abs() <= ulp * 1.0001).all()),
                  f"K5 {sname} M={m} off by more than one bf16 ulp")
            check(bool(torch.isfinite(y).all()), f"K5 {sname} M={m}: non-finite output")
            del y, y_ref
            rep = 30 if m <= 256 else 5
            ms = device_ms(cycler(call), copies, rep=rep)
            plain_ms = timed(plain, rep=2)
            int_mm_ms = device_ms(cycler(lambda i, x8=x8, sh=shadows: torch._int_mm(x8, sh[i][0])), copies, rep=rep)
            wd = [torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(max(1, math.ceil(2.5 * L2_BYTES / (2 * k * n))))]
            bf16_ms = device_ms(cycler(lambda i, x=x, wd=wd: torch.matmul(x, wd[i])), len(wd), rep=rep)
            bnd, by = P.matmul_w8_bound_s(m, k, n, bk, 2)
            split = K.w4a8_split(m, k, n, bk, K._sm_count(dev))
            print(f"    K5     bf16  {sname:12} {m:6} {ms * 1e3:9.1f} {bnd * 1e6:9.1f}  {by:10} {plain_ms:9.2f}   "
                  f"{bf16_ms * 1e3:14.1f} {int_mm_ms * 1e3:10.1f}   {err:.3g}" + (f"   (x{count} per layer)" if count > 1 else "")
                  + f"   grid {-(-m // K.K4_TILE)} x {n // K.K4_TILE} x {split}, {1 if split == 1 else 2} launch(es) per call")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound", bnd), ("bf16_ms", bf16_ms),
                           ("int_mm_ms", int_mm_ms)):
                tot[key] += count * v
            tot["by"][by] = tot["by"].get(by, 0.0) + count * bnd
            tot["err"] = max(tot["err"], err)
            del x, x8, rs, shadows, wd
            torch.cuda.empty_cache()
        shadow_rows[("K5", kind, m)] = tot

    # -- phase 3d: K8, the expert forms of K2/K3/K4 on stacked Mixtral experts ------------------
    print("[3d] kernel  shape          M     us        bound_us  by          eager_us   plain_us   bf16_matmul_us  "
          "max_abs_err   (per call, one expert of a stack of 8; us: CUDA-graph replay cycling the 8 experts)")
    expert_rows = {}
    e_idx = torch.arange(MOE_EXPERTS, dtype=torch.int32, device=dev)  # expert indices in device memory
    for kname, m, run in EXPERT_INSTANCES:
        tot = dict(ms=0.0, plain_ms=0.0, bound=0.0, by={}, bf16_ms=0.0, err=0.0)
        for sname, k, n, count in MOE_UNFUSED_SHAPES if run == "moe_served" else MOE_FUSED_SHAPES:
            gen.manual_seed(k + n + m)
            packed = torch.randint(0, 256, (MOE_EXPERTS, k // 2, n), generator=gen, dtype=torch.uint8, device=dev)
            scale = (torch.rand((MOE_EXPERTS, k // 64, n), generator=gen, device=dev) + 0.5) * (0.01 / 192.0)
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            flat, plain, in_bytes = kernel_calls(kname, x, [packed[e] for e in range(MOE_EXPERTS)],
                                                 [scale[e] for e in range(MOE_EXPERTS)], k)
            stacked, stacked_plain, _ = kernel_calls(kname, x, packed, scale, k, experts=e_idx)
            err = 0.0
            for e in (0, MOE_EXPERTS - 1):
                y, y_flat, y_ref = stacked(e), flat(e), stacked_plain(e)
                torch.cuda.synchronize()
                check(torch.equal(y, y_flat), f"K8 {kname} {sname} M={m} expert {e}: not bit-equal to the 2-D kernel")
                check(bool(torch.isfinite(y).all()), f"K8 {kname} {sname} M={m}: non-finite output")
                d = (y.float() - y_ref.float()).abs()
                if kname == "K4":
                    ulp = torch.exp2(torch.floor(torch.log2(y_ref.float().abs().clamp_min(1e-30))) - 7)
                    check(bool((d <= ulp * 1.0001).all()), f"K8 {kname} {sname} M={m}: off by more than one bf16 ulp")
                else:
                    check(d.max().item() <= 2.0**-7 * y_ref.float().abs().max().item(),
                          f"K8 {kname} {sname} M={m} expert {e}: err {d.max().item()}")
                err = max(err, d.max().item())
            rep = 100 if m < 64 else 30
            ms = device_ms(cycler(stacked), MOE_EXPERTS, rep=rep)
            eager_ms = timed(cycler(stacked), MOE_EXPERTS, rep=rep)
            plain_ms = timed(lambda: stacked_plain(0), rep=3)
            wd = [torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(max(1, math.ceil(2.5 * L2_BYTES / (2 * k * n))))]
            bf16_ms = device_ms(cycler(lambda i, x=x, wd=wd: torch.matmul(x, wd[i])), len(wd), rep=rep)
            bnd, by = P.pk_matmul_bound_s(m, k, n, x_bytes=in_bytes, out_bytes=2, a8=kname == "K4")
            print(f"    K8/{kname} {sname:12} {m:6} {ms * 1e3:9.1f} {bnd * 1e6:9.1f}  {by:10} {eager_ms * 1e3:8.1f} "
                  f"{plain_ms * 1e3:10.1f} {bf16_ms * 1e3:14.1f}   {err:.3g}"
                  + (f"   (x{count} per expert)" if count > 1 else "") + "   " + grid_text(kname, m, k, n))
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound", bnd), ("bf16_ms", bf16_ms)):
                tot[key] += count * v
            tot["by"][by] = tot["by"].get(by, 0.0) + count * bnd
            tot["err"] = max(tot["err"], err)
            del x, packed, scale, wd
            torch.cuda.empty_cache()
        expert_rows[(kname, m, run)] = tot

    # -- phase 3e: K9a/K9b, the split-K kernels ------------------------------------------------
    from torch_bnb_fp4_tpu_torch.convert.quantize import repack_k_shards
    from torch_bnb_fp4_tpu_torch.models import linear as L

    print("[3e] kernel  x/out  shape          M     us        bound_us  by          plain_us   bf16_matmul_us  "
          "max_abs_err   (us: CUDA-graph replay cycling weight copies; checks on the FP4 and NF4 tables)")
    tables = {"fp4": (None, K.code_table(None, dev)), "nf4": (fmt.NF4_CODE, K.code_table(fmt.NF4_CODE, dev))}
    splitk_rows = {}

    def splitk_operands(k, n, seed, copies):
        """``copies`` random split-K packings (uniform bytes, absmax halves in [0.5, 1.5) * 0.01)."""
        gen.manual_seed(seed)
        packed = [torch.randint(0, 256, (k // 2, n), generator=gen, dtype=torch.uint8, device=dev)
                  for _ in range(copies)]
        halves = [tuple((torch.rand((k // 128, n), generator=gen, device=dev) + 0.5) * 0.01 for _ in range(2))
                  for _ in range(copies)]
        return packed, halves

    def add(key, count, **vals):
        tot = splitk_rows.setdefault(key, dict(ms=0.0, plain_ms=0.0, bound=0.0, by={}, bf16_ms=0.0, err=0.0))
        for name in ("ms", "plain_ms", "bound", "bf16_ms"):
            tot[name] += count * vals.get(name, 0.0)
        tot["by"][vals["by"]] = tot["by"].get(vals["by"], 0.0) + count * vals["bound"]
        tot["err"] = max(tot["err"], vals["err"])

    for sname, k, n, count in UNFUSED_SHAPES:
        w_bytes = k * n // 2 + (k // 64) * n * 4
        copies = max(1, math.ceil(2.5 * L2_BYTES / w_bytes))
        packed, halves = splitk_operands(k, n, k + n + 5, copies)
        sfx = f"   (x{count} per layer)" if count > 1 else ""
        for out_dtype, oname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for qt, (cb, tab) in tables.items():  # K9a: bit-exact
                got = K.dequantize_tpu(packed[0], halves[0], cb, out_dtype=out_dtype)
                want = K.dequantize_splitk_plain(packed[0], *halves[0], tab, out_dtype=out_dtype)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"K9a {sname} {qt} out {oname} not bit-exact")
                del got, want
            ms = device_ms(cycler(lambda i, o=out_dtype: K.dequantize_tpu(packed[i], halves[i], out_dtype=o)),
                           copies, rep=10)
            plain_ms = timed(lambda o=out_dtype: K.dequantize_splitk_plain(packed[0], *halves[0], tables["fp4"][1],
                                                                            out_dtype=o), rep=2)
            bnd, by = P.dequant_splitk_bound_s(k, n, 4 if out_dtype == torch.float32 else 2)
            print(f"    K9a    -/{oname:4} {sname:12} {'-':>6} {ms * 1e3:9.1f} {bnd * 1e6:9.1f}  {by:10} "
                  f"{plain_ms * 1e3:9.1f}   {'-':>14}   0 (bit-exact){sfx}")
            add(("K9a", oname), count, ms=ms, plain_ms=plain_ms, bound=bnd, by=by, err=0.0)
            torch.cuda.empty_cache()
        wd = [torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(max(1, math.ceil(2.5 * L2_BYTES / (2 * k * n))))]
        for m, x_dtype in [(m, torch.bfloat16) for m, _ in SPLITK_INSTANCES] + [(1, torch.float32), (64, torch.float32)]:
            gen.manual_seed(m + k + n)
            x = torch.randn((m, k), generator=gen, device=dev).to(x_dtype)
            tol = 1e-5 if x_dtype == torch.float32 else 2.0**-7
            err = 0.0
            for qt, (cb, tab) in tables.items():  # K9b vs plain on both tables
                y = K.matmul_fp4(x, packed[0], halves[0], None, cb)
                y_ref = K.matmul_splitk_plain(x, packed[0], *halves[0], None, tab, out_dtype=x_dtype)
                torch.cuda.synchronize()
                d, ref_max = (y.float() - y_ref.float()).abs().max().item(), y_ref.float().abs().max().item()
                check(bool(torch.isfinite(y).all()), f"K9b {sname} M={m} {qt}: non-finite output")
                check(d <= tol * ref_max, f"K9b {sname} M={m} {x_dtype} {qt}: err {d} > {tol} * {ref_max}")
                err = max(err, d)
            rep = 100 if m < 64 else 30
            ms = device_ms(cycler(lambda i, x=x: K.matmul_fp4(x, packed[i], halves[i])), copies, rep=rep)
            plain_ms = timed(lambda x=x: K.matmul_splitk_plain(x, packed[0], *halves[0], None, tables["fp4"][1],
                                                                out_dtype=x.dtype), rep=3)
            bf16_ms = device_ms(cycler(lambda i, x=x: torch.matmul(x.to(torch.bfloat16), wd[i])), len(wd), rep=rep)
            xb = x.element_size()
            bnd, by = P.splitk_matmul_bound_s(m, k, n, x_bytes=xb, out_bytes=xb)
            xname = "bf16" if x_dtype == torch.bfloat16 else "f32"
            if x_dtype == torch.bfloat16:
                plan = K.k9b_plan(m, k, n, K._sm_count(dev))
                grid = (f"   grid {plan.n_tiles} x {plan.ksplit}" + (f" x {plan.m_tiles}" if plan.m_tiles > 1 else "")
                        + f" ({'large' if plan.rows == 128 else 'small'} kernel, {plan.rows} x {plan.cols} tiles, "
                          f"{k // 128 // plan.ksplit} stages of 64 packed rows per split), 1 launch per call")
            else:
                grid = "   CUDA-core stream and its split reduction, 2 launches per call"
            print(f"    K9b    {xname:4}/{xname:4} {sname:9} {m:6} {ms * 1e3:9.1f} {bnd * 1e6:9.1f}  {by:10} "
                  f"{plain_ms * 1e3:9.1f}   {bf16_ms * 1e3:14.1f}   {err:.3g}{sfx}{grid}")
            add(("K9b", xname, m), count, ms=ms, plain_ms=plain_ms, bound=bnd, by=by, bf16_ms=bf16_ms, err=err)
            del x
        if sname == "wk|wv":  # f16 x computes in bf16 (the JAX contract): bit-equal to the bf16 call with f16 out
            x16 = torch.randn((4, k), generator=gen, device=dev).to(torch.float16)
            y16 = K.matmul_fp4(x16, packed[0], halves[0])
            check(y16.dtype == torch.float16 and torch.equal(y16, K.matmul_fp4(x16.to(torch.bfloat16), packed[0],
                                                                               halves[0], out_dtype=torch.float16)),
                  "K9b: f16 x is not the bf16 call with f16 out")
            print(f"    K9b    f16 x at {sname}, M=4: bit-equal to the bf16 call with out_dtype=float16")
        del packed, halves, wd
        torch.cuda.empty_cache()
    # w_down K-sharded into 4 (the row-parallel layout synth_params(tp=4) gives), through apply_linear
    (packed,), (halves,) = splitk_operands(14336, 4096, 77, 1)
    q1 = L.QuantLinear(packed=packed, scale=halves[0], scale_lo=halves[1], bias=None, n_out=4096, k_in=14336,
                       variant="exact", layout="splitk")
    p4, h4, l4 = repack_k_shards(packed, *halves, 64, 1, 4)
    q4 = dataclasses.replace(q1, packed=p4, scale=h4, scale_lo=l4, k_shards=4)
    check(torch.equal(L.dequantize_weight(q4, torch.float32), L.dequantize_weight(q1, torch.float32)),
          "K9a: the k_shards=4 w_down does not dequantize to its k_shards=1 packing")
    worst = 0.0
    for m in (1, 4, 64, 256):
        x = torch.randn((m, 14336), generator=gen, device=dev).to(torch.bfloat16)
        y4, y1 = L.apply_linear(q4, x), L.apply_linear(q1, x)
        torch.cuda.synchronize()
        d = (y4.float() - y1.float()).abs().max().item()
        check(d <= 2.0**-7 * y1.float().abs().max().item(), f"K9b k_shards=4 w_down at M={m}: err {d}")
        worst = max(worst, d / y1.float().abs().max().item())
    print(f"    K9b    w_down k_shards=4 through apply_linear (x read in place) = its k_shards=1 packing: dequantize "
          f"bit-equal, M 1/4/64/256 within {worst:.3g} of max|y| (bf16 output rounding and f32 order)")
    del packed, halves, q1, q4, p4, h4, l4
    torch.cuda.empty_cache()

    # -- phase 4: 2-layer full-width model, card vs CPU -------------------------------

    cfg2 = T.ModelConfig.mistral_7b()
    cfg2 = T.ModelConfig(**{**cfg2.__dict__, "n_layers": 2})
    p_gpu = synth_params(cfg2, seed=1, fuse=True, device=dev)
    p_cpu = T.params_to(p_gpu, "cpu")
    g_cpu = torch.Generator().manual_seed(2)
    for lp in (300, 1024):  # 1024^2 cells take the flash route: K7 on the card, its plain version on the CPU
        # the 1024-token prompt has its own generator: phase 5 draws the same prompts from g_cpu as before
        g = g_cpu if lp == 300 else torch.Generator().manual_seed(4)
        prompt = torch.randint(0, cfg2.vocab_size, (1, lp), generator=g, dtype=torch.int32)
        c_gpu = T.KVCache.zeros(cfg2, 1, lp + 4, device=dev)
        c_cpu = T.KVCache.zeros(cfg2, 1, lp + 4, device="cpu")
        toks = prompt
        t_cpu = 0.0
        for step in range(5):  # prefill, then 4 decode steps fed the CPU run's greedy token
            K.reset_launch_counts()
            with torch.no_grad():
                lg_gpu, c_gpu = T.forward(p_gpu, cfg2, toks.to(dev), c_gpu, last_only=True)
                t = time.perf_counter()
                lg_cpu, c_cpu = T.forward(p_cpu, cfg2, toks, c_cpu, last_only=True)
                t_cpu += time.perf_counter() - t
            lg_gpu = lg_gpu.cpu()
            flash = K.launch_counts()["flash_attention"]
            check(flash == (cfg2.n_layers if step == 0 and T._use_flash(lp, lp + 4) else 0),
                  f"2-layer model, {lp}-token prompt step {step}: {flash} K7 launches")
            d = (lg_gpu - lg_cpu).abs().max().item()
            rel = ((lg_gpu - lg_cpu).norm() / lg_cpu.norm()).item()
            # prefill takes the w4a8 path: a bf16 flip of one activation can move
            # its K-tile's int8 scale (one step ~ 1/127 of the tile)
            check(bool(torch.isfinite(lg_gpu).all()), "2-layer model: non-finite logits")
            check(d <= 6e-2 * lg_cpu.abs().max().item() and rel <= 3e-2,
                  f"2-layer model, {lp}-token prompt step {step}: max|d| {d}, rel L2 {rel}")
            print(f"[4] 2-layer full-width model, {lp}-token prompt, step {step}: max|dlogit| {d:.4g} of max "
                  f"{lg_cpu.abs().max().item():.4g}, rel L2 {rel:.3g}, argmax gpu {int(lg_gpu.argmax())} "
                  f"cpu {int(lg_cpu.argmax())}, K7 launches {flash}")
            toks = lg_cpu[:, -1].argmax(-1).to(torch.int32)[:, None]
        print(f"[4] {lp}-token prompt: CPU side {t_cpu:.1f} s")
    del p_gpu, p_cpu, c_gpu, c_cpu
    torch.cuda.empty_cache()

    # -- phase 5: the main path -------------------------------------------------------
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request

    cfg = T.ModelConfig.mistral_7b()
    t0 = time.perf_counter()
    params = synth_params(cfg, seed=3, fuse=True, device=dev)
    torch.cuda.synchronize()
    print(f"[5] Mistral-7B geometry FP4 params built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = [torch.randint(0, cfg.vocab_size, (lp,), generator=g_cpu).tolist() for lp in PROMPTS]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    ecfg = EngineConfig(max_batch=8, max_len=1024, inner_steps=8)
    eng = Engine(params, cfg, ecfg)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen_out = T.generate(params, cfg, torch.tensor([prompts[0]], dtype=torch.int32, device=dev), NEW_TOKENS)
    torch.cuda.synchronize()
    launches = K.launch_counts()

    st = eng.stats()
    check(set(res) == set(range(len(PROMPTS))), "engine did not complete every request")
    for r in reqs:
        c = res[r.uid]
        check(len(c.tokens) == NEW_TOKENS and c.finish_reason == "length", f"request {r.uid}: {c}")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens), f"request {r.uid}: token out of range")
    check(tuple(gen_out.shape) == (1, NEW_TOKENS), "generate shape")
    for name in ("matmul_pk", "matmul_pk_minner", "matmul_pk_w4a8"):
        check(launches[name] > 0, f"main path never launched {name}")
    print(f"[5] engine served {len(res)} requests (prompts {PROMPTS}, {NEW_TOKENS} new tokens each) in "
          f"{wall:.2f} s: {st['tok_per_s']:.1f} tok/s, mean TTFT {st['mean_ttft_s'] * 1e3:.1f} ms, "
          f"decode {st['step_p50_s'] * 1e3:.2f} ms/step p50 (batch {st['decode_batch']}), "
          f"{st['decode_steps']} decode steps")
    print(f"[5] launches on the main path: {json.dumps(launches)}")
    engine_vs_generate(T, Engine, params, cfg, ecfg, reqs, res[0].tokens, gen_out[0].tolist(), dev)

    def b1_decode(p, steps=64):
        """Batch-1 greedy decode after a 20-token prompt: (tok/s of the eager
        loop, device ms of one step replayed from a CUDA graph)."""
        cache = T.KVCache.zeros(cfg, 1, 32 + steps + 1, device=dev)
        with torch.no_grad():
            logits, cache = T.forward(p, cfg, torch.tensor([prompts[0][:20]], dtype=torch.int32, device=dev),
                                      cache, last_only=True)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            tok, cache = T.decode_step(p, cfg, tok, cache)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                tok, cache = T.decode_step(p, cfg, tok, cache)
            torch.cuda.synchronize()
            tps = steps / (time.perf_counter() - t)
            # each replay rewrites the same cache row: the step's device work only
            step_ms = P.time_graph(lambda: T.decode_step(p, cfg, tok, cache), rep=4) * 1e3
        return tps, step_ms

    with torch.no_grad():  # the engine's decode step shape: batch 8 over its 1024-row cache
        tok8 = torch.zeros(ecfg.max_batch, dtype=torch.int32, device=dev)
        eng_dev_ms = P.time_graph(lambda: T.decode_step(params, cfg, tok8, eng.cache), rep=4) * 1e3
    print(f"[5] engine decode step (batch {ecfg.max_batch}, {ecfg.max_len}-row cache) on the card alone "
          f"(CUDA graph): {eng_dev_ms:.3f} ms, vs {st['step_p50_s'] * 1e3:.2f} ms per step in the engine")
    fp4_tps, fp4_dev_ms = b1_decode(params)
    del eng, params
    torch.cuda.empty_cache()
    dense = synth_params(cfg, quantized=False, seed=3, device=dev)
    bf16_tps, bf16_dev_ms = b1_decode(dense)
    del dense
    print(f"[5] batch-1 decode: FP4 {fp4_tps:.1f} tok/s, dense bf16 twin {bf16_tps:.1f} tok/s, "
          f"ratio {fp4_tps / bf16_tps:.2f}")
    print(f"[5] batch-1 decode step on the card alone (CUDA graph): FP4 {fp4_dev_ms:.3f} ms, bf16 twin "
          f"{bf16_dev_ms:.3f} ms, ratio {bf16_dev_ms / fp4_dev_ms:.2f}; device busy "
          f"{fp4_dev_ms * fp4_tps / 10:.1f}% (FP4) and {bf16_dev_ms * bf16_tps / 10:.1f}% (bf16) of the eager step")

    # -- phase 6: long prompts: chunked prefill on sliding-window rings -----------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = synth_params(cfg, seed=3, fuse=True, device=dev)
    torch.cuda.synchronize()
    print(f"[6] Mistral-7B geometry FP4 params built in {time.perf_counter() - t0:.1f} s")
    long_prompts = [torch.randint(0, cfg.vocab_size, (lp,), generator=g_cpu).tolist() for lp in LONG_PROMPTS]
    long_reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(long_prompts)]
    short_uids = {r.uid for r in long_reqs if len(r.prompt) < 4096}
    big = len(long_reqs) - 1  # the 6000-token request
    ecfg6 = EngineConfig(max_batch=4, max_len=8192, inner_steps=8, prefill_chunk=256)
    eng = Engine(params, cfg, ecfg6)
    cache_rows = sorted({a.shape[1] for a in eng.cache.k + eng.cache.v})
    check(cache_rows == [4352], f"ring engine: cache rows {cache_rows}, want 4352 on every layer")
    for r in long_reqs:
        eng.submit(r)
    interleaved = 0
    K.reset_launch_counts()
    with Recorder(T, eng, big) as rec:
        t0 = time.perf_counter()
        while eng.pending or eng._pf is not None or any(r is not None for r in eng.slot_req):
            before = {r.uid: len(eng.slot_tokens[i]) for i, r in enumerate(eng.slot_req)
                      if r is not None and r.uid in short_uids and len(eng.slot_tokens[i]) < r.max_new_tokens}
            eng.step()
            if eng._pf is not None and eng._pf["req"].uid not in short_uids and before:
                # this tick ran a chunk of a long prompt: every short request still decoding grew
                after = {r.uid: len(eng.slot_tokens[i]) for i, r in enumerate(eng.slot_req) if r is not None}
                for uid, n in before.items():
                    check(after.get(uid, n) > n, f"request {uid} did not decode on a long-prefill tick")
                interleaved += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches6 = K.launch_counts()
    st6 = eng.stats()
    res6 = {c.uid: c for c in eng.completions}
    check(set(res6) == {r.uid for r in long_reqs}, "phase 6: the engine did not complete every request")
    for r in long_reqs:
        c = res6[r.uid]
        check(len(c.tokens) == NEW_TOKENS and c.finish_reason == "length", f"phase 6 request {r.uid}: {c}")
    check(interleaved > 0, "phase 6: no tick ran a long prompt's chunk while a short request decoded")
    for name in ("flash_attention", "matmul_pk", "matmul_pk_minner", "matmul_pk_w4a8"):
        check(launches6[name] > 0, f"phase 6 never launched {name}")
    big_chunks = [(n, e0.elapsed_time(e1)) for uid, n, _, e0, e1 in rec.prefill if uid == big]
    full_chunks = [ms for n, ms in big_chunks if n == ecfg6.prefill_chunk]
    ring_lg = rec.logits(NEW_TOKENS)
    ring_tokens = res6[big].tokens
    print(f"[6] ring engine served prompts {LONG_PROMPTS} ({NEW_TOKENS} new tokens each) in {wall:.2f} s: "
          f"{st6['tok_per_s']:.1f} tok/s, mean TTFT {st6['mean_ttft_s'] * 1e3:.1f} ms "
          f"(TTFT per request ms: {[round(res6[r.uid].ttft_s * 1e3, 1) for r in long_reqs]}), decode "
          f"{st6['step_p50_s'] * 1e3:.2f} ms/step p50, {st6['decode_steps']} decode steps; {interleaved} ticks ran "
          f"a long prompt's chunk while a short request decoded")
    print(f"[6] 6000-token prompt: {len(big_chunks)} chunks, 256-row chunk {sum(full_chunks) / len(full_chunks):.1f} ms "
          f"mean (min {min(full_chunks):.1f}, max {max(full_chunks):.1f}; CUDA events around each chunk forward), "
          f"final {big_chunks[-1][0]}-row chunk {big_chunks[-1][1]:.1f} ms")
    print(f"[6] launches on the long-prompt path: {json.dumps(launches6)}")
    del eng, rec
    torch.cuda.empty_cache()

    def serve_alone(ecfg_x, label):
        """Serve the 6000-token request alone; returns (tokens, logits, stats, launches)."""
        e = Engine(params, cfg, ecfg_x)
        K.reset_launch_counts()
        with Recorder(T, e, big) as r:
            t = time.perf_counter()
            out = e.run([Request(uid=big, prompt=long_prompts[big], max_new_tokens=NEW_TOKENS)])[big]
            torch.cuda.synchronize()
            t = time.perf_counter() - t
        stx, lx = e.stats(), K.launch_counts()
        check(len(out.tokens) == NEW_TOKENS, f"{label}: {out}")
        print(f"[6] {label}: cache rows {sorted({a.shape[1] for a in e.cache.k})}, kv_cache_bytes "
              f"{stx['kv_cache_bytes']}, served in {t:.2f} s, TTFT {out.ttft_s * 1e3:.1f} ms, K7 launches "
              f"{lx['flash_attention']}, K4 launches {lx['matmul_pk_w4a8']}")
        return out.tokens, r.logits(NEW_TOKENS), stx, lx

    full_tokens, full_lg, st_full, _ = serve_alone(
        EngineConfig(max_batch=4, max_len=8192, inner_steps=8, prefill_chunk=256, sliding_kv=False),
        "chunked, full 8192-row caches")
    torch.cuda.empty_cache()
    whole_tokens, whole_lg, _, l_whole = serve_alone(EngineConfig(max_batch=4, max_len=8192, inner_steps=8),
                                                     "whole-prompt prefill (Lq = Lk = 6016)")
    check(l_whole["flash_attention"] >= cfg.n_layers and l_whole["matmul_pk_w4a8"] > 0,
          "whole-prompt prefill did not run K7 and K4")
    print(f"[6] kv_cache_bytes: rings {st6['kv_cache_bytes']} vs full {st_full['kv_cache_bytes']} "
          f"({st6['kv_cache_bytes'] / st_full['kv_cache_bytes']:.3f})")
    hold_runs("[6]", ("ring run", "full-cache run"), ring_lg, ring_tokens, full_lg, full_tokens)
    hold_runs("[6]", ("ring run", "whole-prompt run"), ring_lg, ring_tokens, whole_lg, whole_tokens)
    del params
    torch.cuda.empty_cache()

    # -- phase 7: packed checkpoint -> HTTP server CLI with the prefill shadow -----------------
    from torch_bnb_fp4_tpu_torch.convert import load_checkpoint, save_checkpoint
    from torch_bnb_fp4_tpu_torch.models.linear import QuantLinear, attach_prefill_shadow

    ckpt = root / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    print(f"[7] disk free under {ckpt.parent}: {shutil.disk_usage(ckpt.parent).free / 2**30:.1f} GiB")
    g7 = torch.Generator().manual_seed(7)
    served = [torch.randint(0, cfg.vocab_size, (lp,), generator=g7).tolist() for lp in SERVED_PROMPTS]
    aborted_prompt = torch.randint(0, cfg.vocab_size, (4500,), generator=g7).tolist()
    short_prompt = torch.randint(0, cfg.vocab_size, (50,), generator=g7).tolist()
    try:
        params = synth_params(cfg, seed=5, device=dev)  # unfused, as the CLI loads a checkpoint
        t0 = time.perf_counter()
        save_checkpoint(str(ckpt), cfg, params)
        write_s = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.iterdir())
        print(f"[7] wrote the 32-layer Mistral-7B geometry as a packed checkpoint: {ckpt_bytes / 1e9:.2f} GB in "
              f"{write_s:.1f} s")
        http_tokens, http_short, child_stats, startup_s = serve_over_http(
            root, ckpt, served, aborted_prompt, short_prompt, root / "build" / "chip_smoke_server.log")
        child_launches = child_stats["launches"]
        served_kernels = ("matmul_w8", "dequant_pk", "matmul_pk", "matmul_pk_minner", "flash_attention")
        check(all(child_launches[nm] > 0 for nm in served_kernels) and child_launches["matmul_pk_w4a8"] == 0,
              f"phase 7 server launches {child_launches}")
        print(f"[7] CLI server: serving line after {startup_s:.1f} s (start, checkpoint load, shadow attach); "
              f"served prompts {SERVED_PROMPTS} at once ({NEW_TOKENS} new tokens each, the 300-token one streaming), "
              f"aborted a streaming 4500-token request on its first event, then a 50-token one; SIGINT -> rc 0; "
              f"server launches {json.dumps(child_launches)}")

        # the same requests in this process: load, attach, serve (the counted run of K5 and K6)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        cfg7, params7 = load_checkpoint(str(ckpt), device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        shadowed = attach_prefill_shadow(params7)
        torch.cuda.synchronize()
        attach_s = time.perf_counter() - t0
        lins = [getattr(lp, f) for lp in shadowed.layers for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
        check(all(isinstance(q, QuantLinear) and q.w8 is not None for q in lins), "a linear has no shadow")
        shadow_bytes = sum(q.w8.numel() + q.w8_scale.numel() * 4 for q in lins)
        packed_bytes = sum(q.packed.numel() + q.scale.numel() * q.scale.element_size() for q in lins)
        reqs7 = [Request(uid=i, prompt=pr, max_new_tokens=NEW_TOKENS) for i, pr in enumerate(served + [short_prompt])]
        big7 = SERVED_PROMPTS.index(4500)
        ecfg7 = EngineConfig(max_batch=4, max_len=8192, inner_steps=8, prefill_chunk=256)

        def replay(p, label):
            e = Engine(p, cfg7, ecfg7)
            with Recorder(T, e, big7) as r:
                t = time.perf_counter()
                out = e.run(reqs7)
                torch.cuda.synchronize()
                t = time.perf_counter() - t
            chunk_ms = [e0.elapsed_time(e1) for uid, n, _, e0, e1 in r.prefill if uid == big7 and n == 256]
            print(f"[7] {label}: served in {t:.2f} s, 4500-token prompt: {len(chunk_ms)} 256-row chunks, "
                  f"{sum(chunk_ms) / len(chunk_ms):.2f} ms mean (min {min(chunk_ms):.2f}, max {max(chunk_ms):.2f}; "
                  f"CUDA events around each chunk forward), TTFT {out[big7].ttft_s * 1e3:.1f} ms")
            return out, r.logits(NEW_TOKENS), sum(chunk_ms) / len(chunk_ms)

        res7, shadow_lg, shadow_chunk_ms = replay(shadowed, "in-process replay with shadows")
        launches7 = K.launch_counts()
        for i in range(len(served)):
            check(res7[i].tokens == http_tokens[i], f"phase 7: request {i} over HTTP differs from the replay")
        check(res7[len(served)].tokens == http_short, "phase 7: the short request over HTTP differs from the replay")
        check(all(launches7[nm] > 0 for nm in served_kernels) and launches7["matmul_pk_w4a8"] == 0,
              f"phase 7 replay launches {launches7}")
        print(f"[7] HTTP tokens equal the replay's for all {len(served) + 1} completed requests; checkpoint load "
              f"{load_s:.1f} s, shadow attach {attach_s:.2f} s ({launches7['dequant_pk']} K6 launches); shadow "
              f"{shadow_bytes / 1e9:.3f} GB vs packed {packed_bytes / 1e9:.3f} GB ({shadow_bytes / packed_bytes:.2f}x); "
              f"launches {json.dumps(launches7)}")
        K.reset_launch_counts()
        res0, plain_lg, plain_chunk_ms = replay(params7, "the same engine without shadows")
        launches7_plain = K.launch_counts()
        check(launches7_plain["matmul_pk_w4a8"] > 0 and launches7_plain["matmul_w8"] == 0,
              f"phase 7 unshadowed replay launches {launches7_plain}")
        hold_runs("[7]", ("unshadowed engine", "shadowed engine"), plain_lg, res0[big7].tokens, shadow_lg,
                  res7[big7].tokens)
        print(f"[7] 256-row chunk in the engine runs: {shadow_chunk_ms:.2f} ms with shadows (K5) vs "
              f"{plain_chunk_ms:.2f} ms without (K4)")
        # the same chunk alone, the two params in turns (K4 K5 K5 K4, three rounds): the host's share
        # drifts between calls, so one reading of each side does not compare them
        ring = T.KVCache.zeros(cfg7, 1, 8192, write_chunk=256, device=dev)
        ring.length.fill_(4096)
        chunk_tokens = torch.randint(0, cfg7.vocab_size, (1, 256), generator=g7, dtype=torch.int32).to(dev)
        sides = {"K4": params7, "K5": shadowed}
        eager = {"K4": [], "K5": []}
        with torch.no_grad():
            for side in ("K4", "K5", "K5", "K4") * 3:
                eager[side].append(timed(lambda p=sides[side]: T.forward(p, cfg7, chunk_tokens, ring, last_index=255),
                                         rep=5))
            alone = {side: device_ms(lambda p=p: T.forward(p, cfg7, chunk_tokens, ring, last_index=255), rep=3)
                     for side, p in sides.items()}
        med = {side: sorted(v)[len(v) // 2] for side, v in eager.items()}
        print(f"[7] one 256-row chunk at positions 4096-4351 (4352-row rings), eager ms per chunk, CUDA events "
              f"over 5 back-to-back chunks, in turns K4 K5 K5 K4 x3: K4 {[round(v, 2) for v in eager['K4']]} "
              f"(median {med['K4']:.2f}), K5 {[round(v, 2) for v in eager['K5']]} (median {med['K5']:.2f}); "
              f"on the card alone (CUDA graph): K4 {alone['K4']:.2f} ms, K5 {alone['K5']:.2f} ms")
        del params7, shadowed, res0, ring
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- phase 8: Mixtral-8x7B, the sparse-MoE path (K8) ------------------------------------------
    mcfg = T.ModelConfig.mixtral_8x7b()
    k_act = mcfg.experts_per_tok

    # (c) a 2-layer cut at full width, on the card and on the CPU; each side's routing is recorded.
    # synth_params' router (scale 1, as the JAX package's) spreads its logits ~64 apart, so the 0.5%
    # drift bf16 flips leave in a layer's input move the top-2 weights by tens of percent (measured on
    # an H100 at layer 1 of this cut: 0.04/0.96 on the card vs 0.28/0.72 on the CPU for one token; the
    # last position's logits then differ by 15% rel L2): this cut takes a router of random_weights'
    # scale 0.02 (logits ~1.3 apart).  Each layer's MoE is also run on the CPU on the
    # card's own input and must give the card's output: that holds the expert path itself at any router.
    mcfg2 = T.ModelConfig(**{**mcfg.__dict__, "n_layers": 2})
    p_gpu = synth_params(mcfg2, seed=11, fuse=True, device=dev)
    gen.manual_seed(12)
    for lp in p_gpu.layers:
        lp.moe.router = synth_dense_linear(gen, mcfg.n_experts, mcfg.dim, scale=0.02, device=dev)
    p_cpu = T.params_to(p_gpu, "cpu")
    moe_forward, routes, moe_io = T.moe_forward, [], []

    def recorded(moe, c, x, force_dense=None):
        routes.append(torch.softmax(moe.router(x.reshape(-1, x.shape[-1]), out_dtype=torch.float32), -1).cpu())
        y = moe_forward(moe, c, x, force_dense)
        if x.is_cuda:
            moe_io.append((x.cpu(), y.cpu()))
        return y

    toks = torch.randint(0, mcfg.vocab_size, (1, 300), generator=torch.Generator().manual_seed(8), dtype=torch.int32)
    c_gpu, c_cpu = T.KVCache.zeros(mcfg2, 1, 304, device=dev), T.KVCache.zeros(mcfg2, 1, 304, device="cpu")
    t_cpu, flips, decisions = 0.0, 0, 0
    T.moe_forward = recorded
    try:
        for step in range(5):  # prefill (all experts, K4 form), then 4 decode steps (per-token, K2 form)
            routes.clear()
            moe_io.clear()
            K.reset_launch_counts()
            with torch.no_grad():
                lg_gpu, c_gpu = T.forward(p_gpu, mcfg2, toks.to(dev), c_gpu, last_only=True)
                lc = K.launch_counts()
                t = time.perf_counter()
                lg_cpu, c_cpu = T.forward(p_cpu, mcfg2, toks, c_cpu, last_only=True)
                t_cpu += time.perf_counter() - t
            lg_gpu = lg_gpu.cpu()
            form = "matmul_pk_w4a8_expert" if step == 0 else "matmul_pk_expert"
            check(lc[form] == 2 * mcfg2.n_layers * (mcfg.n_experts if step == 0 else k_act),
                  f"[8c] step {step}: launches {lc}")
            # a routing flip must be a near-tie: the 2nd-3rd probability margin under 1e-2 on both sides.  The
            # ~0.5% drift P2 leaves in a layer's input at M >= 256 moves this router's logits (spread ~1.3) by up
            # to ~0.03, so a flipped pair's margin reaches p * 0.03 ~ 1e-2 (measured on an H100: 2.7e-3); the
            # cross-check below holds the routing itself exactly, on identical inputs
            for layer, (a, b) in enumerate(zip(routes[: mcfg2.n_layers], routes[mcfg2.n_layers :])):
                decisions += a.shape[0]
                top_a, top_b = (r.topk(k_act, dim=-1).indices.sort(-1).values for r in (a, b))
                for ti in (top_a != top_b).any(-1).nonzero().flatten().tolist():
                    margins = [(v[k_act - 1] - v[k_act]).item() for v in (r[ti].topk(k_act + 1).values for r in (a, b))]
                    print(f"[8c] step {step} layer {layer} token {ti}: top-{k_act} experts card {top_a[ti].tolist()}, "
                          f"CPU {top_b[ti].tolist()}; margin of the {k_act}nd over the next probability: card "
                          f"{margins[0]:.3g}, CPU {margins[1]:.3g}; router drift max|dp| "
                          f"{(a[ti] - b[ti]).abs().max().item():.3g}")
                    check(max(margins) < 1e-2, f"[8c] routing differs without a near-tie (margins {margins})")
                    flips += 1
            worst_moe = 0.0
            with torch.no_grad():
                for lp, (x_card, y_card) in zip(p_cpu.layers, moe_io):
                    y_cpu = moe_forward(lp.moe, mcfg2, x_card)
                    e = (y_card - y_cpu).abs().max().item() / y_cpu.abs().max().item()
                    check(e <= 2.0**-7, f"[8c] step {step}: the MoE on the card's input differs by {e} of max|y|")
                    worst_moe = max(worst_moe, e)
            d = (lg_gpu - lg_cpu).abs().max().item()
            rel = ((lg_gpu - lg_cpu).norm() / lg_cpu.norm()).item()
            check(bool(torch.isfinite(lg_gpu).all()), "[8c] non-finite logits")
            check(d <= 6e-2 * lg_cpu.abs().max().item() and rel <= 3e-2, f"[8c] step {step}: max|d| {d}, rel L2 {rel}")
            print(f"[8c] 2-layer full-width Mixtral, 300-token prompt, step {step}: max|dlogit| {d:.4g} of max "
                  f"{lg_cpu.abs().max().item():.4g}, rel L2 {rel:.3g}, argmax gpu {int(lg_gpu.argmax())} cpu "
                  f"{int(lg_cpu.argmax())}; K8 launches {lc[form]} ({form}); the CPU's MoE on the card's inputs: "
                  f"worst max|d| {worst_moe:.3g} of max|y|")
            toks = lg_cpu[:, -1].argmax(-1).to(torch.int32)[:, None]
    finally:
        T.moe_forward = moe_forward
    check(flips <= 0.01 * decisions, f"[8c] {flips} of {decisions} routing decisions differ between card and CPU")
    print(f"[8c] routing: {flips} of {decisions} (token, layer) decisions differ between card and CPU, each a "
          f"near-tie; CPU side {t_cpu:.1f} s")
    del p_gpu, p_cpu, c_gpu, c_cpu
    torch.cuda.empty_cache()

    # (a) the full model served by the engine
    t0 = time.perf_counter()
    params = synth_params(mcfg, seed=13, fuse=True, device=dev)
    torch.cuda.synchronize()
    lay = params.layers
    expert_bytes = sum(tensor_bytes(lp.moe.gateup) + tensor_bytes(lp.moe.down) for lp in lay)
    attn_bytes = sum(tensor_bytes(lp.wqkv) + tensor_bytes(lp.wo) for lp in lay)
    other_bytes = tensor_bytes(params) - expert_bytes - attn_bytes
    print(f"[8a] Mixtral-8x7B FP4 params ({mcfg.n_layers} layers, {mcfg.n_experts} experts, gate|up fused) built in "
          f"{time.perf_counter() - t0:.1f} s: {tensor_bytes(params) / 1e9:.2f} GB (experts {expert_bytes / 1e9:.2f}, "
          f"attention {attn_bytes / 1e9:.3f}, embedding, router, norms and dense lm_head {other_bytes / 1e9:.3f}), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the card")
    g8 = torch.Generator().manual_seed(9)
    moe_prompts = [torch.randint(0, mcfg.vocab_size, (lp,), generator=g8).tolist() for lp in MOE_PROMPTS]
    reqs8 = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(moe_prompts)]
    big8 = MOE_PROMPTS.index(4500)
    eng = Engine(params, mcfg, EngineConfig(max_batch=4, max_len=8192, inner_steps=8, prefill_chunk=256))
    K.reset_launch_counts()
    with Recorder(T, eng, big8) as rec:
        t0 = time.perf_counter()
        res8 = eng.run(reqs8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches8 = K.launch_counts()
    st8 = eng.stats()
    for r in reqs8:
        c = res8[r.uid]
        check(len(c.tokens) == NEW_TOKENS and c.finish_reason == "length", f"[8a] request {r.uid}: {c}")
    for name in ("matmul_pk_expert", "matmul_pk_minner_expert", "matmul_pk_w4a8_expert", "flash_attention"):
        check(launches8[name] > 0, f"[8a] the Mixtral engine never launched {name}")
    chunks8 = [(n, e0.elapsed_time(e1)) for uid, n, _, e0, e1 in rec.prefill if uid == big8]
    full8 = [ms for n, ms in chunks8 if n == 256]
    print(f"[8a] engine served prompts {MOE_PROMPTS} ({NEW_TOKENS} new tokens each) in {wall:.2f} s: "
          f"{st8['tok_per_s']:.1f} tok/s, TTFT per request ms {[round(res8[r.uid].ttft_s * 1e3, 1) for r in reqs8]}, "
          f"decode {st8['step_p50_s'] * 1e3:.2f} ms/step p50 (batch 4, per-token dispatch); 4500-token prompt: "
          f"{len(chunks8)} chunks, 256-row chunk {sum(full8) / len(full8):.1f} ms mean (min {min(full8):.1f}, max "
          f"{max(full8):.1f}), final {chunks8[-1][0]}-row chunk {chunks8[-1][1]:.1f} ms")
    print(f"[8a] launches on the Mixtral path: {json.dumps(launches8)}")
    del eng, rec
    torch.cuda.empty_cache()

    # (b) a batch-8 generate: 8 * k > n_experts, so decode runs every expert at M = 8
    K.reset_launch_counts()
    short8 = torch.randint(0, mcfg.vocab_size, (8, 8), generator=g8, dtype=torch.int32).to(dev)
    out_b8 = T.generate(params, mcfg, short8, 8)
    torch.cuda.synchronize()
    launches_b8 = K.launch_counts()
    check(tuple(out_b8.shape) == (8, 8) and launches_b8["matmul_pk_expert"] > 0, f"[8b] {launches_b8}")
    print(f"[8b] batch-8 generate (8-token prompts, 8 new tokens): launches {json.dumps(launches_b8)}")

    # (d) decode steps: no host sync, CUDA-graph replay, times against the byte bound
    def graph_of(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        return graph, out

    def replay_ms(graph, rep=10):
        graph.replay()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(rep):
            graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / rep

    head_bytes = tensor_bytes(params.lm_head) + sum(tensor_bytes(lp.moe.router) for lp in lay)
    with torch.no_grad():
        cache1 = T.KVCache.zeros(mcfg, 1, 64, device=dev)
        lg, cache1 = T.forward(params, mcfg, torch.tensor([moe_prompts[0][:20]], dtype=torch.int32, device=dev),
                               cache1, last_only=True)
        tok1 = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager_lg, _ = T.forward(params, mcfg, tok1, cache1)  # raises on any device -> host sync
        finally:
            torch.cuda.set_sync_debug_mode("default")
        b1_eager = timed(lambda: T.forward(params, mcfg, tok1, cache1), rep=10)
        graph, graph_lg = graph_of(lambda: T.forward(params, mcfg, tok1, cache1)[0])
        b1_card = replay_ms(graph)
        check(torch.equal(graph_lg, eager_lg), "[8d] the graph's decode-step logits differ from the eager step's")
        del graph
        b1_bytes = attn_bytes + expert_bytes * k_act / mcfg.n_experts + head_bytes
        cache8 = T.KVCache.zeros(mcfg, 8, 64, device=dev)
        tok8 = out_b8[:, :1].contiguous()
        b8_eager = timed(lambda: T.forward(params, mcfg, tok8, cache8), rep=5)
        graph, _ = graph_of(lambda: T.forward(params, mcfg, tok8, cache8)[0])
        b8_card = replay_ms(graph)
        del graph
        b8_bytes = attn_bytes + expert_bytes + head_bytes
    b1_bound, b8_bound = b1_bytes / P.H100_HBM_BYTES_PER_S * 1e3, b8_bytes / P.H100_HBM_BYTES_PER_S * 1e3
    print(f"[8d] batch-1 decode step: no device->host sync (set_sync_debug_mode('error')); CUDA graph replay gives "
          f"the eager logits; {b1_eager:.2f} ms eager, {b1_card:.3f} ms on the card alone (CUDA graph) vs the byte "
          f"bound {b1_bound:.3f} ms ({b1_bytes / 1e9:.2f} GB: {k_act} of {mcfg.n_experts} experts per layer, "
          f"attention, router, lm_head; {b1_bound / b1_card:.1%} of it)")
    print(f"[8d] batch-8 decode step (all experts): {b8_eager:.2f} ms eager, {b8_card:.3f} ms on the card alone vs "
          f"the byte bound {b8_bound:.3f} ms ({b8_bytes / 1e9:.2f} GB; {b8_bound / b8_card:.1%} of it)")
    del params, cache1, cache8
    torch.cuda.empty_cache()

    # (e) a 4-layer Mixtral at full width as a packed checkpoint, served by the CLI with --prefill-shadow
    mcfg4 = T.ModelConfig(**{**mcfg.__dict__, "n_layers": 4})
    ckpt8 = root / "build" / "chip_smoke_moe_ckpt"
    shutil.rmtree(ckpt8, ignore_errors=True)
    g8e = torch.Generator().manual_seed(10)
    served8 = [torch.randint(0, mcfg.vocab_size, (lp,), generator=g8e).tolist() for lp in MOE_SERVED_PROMPTS]
    aborted8 = torch.randint(0, mcfg.vocab_size, (300,), generator=g8e).tolist()
    short8p = torch.randint(0, mcfg.vocab_size, (50,), generator=g8e).tolist()
    try:
        p4 = synth_params(mcfg4, seed=15, device=dev)  # unfused, as the CLI loads a checkpoint
        t0 = time.perf_counter()
        save_checkpoint(str(ckpt8), mcfg4, p4)
        write_s = time.perf_counter() - t0
        del p4
        torch.cuda.empty_cache()
        print(f"[8e] wrote a 4-layer full-width Mixtral-8x7B checkpoint: "
              f"{sum(f.stat().st_size for f in ckpt8.iterdir()) / 1e9:.2f} GB in {write_s:.1f} s")
        http8, http_short8, child8, startup8 = serve_over_http(root, ckpt8, served8, aborted8, short8p,
                                                               root / "build" / "chip_smoke_moe_server.log")
        moe_served = ("matmul_pk_expert", "matmul_pk_w4a8_expert", "matmul_w8", "dequant_pk")
        check(all(child8["launches"][nm] > 0 for nm in moe_served), f"[8e] server launches {child8['launches']}")
        K.reset_launch_counts()
        cfg8e, p8e = load_checkpoint(str(ckpt8), device=dev)
        check(p8e.layers[0].moe is not None and p8e.layers[0].moe.gate is not None, "[8e] the checkpoint lost its MoE")
        shadowed8 = attach_prefill_shadow(p8e)
        reqs8e = [Request(uid=i, prompt=pr, max_new_tokens=NEW_TOKENS) for i, pr in enumerate(served8 + [short8p])]
        res8e = Engine(shadowed8, cfg8e, EngineConfig(max_batch=4, max_len=8192, inner_steps=8,
                                                      prefill_chunk=256)).run(reqs8e)
        launches8e = K.launch_counts()
        for i, toks_http in enumerate(http8 + [http_short8]):
            check(res8e[i].tokens == toks_http, f"[8e] request {i} over HTTP differs from the in-process replay")
        check(all(launches8e[nm] > 0 for nm in moe_served), f"[8e] replay launches {launches8e}")
        print(f"[8e] CLI server (--prefill-shadow): serving line after {startup8:.1f} s; prompts {MOE_SERVED_PROMPTS} "
              f"at once, an aborted 300-token request and a 50-token one; HTTP tokens equal the in-process replay's "
              f"(load_checkpoint + attach_prefill_shadow) for all {len(reqs8e)}; server launches "
              f"{json.dumps(child8['launches'])}; replay launches {json.dumps(launches8e)}")
        del p8e, shadowed8
    finally:
        shutil.rmtree(ckpt8, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- phase 9: the split-K path at Mistral-7B width (K9a/K9b) --------------------------------
    import numpy as np

    from torch_bnb_fp4_tpu_torch.convert.bnb import from_bnb_state

    # (a) full width and depth, every linear split-K, wo/w_down K-sharded into 4, served by the engine
    t0 = time.perf_counter()
    params = synth_params(cfg, layout="splitk", tp=4, seed=21, device=dev)
    torch.cuda.synchronize()
    lay = params.layers
    check(all(lp.wqkv is None and lp.wo.k_shards == lp.w_down.k_shards == 4 and lp.wq.layout == "splitk"
              for lp in lay), "[9a] the split-K params are fused or not K-sharded")
    linear_bytes = sum(tensor_bytes(getattr(lp, f)) for lp in lay for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                                                             "w_down"))
    print(f"[9a] Mistral-7B split-K FP4 params ({cfg.n_layers} layers, unfused, wo/w_down k_shards=4) built in "
          f"{time.perf_counter() - t0:.1f} s: {tensor_bytes(params) / 1e9:.2f} GB (linears {linear_bytes / 1e9:.2f}, "
          f"embedding, norms and dense lm_head {(tensor_bytes(params) - linear_bytes) / 1e9:.3f})")
    g9 = torch.Generator().manual_seed(21)
    sk_prompts = [torch.randint(0, cfg.vocab_size, (lp,), generator=g9).tolist() for lp in SPLITK_PROMPTS]
    reqs9 = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(sk_prompts)]
    eng = Engine(params, cfg, EngineConfig(max_batch=4, max_len=2048, inner_steps=8, prefill_chunk=256))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res9 = eng.run(reqs9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches9 = K.launch_counts()
    st9 = eng.stats()
    for r in reqs9:
        c = res9[r.uid]
        check(len(c.tokens) == NEW_TOKENS and c.finish_reason == "length", f"[9a] request {r.uid}: {c}")
    check(launches9["matmul_splitk"] > 0 and all(launches9[nm] == 0 for nm in ("matmul_pk", "matmul_pk_minner",
                                                                              "matmul_pk_w4a8")),
          f"[9a] launches {launches9}")
    print(f"[9a] engine served prompts {SPLITK_PROMPTS} ({NEW_TOKENS} new tokens each) in {wall:.2f} s: "
          f"{st9['tok_per_s']:.1f} tok/s, TTFT per request ms {[round(res9[r.uid].ttft_s * 1e3, 1) for r in reqs9]}, "
          f"decode {st9['step_p50_s'] * 1e3:.2f} ms/step p50 (batch 4); launches {json.dumps(launches9)}")
    del eng

    # (b) batch-1: generate (K9b at M = 1), then one decode step: no host sync, CUDA-graph replay
    K.reset_launch_counts()
    out_b1 = T.generate(params, cfg, torch.tensor([sk_prompts[0][:20]], dtype=torch.int32, device=dev), 16)
    torch.cuda.synchronize()
    launches9_b1 = K.launch_counts()
    check(tuple(out_b1.shape) == (1, 16) and launches9_b1["matmul_splitk"] > 0, f"[9b] {launches9_b1}")
    with torch.no_grad():
        cache1 = T.KVCache.zeros(cfg, 1, 64, device=dev)
        lg, cache1 = T.forward(params, cfg, torch.tensor([sk_prompts[0][:20]], dtype=torch.int32, device=dev),
                               cache1, last_only=True)
        tok1 = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager_lg, _ = T.forward(params, cfg, tok1, cache1)  # raises on any device -> host sync
        finally:
            torch.cuda.set_sync_debug_mode("default")
        b1_eager = timed(lambda: T.forward(params, cfg, tok1, cache1), rep=10)
        graph, graph_lg = graph_of(lambda: T.forward(params, cfg, tok1, cache1)[0])
        b1_card = replay_ms(graph)
        check(torch.equal(graph_lg, eager_lg), "[9b] the graph's decode-step logits differ from the eager step's")
        del graph
    step_bytes = linear_bytes + tensor_bytes(params.lm_head)
    sk_bound = step_bytes / P.H100_HBM_BYTES_PER_S * 1e3
    print(f"[9b] batch-1 generate (20-token prompt, 16 new tokens): launches {json.dumps(launches9_b1)}; decode step: "
          f"no device->host sync (set_sync_debug_mode('error')); CUDA graph replay gives the eager logits; "
          f"{b1_eager:.2f} ms eager, {b1_card:.3f} ms on the card alone vs the byte bound {sk_bound:.3f} ms "
          f"({step_bytes / 1e9:.2f} GB: every linear's packed bytes and absmax, the lm_head; "
          f"{sk_bound / b1_card:.1%} of it)")
    del params, cache1
    torch.cuda.empty_cache()

    # (c) a 2-layer cut at full width on the card and on the CPU (plain versions); no int8 path
    cfg9 = T.ModelConfig(**{**cfg.__dict__, "n_layers": 2})
    p_gpu = synth_params(cfg9, layout="splitk", tp=4, seed=22, device=dev)
    p_cpu = T.params_to(p_gpu, "cpu")
    toks = torch.randint(0, cfg9.vocab_size, (1, 300), generator=torch.Generator().manual_seed(23), dtype=torch.int32)
    c_gpu, c_cpu = T.KVCache.zeros(cfg9, 1, 304, device=dev), T.KVCache.zeros(cfg9, 1, 304, device="cpu")
    t_cpu = 0.0
    for step in range(5):  # prefill, then 4 decode steps fed the CPU run's greedy token
        with torch.no_grad():
            lg_gpu, c_gpu = T.forward(p_gpu, cfg9, toks.to(dev), c_gpu, last_only=True)
            t = time.perf_counter()
            lg_cpu, c_cpu = T.forward(p_cpu, cfg9, toks, c_cpu, last_only=True)
            t_cpu += time.perf_counter() - t
        lg_gpu = lg_gpu.cpu()
        d = (lg_gpu - lg_cpu).abs().max().item()
        rel = ((lg_gpu - lg_cpu).norm() / lg_cpu.norm()).item()
        check(bool(torch.isfinite(lg_gpu).all()), "[9c] non-finite logits")
        check(d <= 2e-2 * lg_cpu.abs().max().item() and rel <= 3e-2, f"[9c] step {step}: max|d| {d}, rel L2 {rel}")
        print(f"[9c] 2-layer full-width split-K model, 300-token prompt, step {step}: max|dlogit| {d:.4g} of max "
              f"{lg_cpu.abs().max().item():.4g} (limit 2e-2 of it), rel L2 {rel:.3g} (limit 3e-2), argmax gpu "
              f"{int(lg_gpu.argmax())} cpu {int(lg_cpu.argmax())}")
        toks = lg_cpu[:, -1].argmax(-1).to(torch.int32)[:, None]
    print(f"[9c] CPU side {t_cpu:.1f} s")
    del p_gpu, p_cpu, c_gpu, c_cpu
    torch.cuda.empty_cache()

    # (d) a bnb-exact NF4 checkpoint (flat state -> from_bnb_state(layout="splitk")), served by the CLI
    cfg9d = T.ModelConfig(**{**cfg.__dict__, "n_layers": 4})
    ckpt9 = root / "build" / "chip_smoke_splitk_ckpt"
    shutil.rmtree(ckpt9, ignore_errors=True)
    rng9 = np.random.default_rng(24)
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    shapes9 = dict(wq=(cfg.q_dim, cfg.dim), wk=(kv_dim, cfg.dim), wv=(kv_dim, cfg.dim), wo=(cfg.dim, cfg.q_dim),
                   w_gate=(cfg.ffn_dim, cfg.dim), w_up=(cfg.ffn_dim, cfg.dim), w_down=(cfg.dim, cfg.ffn_dim))
    served9 = [torch.randint(0, cfg.vocab_size, (lp,), generator=g9).tolist() for lp in SPLITK_SERVED_PROMPTS]
    aborted9 = torch.randint(0, cfg.vocab_size, (300,), generator=g9).tolist()
    short9 = torch.randint(0, cfg.vocab_size, (50,), generator=g9).tolist()
    try:
        t0 = time.perf_counter()
        layers, flat0 = [], {}
        for i in range(cfg9d.n_layers):
            lins = {}
            for f, (n_out, k_in) in shapes9.items():  # what a bnb NF4 model holds: flat codes, one absmax per 64
                flat = rng9.integers(0, 256, n_out * k_in // 2, dtype=np.uint8)
                absmax = (rng9.random(n_out * k_in // 64, dtype=np.float32) + 0.5) * 0.01
                lins[f] = from_bnb_state(flat, absmax, (n_out, k_in), quant_type="nf4", layout="splitk", device=dev)
                if i == 0:
                    flat0[f] = lins[f]
            layers.append(T.LayerParams(attn_norm=torch.ones(cfg.dim, dtype=torch.bfloat16, device=dev),
                                        mlp_norm=torch.ones(cfg.dim, dtype=torch.bfloat16, device=dev), **lins))
        gen.manual_seed(25)
        p9 = T.ModelParams(embed=(torch.randn((cfg.vocab_size, cfg.dim), generator=gen, device=dev) * 0.01)
                           .to(torch.bfloat16), layers=layers, final_norm=torch.ones(cfg.dim, dtype=torch.bfloat16,
                                                                                     device=dev),
                           lm_head=synth_dense_linear(gen, cfg.vocab_size, cfg.dim, device=dev))
        conv_s = time.perf_counter() - t0
        # K9a on layer 0: dequantize_weight (f32 out) = the numpy golden of the same bytes
        K.reset_launch_counts()
        for f, q in flat0.items():
            want = fmt.unpack_tpu_sharded(q.packed.cpu().numpy(), q.scale.cpu().numpy(), q.scale_lo.cpu().numpy(),
                                          code=fmt.NF4_CODE)[: q.k_in, : q.n_out].T
            check(np.array_equal(L.dequantize_weight(q, torch.float32).cpu().numpy(), want),
                  f"[9d] K9a dequantize_weight of layer 0 {f} is not the golden")
        launches9_dq = K.launch_counts()
        check(launches9_dq["dequant_splitk"] == len(flat0), f"[9d] K9a launches {launches9_dq}")
        del flat0, want
        t0 = time.perf_counter()
        save_checkpoint(str(ckpt9), cfg9d, p9)
        write_s = time.perf_counter() - t0
        del p9, layers, lins, q
        torch.cuda.empty_cache()
        print(f"[9d] built a 4-layer full-width NF4 model from bnb flat state (from_bnb_state, layout='splitk') in "
              f"{conv_s:.1f} s and wrote it as a checkpoint: {sum(f.stat().st_size for f in ckpt9.iterdir()) / 1e9:.2f} "
              f"GB in {write_s:.1f} s; K9a dequantize_weight of layer 0's 7 linears bit-exact with the numpy golden")
        http9, http_short9, child9, startup9 = serve_over_http(root, ckpt9, served9, aborted9, short9,
                                                               root / "build" / "chip_smoke_splitk_server.log")
        cl = child9["launches"]
        check(cl["matmul_splitk"] > 0 and cl["matmul_w8"] == 0 and cl["dequant_pk"] == 0,
              f"[9d] server launches {cl}")
        K.reset_launch_counts()
        cfg9r, p9r = load_checkpoint(str(ckpt9), device=dev)
        check(p9r.layers[0].wq.layout == "splitk" and p9r.layers[0].wq.codebook is not None, "[9d] lost the layout")
        shadowed9 = attach_prefill_shadow(p9r)
        check(all(getattr(lp, f).w8 is None for lp in shadowed9.layers for f in shapes9), "[9d] a split-K shadow")
        reqs9d = [Request(uid=i, prompt=pr, max_new_tokens=NEW_TOKENS) for i, pr in enumerate(served9 + [short9])]
        res9d = Engine(shadowed9, cfg9r, EngineConfig(max_batch=4, max_len=8192, inner_steps=8,
                                                      prefill_chunk=256)).run(reqs9d)
        launches9d = K.launch_counts()
        for i, toks_http in enumerate(http9 + [http_short9]):
            check(res9d[i].tokens == toks_http, f"[9d] request {i} over HTTP differs from the in-process replay")
        check(launches9d["matmul_splitk"] > 0 and launches9d["matmul_w8"] == 0, f"[9d] replay launches {launches9d}")
        print(f"[9d] CLI server (--prefill-shadow, which skips every split-K linear): serving line after "
              f"{startup9:.1f} s; prompts {SPLITK_SERVED_PROMPTS} at once, an aborted 300-token request and a 50-token "
              f"one; HTTP tokens equal the in-process replay's for all {len(reqs9d)}; server launches "
              f"{json.dumps(cl)}; replay launches {json.dumps(launches9d)}")
        del p9r, shadowed9
    finally:
        shutil.rmtree(ckpt9, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- kernel table ------------------------------------------------------------------
    k_launch = launches["matmul_pk"] + launches["matmul_pk_minner"] + launches["matmul_pk_w4a8"]
    kernels_json.append(dict(
        name="K1 decode_pairs (ramp, 4096x28672 bytes; on the main path inlined in K2-K4)", route="cuda",
        source="torch_bnb_fp4_tpu_torch/csrc/pairk_decode.cuh",
        replaces="torch_bnb_fp4_tpu/ops/kernels.py:573", launches=k_launch, max_abs_err=0.0,
        ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound * 1e3, bound_by=k1_by, library_ms=None))
    meta = {"K2": ("matmul_pk", "matmul_pk.cu", 655), "K3": ("matmul_pk_minner", "matmul_pk_minner.cu", 702),
            "K4": ("matmul_pk_w4a8", "matmul_pk_w4a8.cu", 750)}
    run_launches = {"main": (launches, "phase 5"), "ring": (launches6, "phase 6 ring run"),
                    "whole": (l_whole, "phase 6 whole-prompt run"),
                    "served": (launches7, "phase 7's shadowed replay: load, attach, serve"),
                    "unshadowed": (launches7_plain, "phase 7's unshadowed replay")}
    def redesigned(kname):
        return " [redesigned for the warpgroup MMA]" if kname in ("K2", "K3", "K5", "K9b") else ""

    for (kname, m, run), tot in rows.items():
        wrapper, src, line = meta[kname]
        counts, run_name = run_launches[run]
        bnd, by = P.bound_s(tot["bytes"], tot["ops"], P.H100_INT8_OPS if kname == "K4" else P.H100_BF16_FLOPS)
        matmuls = "7 unfused" if run in UNFUSED_RUNS else "4 fused"
        kernels_json.append(dict(
            name=f"{kname} {wrapper} (M={m}, the {matmuls} matmuls of one Mistral-7B layer; launches of {run_name})"
                 + redesigned(kname),
            route="cuda", source=f"torch_bnb_fp4_tpu_torch/csrc/{src}",
            replaces=f"torch_bnb_fp4_tpu/ops/kernels.py:{line}", launches=counts[wrapper], max_abs_err=tot["err"],
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bnd * 1e3, bound_by=by, library_ms=None,
            bf16_matmul_ms=tot["bf16_ms"]))
    # the shapes the long-prompt path gives K7: ring chunks and a whole prompt
    for case, run in (("a", "ring"), ("b", "whole")):
        fr = flash_rows[case]
        counts, run_name = run_launches[run]
        kernels_json.append(dict(
            name=f"K7 flash_attention ({fr['what']}; launches of {run_name})", route="cuda",
            source="torch_bnb_fp4_tpu_torch/csrc/flash_attention.cu", replaces="torch_bnb_fp4_tpu/ops/attention.py:40",
            launches=counts["flash_attention"], max_abs_err=fr["max_abs_err"], row_err=fr["row_err"], ms=fr["ms"],
            plain_ms=fr["plain_ms"], bound_ms=fr["bound_ms"], bound_by=fr["bound_by"], library_ms=fr["library_ms"],
            library_eager_ms=fr["library_eager_ms"], dense_path_ms=fr["dense_ms"], split=fr["split"]))
    # only the instances phase 7 runs (unfused; K6 at f32 out); the fused K5/K6 instances of phase 3c are
    # yardsticks that no served run launches, printed above and left out of the table
    for key, tot in shadow_rows.items():
        if key[1] != "unfused":
            continue
        if key[0] == "K6":
            name = (f"K6 dequantize_tpu_pk ({key[2]} out, the 7 unfused shapes of one Mistral-7B layer; launches of "
                    f"phase 7's shadowed replay, whose attach_prefill_shadow runs it)")
            wrapper, src, line = "dequant_pk", "dequant_pk.cu", 1329
        else:
            name = (f"K5 matmul_w8 (M={key[2]}, the 7 unfused matmuls of one Mistral-7B layer; launches of "
                    f"phase 7's shadowed replay)" + redesigned("K5"))
            wrapper, src, line = "matmul_w8", "matmul_w8.cu", 813
        kernels_json.append(dict(
            name=name, route="cuda", source=f"torch_bnb_fp4_tpu_torch/csrc/{src}",
            replaces=f"torch_bnb_fp4_tpu/ops/kernels.py:{line}", launches=launches7[wrapper],
            max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound"] * 1e3,
            bound_by=max(tot["by"], key=tot["by"].get), library_ms=None, bf16_matmul_ms=tot["bf16_ms"],
            int_mm_ms=tot["int_mm_ms"]))
    # K8: the expert forms, per expert of one Mixtral-8x7B layer (times of phase 3d), launches of phase 8
    run_launches.update(moe=(launches8, "phase 8a's engine"), moe_b8=(launches_b8, "phase 8b's batch-8 generate"),
                        moe_served=(launches8e, "phase 8e's in-process replay of the served checkpoint"))
    k8_meta = {"K2": ("matmul_pk_expert", "matmul_pk.cu", 1295),
               "K3": ("matmul_pk_minner_expert", "matmul_pk_minner.cu", 1215),
               "K4": ("matmul_pk_w4a8_expert", "matmul_pk_w4a8.cu", 1215)}
    for (kname, m, run), tot in expert_rows.items():
        wrapper, src, line = k8_meta[kname]
        counts, run_name = run_launches[run]
        shapes = "unfused gate, up and down" if run == "moe_served" else "fused gate|up and down"
        kernels_json.append(dict(
            name=f"K8 {kname} form {wrapper} (M={m}, the {shapes} matmuls of one expert of a Mixtral-8x7B layer, "
                 f"the index in device memory; launches of {run_name})" + redesigned(kname),
            route="cuda", source=f"torch_bnb_fp4_tpu_torch/csrc/{src}",
            replaces=f"torch_bnb_fp4_tpu/ops/kernels.py:{line}", launches=counts[wrapper], max_abs_err=tot["err"],
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound"] * 1e3,
            bound_by=max(tot["by"], key=tot["by"].get), library_ms=None, bf16_matmul_ms=tot["bf16_ms"]))
    # K9a/K9b: per Mistral-7B layer of the split-K model (the 7 unfused shapes, times of phase 3e),
    # launches of the phase-9 run that makes each instance
    run_launches.update(splitk=(launches9, "phase 9a's engine"), splitk_b1=(launches9_b1, "phase 9b's batch-1 generate"))
    k9 = [("K9a", ("K9a", "f32"), "dequantize_tpu (f32 out, the 7 unfused shapes of one Mistral-7B layer; launches of "
                                  "phase 9d's dequantize_weight of the served checkpoint's layer 0)",
           launches9_dq["dequant_splitk"], "dequant_splitk.cu", 243)]
    for m, run in SPLITK_INSTANCES:
        counts, run_name = run_launches[run]
        k9.append(("K9b", ("K9b", "bf16", m), f"matmul_fp4 (bf16 x, M={m}, the 7 unfused matmuls of one split-K "
                                               f"Mistral-7B layer; launches of {run_name})" + redesigned("K9b"),
                   counts["matmul_splitk"], "matmul_splitk.cu", 322))
    for kname, key, what, n_launch, src, line in k9:
        tot = splitk_rows[key]
        kernels_json.append(dict(
            name=f"{kname} {what}", route="cuda", source=f"torch_bnb_fp4_tpu_torch/csrc/{src}",
            replaces=f"torch_bnb_fp4_tpu/ops/kernels.py:{line}", launches=n_launch, max_abs_err=tot["err"],
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound"] * 1e3,
            bound_by=max(tot["by"], key=tot["by"].get), library_ms=None,
            **({"bf16_matmul_ms": tot["bf16_ms"]} if kname == "K9b" else {})))
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
