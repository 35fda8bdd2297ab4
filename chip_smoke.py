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
     CUDA-graph replay as K7 is, its eager time beside it); (f) case (a)'s
     shape with e4m3 K/V (K7's fp8 form, bf16 q) against its plain version at
     the same per-row tolerance, timed beside case (a) in turns, with SDPA on
     K/V widened to bf16 as the yardstick (no library call takes e4m3 K/V
     beside a bf16 q); the fp8 KV write cast (kv_cast) of all 65536 bf16 bit
     patterns, the same bytes on the card as on the CPU; then a dense-vs-K7
     grid of Lq x Lk at the Mistral heads;
  3f. K10 (decode attention, one query row per slot) against its plain
     version with the kernel's key ranges, every slot within one bf16 ulp of
     its rows' largest |o|, at the chat cell's shape (32 slots x 3072 rows,
     Mistral heads, lengths drawn as chat prompts, and every slot full),
     longdoc's (4 slots on wrapped 4352-row rings, window 4096) and batch 1
     (an 8192-row cache); kernel time, bound (live K/V bytes plus q and out),
     plain time, the dense route and one scaled_dot_product_attention call
     (the yardstick, replayed), the range count; phase 5 then serves 3
     requests through a warmed-up engine, K10 launching 32 times per decode
     step;
  4. a 2-layer model at full Mistral-7B width from seeded weights, on the
     card (kernels) and on the CPU (plain versions): 300- and 1024-token
     prompts (the 1024 one takes the flash route: K7 on the card, its plain
     version on the CPU) and 4 decode steps each, logits within the stated
     tolerance;
  5. the main path: the full 32-layer Mistral-7B geometry (synth_params,
     fused) served by the Engine (max_batch 8, max_len 1024, inner_steps 8)
     with 6 requests (prompts 20..700 tokens, 32 new tokens each) plus a
     batch-1 generate; every kernel's launch count must be > 0.  The
     engine decodes by CUDA-graph replay (as in every later phase); its
     logits for the 20-token request are held against generate's at
     every step up to the first token where the two differ (if any), which
     must be a near-tie.  Then batch-1 decode tok/s of the FP4 model beside
     its dense bf16 twin;
  6. the long-prompt path: the 32-layer Mistral-7B geometry served by the
     Engine with chunked prefill (max_batch 4, max_len 8192, chunk 256) on
     4352-row sliding-window rings: warmup() given one prompt length must
     capture the chunk graph of every width 32-256; then prompts of 100, 300,
     4500 and 6000 tokens, 32 new tokens each, with no new program and every
     chunk a graph replay (``prefill_chunks_eager`` 0); the short requests
     must gain tokens on the ticks that run a long prompt's chunk, and K7 and
     K4 must both launch.  One 256-row chunk is then timed as its graph's
     replay against its eager run (host ms to issue it, wall and device ms,
     the device operations and launch calls of one run under torch.profiler,
     the port's kernel launches per replay).  The 6000-token request is served
     again with full 8192-row caches and as one whole-prompt prefill (Lq = Lk
     = 6016: K7, and K4 at M = 6016); each run's logits are held against the
     ring run's as in phase 5.
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
  10. the full serving engine on the 32-layer Mistral-7B geometry (phase 5's
     weights): (a) warmup() of an engine with batch buckets (max_batch 8,
     max_len 1024, inner_steps 8, logprobs) captures every decode graph,
     then serves phase 5's prompts with no new program (traces flat), each
     request held against eager batch-1 generate as phase 5 holds its
     engine, ms/step beside the card-alone steps of phase 5 at batch 8 and
     (one request alone, bucket 1) at batch 1, logprobs against log_softmax
     of the logits; (b) sampling (temperature 0.8, top_k 50, top_p 0.9, min_p
     0.05): two engines with seed 7 give the same tokens, seed 8 others, every
     logprob <= 0; (c) speculation (spec_tokens 4) on prompts that repeat a
     16-token period: tokens equal the plain engine's or differ at a near-tie
     of the eager logits, tokens per verify forward and ms per emitted token;
     (d) prefix cache and store (prefill_chunk 256): four requests sharing a
     1024-token prompt, two together, two after: 3 hits, tokens equal the
     engine without the cache (or a near-tie), TTFT with and without; (e) the
     fp8 KV cache: phase 6's ring engine with e4m3 rings (half the KV bytes),
     prompts of 100, 300 and 4500 tokens launching K7's fp8 form, and a
     2-layer cut with e4m3 caches on the card vs the CPU within phase 4's
     tolerance; (f) the CLI on a 4-layer checkpoint with --warmup-prompt-len
     --temperature --top-p --prefix-cache --prefix-store --kv-dtype
     float8_e4m3fn --logprobs: a sampled and a temperature-0 request over
     HTTP, the latter equal to the in-process greedy engine, SIGINT -> 0.
  11. HF checkpoints to served tokens (sources written under build/ with the
     port's own safetensors writer, from seeded weights with torch's own
     initialization of each module, and removed at the end): (a) a 32-layer
     Mistral-7B HF source (config.json and bf16 shards, 14.5 GB) converted by
     ``python -m torch_bnb_fp4_tpu_torch.convert --quantize-embed`` in a
     child process (seconds, GB/s of source, peak pending bytes, the packer,
     which must be the native C one), loaded with load_checkpoint(fuse=True):
     layers 0-1, the table, the final norm and the lm_head byte-equal to
     quantize_params on the same weights; the embedding table's bytes packed
     and in bf16; prompts of 100, 200 and 300 tokens through the graphed
     engine (K2, K3 and K4 must launch), its tokens against eager generate
     with phase 10a's near-tie rule; (b) the 2-layer cut of (a) on the card
     against the CPU's plain versions at phase 4's tolerances, and against
     reference_forward on the card, correlation > 0.98; (c) a 4-layer
     bitsandbytes-serialized NF4 source (nested absmax, quant_map, the JSON
     blob) converted twice, imported exactly (lut) and with --requantize
     (ramp), each served by the engine (tokens against eager generate) with
     the mean |dequant error| of layer 0's q_proj against the source
     weights; (d) compat at the Mistral-7B widths 4096->14336 and
     14336->4096: TorchFP4Linear.from_linear(nn.Linear) at M = 1, 64, 256
     (K2, K2, K4) against its plain version and the layer's own output (mean
     |y - exact| in the reference's band 0.045-0.065), QuantData from a
     double-quantized state at M = 1 (K2) with dequantize (K6) against
     dequantize_fp4_codebook_invoke, gemm_4bit_inference card against CPU,
     the module's forward against apply_linear and gemm_4bit_inference timed
     by graph replay; recursively_replace_with_fp4_linear on a 2-layer
     full-width stand-in built from nn.Linear: every linear's bytes and the
     greedy tokens equal those of the CLI-converted checkpoint of the same
     weights.
  12. LoRA adapters at Mistral-7B width (two seeded PEFT directories written
     under build/ with the port's safetensors writer and read back: a, r 16,
     alpha 32, on q/k/v/o/gate/up/down of all 32 layers; b, r 8, alpha 16,
     on q and v; phase 5's geometry unfused from seed 5): (a) an engine on
     attach_multi_lora's params (max_batch 8, max_len 1024, inner_steps 8,
     batch buckets) after warmup() serves 8 requests of 100-300 tokens mixed
     over a, b and no adapter in one batch with no new graph, K2, K3 and K4
     launching, each request's tokens against eager generate on its
     single-attach params (or the base) with phase 10a's near-tie rule; the
     batch-8 decode step with and without adapters, host p50 and the depth-8
     graph replayed on the card alone; (b) a 2-layer cut on the card against
     the CPU at phase 4's tolerances, attach_lora(a) and attach_multi_lora
     with rows a / none / b; (c) merge_lora(a) on the cut: the card's merged
     bytes (K6) equal to the CPU's, merged against attached logits; (e) R7: a
     512-token prompt under a and b together with the prefix cache on gives
     no hit and the tokens of an engine without the cache, a third request
     under a hits its own store entry; (d) a 4-layer checkpoint served by the
     CLI with --lora a=DIR --lora b=DIR --prefill-shadow --prefill-chunk 256
     --prefix-cache --warmup-prompt-len 512: requests under a, b and none
     over HTTP equal the in-process engine's tokens, K5 launches under the
     adapters' bases, an unknown adapter is a 400, SIGINT -> 0; then --lora
     DIR --lora-merge serves; (f) examples_torch/sanity_check.py in a child
     process on the card, inside the band.  Each sub-phase prints its
     seconds.
  13. tensor parallelism and multi-process serving on this one card: every
     rank is a process of its own on it (torch.multiprocessing spawn, the
     kernels built in phase 1, a TCP rendezvous on a free port, gloo groups:
     NCCL refuses two ranks on one card), so the phase shows correctness at
     full width, never a TP speed.  (a) Mistral-7B at full width and depth,
     tp = 2: each rank builds its shard of synth_params(fuse=True, tp=2)
     one layer at a time; a 300-token (K4) and a 160-token (K3) prefill and
     4 decode steps (K2, M = 1) fed the tp = 1 run's tokens, every call's
     logits within 6e-2 of max and 3e-2 rel L2 of the tp = 1 forward on the
     card; 2 x 32 all-reduces per decode step; an engine at tp = 2
     (max_batch 4, prompts of 20-300 tokens, 32 new tokens) whose tokens
     equal the tp = 1 engine's or first differ at a near-tie of both runs'
     logits; ms per decode step and its all-reduces alone.  (c) Mixtral at
     2 layers, tp = 2: logits as (a), routing as phase 8c.  (b) Llama-2-70B
     at full width, 4 layers, tp = 4 (4 ranks), pair-K fused and split-K (K9b
     reading the row-parallel shards in place), logits as (a).  (d) the CLI
     as two processes (--multihost --coordinator, RANK / WORLD_SIZE) on a
     4-layer checkpoint with --prefill-shadow: --tp 2, then --tp 1 (data 2);
     HTTP tokens against the in-process tp = 1 engine (equal or a near-tie),
     an abort, K5 launching on rank 0, SIGINT -> both ranks exit 0.  Then
     the local shapes of K2-K5, K8 and K9b against their plain versions,
     timed, as kernel-table rows with their launches per rank.
Every engine of phases 5-12 decodes by CUDA-graph replay; its launch counts
include the replays (phase 13's meshed engines decode eagerly).  Prints the kernel table as one JSON line, then the
final status line.
Kernel times are CUDA-graph replays timed with CUDA events (the card's own
time, without the Python wrappers' launch cost, which is printed beside them
as eager_us); serving times are host clocks around synchronized work.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pickle
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
HF_LAYERS = 32  # phase 11a: Mistral-7B's own depth (a 14.5 GB bf16 source)
HF_LAYERS_PER_SHARD = 8
HF_PROMPTS = (100, 200, 300)  # buckets 128, 224, 320: K2, K3 and K4 prefill, K2 decode
BNB_LAYERS = 4  # phase 11c
BNB_PROMPTS = (100, 300)
COMPAT_SHAPES = ((4096, 14336), (14336, 4096))  # (in, out) of Mistral-7B's gate/up and down
COMPAT_MS = (1, 64, 256)  # K2, K2, K4
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

# phase 3f: K10's shapes (case, what, B, rows, Hq, Hk, D, lens, window); lens None: drawn as the chat
# traffic's prompt lengths (lognormal, median 1020, sigma 0.5, clipped to 32-2560; the benchmark's chat cell)
DECODE_CASES = (
    ("chat", "chat: 32 slots x 3072 rows, lengths drawn as chat prompts, Mistral heads, window 4096",
     32, 3072, 32, 8, 128, None, 4096),
    ("chat_full", "chat: 32 slots x 3072 rows, every slot full", 32, 3072, 32, 8, 128, 3072, 4096),
    ("longdoc", "longdoc: 4 slots on 4352-row rings of 4608-6144 positions, window 4096",
     4, 4352, 32, 8, 128, [4608, 5120, 5632, 6144], 4096),
    ("batch1", "batch 1: one full 8192-row cache, window 4096", 1, 8192, 32, 8, 128, 8192, 4096),
)
CHAT_PROMPT = (1020, 0.5, 32, 2560)  # median, sigma, min, max


def decode_lens(b: int, seed: int) -> list:
    """``b`` slot lengths drawn as the chat traffic's prompts (CHAT_PROMPT)."""
    import numpy as np

    median, sigma, lo, hi = CHAT_PROMPT
    x = np.random.default_rng(seed).lognormal(np.log(median), sigma, b)
    return np.clip(np.round(x), lo, hi).astype(int).tolist()


def row_ulps(got, want):
    """Per slot, the worst |got - want| in bf16 ulps of the largest |want| of
    the element's (slot, head) row: (B,) floats."""
    import torch

    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().amax(-1, keepdim=True).clamp_min(2.0**-126))) - 7)
    return ((got.float() - w).abs() / ulp).flatten(1).amax(1)


def decode_operands(case, dev) -> tuple:
    """Operands of one DECODE_CASES entry, the same for phase 3f and
    ``benchmarks_torch/hopper_bench.py``: (q, k, v, keys, (q_positions,
    kv_valid, kv_positions), walked bytes, visible bytes).  K10 walks
    each slot's rows below min(len, rows); of those a query sees min(len,
    rows, window), whose K/V bytes are the bound's."""
    from torch_bnb_fp4_tpu_torch.ops import attention as A
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_attention

    _case, _what, b, rows, hq, hk, d, lens, window = case
    lens = decode_lens(b, seed=rows + b) if lens is None else [lens] * b if isinstance(lens, int) else lens
    q, k, v, qpos, valid, kpos = synth_attention(b, 1, rows, hq, hk, d, lens=lens, seed=rows + d, device=dev)
    keys = A.decode_keys(qpos, valid, kpos)
    row_bytes = hk * d * k.element_size() * 2  # K and V
    walked = sum(min(n, rows) for n in lens) * row_bytes
    visible = sum(min(n, rows, window or n) for n in lens) * row_bytes
    return q, k, v, keys, (qpos, valid, kpos), walked, visible


def phase3f(dev) -> dict:
    """K10 (decode attention) at DECODE_CASES against its plain version with
    the kernel's ranges, slot by slot within one bf16 ulp of each row's
    largest |o|; kernel time (CUDA-graph replay), its bound (the visible K/V
    bytes plus q and out at 3.35 TB/s), the plain version's time, the dense
    route's and one scaled_dot_product_attention call's (the yardstick,
    timed only, replayed).  Returns case -> row."""
    import torch
    import torch.nn.functional as F

    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.ops import attention as A
    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.utils import profiling as P

    print("[3f] case       us     bound_us  walked_GB  visible_GB  plain_ms  dense_us   sdpa_us  ranges  worst slot "
          "ulps  (us, sdpa_us: CUDA-graph replay; bound: visible rows)")
    out = {}
    for case in DECODE_CASES:
        name, what, b, rows, _hq, hk, _d, _lens, window = case
        q, k, v, keys, (qpos, valid, kpos), walked, visible = decode_operands(case, dev)
        before = K.launch_counts()["decode_attention"]
        got = A.decode_attention(q, k, v, keys, window)
        check(K.launch_counts()["decode_attention"] == before + 1, f"K10 {name}: the kernel did not launch")
        r = A.decode_range_rows(b, rows, hk, K._sm_count(dev))
        plain = lambda: A.decode_attention_plain(q, k, v, keys, window, range_rows=r)  # noqa: E731
        want = plain()
        torch.cuda.synchronize()
        ulps = row_ulps(got, want)
        check(bool(torch.isfinite(got).all()) and got.dtype == torch.bfloat16, f"K10 {name}: non-finite or not bf16")
        check(bool((ulps <= 1.0001).all()), f"K10 {name}: slots off by more than one bf16 ulp: {ulps.tolist()}")
        ms = P.time_graph(lambda: A.decode_attention(q, k, v, keys, window), rep=20) * 1e3
        plain_ms = P.time_fn(plain, rep=3, warmup=1) * 1e3
        mask = T.attention_mask(qpos, kpos, valid, window)
        dense_ms = P.time_fn(lambda: T._attention_chunked(q, k, v, ~mask), rep=3, warmup=1) * 1e3
        sdpa_ms = P.time_graph(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask[:, 0], enable_gqa=True),
            rep=20) * 1e3
        bound_ms = (visible + 2 * q.numel() * q.element_size()) / P.H100_HBM_BYTES_PER_S * 1e3
        out[name] = dict(what=what, ms=ms, bound_ms=bound_ms, walked_bytes=walked, visible_bytes=visible,
                         plain_ms=plain_ms, dense_ms=dense_ms, library_ms=sdpa_ms, range_rows=r,
                         ranges=-(-rows // r), worst_ulps=ulps.max().item(),
                         slot_ulps=[round(u, 3) for u in ulps.tolist()])
        print(f"     {name:9} {ms * 1e3:8.1f} {bound_ms * 1e3:9.1f} {walked / 1e9:10.3f} {visible / 1e9:11.3f} "
              f"{plain_ms:9.2f} {dense_ms * 1e3:9.1f} {sdpa_ms * 1e3:9.1f}  {-(-rows // r):2} x {r:4}  "
              f"{ulps.max().item():.3f}   {what}; {walked / (ms * 1e-3) / 1e12:.2f} TB/s of walked K/V")
        del q, k, v, got, want, mask, keys
        torch.cuda.empty_cache()
    return out


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
    """While ``eng`` serves, keeps on the device: the last-position logits of
    every prefill pass (a whole prompt, a prefix-suffix chunk, or a chunk of
    a chunked admission) with its request's uid and CUDA events around it;
    and every request's decode logits.  The engine decodes, and runs the
    chunks of a chunked admission, by CUDA-graph replay, where a wrapper
    around ``T.forward`` runs only at capture, so the decode rows come from
    the engine's ``step_logits`` buffer, read after each tick, and a chunk's
    from its ``_pf_logits`` buffer, read after each ``_prefill_chunk`` (both
    written while ``step_logits`` is set: enter before the engine's first
    tick, or before its warmup).  Warmup's chunks are not recorded."""

    def __init__(self, T, eng):
        self.T, self.eng, self.forward = T, eng, T.forward
        self.prefill = []  # (uid, rows, logits, start, end)
        self.decode = {}  # uid -> [logits of its decode steps]
        self._in_chunk = False

    def __enter__(self):
        import torch

        e = self.eng
        self.T.forward = self._call
        e.step_logits = torch.zeros((e.ecfg.inner_steps, e.ecfg.max_batch, e.cfg.vocab_size), dtype=torch.float32,
                                    device=e.device)
        step, bind = e.step, e._bind

        def recorded_bind(slot, req, *a):  # a whole-prompt prefill's calls belong to the request bound next
            self.prefill = [(req.uid if u is None else u, *rest) for u, *rest in self.prefill]
            return bind(slot, req, *a)

        def recorded_step():
            n = step()
            for i, r in enumerate(e.slot_req):
                if r is not None and e.last_decode_steps:
                    self.decode.setdefault(r.uid, []).extend(
                        e.step_logits[j, i].clone() for j in range(e.last_decode_steps))
            return n

        chunk = e._prefill_chunk

        def recorded_chunk(w, rows):  # one chunk of a chunked admission, a graph replay on the card
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            self._in_chunk = True
            try:
                chunk(w, rows)
            finally:
                self._in_chunk = False
            ev[1].record()
            if e._pf is not None:  # not warmup's
                self.prefill.append((e._pf["req"].uid, w, e._pf_logits[0].clone(), *ev))

        e.step, e._bind, e._prefill_chunk = recorded_step, recorded_bind, recorded_chunk
        return self

    def __exit__(self, *exc):
        self.T.forward = self.forward
        del self.eng.step, self.eng._bind, self.eng._prefill_chunk
        self.eng.step_logits = None

    def _call(self, p, c, tokens, cache, **kw):
        import torch

        if "last_index" not in kw or self._in_chunk:  # a decode step or a chunk program (recorded around it)
            return self.forward(p, c, tokens, cache, **kw)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        lg, cache = self.forward(p, c, tokens, cache, **kw)
        ev[1].record()
        uid = self.eng._pf["req"].uid if self.eng._pf is not None else None
        self.prefill.append((uid, tokens.shape[1], lg[0, -1].float().clone(), *ev))
        return lg, cache

    def logits(self, uid, n):
        """Request ``uid``'s logits for its first ``n`` tokens, on the CPU: its
        last prefill call, then its decode rows."""
        first = [r[2] for r in self.prefill if r[0] == uid][-1]
        return [first.cpu()] + [x.cpu() for x in self.decode.get(uid, [])[: n - 1]]


def chunk_replay_vs_eager(eng, at: int = 4096, rep: int = 8) -> dict:
    """One full-width chunk of the idle engine ``eng`` at position ``at`` of
    its static prefill cache (over the rows of a prompt of max_len tokens,
    ``Engine._chunk_rows``), ``rep`` times as a replay of its CUDA graph and
    ``rep`` times eagerly through ``Engine._chunk_fn``, in turns: medians of
    the host ms to issue it, the wall ms to its end and the device ms between
    CUDA events around it; then one of each under ``torch.profiler``: the
    device operations and the host's kernel or graph launch calls it made.
    ``graph_launches`` are the port's kernel launches one replay adds to
    ``ops.kernels``' counts."""
    import statistics

    import torch
    from torch.autograd import DeviceType

    w = eng.ecfg.prefill_chunk
    rows = eng._chunk_rows(w, at + w, eng.ecfg.max_len)
    key = ("chunk", w, rows, eng.step_logits is not None)
    if key not in eng._graphs:
        eng._prefill_chunk(w, rows)  # captures it
    graph, pc = eng._graphs[key], eng._pcache

    def go(kind):
        if kind == "graph":
            graph.graph.replay()
        else:
            eng._chunk_fn(w, rows)

    times = {"graph": [], "eager": []}
    for _ in range(rep):
        for kind in times:
            pc.length.fill_(at)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            go(kind)
            ev[1].record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times[kind].append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3, ev[0].elapsed_time(ev[1])))
    out = {"width": w, "at": at, "rows": sorted(set(rows)), "graph_launches": sum(graph.launches.values())}
    for kind, runs in times.items():
        out[kind] = {name: statistics.median(r[i] for r in runs) for i, name in enumerate(("issue_ms", "wall_ms",
                                                                                            "device_ms"))}
        pc.length.fill_(at)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            go(kind)
            torch.cuda.synchronize()
        evs = prof.events()
        out[kind]["device_ops"] = sum(1 for e in evs if e.device_type == DeviceType.CUDA)
        out[kind]["launch_calls"] = sum(1 for e in evs if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                                                     "cuLaunchKernel", "cudaGraphLaunch"))
    pc.length.zero_()
    return out


def engine_vs_generate(T, Engine, params, cfg, ecfg, reqs, eng_tokens, gen_tokens, dev):
    """Hold the engine's logits for request 0 (served in slot 0 beside the
    other requests) against batch-1 ``generate``'s with :func:`hold_runs`.
    The engine is rerun under a :class:`Recorder`; generate's steps are
    replayed fed its own tokens."""
    import torch

    eng = Engine(params, cfg, ecfg)
    with Recorder(T, eng) as rec:
        rerun = eng.run(reqs)[reqs[0].uid].tokens
    eng_lg = rec.logits(reqs[0].uid, NEW_TOKENS)
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


def hf_config(cfg, n_layers: int) -> dict:
    """The MistralConfig fields of ``cfg`` at ``n_layers``, as config.json holds them."""
    return {"architectures": ["MistralForCausalLM"], "model_type": "mistral", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.dim, "intermediate_size": cfg.ffn_dim, "num_hidden_layers": n_layers,
            "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "hidden_act": "silu", "max_position_embeddings": 32768, "rms_norm_eps": cfg.rms_eps,
            "rope_theta": cfg.rope_theta, "sliding_window": cfg.sliding_window, "tie_word_embeddings": False,
            "torch_dtype": "bfloat16", "bos_token_id": 1, "eos_token_id": 2}


def hf_layer_shapes(cfg, i: int) -> dict:
    """HF names and shapes of decoder layer ``i``."""
    p, kv = f"model.layers.{i}.", cfg.n_kv_heads * cfg.head_dim
    return {p + "input_layernorm.weight": (cfg.dim,), p + "post_attention_layernorm.weight": (cfg.dim,),
            p + "self_attn.q_proj.weight": (cfg.q_dim, cfg.dim), p + "self_attn.k_proj.weight": (kv, cfg.dim),
            p + "self_attn.v_proj.weight": (kv, cfg.dim), p + "self_attn.o_proj.weight": (cfg.dim, cfg.q_dim),
            p + "mlp.gate_proj.weight": (cfg.ffn_dim, cfg.dim), p + "mlp.up_proj.weight": (cfg.ffn_dim, cfg.dim),
            p + "mlp.down_proj.weight": (cfg.dim, cfg.ffn_dim)}


def hf_shards(cfg, n_layers: int) -> list:
    """[{name: shape}] of each source shard: up to HF_LAYERS_PER_SHARD layers
    each and at least two shards, the embedding and final norm in the first,
    the lm_head in the last."""
    per = min(HF_LAYERS_PER_SHARD, max(1, n_layers // 2))
    shards = [{} for _ in range(-(-n_layers // per))]
    shards[0].update({"model.embed_tokens.weight": (cfg.vocab_size, cfg.dim), "model.norm.weight": (cfg.dim,)})
    for i in range(n_layers):
        shards[i // per].update(hf_layer_shapes(cfg, i))
    shards[-1]["lm_head.weight"] = (cfg.vocab_size, cfg.dim)
    return shards


def source_tensor(name: str, shape, dev, seed: int = 11):
    """One source weight as a bf16 CPU tensor, made on the card from a
    generator seeded by its name (every source of phase 11 holds the same
    values under the same name), with torch's own initialization of the
    module that holds it: a norm ones, nn.Embedding N(0, 1), nn.Linear
    U(-1/sqrt(in), 1/sqrt(in))."""
    import zlib

    import torch

    if name.endswith("norm.weight"):
        return torch.ones(shape, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + zlib.crc32(name.encode()))
    if "embed_tokens" in name:
        t = torch.randn(shape, generator=g, device=dev)
    else:
        bound = 1.0 / math.sqrt(shape[1])
        t = torch.empty(shape, device=dev).uniform_(-bound, bound, generator=g)
    return t.to(torch.bfloat16).cpu()


def write_hf_source(path: Path, cfg, n_layers: int, dev, transform=None) -> int:
    """A seeded HF Mistral directory (config.json and bf16 safetensors shards,
    written with the port's own writer); ``transform(name, tensor, out)``
    may store a tensor in another form.  Returns the bytes written."""
    from torch_bnb_fp4_tpu_torch.convert import safetensors_io as st

    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(hf_config(cfg, n_layers)))
    shards, total = hf_shards(cfg, n_layers), 0
    for s, names in enumerate(shards):
        out = {}
        for name, shape in names.items():
            t = source_tensor(name, shape, dev)
            if transform is None:
                out[name] = t
            else:
                transform(name, t, out)
        f = path / f"model-{s + 1:05d}-of-{len(shards):05d}.safetensors"
        st.save_file(out, str(f))
        total += f.stat().st_size
    return total


def source_weights(cfg, n_layers: int, dev) -> dict:
    """The f32 numpy weights of a source's first ``n_layers`` layers (its bf16 values, exactly)."""
    names = {"model.embed_tokens.weight": (cfg.vocab_size, cfg.dim), "model.norm.weight": (cfg.dim,),
             "lm_head.weight": (cfg.vocab_size, cfg.dim)}
    for i in range(n_layers):
        names.update(hf_layer_shapes(cfg, i))
    return {n: source_tensor(n, s, dev).float().numpy() for n, s in names.items()}


def run_convert(root: Path, src: Path, out: Path, flags, log: Path):
    """The converter CLI as a child process: (seconds, peak pending MiB,
    total MiB, the packer it names)."""
    import re

    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch_bnb_fp4_tpu_torch.convert", str(src), str(out), *flags]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run(cmd, cwd=root, stdout=f, stderr=subprocess.STDOUT, timeout=900).returncode
    secs = time.perf_counter() - t0
    text = log.read_text()
    if rc != 0:
        print(f"[11] convert log (tail):\n{text[-4000:]}", file=sys.stderr)
    check(rc == 0, f"the converter CLI exited with {rc}")
    m = re.search(r"peak pending ([\d.]+) MiB of ([\d.]+) MiB total; packer ([^)]+)\)", text)
    check(m is not None, "the converter CLI printed no summary line")
    return secs, float(m.group(1)), float(m.group(2)), m.group(3)


def engine_tokens_vs_eager(T, params, cfg, prompt, tokens, dev, tag):
    """Engine tokens against eager greedy decoding (``generate``): equal, or
    at the first difference a near-tie of the eager logits fed the eager
    tokens (phase 10a's rule: the two winners within 2^-7 * max|logit|)."""
    import torch

    ref = T.generate(params, cfg, torch.tensor([prompt], dtype=torch.int32, device=dev), len(tokens))[0].tolist()
    j = next((t for t, (a, b) in enumerate(zip(ref, tokens)) if a != b), None)
    if j is None:
        check(len(ref) == len(tokens), f"{tag}: token counts differ")
        return f"{len(tokens)}/{len(tokens)} tokens equal to eager generate"
    cache = T.KVCache.zeros(cfg, 1, len(prompt) + j + 1, device=dev)
    toks = torch.tensor([prompt + ref[:j]], dtype=torch.int32, device=dev)
    with torch.no_grad():
        g = T.forward(params, cfg, toks, cache, last_only=True)[0][0, -1].float().cpu()
    tie = 2.0**-7 * g.abs().max().item()
    margin = (g[ref[j]] - g[tokens[j]]).item()
    check(abs(margin) <= tie, f"{tag}: engine differs from eager generate at token {j}, margin {margin} > {tie}")
    return f"first difference from eager generate at token {j}, a near-tie (margin {margin:.4g} <= {tie:.4g})"


def nested_absmax_state(absmax, nested_blocksize: int = 256):
    """bnb's double quantization of an f32 absmax: (uint8 indices into a
    256-entry uniform map around the mean, one nested scale (1.0) per
    ``nested_blocksize`` indices, the map, the offset)."""
    import numpy as np

    offset = float(absmax.mean())
    centered = absmax - np.float32(offset)
    lo, hi = float(centered.min()) - 1e-6, float(centered.max()) + 1e-6
    qmap = np.linspace(lo, hi, 256).astype(np.float32)
    u8 = np.clip(np.rint((centered - lo) / ((hi - lo) / 255)), 0, 255).astype(np.uint8)
    return u8, np.ones(-(-absmax.size // nested_blocksize), np.float32), qmap, offset


def bnb_serialize(name: str, w, quant_type: str, out: dict) -> None:
    """HF-serialized bitsandbytes state of one linear (what transformers
    writes for a load_in_4bit model), double-quantized as HF's default: the
    port's flat packing of the codes, the nested absmax, the quant_map and
    the JSON blob."""
    import numpy as np

    from torch_bnb_fp4_tpu_torch.ops import format as fmt

    code = fmt.NF4_CODE if quant_type == "nf4" else fmt.FP4_CODE
    packed, absmax = fmt.quantize_fp4(w, code=code)
    u8, absmax2, qmap, offset = nested_absmax_state(absmax)
    stem = name[: -len(".weight")]
    out[f"{stem}.weight"] = packed.reshape(-1, 1)
    out[f"{stem}.weight.absmax"] = u8
    out[f"{stem}.weight.nested_absmax"] = absmax2
    out[f"{stem}.weight.nested_quant_map"] = qmap
    out[f"{stem}.weight.quant_map"] = code
    blob = {"quant_type": quant_type, "blocksize": 64, "dtype": "bfloat16", "shape": list(w.shape),
            "nested_blocksize": 256, "nested_offset": offset, "nested_dtype": "float32"}
    out[f"{stem}.weight.quant_state.bitsandbytes__{quant_type}"] = np.frombuffer(json.dumps(blob).encode(),
                                                                                 np.uint8).copy()


def phase11(root: Path, dev, smi: str) -> None:
    """Phase 11: HF checkpoints to served tokens (the module docstring lists
    its parts).  Every source is written under build/ and removed at the end."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from torch_bnb_fp4_tpu_torch import compat as C
    from torch_bnb_fp4_tpu_torch.convert import dequantize_nested_absmax, load_checkpoint, native
    from torch_bnb_fp4_tpu_torch.models import linear as L
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.ops import format as fmt
    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
    from torch_bnb_fp4_tpu_torch.utils import profiling as P

    t_phase = time.perf_counter()
    build = root / "build"
    base = T.ModelConfig.mistral_7b()
    g11 = torch.Generator().manual_seed(11)
    check(native.available(), "[11] the native packer (csrc/host/qpack.c) did not build: no C compiler?")
    print(f"[11] native packer: {Path(native._build_lib()).relative_to(root)}")
    dirs = [build / n for n in ("chip_smoke_hf_src", "chip_smoke_hf_ckpt", "chip_smoke_bnb_src",
                                "chip_smoke_bnb_ckpt", "chip_smoke_hf2_src", "chip_smoke_hf2_ckpt")]
    src_a, out_a, src_c, out_c, src_d, out_d = dirs
    ecfg = EngineConfig(max_batch=4, max_len=512, inner_steps=8)

    def close(y, y_ref, what):
        """Card against CPU: |dy| <= 2^-7 * max|y_ref| (bf16 output rounding, f32 summation order)."""
        y, y_ref = y.float().cpu(), y_ref.float().cpu()
        d = (y - y_ref).abs().max().item()
        check(bool(torch.isfinite(y).all()) and d <= 2.0**-7 * y_ref.abs().max().item(),
              f"{what}: max|d| {d} > 2^-7 max|y|")
        return d

    try:
        # (a) a 32-layer HF source -> the converter CLI -> load_checkpoint -> the graphed engine
        t0 = time.perf_counter()
        src_bytes = write_hf_source(src_a, base, HF_LAYERS, dev)
        write_s = time.perf_counter() - t0
        conv_s, peak_mib, total_mib, packer = run_convert(root, src_a, out_a, ["--quantize-embed"],
                                                          build / "chip_smoke_convert.log")
        shutil.rmtree(src_a)
        check(packer == "native C", f"[11a] the converter packed with {packer}")
        print(f"[11a] wrote a {HF_LAYERS}-layer Mistral-7B HF source ({len(hf_shards(base, HF_LAYERS))} bf16 shards, "
              f"{src_bytes / 1e9:.2f} GB) in {write_s:.1f} s; `python -m torch_bnb_fp4_tpu_torch.convert "
              f"--quantize-embed`: {conv_s:.1f} s, {src_bytes / conv_s / 1e9:.3f} GB/s of source, peak pending "
              f"{peak_mib:.1f} MiB of {total_mib:.1f} MiB read, packer {packer} ({smi})")
        t0 = time.perf_counter()
        cfg, params = load_checkpoint(str(out_a), fuse=True, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(cfg == dataclasses.replace(base, n_layers=HF_LAYERS, quantize_embed=True), f"[11a] config {cfg}")
        check(isinstance(params.embed, T.QuantEmbedding), "[11a] the embedding table is not quantized")
        emb_q, emb_bf16 = tensor_bytes(params.embed), cfg.vocab_size * cfg.dim * 2
        print(f"[11a] load_checkpoint(fuse=True) in {load_s:.1f} s: {tensor_bytes(params) / 1e9:.2f} GB on the card; "
              f"embedding table {emb_q / 1e6:.1f} MB packed against {emb_bf16 / 1e6:.1f} MB in bf16")
        t0 = time.perf_counter()
        weights2 = source_weights(base, 2, dev)
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        ref2 = T.quantize_params(cfg2, weights2, fuse=True, device=dev)
        for i in range(2):
            for f in ("wqkv", "wo", "w_gateup", "w_down"):
                a, b = getattr(params.layers[i], f), getattr(ref2.layers[i], f)
                check(torch.equal(a.packed, b.packed) and a.scale.dtype == b.scale.dtype
                      and torch.equal(a.scale, b.scale), f"[11a] layer {i} {f}: the converted bytes differ")
            for f in ("attn_norm", "mlp_norm"):
                check(torch.equal(getattr(params.layers[i], f), getattr(ref2.layers[i], f)), f"[11a] layer {i} {f}")
        for f in ("packed", "scale", "code"):
            check(torch.equal(getattr(params.embed, f), getattr(ref2.embed, f)), f"[11a] the table's {f} differs")
        check(torch.equal(params.lm_head.w, ref2.lm_head.w) and torch.equal(params.final_norm, ref2.final_norm),
              "[11a] the lm_head or the final norm differs")
        del ref2
        print(f"[11a] layers 0-1 (packed bytes and scales), the table, the final norm and the lm_head equal "
              f"quantize_params on the same weights in this process ({time.perf_counter() - t0:.1f} s)")
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g11).tolist() for n in HF_PROMPTS]
        eng = Engine(params, cfg, ecfg)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.run([Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        for name in ("matmul_pk", "matmul_pk_minner", "matmul_pk_w4a8"):
            check(launches[name] > 0, f"[11a] the converted model's engine never launched {name}")
        st = eng.stats()
        print(f"[11a] the graphed engine served prompts of {HF_PROMPTS} tokens ({NEW_TOKENS} new each) in {wall:.2f} s, "
              f"decode {st['step_p50_s'] * 1e3:.2f} ms/step p50 ({smi}); launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}")
        for i, p in enumerate(prompts):
            print(f"[11a] {len(p)}-token prompt: "
                  + engine_tokens_vs_eager(T, params, cfg, p, res[i].tokens, dev, f"[11a] {len(p)}-token prompt"))
        cut = T.ModelParams(embed=params.embed, layers=params.layers[:2], final_norm=params.final_norm,
                            lm_head=params.lm_head)
        del eng, params
        torch.cuda.empty_cache()
        shutil.rmtree(out_a)
        print(f"[11a] took {time.perf_counter() - t_phase:.1f} s")

        # (b) the 2-layer cut of (a): card against the CPU's plain versions, and against reference_forward
        t0 = time.perf_counter()
        cut_cpu = T.params_to(cut, "cpu")
        prompt = torch.randint(0, cfg.vocab_size, (1, 100), generator=g11, dtype=torch.int32)
        c_gpu = T.KVCache.zeros(cfg2, 1, 104, device=dev)
        c_cpu = T.KVCache.zeros(cfg2, 1, 104, device="cpu")
        toks, worst = prompt, (0.0, 0.0)
        for step in range(5):  # prefill, then 4 decode steps fed the CPU run's greedy token
            with torch.no_grad():
                lg_gpu, c_gpu = T.forward(cut, cfg2, toks.to(dev), c_gpu, last_only=True)
                lg_cpu, c_cpu = T.forward(cut_cpu, cfg2, toks, c_cpu, last_only=True)
            lg_gpu = lg_gpu.cpu()
            d = (lg_gpu - lg_cpu).abs().max().item()
            rel = ((lg_gpu - lg_cpu).norm() / lg_cpu.norm()).item()
            check(bool(torch.isfinite(lg_gpu).all()) and d <= 6e-2 * lg_cpu.abs().max().item() and rel <= 3e-2,
                  f"[11b] step {step}: max|d| {d}, rel L2 {rel}")
            worst = (max(worst[0], d / lg_cpu.abs().max().item()), max(worst[1], rel))
            toks = lg_cpu[:, -1].argmax(-1).to(torch.int32)[:, None]
        with torch.no_grad():
            q_lg = T.forward(cut, cfg2, prompt.to(dev), T.KVCache.zeros(cfg2, 1, 100, device=dev))[0]
        r_lg = T.reference_forward(cfg2, weights2, prompt, device=dev)
        corr = float(np.corrcoef(q_lg.float().cpu().numpy().ravel(), r_lg.cpu().numpy().ravel())[0, 1])
        check(corr > 0.98, f"[11b] the quantized cut's logits correlate {corr} with reference_forward's")
        print(f"[11b] 2-layer cut of the converted model (quantized table), card against the CPU's plain versions: "
              f"100-token prompt and 4 decode steps, worst max|dlogit| {worst[0]:.3g} of max|logit|, worst rel L2 "
              f"{worst[1]:.3g}; against reference_forward on the card (bf16, unquantized) over all 100 positions: "
              f"correlation {corr:.5f} ({time.perf_counter() - t0:.1f} s)")
        del cut, cut_cpu, c_gpu, c_cpu
        torch.cuda.empty_cache()

        # (c) a bitsandbytes-serialized NF4 source, imported exactly and requantized
        t0 = time.perf_counter()

        def to_bnb(name, t, out):
            if name.endswith("_proj.weight"):
                bnb_serialize(name, t.float().numpy(), "nf4", out)
            else:
                out[name] = t

        bnb_bytes = write_hf_source(src_c, base, BNB_LAYERS, dev, transform=to_bnb)
        print(f"[11c] wrote a {BNB_LAYERS}-layer bitsandbytes NF4 source (double-quantized absmax, "
              f"{bnb_bytes / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")
        w0 = torch.from_numpy(weights2["model.layers.0.self_attn.q_proj.weight"]).to(dev)
        bnb_prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g11).tolist() for n in BNB_PROMPTS]
        errs = {}
        for mode, flags, variant in (("exact", [], "lut"), ("requantize", ["--requantize"], "ramp")):
            secs, *_ = run_convert(root, src_c, out_c, flags, build / f"chip_smoke_convert_bnb_{mode}.log")
            cfg_m, p_m = load_checkpoint(str(out_c), device=dev)
            q0 = p_m.layers[0].wq
            check(q0.variant == variant, f"[11c] {mode}: layer 0 wq has variant {q0.variant}")
            errs[mode] = (L.dequantize_weight(q0, out_dtype=torch.float32) - w0).abs().mean().item()
            p_m = T.fuse_params(p_m)
            eng = Engine(p_m, cfg_m, ecfg)
            K.reset_launch_counts()
            res = eng.run([Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(bnb_prompts)])
            launches = K.launch_counts()
            check(launches["matmul_pk"] > 0 and launches["matmul_pk_w4a8" if mode == "requantize" else
                                                             "matmul_pk"] > 0, f"[11c] {mode}: launches {launches}")
            print(f"[11c] {mode} ({' '.join(flags) or 'no flags'}): converted in {secs:.1f} s, {cfg_m.quant_type} "
                  f"{variant}; layer 0 q_proj mean |dequant - source| {errs[mode]:.5g}; launches "
                  f"{json.dumps({k: v for k, v in launches.items() if v})}")
            for i, p in enumerate(bnb_prompts):
                note = engine_tokens_vs_eager(T, p_m, cfg_m, p, res[i].tokens, dev, f"[11c] {mode} {len(p)}")
                print(f"[11c] {mode}, {len(p)}-token prompt: tokens {res[i].tokens[:8]}...; {note}")
            del eng, p_m
            torch.cuda.empty_cache()
            shutil.rmtree(out_c)
        check(errs["exact"] < errs["requantize"] < 2 * errs["exact"],
              f"[11c] weight errors exact {errs['exact']}, requantized {errs['requantize']}")
        shutil.rmtree(src_c)
        print(f"[11c] requantized / exact weight error {errs['requantize'] / errs['exact']:.3f}")

        # (d) compat at Mistral-7B widths, and a stand-in model through recursively_replace_with_fp4_linear
        t0 = time.perf_counter()
        for k, n in COMPAT_SHAPES:
            torch.manual_seed(k)
            lin = torch.nn.Linear(k, n)  # torch's default init, on the CPU
            q = C.TorchFP4Linear.from_linear(lin, device=dev)
            q_cpu = q.quant_linear.to("cpu")
            for m in COMPAT_MS:
                x = torch.randn((m, k), generator=g11).to(torch.bfloat16)
                K.reset_launch_counts()
                y = q(x.to(dev))
                wrapper = "matmul_pk_w4a8" if m >= 256 else "matmul_pk"
                check(y.device.type == "cuda" and K.launch_counts()[wrapper] == 1,
                      f"[11d] TorchFP4Linear {k}->{n} M={m}: launches {K.launch_counts()}")
                d = close(y, L.apply_linear(q_cpu, x), f"[11d] TorchFP4Linear {k}->{n} M={m}")
                with torch.no_grad():
                    err = (y.float().cpu() - lin(x.float())).abs().mean().item()
                check(0.045 <= err <= 0.065, f"[11d] TorchFP4Linear {k}->{n} M={m}: mean |y - exact| {err}")
                print(f"[11d] TorchFP4Linear.from_linear(nn.Linear({k}, {n})) at M={m} ({wrapper}): max|d| {d:.3g} "
                      f"against its plain version; mean |y - nn.Linear(x)| {err:.4f} (the reference's band "
                      f"0.045-0.065)")
            x1 = torch.randn((1, k), generator=g11).to(torch.bfloat16).to(dev)
            mod_ms = P.time_graph(lambda: q(x1)) * 1e3
            app_ms = P.time_graph(lambda: L.apply_linear(q.quant_linear, x1)) * 1e3
            w = lin.weight.detach().numpy()
            packed, absmax = fmt.quantize_fp4(w)
            pk_d, am_d = torch.from_numpy(packed).to(dev), torch.from_numpy(absmax).to(dev)
            code_d = torch.from_numpy(fmt.FP4_CODE).to(dev)  # on the card: no host copy inside the graph

            def gemm():
                return C.gemm_4bit_inference(x1, pk_d, am_d, code_d, 64, dtype="bfloat16", Bshape=w.shape)

            dg = close(gemm(), C.gemm_4bit_inference(x1.cpu(), packed, absmax, fmt.FP4_CODE, 64, dtype="bfloat16",
                                                     Bshape=w.shape), f"[11d] gemm_4bit_inference {k}->{n}")
            gemm_ms = P.time_graph(gemm, rep=10) * 1e3
            u8, absmax2, qmap, offset = nested_absmax_state(absmax)
            state = SimpleNamespace(absmax=u8, blocksize=64, code=fmt.FP4_CODE, shape=w.shape, quant_type="fp4",
                                    state2=SimpleNamespace(absmax=absmax2, code=qmap, blocksize=256), offset=offset)
            qd = C.QuantData(packed, state, w.shape, device=dev)
            K.reset_launch_counts()
            yq = qd(x1)
            check(K.launch_counts()["matmul_pk"] == 1, f"[11d] QuantData {k}->{n}: launches {K.launch_counts()}")
            dq = close(yq, L.apply_linear(qd.quant_linear.to("cpu"), x1.cpu()), f"[11d] QuantData {k}->{n} M=1")
            K.reset_launch_counts()
            wq = qd.dequantize("float32")
            check(K.launch_counts()["dequant_pk"] == 1, f"[11d] QuantData.dequantize: launches {K.launch_counts()}")
            dec = torch.from_numpy(dequantize_nested_absmax(u8, absmax2, qmap, offset, 256)).to(dev)
            wref = C.dequantize_fp4_codebook_invoke(pk_d, dec, code_d, 64, n, k, n * k, "float32")
            dw = (wq - wref).abs().max().item()
            check(dw <= 1e-6 * wref.abs().max().item(), f"[11d] QuantData.dequantize (K6) {k}->{n}: max|d| {dw}")
            print(f"[11d] {k}->{n} at M=1, graph-replayed ({smi}): TorchFP4Linear.forward {mod_ms:.4f} ms, "
                  f"apply_linear on its QuantLinear {app_ms:.4f} ms (module overhead {mod_ms - app_ms:+.4f} ms); "
                  f"gemm_4bit_inference {gemm_ms:.4f} ms (max|d| {dg:.3g} card against CPU); QuantData from a "
                  f"double-quantized state: forward max|d| {dq:.3g} against its plain version, dequantize (K6) "
                  f"max|d| {dw:.3g} against dequantize_fp4_codebook_invoke")
            del lin, q, q_cpu, qd, pk_d, am_d, code_d, wq, wref, dec
        write_hf_source(src_d, base, 2, dev)
        conv2_s, *_ = run_convert(root, src_d, out_d, [], build / "chip_smoke_convert2.log")
        cfg_d, p_d = load_checkpoint(str(out_d), fuse=True, device=dev)

        class Config:
            def to_dict(self):
                return hf_config(base, 2)

        def linear(name):
            w = weights2[name]
            m = torch.nn.utils.skip_init(torch.nn.Linear, w.shape[1], w.shape[0], bias=False)
            m.weight.data = torch.from_numpy(w)
            return m

        def norm(name):
            m = torch.nn.Module()
            m.weight = torch.nn.Parameter(torch.from_numpy(weights2[name]))
            return m

        standin = torch.nn.Module()  # a transformers-like causal LM built from nn.Linear modules
        standin.config = Config()
        standin.model = torch.nn.Module()
        standin.model.embed_tokens = norm("model.embed_tokens.weight")
        standin.model.layers = torch.nn.ModuleList()
        for i in range(2):
            p, lay = f"model.layers.{i}.", torch.nn.Module()
            lay.self_attn, lay.mlp = torch.nn.Module(), torch.nn.Module()
            for s in ("q", "k", "v", "o"):
                setattr(lay.self_attn, f"{s}_proj", linear(f"{p}self_attn.{s}_proj.weight"))
            for s in ("gate", "up", "down"):
                setattr(lay.mlp, f"{s}_proj", linear(f"{p}mlp.{s}_proj.weight"))
            lay.input_layernorm, lay.post_attention_layernorm = (norm(p + "input_layernorm.weight"),
                                                                 norm(p + "post_attention_layernorm.weight"))
            standin.model.layers.append(lay)
        standin.model.norm = norm("model.norm.weight")
        standin.lm_head = linear("lm_head.weight")
        cfg_s, p_s = C.recursively_replace_with_fp4_linear(standin, device=dev)
        check(cfg_s == cfg_d, f"[11d] the stand-in's config {cfg_s} is not the checkpoint's {cfg_d}")
        p_s = T.fuse_params(p_s)
        for i in range(2):
            for f in ("wqkv", "wo", "w_gateup", "w_down"):
                a, b = getattr(p_s.layers[i], f), getattr(p_d.layers[i], f)
                check(torch.equal(a.packed, b.packed) and torch.equal(a.scale, b.scale), f"[11d] layer {i} {f}")
        check(torch.equal(p_s.embed, p_d.embed) and torch.equal(p_s.lm_head.w, p_d.lm_head.w), "[11d] embed/lm_head")
        pr = torch.tensor([prompts[0]], dtype=torch.int32, device=dev)
        t_s, t_d = (T.generate(p, cfg_d, pr, NEW_TOKENS)[0].tolist() for p in (p_s, p_d))
        check(t_s == t_d, "[11d] the stand-in's greedy tokens differ from the CLI-converted checkpoint's")
        print(f"[11d] recursively_replace_with_fp4_linear on a 2-layer full-width stand-in built from nn.Linear: every "
              f"linear's bytes and {NEW_TOKENS} greedy tokens equal those of the CLI-converted checkpoint of the "
              f"same weights (convert {conv2_s:.1f} s); phase 11d took {time.perf_counter() - t0:.1f} s")
        del p_s, p_d, standin
        torch.cuda.empty_cache()
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    print(f"[11] phase 11 took {time.perf_counter() - t_phase:.1f} s")


LORA_PROMPTS = (100, 130, 160, 190, 220, 250, 280, 300)  # phase 12a: prefill buckets 128 (K2), 160-224 (K3), 256+ (K4)
LORA_ADAPTERS = (None, "a", "b", "a", "b", None, "a", "b")
LORA_CLI_LAYERS = 4  # phase 12d's checkpoint
PEFT_TARGETS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj", "mlp.gate_proj",
                "mlp.up_proj", "mlp.down_proj")


def peft_weights(cfg, n_layers: int, r: int, targets, gen, dev) -> dict:
    """Seeded PEFT factors {module stem: (lora_A (r, k_in), lora_B (n_out, r))}
    as f32 numpy, drawn on the device (N(0, 0.01^2) entries)."""
    import torch

    kv = cfg.n_kv_heads * cfg.head_dim
    shapes = {"self_attn.q_proj": (cfg.q_dim, cfg.dim), "self_attn.k_proj": (kv, cfg.dim),
              "self_attn.v_proj": (kv, cfg.dim), "self_attn.o_proj": (cfg.dim, cfg.q_dim),
              "mlp.gate_proj": (cfg.ffn_dim, cfg.dim), "mlp.up_proj": (cfg.ffn_dim, cfg.dim),
              "mlp.down_proj": (cfg.dim, cfg.ffn_dim)}
    out = {}
    for i in range(n_layers):
        for t in targets:
            n, k = shapes[t]
            out[f"model.layers.{i}.{t}"] = tuple((torch.randn(s, generator=gen, device=dev) * 0.01).cpu().numpy()
                                                 for s in ((r, k), (n, r)))
    return out


def write_peft(path: Path, weights: dict, r: int, alpha: float) -> None:
    """A HF PEFT adapter directory written with the port's own safetensors writer."""
    from torch_bnb_fp4_tpu_torch.convert.safetensors_io import save_file

    path.mkdir(parents=True, exist_ok=True)
    tensors = {}
    for stem, (a, b) in weights.items():
        tensors[f"base_model.model.{stem}.lora_A.weight"] = a
        tensors[f"base_model.model.{stem}.lora_B.weight"] = b
    save_file(tensors, str(path / "adapter_model.safetensors"))
    targets = sorted({s.rsplit(".", 1)[1] for s in weights})
    (path / "adapter_config.json").write_text(json.dumps({"peft_type": "LORA", "r": r, "lora_alpha": alpha,
                                                          "target_modules": targets}))


def start_cli(root: Path, args, log_path: Path, tag: str):
    """Start the CLI as a child process and wait for its serving line:
    (process, url, seconds to the line)."""
    cmd = [sys.executable, "-m", "torch_bnb_fp4_tpu_torch.serve", "--port", "0", *args]
    err = open(log_path, "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        line = lines.get(timeout=600)
    except queue.Empty:
        line = ""
    if not line.startswith("serving on http://"):
        proc.kill()
        proc.wait()
        print(f"{tag} server log (tail):\n" + log_path.read_text()[-4000:], file=sys.stderr)
        check(False, f"{tag} the server printed {line!r}")
    return proc, line.split()[-1], time.perf_counter() - t0


def stop_cli(proc, log_path: Path, tag: str) -> None:
    proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        print(f"{tag} server log (tail):\n" + log_path.read_text()[-4000:], file=sys.stderr)
    check(rc == 0, f"{tag} the server exited with {rc} on SIGINT")


def graph_step_ms(e, aidx) -> float:
    """Device ms of one batch-8 decode step of engine ``e`` (served, idle):
    its captured depth-8 graph replayed 5 times with all 8 slots active at
    ~300-row contexts and adapter indices ``aidx`` written to its buffer."""
    import torch

    graph = e._graphs[("decode", 8, 8, False)].graph
    e._active.fill_(True)
    e.cache.length[:8].fill_(300)
    e._aidx.copy_(torch.tensor(aidx, dtype=torch.int32))
    graph.replay()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(5):
        graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / 5 / 8


def phase12(root: Path, dev, smi: str) -> None:
    """Phase 12: LoRA adapters at Mistral-7B width (the module docstring lists
    its parts).  The adapter directories and the checkpoint are written under
    build/ and removed at the end."""
    import re
    import urllib.error

    import numpy as np
    import torch

    from torch_bnb_fp4_tpu_torch.convert import load_checkpoint, save_checkpoint
    from torch_bnb_fp4_tpu_torch.models import linear as L
    from torch_bnb_fp4_tpu_torch.models import lora as LoRA
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

    t_phase = time.perf_counter()
    build = root / "build"
    dirs = [build / n for n in ("chip_smoke_lora_a", "chip_smoke_lora_b", "chip_smoke_lora_a4", "chip_smoke_lora_b4",
                                "chip_smoke_lora_ckpt")]
    dir_a, dir_b, dir_a4, dir_b4, ckpt = dirs
    logs = [build / "chip_smoke_lora_server.log", build / "chip_smoke_lora_merge_server.log"]
    cfg = T.ModelConfig.mistral_7b()
    gen = torch.Generator(device=dev).manual_seed(12)
    g12 = torch.Generator().manual_seed(12)

    def sub_adapter(ad, n_layers):
        return LoRA.PEFTAdapter(r=ad.r, alpha=ad.alpha, weights={s: v for s, v in ad.weights.items()
                                                                 if int(s.split(".")[2]) < n_layers})

    try:
        # setup: two PEFT directories and the base params
        t0 = time.perf_counter()
        wa = peft_weights(cfg, cfg.n_layers, 16, PEFT_TARGETS, gen, dev)
        wb = peft_weights(cfg, cfg.n_layers, 8, ("self_attn.q_proj", "self_attn.v_proj"), gen, dev)
        write_peft(dir_a, wa, 16, 32.0)
        write_peft(dir_b, wb, 8, 16.0)
        A, B = LoRA.load_peft_adapter(str(dir_a)), LoRA.load_peft_adapter(str(dir_b))
        check((A.r, A.alpha, B.r, B.alpha) == (16, 32.0, 8, 16.0) and sorted(A.weights) == sorted(wa)
              and all(np.array_equal(A.weights[s][j], wa[s][j]) for s in wa for j in (0, 1)),
              "[12] the PEFT directory read back other factors")
        mb = (dir_a / "adapter_model.safetensors").stat().st_size / 1e6
        params = synth_params(cfg, seed=5, fuse=False, device=dev)
        mp, ids = LoRA.attach_multi_lora(params, cfg, {"a": A, "b": B})
        singles = {None: params, "a": LoRA.attach_lora(params, cfg, A), "b": LoRA.attach_lora(params, cfg, B)}
        stack_mb = sum(tensor_bytes((q.a, q.b)) for lp in mp.layers for q in vars(lp).values()
                       if isinstance(q, L.MultiLoRALinear)) / 1e6
        torch.cuda.synchronize()
        print(f"[12] adapters a (r 16, alpha 32, q/k/v/o/gate/up/down x {cfg.n_layers} layers; {mb:.1f} MB of f32 "
              f"PEFT file) and b (r 8, alpha 16, q/v) written and read back with the port's safetensors code; "
              f"attach_multi_lora: {ids}, stacks {stack_mb:.1f} MB bf16 on the card; setup "
              f"{time.perf_counter() - t0:.1f} s ({smi})")

        # (a) the multi-LoRA engine: warmup, then 8 mixed requests in one batch, against eager generate
        t_sub = time.perf_counter()
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g12).tolist() for n in LORA_PROMPTS]
        ecfg = EngineConfig(max_batch=8, max_len=1024, inner_steps=8, batch_buckets=True)
        eng = Engine(mp, cfg, ecfg, adapter_ids=ids)
        t0 = time.perf_counter()
        warm = eng.warmup(max_prompt_len=max(LORA_PROMPTS))
        warm_s, n_graphs = time.perf_counter() - t0, len(eng._graphs)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS, adapter=a)
                for i, (p, a) in enumerate(zip(prompts, LORA_ADAPTERS))]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        st = eng.stats()
        check(eng.traces == warm and len(eng._graphs) == n_graphs,
              f"[12a] serving after warmup() added programs: {warm} -> {eng.traces}, graphs {n_graphs} -> "
              f"{len(eng._graphs)}")
        for name in ("matmul_pk", "matmul_pk_minner", "matmul_pk_w4a8"):
            check(launches[name] > 0, f"[12a] the multi-LoRA engine never launched {name}")
        check(st["decode_batch"] == 8 and all(len(res[i].tokens) == NEW_TOKENS for i in range(len(reqs))),
              f"[12a] stats {st}")
        lora_card_ms = graph_step_ms(eng, [ids[a] if a else 0 for a in LORA_ADAPTERS])
        del eng
        e0 = Engine(params, cfg, ecfg)
        e0.warmup(prompt_lens=LORA_PROMPTS)
        res0 = e0.run([Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        st0 = e0.stats()
        base_card_ms = graph_step_ms(e0, [0] * 8)
        del e0, res0
        torch.cuda.empty_cache()
        print(f"[12a] multi-LoRA engine (max_batch 8, max_len 1024, inner_steps 8, batch buckets): warmup("
              f"max_prompt_len={max(LORA_PROMPTS)}) {warm_s:.1f} s, {n_graphs} decode graphs, traces {warm}; 8 "
              f"requests (prompts {LORA_PROMPTS}, adapters {list(LORA_ADAPTERS)}) in {wall:.2f} s, no new graph; "
              f"launches {json.dumps(launches)}")
        print(f"[12a] decode ms/step at batch 8: with adapters {st['step_p50_s'] * 1e3:.3f} p50 (host clock, the "
              f"serving ticks), {lora_card_ms:.3f} on the card alone (the depth-8 graph replayed, rows a/b/none); "
              f"the same engine without adapters {st0['step_p50_s'] * 1e3:.3f} p50, {base_card_ms:.3f} on the card "
              f"alone; the adapters' cost {lora_card_ms - base_card_ms:.3f} ms/step "
              f"({100 * (lora_card_ms / base_card_ms - 1):.1f}%) on the card ({smi})")
        for i, (p, a) in enumerate(zip(prompts, LORA_ADAPTERS)):
            msg = engine_tokens_vs_eager(T, singles[a], cfg, p, res[i].tokens, dev, f"[12a] request {i}")
            print(f"[12a] request {i} ({len(p)} tokens, adapter {a}): {msg} on "
                  f"{'the base' if a is None else f'attach_lora({a})'}")
        print(f"[12a] took {time.perf_counter() - t_sub:.1f} s")

        # (b) the 2-layer cut: card against the CPU's plain versions, one adapter attached and three stacked
        t_sub = time.perf_counter()
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        A2, B2 = sub_adapter(A, 2), sub_adapter(B, 2)
        p_gpu = synth_params(cfg2, seed=1, device=dev)
        p_cpu = T.params_to(p_gpu, "cpu")
        mg, _ = LoRA.attach_multi_lora(p_gpu, cfg2, {"a": A2, "b": B2})
        mc, _ = LoRA.attach_multi_lora(p_cpu, cfg2, {"a": A2, "b": B2})
        idx = torch.tensor([1, 0, 2], dtype=torch.int32)
        cuts = {"attach_lora(a)": (LoRA.attach_lora(p_gpu, cfg2, A2), LoRA.attach_lora(p_cpu, cfg2, A2), None),
                "attach_multi_lora, rows a / none / b": (mg, mc, idx)}
        t_cpu = 0.0
        for tag, (pg, pc, ix) in cuts.items():
            b = 1 if ix is None else len(ix)
            toks = torch.randint(0, cfg2.vocab_size, (b, 100), generator=g12, dtype=torch.int32)
            c_gpu, c_cpu = T.KVCache.zeros(cfg2, b, 103, device=dev), T.KVCache.zeros(cfg2, b, 103, device="cpu")
            kg, kc = ({}, {}) if ix is None else (dict(adapter_idx=ix.to(dev)), dict(adapter_idx=ix))
            for step in range(3):  # the prompt, then 2 decode steps fed the CPU run's greedy tokens
                with torch.no_grad():
                    lg_gpu, c_gpu = T.forward(pg, cfg2, toks.to(dev), c_gpu, last_only=True, **kg)
                    t = time.perf_counter()
                    lg_cpu, c_cpu = T.forward(pc, cfg2, toks, c_cpu, last_only=True, **kc)
                    t_cpu += time.perf_counter() - t
                lg_gpu = lg_gpu.cpu()
                d = (lg_gpu - lg_cpu).abs().max().item()
                rel = ((lg_gpu - lg_cpu).norm() / lg_cpu.norm()).item()
                check(bool(torch.isfinite(lg_gpu).all()) and d <= 6e-2 * lg_cpu.abs().max().item() and rel <= 3e-2,
                      f"[12b] {tag} step {step}: max|d| {d}, rel L2 {rel}")
                print(f"[12b] 2-layer cut, {tag}, batch {b}, {'100-token prompt' if step == 0 else 'decode'} step "
                      f"{step}: max|dlogit| {d:.4g} of max {lg_cpu.abs().max().item():.4g}, rel L2 {rel:.3g} "
                      f"(limits 6e-2 of max, 3e-2)")
                toks = lg_cpu[:, -1].argmax(-1).to(torch.int32)[:, None]
        print(f"[12b] took {time.perf_counter() - t_sub:.1f} s (CPU side {t_cpu:.1f} s)")

        # (c) merge_lora(a) on the cut: the card's merge (K6) against the CPU's, byte for byte
        t_sub = time.perf_counter()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        merged = LoRA.merge_lora(p_gpu, cfg2, A2)
        torch.cuda.synchronize()
        card_s, k6 = time.perf_counter() - t0, K.launch_counts()["dequant_pk"]
        t0 = time.perf_counter()
        merged_cpu = LoRA.merge_lora(p_cpu, cfg2, A2)
        cpu_s = time.perf_counter() - t0
        check(k6 == 7 * cfg2.n_layers, f"[12c] {k6} K6 launches in the card's merge")
        for i in range(cfg2.n_layers):
            for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                qg, qc = getattr(merged.layers[i], f), getattr(merged_cpu.layers[i], f)
                check(torch.equal(qg.packed.cpu(), qc.packed) and torch.equal(qg.scale.cpu(), qc.scale)
                      and not torch.equal(qg.packed, getattr(p_gpu.layers[i], f).packed),
                      f"[12c] layer {i} {f}: the card's merged bytes differ from the CPU's (or equal the base's)")
        toks = torch.randint(0, cfg2.vocab_size, (1, 100), generator=g12, dtype=torch.int32).to(dev)
        with torch.no_grad():
            lm = T.forward(merged, cfg2, toks, T.KVCache.zeros(cfg2, 1, 100, device=dev))[0].float().cpu()
            la = T.forward(cuts["attach_lora(a)"][0], cfg2, toks, T.KVCache.zeros(cfg2, 1, 100, device=dev))[0]
            lb = T.forward(p_gpu, cfg2, toks, T.KVCache.zeros(cfg2, 1, 100, device=dev))[0]
        la, lb = la.float().cpu(), lb.float().cpu()
        corr = float(np.corrcoef(lm.ravel().numpy(), la.ravel().numpy())[0, 1])
        corr_b = float(np.corrcoef(lb.ravel().numpy(), la.ravel().numpy())[0, 1])
        dm = (lm - la).abs().max().item() / la.abs().max().item()
        check(bool(torch.isfinite(lm).all()), "[12c] non-finite logits from the merged cut")
        print(f"[12c] merge_lora(a) on the 2-layer cut: card {card_s:.1f} s (K6 launches {k6}), CPU {cpu_s:.1f} s; "
              f"every merged packing and scale byte-equal; merged vs attached logits over 100 positions: max|d| / "
              f"max {dm:.4g}, correlation {corr:.5f} (the base against the attached form: {corr_b:.5f}); took "
              f"{time.perf_counter() - t_sub:.1f} s")
        del p_gpu, p_cpu, mg, mc, cuts, merged, merged_cpu
        torch.cuda.empty_cache()

        # (e) R7: one 512-token prompt under a, then b (together), then a again, with the prefix cache
        t_sub = time.perf_counter()
        sysp = torch.randint(0, cfg.vocab_size, (512,), generator=g12).tolist()
        r7 = [Request(uid=0, prompt=sysp, max_new_tokens=NEW_TOKENS, adapter="a"),
              Request(uid=1, prompt=sysp, max_new_tokens=NEW_TOKENS, adapter="b")]
        e_pc = Engine(mp, cfg, EngineConfig(max_batch=4, max_len=1024, inner_steps=8, prefix_cache=True,
                                            prefix_store=2), adapter_ids=ids)
        out = e_pc.run([dataclasses.replace(r) for r in r7])
        hits_ab = e_pc.stats()["prefix_hits"]
        check(hits_ab == 0, f"[12e] {hits_ab} prefix hits across adapters")
        e_np = Engine(mp, cfg, EngineConfig(max_batch=4, max_len=1024, inner_steps=8), adapter_ids=ids)
        ref = e_np.run([dataclasses.replace(r) for r in r7])
        check(out[1].tokens == ref[1].tokens and out[0].tokens == ref[0].tokens,
              "[12e] the prefix engine's tokens under a and b differ from the engine without the cache")
        third = e_pc.run([Request(uid=2, prompt=sysp, max_new_tokens=NEW_TOKENS, adapter="a")])[2]
        st_pc = e_pc.stats()
        check(st_pc["prefix_hits"] == 1 and st_pc["prefix_tokens_reused"] == 480,
              f"[12e] third request: hits {st_pc['prefix_hits']}, reused {st_pc['prefix_tokens_reused']}")
        msg = engine_tokens_vs_eager(T, singles["a"], cfg, sysp, third.tokens, dev, "[12e] third request")
        print(f"[12e] R7: a 512-token prompt under a and b together: 0 prefix hits, both requests' tokens equal the "
              f"engine without the cache; the same prompt under a again: 1 hit (480 tokens reused from a's store "
              f"entry), {msg}; TTFT {out[0].ttft_s * 1e3:.1f} / {out[1].ttft_s * 1e3:.1f} ms, the hit "
              f"{third.ttft_s * 1e3:.1f} ms; took {time.perf_counter() - t_sub:.1f} s")
        del e_pc, e_np, mp, singles, params
        torch.cuda.empty_cache()

        # (d) the CLI on a 4-layer checkpoint: named adapters over HTTP with shadows; then --lora-merge
        t_sub = time.perf_counter()
        cfg4 = dataclasses.replace(cfg, n_layers=LORA_CLI_LAYERS)
        p4 = synth_params(cfg4, seed=17, device=dev)
        save_checkpoint(str(ckpt), cfg4, p4)
        del p4
        torch.cuda.empty_cache()
        for d, w, r, alpha in ((dir_a4, wa, 16, 32.0), (dir_b4, wb, 8, 16.0)):
            write_peft(d, {s: v for s, v in w.items() if int(s.split(".")[2]) < LORA_CLI_LAYERS}, r, alpha)
        flags = ["--lora", f"a={dir_a4}", "--lora", f"b={dir_b4}", "--prefill-shadow", "--prefill-chunk", "256",
                 "--prefix-cache", "--warmup-prompt-len", "512"]
        bodies = {name: {"prompt": torch.randint(0, cfg.vocab_size, (n,), generator=g12).tolist(),
                         "max_tokens": NEW_TOKENS} | ({"adapter": name} if name != "none" else {})
                  for name, n in (("a", 300), ("b", 100), ("none", 200))}
        proc, url, startup_s = start_cli(root, ["--ckpt", str(ckpt), "--max-batch", "4", "--max-len", "2048", *flags],
                                         logs[0], "[12d]")
        try:
            http = {}
            threads = [threading.Thread(target=lambda k=k: http.__setitem__(k, http_post(url, bodies[k])))
                       for k in bodies]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            check(sorted(http) == sorted(bodies) and all(len(c["tokens"]) == NEW_TOKENS for c in http.values()),
                  f"[12d] requests over HTTP: {http}")
            try:
                http_post(url, {"prompt": [1, 2, 3], "max_tokens": 4, "adapter": "c"})
                code, err_msg = 200, ""
            except urllib.error.HTTPError as e:
                code, err_msg = e.code, json.loads(e.read())["error"]
            check(code == 400 and "unknown adapter 'c'" in err_msg, f"[12d] unknown adapter answered {code} {err_msg}")
            srv_launches = http_get(url, "/v1/stats")["launches"]
        finally:
            stop_cli(proc, logs[0], "[12d]")
        check(srv_launches["matmul_w8"] > 0, f"[12d] the server never launched K5: {srv_launches}")
        cfg4r, p4r = load_checkpoint(str(ckpt), device=dev)
        m4, ids4 = LoRA.attach_multi_lora(p4r, cfg4r, {"a": LoRA.load_peft_adapter(str(dir_a4)),
                                                       "b": LoRA.load_peft_adapter(str(dir_b4))})
        m4 = L.attach_prefill_shadow(m4)
        check(all(q.base.w8 is not None for lp in m4.layers for q in vars(lp).values()
                  if isinstance(q, L.MultiLoRALinear)), "[12d] a base inside a MultiLoRALinear has no shadow")
        e4 = Engine(m4, cfg4r, EngineConfig(max_batch=4, max_len=2048, prefill_chunk=256, prefix_cache=True),
                    adapter_ids=ids4)
        K.reset_launch_counts()
        local = e4.run([Request(uid=i, prompt=b["prompt"], max_new_tokens=NEW_TOKENS, adapter=b.get("adapter"))
                        for i, b in enumerate(bodies.values())])
        launches4 = K.launch_counts()
        for i, k in enumerate(bodies):
            check(local[i].tokens == http[k]["tokens"], f"[12d] request {k}: HTTP tokens differ from in-process")
        check(launches4["matmul_w8"] > 0 and launches4["dequant_pk"] == 0,
              f"[12d] in-process launches {launches4}")
        del e4, m4, p4r
        torch.cuda.empty_cache()
        proc, url, merge_startup_s = start_cli(root, ["--ckpt", str(ckpt), "--max-batch", "2", "--max-len", "512",
                                                      "--lora", str(dir_b4), "--lora-merge"], logs[1], "[12d merge]")
        try:
            merged_out = http_post(url, {"prompt": bodies["b"]["prompt"], "max_tokens": NEW_TOKENS})
        finally:
            stop_cli(proc, logs[1], "[12d merge]")
        check(len(merged_out["tokens"]) == NEW_TOKENS, f"[12d] --lora-merge served {merged_out}")
        same_b = sum(x == y for x, y in zip(merged_out["tokens"], http["b"]["tokens"]))
        print(f"[12d] CLI {' '.join(flags).replace(str(build) + '/', '')} on a {LORA_CLI_LAYERS}-layer checkpoint: "
              f"serving line after {startup_s:.1f} s; requests under a (300 tokens), b (100) and none (200) at once "
              f"over HTTP, tokens equal to the in-process engine's (load, attach_multi_lora, attach_prefill_shadow); "
              f"K5 launches {launches4['matmul_w8']} in process (the 300-token prompt's 256-row chunk under "
              f"LoRA-wrapped bases), {srv_launches['matmul_w8']} in the server; an unknown adapter -> 400 "
              f"({err_msg!r}); SIGINT -> 0")
        print(f"[12d] CLI --lora DIR --lora-merge: serving line after {merge_startup_s:.1f} s, {NEW_TOKENS} tokens "
              f"served ({same_b}/{NEW_TOKENS} equal to the attached b's), SIGINT -> 0; (d) took "
              f"{time.perf_counter() - t_sub:.1f} s")

        # (f) the example script on the card
        t_sub = time.perf_counter()
        ex = subprocess.run([sys.executable, str(root / "examples_torch" / "sanity_check.py")], cwd=root,
                            capture_output=True, text=True, timeout=600)
        errs = [float(x) for x in re.findall(r"mean \|err\| = ([\d.]+)", ex.stdout)]
        if ex.returncode != 0:
            print(f"[12f] sanity_check.py stderr (tail):\n{ex.stderr[-3000:]}", file=sys.stderr)
        check(ex.returncode == 0 and "PASSED" in ex.stdout and len(errs) == 3
              and all(0.045 <= e <= 0.065 for e in errs), f"[12f] sanity_check.py: rc {ex.returncode}, {ex.stdout}")
        print("[12f] examples_torch/sanity_check.py on the card: mean |err| " + ", ".join(f"{e:.4f}" for e in errs)
              + " (band 0.045-0.065); its speed table:")
        for ln in ex.stdout.splitlines():
            if ln.strip().startswith(("gemv", "gemm", "mode", "[bfloat16]")):
                print("[12f]   " + ln.strip())
        print(f"[12f] took {time.perf_counter() - t_sub:.1f} s")
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    print(f"[12] phase 12 took {time.perf_counter() - t_phase:.1f} s")


TP_A_FORWARD = (300, 160)  # phase 13a's forwards: K4 and K3 at the local shapes, then decode steps (K2, M=1)
TP_A_PROMPTS = (20, 100, 200, 300)  # phase 13a's engine: prefill buckets 32 and 128 (K2), 224 (K3), 320 (K4)
TP_DECODE_STEPS = 4
LLAMA70_LAYERS = 4  # phase 13b: Llama-2-70B at full width, cut in depth
MIXTRAL_TP_LAYERS = 2  # phase 13c
TP_CLI_LAYERS = 4  # phase 13d's checkpoint
TP_CLI_PROMPTS = (100, 300)  # 300: a 320-row prefill, K5 on the shadowed shards
# the local (per-rank) shapes phase 13 gives the kernels: (name, K, N, count per layer or expert)
TP2_FUSED = (("qkv", 4096, 3072, 1), ("o", 2048, 4096, 1), ("gate_up", 4096, 14336, 1), ("down", 7168, 4096, 1))
TP2_UNFUSED = (("wq", 4096, 2048, 1), ("wk|wv", 4096, 512, 2), ("wo", 2048, 4096, 1), ("w_gate|w_up", 4096, 7168, 2),
               ("w_down", 7168, 4096, 1))
TP2_EXPERT = (("gate|up", 4096, 14336, 1), ("down", 7168, 4096, 1))
TP4_SPLITK_70B = (("wq", 8192, 2048, 1), ("wk|wv", 8192, 256, 2), ("wo", 2048, 8192, 1), ("w_gate|w_up", 8192, 7168, 2),
                  ("w_down", 7168, 8192, 1))


def sync(dev) -> None:
    """Wait for ``dev``'s queued work (a no-op on the CPU, where phase 13 is
    rehearsed)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tp_forwards(params, cfg, prompts, forced, dev, mesh=None, steps=TP_DECODE_STEPS):
    """Prefill each prompt at batch 1, then ``steps`` decode steps fed the
    tokens ``forced[i]`` (None: this run's own greedy tokens), through
    ``parallel.tp_forward_fn`` on ``mesh`` or ``T.forward`` without one.
    Returns the full-vocabulary last-position logits of every call (CPU),
    the tokens fed, the launches of all the calls, the all-reduces of one
    decode step, and the eager ms of a decode step (and, on a mesh, of its
    2 all-reduces per layer alone)."""
    import torch

    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.parallel import tp as TP

    kv_cfg = cfg if mesh is None else dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // mesh.n_model)
    if mesh is None:
        def fwd(p, t, c):
            return T.forward(p, cfg, t, c, last_index=t.shape[1] - 1)
    else:
        tpf = TP.tp_forward_fn(params, cfg, T.KVCache.zeros(kv_cfg, 1, 1, device=dev), mesh, with_last_index=True)

        def fwd(p, t, c):
            return tpf(p, t, c, t.shape[1] - 1)
    gather = (lambda x: x) if mesh is None else (lambda x: TP.gather_vocab(x, mesh))
    out = dict(logits=[], tokens=[], ar_per_step=0)
    K.reset_launch_counts()
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            cache = T.KVCache.zeros(kv_cfg, 1, len(prompt) + steps + 1, device=dev)
            toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
            rows, fed = [], []
            for s in range(steps + 1):
                TP.reset_collective_counts()
                lg, cache = fwd(params, toks, cache)
                if s == 1:
                    out["ar_per_step"] = TP.collective_counts()["all_reduce"]
                lg = gather(lg[0, -1]).float()
                rows.append(lg.cpu())
                nxt = int(lg.argmax()) if forced is None else forced[i][s]
                fed.append(nxt)
                toks = torch.tensor([[nxt]], dtype=torch.int32, device=dev)
            out["logits"].append(rows)
            out["tokens"].append(fed)
        sync(dev)
        out["launches"] = K.launch_counts()
        at = T.KVCache(k=cache.k, v=cache.v, length=cache.length.clone())

        def one_step():
            fwd(params, toks, T.KVCache(k=at.k, v=at.v, length=at.length))

        one_step()
        sync(dev)
        t = time.perf_counter()
        for _ in range(10):
            one_step()
        sync(dev)
        out["step_ms"] = (time.perf_counter() - t) * 100
        if mesh is not None and mesh.n_model > 1:
            y = torch.zeros((1, 1, cfg.dim), dtype=torch.float32, device=dev)
            n_ar = 2 * cfg.n_layers
            torch.distributed.barrier(group=mesh.model_group)
            t = time.perf_counter()
            for _ in range(10 * n_ar):
                TP.all_reduce_(y, mesh.model_group)
            sync(dev)
            out["ar_ms_per_step"] = (time.perf_counter() - t) * 100
    return out


def tp_first_diff_margin(params, cfg, prompt, tokens, ref_tokens, dev, mesh=None):
    """Where ``tokens`` first differ from ``ref_tokens``: (step, this run's
    margin of its own token over the reference's in its own logits fed its
    own tokens, 2^-7 * max|logit|); None when they agree."""
    import torch

    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.parallel import tp as TP

    j = next((t for t, (a, b) in enumerate(zip(ref_tokens, tokens)) if a != b), None)
    if j is None:
        return None
    kv_cfg = cfg if mesh is None else dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // mesh.n_model)
    seq = prompt + tokens[:j]
    cache = T.KVCache.zeros(kv_cfg, 1, len(seq), device=dev)
    with torch.no_grad():
        lg, _ = T.forward(params, cfg, torch.tensor([seq], dtype=torch.int32, device=dev), cache,
                          last_index=len(seq) - 1, group=None if mesh is None or mesh.n_model == 1 else mesh.model_group)
        g = (lg[0, -1] if mesh is None else TP.gather_vocab(lg[0, -1], mesh)).float().cpu()
    return j, (g[tokens[j]] - g[ref_tokens[j]]).item(), 2.0**-7 * g.abs().max().item()


def tp_routes(T):
    """Record the router's probabilities of every MoE call (T.moe_forward
    wrapped; undo with the returned function)."""
    import torch

    routes, orig = [], T.moe_forward

    def rec(moe, cfg, x, force_dense=None, group=None):
        xt = x.reshape(-1, x.shape[-1])
        routes.append(torch.softmax(moe.router(xt, out_dtype=torch.float32), dim=-1).cpu())
        return orig(moe, cfg, x, force_dense=force_dense, group=group)

    T.moe_forward = rec

    def undo():
        T.moe_forward = orig

    return routes, undo


def tp_job(mesh, job: dict) -> dict:
    """One phase-13 job on this rank's mesh: this rank's shard of the seeded
    params (built one layer at a time on its card), the forwards of
    :func:`tp_forwards` fed the tp = 1 run's tokens, and for "mistral" the
    engine, for "mixtral" the router's probabilities."""
    import torch

    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.parallel import tp as TP
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

    cfg, dev, out = job["cfg"], mesh.device, {}
    for name, kw in job["builds"]:
        t0 = time.perf_counter()
        params = synth_params(cfg, tp=mesh.n_model, device=dev, mesh=mesh, **kw)
        sync(dev)
        r = dict(build_s=time.perf_counter() - t0,
                 gib=torch.cuda.memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0)
        routes, undo = tp_routes(T) if cfg.n_experts else (None, None)
        r.update(tp_forwards(params, cfg, job["prompts"], job["forced"][name], dev, mesh, job["steps"]))
        if routes is not None:
            undo()
            r["routes"] = routes
        if "engine" in job:
            e = job["engine"]
            eng = Engine(params, cfg, EngineConfig(**e["ecfg"]), mesh=mesh)
            K.reset_launch_counts()
            TP.reset_collective_counts()
            t0 = time.perf_counter()
            res = eng.run([Request(uid=i, prompt=p, max_new_tokens=e["new"]) for i, p in enumerate(e["prompts"])])
            sync(dev)
            r["engine_s"] = time.perf_counter() - t0
            r["engine_tokens"] = {u: c.tokens for u, c in res.items()}
            r["engine_launches"] = K.launch_counts()
            r["engine_collectives"] = TP.collective_counts()
            r["engine_stats"] = eng.stats()
            r["engine_margins"] = {u: tp_first_diff_margin(params, cfg, e["prompts"][u], r["engine_tokens"][u], ref,
                                                           dev, mesh) for u, ref in e["ref"].items()}
            del eng
        out[name] = r
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def tp_rank(root: str, rank: int, world: int, port: int, jobs: list, q) -> None:
    """One rank of phase 13, a process of its own on the job's device (the
    parent's card, shared by every rank; started by torch.multiprocessing
    with spawn): join the job over TCP, then for each job build a mesh of
    its shape (gloo: the ranks share the card) and run :func:`tp_job`.
    Puts (rank, [results]) or (rank, the traceback)."""
    import traceback

    try:
        sys.path.insert(0, root)
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        from torch_bnb_fp4_tpu_torch import parallel as PP

        PP.init_multihost(f"127.0.0.1:{port}", world, rank)
        outs = []
        for job in jobs:
            mesh = PP.make_mesh(n_model=job["tp"], n_data=world // job["tp"], device=job["device"])
            outs.append(dict(tp_job(mesh, job), backend=mesh.backend))
        # pickled here: the queue would share tensors by file descriptors, gone when this process exits
        q.put((rank, pickle.dumps(outs)))
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001 - sent to the parent, which prints it and fails the phase
        q.put((rank, traceback.format_exc()))


def run_ranks(root: Path, world: int, jobs: list, tag: str) -> list:
    """Start ``world`` ranks of :func:`tp_rank` and collect their results; a
    rank that reports an error, exits non-zero or does not answer within 600
    s fails the phase with its output printed."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=tp_rank, args=(str(root), r, world, port, jobs, q)) for r in range(world)]
    for p in procs:
        p.start()
    res = {}
    t0 = time.perf_counter()
    try:
        while len(res) < world and time.perf_counter() - t0 < 600:
            try:
                rank, out = q.get(timeout=5)
                res[rank] = out if isinstance(out, str) else pickle.loads(out)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break  # a rank died without reporting
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for rank in range(world):
        if isinstance(res.get(rank), str):
            print(f"{tag} rank {rank} failed:\n{res[rank]}", file=sys.stderr)
    check(all(not isinstance(res.get(r), str) and r in res for r in range(world)),
          f"{tag} ranks {sorted(set(range(world)) - {r for r, v in res.items() if not isinstance(v, str)})} failed "
          f"or did not answer")
    check(all(p.exitcode == 0 for p in procs), f"{tag} rank exit codes {[p.exitcode for p in procs]}")
    return [res[r] for r in range(world)]


def hold_logits(tag, ref_rows, rows, lim=(6e-2, 3e-2)) -> tuple[float, float]:
    """Every call's logits within ``lim`` (max|d| of max|logit|, rel L2) of
    the tp = 1 run's; returns the worst (max|d| / max, rel L2)."""
    worst_d = worst_rel = 0.0
    for s, (g, e) in enumerate(zip(ref_rows, rows)):
        d, rel = (e - g).abs().max().item(), ((e - g).norm() / g.norm()).item()
        check(bool(e.isfinite().all()), f"{tag} call {s}: non-finite logits")
        check(d <= lim[0] * g.abs().max().item() and rel <= lim[1], f"{tag} call {s}: max|d| {d}, rel L2 {rel}")
        worst_d, worst_rel = max(worst_d, d / g.abs().max().item()), max(worst_rel, rel)
    return worst_d, worst_rel


def start_rank_clis(root: Path, args, world: int, tag: str):
    """The CLI as ``world`` processes with --multihost --coordinator on a free
    port (RANK / WORLD_SIZE in each one's environment), each on cuda:0:
    (processes, rank 0's URL, seconds to its serving line, log paths)."""
    import os

    port = free_port()
    logs = [root / "build" / f"chip_smoke_tp_{tag}_rank{r}.log" for r in range(world)]
    procs = []
    t0 = time.perf_counter()
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world))
        with open(logs[r], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torch_bnb_fp4_tpu_torch.serve", "--port", "0", "--multihost", "--coordinator",
                 f"127.0.0.1:{port}", *args], cwd=root, env=env, stderr=err,
                stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL, text=True))
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in procs[0].stdout], daemon=True).start()
    try:
        line = lines.get(timeout=600)
    except queue.Empty:
        line = ""
    if not line.startswith("serving on http://"):
        for p in procs:
            p.kill()
            p.wait()
        for r, lp in enumerate(logs):
            print(f"[13d] rank {r} log (tail):\n" + lp.read_text()[-3000:], file=sys.stderr)
        check(False, f"[13d] {tag}: rank 0 printed {line!r}")
    return procs, line.split()[-1], time.perf_counter() - t0, logs


def stop_rank_clis(procs, logs, tag: str) -> None:
    """SIGINT to rank 0: its stop() releases the followers; every rank must
    exit 0 (killed after 120 s)."""
    procs[0].send_signal(signal.SIGINT)
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=120))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    if any(rcs):
        for r, lp in enumerate(logs):
            print(f"[13d] rank {r} log (tail):\n" + lp.read_text()[-3000:], file=sys.stderr)
    check(rcs == [0] * len(procs), f"[13d] {tag}: exit codes {rcs} after stop()")


def tp_kernel_rows(dev, launches: dict) -> list:
    """Phase 13's local shapes of K2-K5, K8 and K9b, per layer (or expert):
    each kernel against its plain version on the card at K2/K3's tolerance
    (2^-7 of max), one bf16 ulp for K4/K5/K8-K4, K9b's 2^-7, timed by graph
    replay cycling weight copies past the L2; the plain version timed
    eagerly.  Returns the kernel-table rows, ``launches`` per instance being
    the per-rank counts of the run that makes it."""
    import torch

    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.utils import profiling as P

    gen = torch.Generator(device=dev)
    e_idx = torch.arange(MOE_EXPERTS, dtype=torch.int32, device=dev)
    fp4_table = K.code_table(None, dev)
    meta = {"K2": ("matmul_pk", "matmul_pk.cu", 655), "K3": ("matmul_pk_minner", "matmul_pk_minner.cu", 702),
            "K4": ("matmul_pk_w4a8", "matmul_pk_w4a8.cu", 750), "K5": ("matmul_w8", "matmul_w8.cu", 813),
            "K8/K2": ("matmul_pk_expert", "matmul_pk.cu", 1295),
            "K8/K4": ("matmul_pk_w4a8_expert", "matmul_pk_w4a8.cu", 1215),
            "K9b": ("matmul_splitk", "matmul_splitk.cu", 322)}
    instances = (("K2", 1, TP2_FUSED, "a", "Mistral-7B tp=2, the 4 fused matmuls of one layer"),
                 ("K3", 160, TP2_FUSED, "a", "Mistral-7B tp=2, the 4 fused matmuls of one layer"),
                 ("K4", 300, TP2_FUSED, "a", "Mistral-7B tp=2, the 4 fused matmuls of one layer"),
                 ("K5", 320, TP2_UNFUSED, "d", "Mistral-7B tp=2 served, the 7 unfused matmuls of one layer"),
                 ("K8/K2", 1, TP2_EXPERT, "c", "Mixtral-8x7B tp=2, gate|up and down of one expert"),
                 ("K8/K4", 300, TP2_EXPERT, "c", "Mixtral-8x7B tp=2, gate|up and down of one expert"),
                 ("K9b", 1, TP4_SPLITK_70B, "b", "split-K Llama-2-70B tp=4, the 7 unfused matmuls of one layer"),
                 ("K9b", 300, TP4_SPLITK_70B, "b", "split-K Llama-2-70B tp=4, the 7 unfused matmuls of one layer"))
    rows = []
    print("[13] local-shape kernel instances (per layer or expert; us: CUDA-graph replay, plain: eager on the card)")
    for kname, m, shapes, run, what in instances:
        tot = dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0, err=0.0)
        for sname, k, n, count in shapes:
            gen.manual_seed(k + n + m)
            lead = (MOE_EXPERTS,) if kname.startswith("K8") else ()
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            if kname == "K9b":
                w_bytes = k * n // 2 + 2 * (k // 128) * n * 4
                copies = max(1, math.ceil(2.5 * L2_BYTES / w_bytes))
                ws = [(torch.randint(0, 256, (k // 2, n), generator=gen, dtype=torch.uint8, device=dev),
                       tuple((torch.rand((k // 128, n), generator=gen, device=dev) + 0.5) * 0.01 for _ in range(2)))
                      for _ in range(copies)]

                def call(i, x=x, ws=ws):
                    return K.matmul_fp4(x, ws[i][0], ws[i][1])

                def plain(x=x, ws=ws):
                    return K.matmul_splitk_plain(x, ws[0][0], *ws[0][1], None, fp4_table, out_dtype=x.dtype)

                bnd_bytes = w_bytes + m * k * 2 + m * n * 2
                tol = 2.0**-7
            else:
                w_bytes = k * n // 2 + (k // 64) * n * 4
                copies = 1 if lead else max(1, math.ceil(2.5 * L2_BYTES / w_bytes))
                ws = [(torch.randint(0, 256, (*lead, k // 2, n), generator=gen, dtype=torch.uint8, device=dev),
                       (torch.rand((*lead, k // 64, n), generator=gen, device=dev) + 0.5) * (0.01 / 192.0))
                      for _ in range(copies)]
                ex = dict(expert=None)
                if kname in ("K4", "K8/K4", "K5"):
                    bk = 1024 if kname == "K5" else K.a8_block_k(k, torch.float32)
                    x8, rs = K.quantize_activations(x, bk)
                    x_bytes = x8.numel() + rs.numel() * 4
                if kname == "K5":
                    sh = [K.make_int8_shadow(w[0], w[1], variant="ramp", block_k=bk) for w in ws]

                    def call(i, x8=x8, rs=rs, sh=sh):
                        return K.matmul_w8_int8(x8, rs, sh[i][0], sh[i][1], out_dtype=torch.bfloat16, block_k=bk)

                    def plain(x8=x8, rs=rs, sh=sh):
                        return K.matmul_w8_plain(x8, rs, sh[0][0], sh[0][1], out_dtype=torch.bfloat16, block_k=bk)

                    bnd_bytes = k * n + (k // bk) * n * 4 + x_bytes + m * n * 2
                elif kname in ("K4", "K8/K4"):
                    kw = dict(out_dtype=torch.bfloat16, variant="ramp", a8_block_k=bk)

                    def call(i, x8=x8, rs=rs, ws=ws, kw=kw):
                        if lead:
                            return K.matmul_pk_w4a8(x8, rs, ws[0][0], ws[0][1], expert=e_idx[i], **kw)
                        return K.matmul_pk_w4a8(x8, rs, ws[i][0], ws[i][1], **kw)

                    def plain(x8=x8, rs=rs, ws=ws, kw=kw):
                        return K.matmul_pk_w4a8_plain(x8, rs, ws[0][0], ws[0][1], expert=e_idx[0] if lead else None,
                                                      **kw)

                    bnd_bytes = w_bytes + x_bytes + m * n * 2
                else:
                    fn, fn_plain = ((K.matmul_pk, K.matmul_pk_plain) if kname in ("K2", "K8/K2") else
                                    (K.matmul_pk_minner, K.matmul_pk_minner_plain))

                    def call(i, x=x, ws=ws, fn=fn):
                        if lead:
                            return fn(x, ws[0][0], ws[0][1], expert=e_idx[i], variant="ramp")
                        return fn(x, ws[i][0], ws[i][1], variant="ramp")

                    def plain(x=x, ws=ws, fn_plain=fn_plain):
                        return fn_plain(x, ws[0][0], ws[0][1], expert=e_idx[0] if lead else None, variant="ramp")

                    bnd_bytes = w_bytes + m * k * 2 + m * n * 2
                tol = None if kname in ("K4", "K8/K4", "K5") else 2.0**-7
            y, y_ref = call(0).float(), plain().float()
            torch.cuda.synchronize()
            d = (y - y_ref).abs()
            check(bool(torch.isfinite(y).all()), f"[13] {kname} {sname} M={m}: non-finite output")
            if tol is None:
                ulp = torch.exp2(torch.floor(torch.log2(y_ref.abs().clamp_min(1e-30))) - 7)
                check(bool((d <= ulp * 1.0001).all()), f"[13] {kname} {sname} M={m}: off by more than one bf16 ulp")
            else:
                check(d.max().item() <= tol * y_ref.abs().max().item(), f"[13] {kname} {sname} M={m}: err {d.max()}")
            n_cyc = MOE_EXPERTS if lead else copies
            state = {"i": 0}

            def cyc(call=call, n_cyc=n_cyc):
                state["i"] = (state["i"] + 1) % n_cyc
                return call(state["i"])

            ms = P.time_graph(cyc, rep=50 if m < 64 else 20) * 1e3
            plain_ms = P.time_fn(plain, rep=2, warmup=1) * 1e3
            print(f"    {kname:6} {sname:12} M={m:4} {ms * 1e3:9.1f} us  plain {plain_ms:8.2f} ms  max|d| {d.max().item():.3g}"
                  + (f"  (x{count})" if count > 1 else ""))
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bytes"] += count * bnd_bytes
            tot["ops"] += count * 2 * m * k * n
            tot["err"] = max(tot["err"], d.max().item())
            del x, ws, y, y_ref
            torch.cuda.empty_cache()
        bnd, by = P.bound_s(tot["bytes"], tot["ops"], P.H100_INT8_OPS if kname in ("K4", "K5", "K8/K4")
                            else P.H100_BF16_FLOPS)
        wrapper, src, line = meta[kname]
        rows.append(dict(
            name=f"{kname} {wrapper} (M={m}, {what}, a rank's local shapes; launches per rank of phase 13{run})",
            route="cuda", source=f"torch_bnb_fp4_tpu_torch/csrc/{src}", replaces=f"torch_bnb_fp4_tpu/ops/kernels.py:{line}",
            launches=launches[run][wrapper], max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=bnd * 1e3, bound_by=by, library_ms=None))
    return rows


def phase13(root: Path, dev, smi: str) -> list:
    """Phase 13: tensor parallelism and multi-process serving with every rank
    a process on this one card (the module docstring lists its parts).
    Returns the kernel-table rows of its local shapes."""
    import torch

    from torch_bnb_fp4_tpu_torch.convert import load_checkpoint, save_checkpoint
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.models.linear import attach_prefill_shadow
    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

    t_phase = time.perf_counter()
    label = f"ranks sharing one card over gloo, not a TP speed; {smi}"
    g = torch.Generator().manual_seed(13)
    launches = {}
    empty = torch.cuda.empty_cache if dev.type == "cuda" else (lambda: None)
    empty()

    # (a) Mistral-7B at full width and depth, tp = 2; (c) Mixtral at 2 layers, tp = 2 (one job of two ranks)
    t_sub = time.perf_counter()
    cfg_a = T.ModelConfig.mistral_7b()
    cfg_c = dataclasses.replace(T.ModelConfig.mixtral_8x7b(), n_layers=MIXTRAL_TP_LAYERS)
    prompts_a = [torch.randint(0, cfg_a.vocab_size, (n,), generator=g).tolist() for n in TP_A_FORWARD]
    prompts_e = [torch.randint(0, cfg_a.vocab_size, (n,), generator=g).tolist() for n in TP_A_PROMPTS]
    prompts_c = [torch.randint(0, cfg_c.vocab_size, (300,), generator=g).tolist()]
    ecfg = dict(max_batch=4, max_len=512, inner_steps=8)
    full = synth_params(cfg_a, seed=13, fuse=True, device=dev)
    ref_a = tp_forwards(full, cfg_a, prompts_a, None, dev)
    eng = Engine(full, cfg_a, EngineConfig(**ecfg))
    ref_eng = {u: c.tokens for u, c in eng.run([Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                                                 for i, p in enumerate(prompts_e)]).items()}
    del eng
    full_c = synth_params(cfg_c, seed=16, fuse=True, device=dev)
    routes_c, undo = tp_routes(T)
    ref_c = tp_forwards(full_c, cfg_c, prompts_c, None, dev, steps=2)
    undo()
    sync(dev)
    print(f"[13a] tp = 1 references on the card: Mistral-7B forwards (prompts {TP_A_FORWARD}, {TP_DECODE_STEPS} decode "
          f"steps each; eager step {ref_a['step_ms']:.2f} ms), its engine ({len(prompts_e)} requests), Mixtral "
          f"{MIXTRAL_TP_LAYERS} layers; {time.perf_counter() - t_sub:.1f} s")
    jobs = [dict(kind="mistral", tp=2, device=str(dev), cfg=cfg_a, builds=[("pairk", dict(seed=13, fuse=True))], prompts=prompts_a,
                 forced={"pairk": ref_a["tokens"]}, steps=TP_DECODE_STEPS,
                 engine=dict(ecfg=ecfg, new=NEW_TOKENS, prompts=prompts_e, ref=ref_eng)),
            dict(kind="mixtral", tp=2, device=str(dev), cfg=cfg_c, builds=[("pairk", dict(seed=16, fuse=True))], prompts=prompts_c,
                 forced={"pairk": ref_c["tokens"]}, steps=2)]
    del full_c  # the Mistral reference stays for the near-tie margins of the engine's tokens
    empty()
    t0 = time.perf_counter()
    ranks = run_ranks(root, 2, jobs, "[13a/c]")
    print(f"[13a/c] 2 ranks on {dev} ({ranks[0][0]['backend']} groups) ran in {time.perf_counter() - t0:.1f} s")
    for r, outs in enumerate(ranks):
        a, c = outs[0]["pairk"], outs[1]["pairk"]
        worst = [hold_logits(f"[13a] rank {r} {n}-token prompt", ref_a["logits"][i], a["logits"][i])
                 for i, n in enumerate(TP_A_FORWARD)]
        check(a["ar_per_step"] == 2 * cfg_a.n_layers, f"[13a] rank {r}: {a['ar_per_step']} all-reduces per decode step")
        ln = {k: a["launches"][w] + a["engine_launches"][w] for k, w in (("K2", "matmul_pk"), ("K3", "matmul_pk_minner"),
                                                                         ("K4", "matmul_pk_w4a8"))}
        check(all(v > 0 for v in ln.values()), f"[13a] rank {r}: launches {ln}")
        launches.setdefault("a", {w: a["launches"][w] + a["engine_launches"][w] for w in a["launches"]})
        print(f"[13a] rank {r}: shard built in {a['build_s']:.1f} s, {a['gib']:.2f} GiB on the card; logits vs tp = 1 "
              f"worst max|d| {max(w[0] for w in worst):.4g} of max, rel L2 {max(w[1] for w in worst):.3g} (300-row "
              f"prefill: K4; 160: K3; decode: K2); {a['ar_per_step']} all-reduces per decode step "
              f"(2 x {cfg_a.n_layers} layers); launches K2 {ln['K2']}, K3 {ln['K3']}, K4 {ln['K4']}; decode step "
              f"{a['step_ms']:.2f} ms eager, of which its all-reduces alone {a['ar_ms_per_step']:.2f} ms ({label})")
        same = 0
        for u, ref in ref_eng.items():
            got, mg = a["engine_tokens"][u], a["engine_margins"][u]
            check(len(got) == NEW_TOKENS, f"[13a] rank {r} request {u}: {len(got)} tokens")
            if mg is None:
                same += 1
                continue
            j, m_tp, tie = mg
            _, m_ref, tie_ref = tp_first_diff_margin(full, cfg_a, prompts_e[u], ref, got, dev)
            check(m_tp <= tie and m_ref <= tie_ref,
                  f"[13a] rank {r} request {u}: first difference at {j} is no near-tie ({m_tp}, {m_ref})")
            print(f"[13a] rank {r} request {u}: first difference from the tp = 1 engine at token {j}, a near-tie "
                  f"(each run's winner leads by {m_ref:.4g} / {m_tp:.4g} in its own logits, limits {tie_ref:.4g} / "
                  f"{tie:.4g})")
        check(outs[0]["pairk"]["engine_tokens"] == ranks[0][0]["pairk"]["engine_tokens"],
              "[13a] the ranks' engines disagree")
        st = a["engine_stats"]
        print(f"[13a] rank {r}: engine at tp = 2, {same}/{len(ref_eng)} requests equal to the tp = 1 engine's tokens; "
              f"{st['decode_steps']} decode steps, {st['step_p50_s'] * 1e3:.1f} ms/step p50 (eager, {label}); "
              f"all-reduces {a['engine_collectives']['all_reduce']}, gathers {a['engine_collectives']['all_gather']}")
        # (c) Mixtral: logits and routing
        worst = hold_logits(f"[13c] rank {r}", ref_c["logits"][0], c["logits"][0])
        check(len(c["routes"]) == len(routes_c), f"[13c] rank {r}: {len(c['routes'])} MoE calls")
        flips = total = 0
        for pr, pt in zip(routes_c, c["routes"]):
            ti_r = torch.topk(pr, cfg_c.experts_per_tok, dim=-1).indices.sort(dim=-1).values
            ti_t = torch.topk(pt, cfg_c.experts_per_tok, dim=-1).indices.sort(dim=-1).values
            diff = (ti_r != ti_t).any(dim=-1)
            srt = pr.sort(dim=-1, descending=True).values
            margin = srt[:, cfg_c.experts_per_tok - 1] - srt[:, cfg_c.experts_per_tok]
            check(bool((margin[diff] < 1e-2).all()), f"[13c] rank {r}: a routing difference that is no near-tie")
            flips += int(diff.sum())
            total += diff.numel()
        check(flips <= 0.01 * total, f"[13c] rank {r}: {flips} of {total} routing decisions differ")
        k8 = {w: c["launches"][w] for w in ("matmul_pk_expert", "matmul_pk_w4a8_expert")}
        check(all(v > 0 for v in k8.values()), f"[13c] rank {r}: K8 launches {k8}")
        launches.setdefault("c", c["launches"])
        print(f"[13c] rank {r}: Mixtral {MIXTRAL_TP_LAYERS} layers at tp = 2: logits vs tp = 1 worst max|d| "
              f"{worst[0]:.4g} of max, rel L2 {worst[1]:.3g}; routing {flips}/{total} decisions differ (near-ties); "
              f"K8 launches {k8}; {c['ar_per_step']} all-reduces per decode step")
    del full
    empty()
    print(f"[13a/c] {time.perf_counter() - t_sub:.1f} s")

    # (b) Llama-2-70B at full width, 4 layers, tp = 4: pair-K fused, then split-K (K9b on the shards in place)
    t_sub = time.perf_counter()
    cfg_b = dataclasses.replace(T.ModelConfig.llama2_70b(), n_layers=LLAMA70_LAYERS)
    prompts_b = [torch.randint(0, cfg_b.vocab_size, (300,), generator=g).tolist()]
    builds = [("pairk", dict(seed=14, fuse=True)), ("splitk", dict(seed=15, layout="splitk"))]
    refs_b = {}
    for name, kw in builds:
        full = synth_params(cfg_b, tp=4 if name == "splitk" else 1, device=dev, **kw)
        refs_b[name] = tp_forwards(full, cfg_b, prompts_b, None, dev, steps=2)
        del full
        empty()
    ranks = run_ranks(root, 4, [dict(kind="llama70", tp=4, device=str(dev), cfg=cfg_b, builds=builds, prompts=prompts_b,
                                     forced={n: refs_b[n]["tokens"] for n, _ in builds}, steps=2)], "[13b]")
    for r, outs in enumerate(ranks):
        for name, _ in builds:
            b = outs[0][name]
            worst = hold_logits(f"[13b] rank {r} {name}", refs_b[name]["logits"][0], b["logits"][0])
            check(b["ar_per_step"] == 2 * cfg_b.n_layers, f"[13b] rank {r} {name}: {b['ar_per_step']} all-reduces")
            w = "matmul_splitk" if name == "splitk" else "matmul_pk_w4a8"
            check(b["launches"][w] > 0, f"[13b] rank {r} {name}: {w} never launched")
            if name == "splitk":
                launches.setdefault("b", b["launches"])
            print(f"[13b] rank {r} {name}: shard {b['gib']:.2f} GiB; logits vs tp = 1 worst max|d| {worst[0]:.4g} of "
                  f"max, rel L2 {worst[1]:.3g}; {b['ar_per_step']} all-reduces per decode step; {w} launches "
                  f"{b['launches'][w]}; decode step {b['step_ms']:.2f} ms eager, all-reduces alone "
                  f"{b['ar_ms_per_step']:.2f} ms ({label})")
    print(f"[13b] Llama-2-70B geometry, {LLAMA70_LAYERS} layers, tp = 4 (row-parallel K 2048 and 7168, 2 KV heads per "
          f"rank), pair-K and split-K: {time.perf_counter() - t_sub:.1f} s")

    # (d) the CLI: two ranks serve a 4-layer checkpoint, --tp 2, then --tp 1 (data 2)
    t_sub = time.perf_counter()
    ckpt = root / "build" / "chip_smoke_tp_ckpt"
    cfg_d = dataclasses.replace(T.ModelConfig.mistral_7b(), n_layers=TP_CLI_LAYERS)
    try:
        save_checkpoint(str(ckpt), cfg_d, synth_params(cfg_d, seed=17, device=dev))
        _, pd = load_checkpoint(str(ckpt), device=dev)
        pd = attach_prefill_shadow(pd)
        prompts_d = [torch.randint(0, cfg_d.vocab_size, (n,), generator=g).tolist() for n in TP_CLI_PROMPTS]
        eng = Engine(pd, cfg_d, EngineConfig(max_batch=4, max_len=512, inner_steps=8))
        ref_d = {u: c.tokens for u, c in eng.run([Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                                                   for i, p in enumerate(prompts_d)]).items()}
        del eng
        args = ["--ckpt", str(ckpt), "--prefill-shadow", "--max-batch", "4", "--max-len", "512"]
        args += [] if dev.type == "cuda" else ["--device", "cpu"]  # the CPU only in a rehearsal
        for tp in ("2", "1"):
            procs, url, up_s, logs = start_rank_clis(root, args + ["--tp", tp], 2, f"tp{tp}")
            try:
                got = [http_post(url, dict(prompt=p, max_tokens=NEW_TOKENS))["tokens"] for p in prompts_d]
                box = {}

                def on_event(ev, box=box, url=url):
                    if "uid" in ev and "abort" not in box:
                        box["abort"] = http_post(url, {"uid": ev["uid"]}, "/v1/abort")

                events = http_stream(url, dict(prompt=prompts_d[0], max_tokens=400), on_event)
                stats = http_get(url, "/v1/stats")
            finally:
                if procs[0].poll() is None:
                    stop_rank_clis(procs, logs, f"tp{tp}")
            check(box.get("abort", {}).get("aborted") is True and events[-1]["done"]["finish_reason"] == "abort",
                  f"[13d] tp {tp}: the abort did not land ({box}, {events[-1]})")
            check(stats["launches"]["matmul_w8"] > 0, f"[13d] tp {tp}: K5 never launched on rank 0")
            launches.setdefault("d", stats["launches"])
            notes = []
            for u, (p, want) in enumerate(zip(prompts_d, [ref_d[i] for i in range(len(prompts_d))])):
                mg = tp_first_diff_margin(pd, cfg_d, p, want, got[u], dev)
                if mg is None:
                    notes.append(f"{len(want)}/{len(want)} equal")
                    continue
                j, m_ref, tie = mg
                check(m_ref <= tie, f"[13d] tp {tp} request {u}: differs at {j}, margin {m_ref} > {tie}")
                notes.append(f"first difference at {j}, a near-tie in the tp = 1 logits ({m_ref:.4g} <= {tie:.4g})")
            print(f"[13d] CLI --multihost --tp {tp} (data {2 // int(tp)}) on {TP_CLI_LAYERS} layers: serving line after "
                  f"{up_s:.1f} s; HTTP tokens vs the in-process tp = 1 engine: {'; '.join(notes)}; abort landed; K5 "
                  f"{stats['launches']['matmul_w8']} launches on rank 0; both ranks exited 0 after stop()")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        empty()
    print(f"[13d] {time.perf_counter() - t_sub:.1f} s")

    rows = tp_kernel_rows(dev, launches)
    print(f"[13] phase 13: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return rows


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
    # (f) case (a)'s shape over an fp8 KV cache: bf16 q, e4m3 K/V (K7's fp8 form); beside case (a), replayed
    case, what, b, lq, lk, hq, hk, d, lens, q_off, window, cap, scale = FLASH_CASES[0]
    q, k, v, qpos, valid, kpos = synth_attention(b, lq, lk, hq, hk, d, lens=lens, q_offset=q_off, seed=lq + lk + d,
                                                 device=dev)
    k8, v8 = T.kv_cast(k, torch.float8_e4m3fn), T.kv_cast(v, torch.float8_e4m3fn)
    ops8 = (q, k8, v8, qpos, valid, kpos)
    split = A.kernel_split(b, lq, lk, hq, hk, K._sm_count(dev), d)
    before = K.launch_counts()
    got = A.flash_attention(*ops8, window, scale, cap)
    check(K.launch_counts()["flash_attention_fp8"] == before["flash_attention_fp8"] + 1
          and K.launch_counts()["flash_attention"] == before["flash_attention"], "K7 case f: the fp8 form did not launch")
    plain = lambda: A.flash_attention_plain(*ops8, window, scale, cap,  # noqa: E731
                                            block_q=A.kernel_blocks(hq, hk, d)[0], block_k=A.BLOCK_K, split=split)
    want = plain()
    torch.cuda.synchronize()
    (err, row_err), ref_max = attention_err(got, want), want.float().abs().max().item()
    check(bool(torch.isfinite(got).all()) and got.dtype == torch.bfloat16, "K7 case f: non-finite or not bf16")
    check(row_err <= 2.0**-7, f"K7 case f: |do| / max|o| of its row reaches {row_err} > 2^-7")
    ms_a, ms, ms_a2 = (device_ms(lambda o=o: A.flash_attention(*o, window, scale, cap), rep=10)
                       for o in ((q, k, v, qpos, valid, kpos), ops8, (q, k, v, qpos, valid, kpos)))
    plain_ms = timed(plain, rep=2)
    mask = T.attention_mask(qpos, kpos, valid, window)
    # the yardstick: SDPA takes no e4m3 K/V beside a bf16 q, so it runs on K/V widened to bf16 (timed only)
    kw, vw = k8.to(torch.bfloat16), v8.to(torch.bfloat16)
    sdpa_ms = device_ms(lambda: sdpa(q, kw, vw, mask, scale), rep=10)
    pairs = P.visible_pairs(qpos, valid, kpos, window)
    bnd, by = P.attention_bound_s(q, k8, pairs)
    flash_rows["f"] = dict(what=what + ", e4m3 K/V", ms=ms, plain_ms=plain_ms, library_ms=None,
                           sdpa_widened_ms=sdpa_ms, bound_ms=bnd * 1e3, bound_by=by, max_abs_err=err,
                           row_err=row_err, pairs=pairs, split=split, bf16_ms=(ms_a + ms_a2) / 2)
    print(f"     (f)  {ms * 1e3:8.1f} {bnd * 1e6:9.1f}  {by:10} {plain_ms:9.1f}          -  {sdpa_ms * 1e3:10.1f}"
          f"          -   {err:.3g} ({ref_max:.3g}; {row_err:.3g})   case (a) with e4m3 K/V (K7's fp8 form): beside "
          f"case (a) in turns {ms_a * 1e3:.1f} / {ms_a2 * 1e3:.1f} us; sdpa_us on K/V widened to bf16 (no library "
          f"call takes e4m3 K/V beside a bf16 q); split {split}")
    del q, k, v, k8, v8, kw, vw, ops8, got, want, mask
    # the fp8 KV write cast (models.transformer.kv_cast): the same byte on the card and on the CPU for every
    # bf16 bit pattern
    x16 = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    cast_card = T.kv_cast(x16.to(dev), torch.float8_e4m3fn).view(torch.uint8).cpu()
    cast_cpu = T.kv_cast(x16, torch.float8_e4m3fn).view(torch.uint8)
    check(torch.equal(cast_card, cast_cpu), f"fp8 KV cast: {int((cast_card != cast_cpu).sum())} of 65536 bf16 "
                                            "patterns give another byte on the card than on the CPU")
    print("[3b] fp8 KV write cast (kv_cast): all 65536 bf16 bit patterns give the same e4m3 byte on the card as on "
          "the CPU")
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

    # -- phase 3f: K10 decode attention -------------------------------------------------------------
    decode_rows = phase3f(dev)

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
    # every decode graph captured before the counts start: the run's decode steps are all replays, each of
    # which counts its captured launches (a capture's eager run would count launches of no decode step)
    eng.warmup(prompt_lens=PROMPTS)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k10_launches = K.launch_counts()["decode_attention"]
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
    for name in ("matmul_pk", "matmul_pk_minner", "matmul_pk_w4a8", "decode_attention"):
        check(launches[name] > 0, f"main path never launched {name}")
    check(st["decode_steps"] > 0 and k10_launches == cfg.n_layers * st["decode_steps"],
          f"K10: {k10_launches} launches over the engine's {st['decode_steps']} decode steps, not {cfg.n_layers} "
          f"per step")
    # generate's NEW_TOKENS - 1 eager decode steps; its prefill (Lq > 1) takes another route
    check(launches["decode_attention"] - k10_launches == cfg.n_layers * (NEW_TOKENS - 1),
          f"K10: {launches['decode_attention'] - k10_launches} launches in generate's {NEW_TOKENS - 1} decode steps")
    print(f"[5] K10 in the engine run: {k10_launches} launches over {st['decode_steps']} decode steps = "
          f"{k10_launches // st['decode_steps']} per step ({cfg.n_layers} layers)")
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
    cache_rows = sorted({a.shape[1] for a in eng.cache.k + eng.cache.v + eng._pcache.k + eng._pcache.v})
    check(cache_rows == [4352], f"ring engine: cache and prefill cache rows {cache_rows}, want 4352 on every layer")
    interleaved = 0
    with Recorder(T, eng) as rec:
        t0 = time.perf_counter()
        warm6 = eng.warmup(prompt_lens=[LONG_PROMPTS[0]])  # every chunk width and row count, whatever the lengths
        warm6_s = time.perf_counter() - t0
        graphs6 = sorted(k[1:3] for k in eng._graphs if k[0] == "chunk")
        widths6 = sorted({w for w, _ in graphs6})
        check(widths6 == list(range(32, 257, 32)) and set(graphs6) == eng._chunk_keys(),
              f"phase 6: warmup captured chunk graphs {graphs6}, want {sorted(eng._chunk_keys())}")
        for r in long_reqs:
            eng.submit(r)
        K.reset_launch_counts()
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
    n_chunks6 = sum(-(-((lp + 31) // 32 * 32) // ecfg6.prefill_chunk) for lp in LONG_PROMPTS)
    check(eng.traces == warm6, f"phase 6: serving after warmup() added programs: {warm6} -> {eng.traces}")
    check(st6["prefill_chunks_eager"] == 0 and st6["prefill_chunks_graphed"] == n_chunks6,
          f"phase 6: chunks graphed {st6['prefill_chunks_graphed']}, eager {st6['prefill_chunks_eager']}; want "
          f"{n_chunks6} and 0")
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
    ring_lg = rec.logits(big, NEW_TOKENS)
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
    print(f"[6] warmup(prompt_lens=[{LONG_PROMPTS[0]}]) in {warm6_s:.1f} s: {len(graphs6)} chunk graphs of widths "
          f"{widths6} over rows {sorted({r[0] for _, r in graphs6})}, traces {warm6}; serving added none; "
          f"{st6['prefill_chunks_graphed']} chunks replayed, {st6['prefill_chunks_eager']} eager")
    cr = chunk_replay_vs_eager(eng)
    print(f"[6] one {cr['width']}-row chunk at position {cr['at']} of the prefill ring (rows {cr['rows']}), medians "
          f"of 8 in turns: graph "
          f"replay issue {cr['graph']['issue_ms']:.3f} ms, wall {cr['graph']['wall_ms']:.2f} ms, device "
          f"{cr['graph']['device_ms']:.2f} ms; eager issue {cr['eager']['issue_ms']:.2f} ms, wall "
          f"{cr['eager']['wall_ms']:.2f} ms, device {cr['eager']['device_ms']:.2f} ms; per run: graph "
          f"{cr['graph']['device_ops']} device ops from {cr['graph']['launch_calls']} launch call(s), eager "
          f"{cr['eager']['device_ops']} from {cr['eager']['launch_calls']}; port kernel launches per replay "
          f"{cr['graph_launches']} ({smi})")
    del eng, rec
    torch.cuda.empty_cache()

    def serve_alone(ecfg_x, label):
        """Serve the 6000-token request alone; returns (tokens, logits, stats, launches)."""
        e = Engine(params, cfg, ecfg_x)
        K.reset_launch_counts()
        with Recorder(T, e) as r:
            t = time.perf_counter()
            out = e.run([Request(uid=big, prompt=long_prompts[big], max_new_tokens=NEW_TOKENS)])[big]
            torch.cuda.synchronize()
            t = time.perf_counter() - t
        stx, lx = e.stats(), K.launch_counts()
        check(len(out.tokens) == NEW_TOKENS, f"{label}: {out}")
        print(f"[6] {label}: cache rows {sorted({a.shape[1] for a in e.cache.k})}, kv_cache_bytes "
              f"{stx['kv_cache_bytes']}, served in {t:.2f} s, TTFT {out.ttft_s * 1e3:.1f} ms, K7 launches "
              f"{lx['flash_attention']}, K4 launches {lx['matmul_pk_w4a8']}")
        return out.tokens, r.logits(big, NEW_TOKENS), stx, lx

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
            with Recorder(T, e) as r:
                t = time.perf_counter()
                out = e.run(reqs7)
                torch.cuda.synchronize()
                t = time.perf_counter() - t
            chunk_ms = [e0.elapsed_time(e1) for uid, n, _, e0, e1 in r.prefill if uid == big7 and n == 256]
            print(f"[7] {label}: served in {t:.2f} s, 4500-token prompt: {len(chunk_ms)} 256-row chunks, "
                  f"{sum(chunk_ms) / len(chunk_ms):.2f} ms mean (min {min(chunk_ms):.2f}, max {max(chunk_ms):.2f}; "
                  f"CUDA events around each chunk forward), TTFT {out[big7].ttft_s * 1e3:.1f} ms")
            return out, r.logits(big7, NEW_TOKENS), sum(chunk_ms) / len(chunk_ms)

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

    def recorded(moe, c, x, force_dense=None, group=None):
        routes.append(torch.softmax(moe.router(x.reshape(-1, x.shape[-1]), out_dtype=torch.float32), -1).cpu())
        y = moe_forward(moe, c, x, force_dense, group=group)
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
    with Recorder(T, eng) as rec:
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
    # long enough that its chunks, graph replays, outlast the abort's round trip: the abort lands mid-prefill
    aborted8 = torch.randint(0, mcfg.vocab_size, (4500,), generator=g8e).tolist()
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
              f"at once, an aborted 4500-token request and a 50-token one; HTTP tokens equal the in-process replay's "
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
    aborted9 = torch.randint(0, cfg.vocab_size, (4500,), generator=g9).tolist()  # as aborted8: lands mid-prefill
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
              f"{startup9:.1f} s; prompts {SPLITK_SERVED_PROMPTS} at once, an aborted 4500-token request and a 50-token "
              f"one; HTTP tokens equal the in-process replay's for all {len(reqs9d)}; server launches "
              f"{json.dumps(cl)}; replay launches {json.dumps(launches9d)}")
        del p9r, shadowed9
    finally:
        shutil.rmtree(ckpt9, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- phase 10: the full serving engine on the Mistral-7B geometry --------------------------------
    t0 = time.perf_counter()
    params = synth_params(cfg, seed=3, fuse=True, device=dev)  # phase 5's weights
    torch.cuda.synchronize()
    print(f"[10] Mistral-7B geometry FP4 params (phase 5's seed) built in {time.perf_counter() - t0:.1f} s")

    def forced_logits(prompt, tokens, p=None, c=None):
        """Eager batch-1 forwards (generate's: the prompt, then one token at a
        time) fed ``tokens``: the last-position logits before each, on the CPU."""
        p, c = params if p is None else p, cfg if c is None else c
        cache = T.KVCache.zeros(c, 1, len(prompt) + len(tokens), device=dev)
        toks, out = torch.tensor([prompt], dtype=torch.int32, device=dev), []
        with torch.no_grad():
            for t in tokens:
                lg, cache = T.forward(p, c, toks, cache, last_only=True)
                out.append(lg[0, -1].float().cpu())
                toks = torch.tensor([[t]], dtype=torch.int32, device=dev)
        return out

    def eager_generate(prompt, n):
        """Batch-1 greedy decode with T.generate's forwards: (tokens, logits before each)."""
        cache = T.KVCache.zeros(cfg, 1, len(prompt) + n, device=dev)
        toks, out, lgs = torch.tensor([prompt], dtype=torch.int32, device=dev), [], []
        with torch.no_grad():
            for _ in range(n):
                lg, cache = T.forward(params, cfg, toks, cache, last_only=True)
                lgs.append(lg[0, -1].float().cpu())
                out.append(int(lgs[-1].argmax()))
                toks = torch.tensor([[out[-1]]], dtype=torch.int32, device=dev)
        return out, lgs

    def near_tie(tag, names, prompt, ref_tokens, tokens):
        """Two greedy runs of one prompt: equal tokens, or at the first
        difference a near-tie in the eager forward's logits fed the reference
        run's tokens (each winner within 2^-7 * max|logit| of the other)."""
        j = next((t for t, (a, b) in enumerate(zip(ref_tokens, tokens)) if a != b), None)
        if j is None:
            check(len(tokens) == len(ref_tokens), f"{tag}: {len(tokens)} tokens, the reference {len(ref_tokens)}")
            return f"{len(tokens)}/{len(tokens)} tokens equal"
        g = forced_logits(prompt, ref_tokens[: j + 1])[j]
        a, b = ref_tokens[j], tokens[j]
        tie = 2.0**-7 * g.abs().max().item()
        margin = (g[a] - g[b]).item()
        check(abs(margin) <= tie, f"{tag}: {names[1]} differs from {names[0]} at token {j}, not a near-tie "
                                  f"(margin {margin} > {tie})")
        return (f"first difference at token {j}: {names[0]} {a} vs {names[1]} {b}, margin {margin:.4g} in the eager "
                f"logits (near-tie limit {tie:.4g})")

    # (a) warmup, then phase 5's prompts through the graphed engine with batch buckets, and one request alone
    ecfg10 = EngineConfig(max_batch=8, max_len=1024, inner_steps=8, batch_buckets=True, logprobs=True)
    eng = Engine(params, cfg, ecfg10)
    reqs10 = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    with Recorder(T, eng) as rec:
        t0 = time.perf_counter()
        warm = eng.warmup(max_prompt_len=max(PROMPTS))
        warm_s = time.perf_counter() - t0
        n_graphs = len(eng._graphs)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res10 = eng.run(reqs10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches10 = K.launch_counts()
        st10 = eng.stats()
        eng.step_times.clear()
        alone = eng.run([Request(uid=100, prompt=prompts[0], max_new_tokens=NEW_TOKENS)])[100]
        alone_ms = float(np.percentile(np.asarray(eng.step_times), 50)) * 1e3
        alone_batch = eng.stats()["decode_batch"]
    check(eng.traces == warm, f"[10a] serving after warmup() added programs: {warm} -> {eng.traces}")
    check(alone_batch == 1 and st10["decode_batch"] == 8, f"[10a] buckets {st10['decode_batch']}, alone {alone_batch}")
    for name in ("matmul_pk", "matmul_pk_minner", "matmul_pk_w4a8"):
        check(launches10[name] > 0, f"[10a] the engine never launched {name}")
    check(launches10["matmul_pk"] >= st10["decode_steps"] * 4 * cfg.n_layers,
          f"[10a] {launches10['matmul_pk']} K2 launches for {st10['decode_steps']} graph-replayed decode steps")
    print(f"[10a] warmup(max_prompt_len={max(PROMPTS)}) in {warm_s:.1f} s: {n_graphs} decode graphs captured (batch "
          f"buckets 1-8 x depths 1-8), traces {warm}; serving added none")
    print(f"[10a] graphed engine served prompts {PROMPTS} ({NEW_TOKENS} new tokens each) in {wall:.2f} s: "
          f"{st10['tok_per_s']:.1f} tok/s, mean TTFT {st10['mean_ttft_s'] * 1e3:.1f} ms, decode "
          f"{st10['step_p50_s'] * 1e3:.2f} ms/step p50 at batch {st10['decode_batch']} (phase 5: eager engine "
          f"{st['step_p50_s'] * 1e3:.2f}, the batch-8 step on the card alone {eng_dev_ms:.3f}); one request alone: "
          f"{alone_ms:.2f} ms/step p50 at batch {alone_batch} (phase 5's batch-1 step on the card alone "
          f"{fp4_dev_ms:.3f}); launches {json.dumps(launches10)}")
    gen10 = {}
    for i, p in enumerate(prompts):
        gen10[i] = eager_generate(p, NEW_TOKENS)
        hold_runs("[10a]", ("eager generate", f"graphed engine (prompt {len(p)})"), gen10[i][1], gen10[i][0],
                  rec.logits(i, NEW_TOKENS), res10[i].tokens)
    check(gen10[0][0] == gen_out[0].tolist(), "[10a] eager generate differs from phase 5's T.generate")
    hold_runs("[10a]", ("eager generate", "graphed engine alone (bucket 1)"), gen10[0][1], gen10[0][0],
              rec.logits(100, NEW_TOKENS), alone.tokens)
    # logprobs: the graphed engine's against log_softmax of its own recorded logits, and the request served alone
    # against log_softmax of eager T.forward on the same rows (a 32-row prefill bucket spliced into a 1024-row
    # cache, then one token at a time at batch 1: what bucket 1 computes)
    lp_err = 0.0
    for i in range(len(prompts)):
        lgs = rec.logits(i, NEW_TOKENS)
        for tok, lp, lg in zip(res10[i].tokens, res10[i].logprobs, lgs):
            lp_err = max(lp_err, abs(lp - torch.log_softmax(lg, -1)[tok].item()))
    p0 = prompts[0]
    lp_pad = eng._bucket(len(p0))
    small = T.KVCache.zeros(cfg, 1, lp_pad, device=dev)
    big = T.KVCache.zeros(cfg, 1, ecfg10.max_len, device=dev)
    padded = torch.zeros((1, lp_pad), dtype=torch.int32)
    padded[0, : len(p0)] = torch.tensor(p0)
    eager_lp = []
    with torch.no_grad():
        lg, small = T.forward(params, cfg, padded.to(dev), small, last_index=len(p0) - 1)
        for a, b_ in zip(big.k + big.v, small.k + small.v):
            a[:, :lp_pad].copy_(b_)
        big = T.KVCache(k=big.k, v=big.v, length=torch.tensor([len(p0)], dtype=torch.int32, device=dev))
        for t in alone.tokens:
            eager_lp.append(torch.log_softmax(lg[0, -1].float(), -1)[t].item())
            lg, big = T.forward(params, cfg, torch.tensor([[t]], dtype=torch.int32, device=dev), big)
    alone_lp_err = max(abs(a - b_) for a, b_ in zip(alone.logprobs, eager_lp))
    check(lp_err <= 1e-3 and alone_lp_err <= 1e-3, f"[10a] logprobs off by {lp_err} (batched) / {alone_lp_err} (alone)")
    print(f"[10a] greedy logprobs: max |lp - log_softmax(logits)[token]| {lp_err:.3g} over the 6 requests (the "
          f"engine's recorded logits), {alone_lp_err:.3g} for the request alone against eager T.forward")
    del rec, small, big
    eng_ms_a = st10["step_p50_s"] * 1e3

    # (b) sampling: two engines with one seed give the same tokens, a third seed others
    scfg = dict(max_batch=8, max_len=1024, inner_steps=8, temperature=0.8, top_k=50, top_p=0.9, min_p=0.05,
                logprobs=True)
    samp = {}
    for tag, seed in (("seed 7", 7), ("seed 7 again", 7), ("seed 8", 8)):
        e = Engine(params, cfg, EngineConfig(seed=seed, **scfg))
        out = e.run([Request(uid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)])
        samp[tag] = [out[i] for i in range(len(prompts))]
        del e
    for c in samp["seed 7"] + samp["seed 8"]:
        check(len(c.tokens) == 16 and len(c.logprobs) == 16 and all(math.isfinite(v) and v <= 0 for v in c.logprobs),
              f"[10b] {c}")
    same = all(a.tokens == b.tokens for a, b in zip(samp["seed 7"], samp["seed 7 again"]))
    differ = sum(a.tokens != b.tokens for a, b in zip(samp["seed 7"], samp["seed 8"]))
    check(same and differ > 0, f"[10b] same seed equal: {same}; requests differing under another seed: {differ}")
    print(f"[10b] sampling (temperature 0.8, top_k 50, top_p 0.9, min_p 0.05): two seed-7 engines gave the same "
          f"tokens for all {len(prompts)} requests, seed 8 other tokens for {differ}; every logprob finite and <= 0 "
          f"(min {min(min(c.logprobs) for c in samp['seed 7']):.3g})")

    # (c) speculation on prompts that repeat a 16-token period, against the plain greedy engine
    g10 = torch.Generator().manual_seed(10)
    spec_prompts = [(torch.randint(0, cfg.vocab_size, (16,), generator=g10).tolist() * 8)[:n] for n in (128, 96, 64, 128)]
    runs = {}
    for tag, extra in (("plain", {}), ("spec", dict(spec_tokens=4))):
        e = Engine(params, cfg, EngineConfig(max_batch=8, max_len=1024, inner_steps=8, **extra))
        e.warmup(prompt_lens=[len(p) for p in spec_prompts])
        out = e.run([Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(spec_prompts)])
        runs[tag] = ([out[i].tokens for i in range(len(spec_prompts))], e.stats())
        del e
    for i, p in enumerate(spec_prompts):
        print(f"[10c] prompt {i} ({len(p)} tokens): " + near_tie(f"[10c] prompt {i}", ("plain engine", "spec engine"), p,
                                                                  runs["plain"][0][i], runs["spec"][0][i]))
    sst = runs["spec"][1]
    print(f"[10c] speculation (spec_tokens 4, spec_ngram 3): {sst['spec_tokens_per_forward']:.3f} tokens per verify "
          f"forward per slot; {sst['step_p50_s'] * 1e3:.2f} ms per emitted token p50 vs the plain engine's "
          f"{runs['plain'][1]['step_p50_s'] * 1e3:.2f} ms/step on the same prompts and (a)'s {eng_ms_a:.2f}")

    # (d) prefix cache and store: a 1024-token system prompt shared by 4 requests, two together, then two more
    sysp = torch.randint(0, cfg.vocab_size, (1024,), generator=g10).tolist()
    pre = [sysp + torch.randint(0, cfg.vocab_size, (40 + 10 * i,), generator=g10).tolist() for i in range(4)]
    pruns = {}
    for tag, extra in (("no cache", {}), ("prefix cache", dict(prefix_cache=True, prefix_store=2))):
        e = Engine(params, cfg, EngineConfig(max_batch=4, max_len=2048, inner_steps=8, prefill_chunk=256, **extra))
        e.run([Request(uid=i, prompt=pre[i], max_new_tokens=NEW_TOKENS) for i in (0, 1)])
        out = e.run([Request(uid=i, prompt=pre[i], max_new_tokens=NEW_TOKENS) for i in (2, 3)])
        pruns[tag] = ([out[i] for i in range(4)], e.stats())
        del e
    pst = pruns["prefix cache"][1]
    check(pst["prefix_hits"] == 3 and pst["prefix_tokens_reused"] == 3 * 1024,
          f"[10d] prefix hits {pst['prefix_hits']}, tokens reused {pst['prefix_tokens_reused']} (want 3, 3072)")
    for i in range(4):
        print(f"[10d] request {i}: " + near_tie(f"[10d] request {i}", ("engine without the cache", "prefix engine"),
                                                pre[i], pruns["no cache"][0][i].tokens,
                                                pruns["prefix cache"][0][i].tokens))
    ttft = {tag: [round(c.ttft_s * 1e3, 1) for c in r[0]] for tag, r in pruns.items()}
    print(f"[10d] prefix cache + store (chunk 256): {pst['prefix_hits']} hits, {pst['prefix_tokens_reused']} prompt "
          f"tokens reused, {pst['prefix_store_entries']} store entries; TTFT per request ms with the cache "
          f"{ttft['prefix cache']} (mean {sum(ttft['prefix cache']) / 4:.1f}) vs without {ttft['no cache']} (mean "
          f"{sum(ttft['no cache']) / 4:.1f})")

    # (e) fp8 KV: phase 6's ring engine with an e4m3 cache
    e = Engine(params, cfg, EngineConfig(max_batch=4, max_len=8192, inner_steps=8, prefill_chunk=256,
                                         kv_dtype="float8_e4m3fn"))
    check(sorted({a.shape[1] for a in e.cache.k}) == [4352] and e.cache.k[0].dtype == torch.float8_e4m3fn,
          "[10e] the fp8 engine's cache is not e4m3 4352-row rings")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res_e = e.run([Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(long_prompts[:3])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches10e = K.launch_counts()
    ste = e.stats()
    del e
    for i in range(3):
        check(len(res_e[i].tokens) == NEW_TOKENS, f"[10e] request {i}: {res_e[i]}")
    check(ste["kv_cache_bytes"] * 2 == st6["kv_cache_bytes"],
          f"[10e] kv_cache_bytes {ste['kv_cache_bytes']} is not half of phase 6's {st6['kv_cache_bytes']}")
    check(launches10e["flash_attention_fp8"] > 0 and launches10e["flash_attention"] == 0,
          f"[10e] launches {launches10e}")
    print(f"[10e] fp8 KV engine (4352-row e4m3 rings) served prompts {LONG_PROMPTS[:3]} in {wall:.2f} s: TTFT per "
          f"request ms {[round(res_e[i].ttft_s * 1e3, 1) for i in range(3)]}, decode {ste['step_p50_s'] * 1e3:.2f} "
          f"ms/step p50; kv_cache_bytes {ste['kv_cache_bytes']} = half of phase 6's bf16 {st6['kv_cache_bytes']}; "
          f"launches {json.dumps(launches10e)}")
    del params
    torch.cuda.empty_cache()
    cfg2 = T.ModelConfig(**{**cfg.__dict__, "n_layers": 2})
    p_gpu = synth_params(cfg2, seed=1, fuse=True, device=dev)
    p_cpu = T.params_to(p_gpu, "cpu")
    prompt = torch.randint(0, cfg2.vocab_size, (1, 1024), generator=torch.Generator().manual_seed(4), dtype=torch.int32)
    c_gpu = T.KVCache.zeros(cfg2, 1, 1028, dtype=torch.float8_e4m3fn, device=dev)
    c_cpu = T.KVCache.zeros(cfg2, 1, 1028, dtype=torch.float8_e4m3fn, device="cpu")
    toks, t_cpu = prompt, 0.0
    for step_i in range(5):  # the prompt (K7's fp8 form on the card, its plain version on the CPU), 4 decode steps
        K.reset_launch_counts()
        with torch.no_grad():
            lg_gpu, c_gpu = T.forward(p_gpu, cfg2, toks.to(dev), c_gpu, last_only=True)
            t = time.perf_counter()
            lg_cpu, c_cpu = T.forward(p_cpu, cfg2, toks, c_cpu, last_only=True)
            t_cpu += time.perf_counter() - t
        lg_gpu = lg_gpu.cpu()
        fl8 = K.launch_counts()["flash_attention_fp8"]
        check(fl8 == (cfg2.n_layers if step_i == 0 else 0), f"[10e] 2-layer cut step {step_i}: {fl8} fp8 K7 launches")
        d = (lg_gpu - lg_cpu).abs().max().item()
        rel = ((lg_gpu - lg_cpu).norm() / lg_cpu.norm()).item()
        check(bool(torch.isfinite(lg_gpu).all()) and d <= 6e-2 * lg_cpu.abs().max().item() and rel <= 3e-2,
              f"[10e] 2-layer fp8 cut step {step_i}: max|d| {d}, rel L2 {rel}")
        print(f"[10e] 2-layer full-width cut, e4m3 caches, 1024-token prompt, step {step_i}: max|dlogit| {d:.4g} of "
              f"max {lg_cpu.abs().max().item():.4g}, rel L2 {rel:.3g} (limits 6e-2 of max, 3e-2), fp8 K7 launches "
              f"{fl8}")
        toks = lg_cpu[:, -1].argmax(-1).to(torch.int32)[:, None]
    print(f"[10e] 2-layer cut: CPU side {t_cpu:.1f} s")
    del p_gpu, p_cpu, c_gpu, c_cpu
    torch.cuda.empty_cache()

    # (f) the CLI with the new flags on a 4-layer checkpoint at Mistral-7B width
    cfg4 = T.ModelConfig(**{**cfg.__dict__, "n_layers": 4})
    ckpt10 = root / "build" / "chip_smoke_engine_ckpt"
    shutil.rmtree(ckpt10, ignore_errors=True)
    sampled_p, greedy_p = (torch.randint(0, cfg.vocab_size, (n,), generator=g10).tolist() for n in (300, 100))
    flags = ["--warmup-prompt-len", "512", "--temperature", "0.7", "--top-p", "0.9", "--prefix-cache",
             "--prefix-store", "2", "--kv-dtype", "float8_e4m3fn", "--logprobs", "--prefill-chunk", "256"]
    log10 = root / "build" / "chip_smoke_engine_server.log"
    try:
        p4 = synth_params(cfg4, seed=17, device=dev)  # unfused, as the CLI loads a checkpoint
        save_checkpoint(str(ckpt10), cfg4, p4)
        del p4
        torch.cuda.empty_cache()
        cmd = [sys.executable, "-m", "torch_bnb_fp4_tpu_torch.serve", "--ckpt", str(ckpt10), "--max-batch", "4",
               "--max-len", "2048", "--port", "0", *flags]
        with open(log10, "w") as err:
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
            try:
                lines = queue.Queue()
                threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
                line = lines.get(timeout=600)
                check(line.startswith("serving on http://"), f"[10f] the server printed {line!r}")
                url, startup_s = line.split()[-1], time.perf_counter() - t0
                out = {}
                bodies = {"sampled": {"prompt": sampled_p, "max_tokens": NEW_TOKENS},
                          "greedy": {"prompt": greedy_p, "max_tokens": NEW_TOKENS, "temperature": 0}}
                threads = [threading.Thread(target=lambda k=k: out.__setitem__(k, http_post(url, bodies[k])))
                           for k in bodies]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                check(sorted(out) == ["greedy", "sampled"], "[10f] a request over HTTP did not complete")
                for k, c in out.items():
                    check(len(c["tokens"]) == NEW_TOKENS and len(c.get("logprobs", [])) == NEW_TOKENS
                          and all(v <= 0 for v in c["logprobs"]), f"[10f] {k} request: {c}")
                stats10 = http_get(url, "/v1/stats")
                proc.send_signal(signal.SIGINT)
                rc = proc.wait(timeout=120)
                check(rc == 0, f"[10f] the server exited with {rc} on SIGINT")
            except BaseException:
                err.flush()
                print("[10f] server log (tail):\n" + log10.read_text()[-4000:], file=sys.stderr)
                raise
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        cfg4r, p4r = load_checkpoint(str(ckpt10), device=dev)
        greedy_eng = Engine(p4r, cfg4r, EngineConfig(max_batch=4, max_len=2048, prefill_chunk=256, prefix_cache=True,
                                                     prefix_store=2, kv_dtype="float8_e4m3fn", logprobs=True))
        local = greedy_eng.run([Request(uid=0, prompt=greedy_p, max_new_tokens=NEW_TOKENS)])[0]
        check(local.tokens == out["greedy"]["tokens"], "[10f] the temperature-0 request over HTTP differs from the "
                                                       "in-process greedy engine")
        print(f"[10f] CLI {' '.join(flags)}: serving line after {startup_s:.1f} s (load and warmup); a sampled "
              f"300-token and a temperature-0 100-token request at once, both with {NEW_TOKENS} logprobs; the "
              f"temperature-0 tokens equal the in-process greedy engine's; SIGINT -> rc 0; server launches "
              f"{json.dumps(stats10['launches'])}")
        del p4r, greedy_eng
    finally:
        shutil.rmtree(ckpt10, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- phase 11: HF checkpoints to served tokens -----------------------------------------------
    phase11(root, dev, smi)

    # -- phase 12: LoRA adapters at Mistral-7B width ----------------------------------------------
    phase12(root, dev, smi)

    # -- phase 13: tensor parallelism and multi-process serving, the ranks sharing this card --------
    tp_rows = phase13(root, dev, smi)

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
    # K10 at the cells' shapes (phase 3f); launches of phase 5's engine run (one per layer and decode step)
    for case in ("chat", "longdoc", "batch1"):
        dr = decode_rows[case]
        kernels_json.append(dict(
            name=f"K10 decode_attention ({dr['what']}; launches of phase 5's engine run)", route="cuda",
            source="torch_bnb_fp4_tpu_torch/csrc/decode_attention.cu", replaces=None, launches=k10_launches,
            max_abs_err=None, worst_ulps=dr["worst_ulps"], ms=dr["ms"], plain_ms=dr["plain_ms"],
            bound_ms=dr["bound_ms"], bound_by="bytes", library_ms=dr["library_ms"], dense_path_ms=dr["dense_ms"],
            range_rows=dr["range_rows"], ranges=dr["ranges"]))
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
    fr = flash_rows["f"]
    kernels_json.append(dict(
        name=f"K7 flash_attention, fp8 K/V form ({fr['what']}; launches of phase 10e's fp8-KV engine)", route="cuda",
        source="torch_bnb_fp4_tpu_torch/csrc/flash_attention.cu", replaces="torch_bnb_fp4_tpu/ops/attention.py:40",
        launches=launches10e["flash_attention_fp8"], max_abs_err=fr["max_abs_err"], row_err=fr["row_err"], ms=fr["ms"],
        plain_ms=fr["plain_ms"], bound_ms=fr["bound_ms"], bound_by=fr["bound_by"], library_ms=None,
        sdpa_on_widened_kv_ms=fr["sdpa_widened_ms"], bf16_form_ms=fr["bf16_ms"], split=fr["split"]))
    kernels_json.extend(tp_rows)  # phase 13's local shapes of K2-K5, K8 and K9b
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
