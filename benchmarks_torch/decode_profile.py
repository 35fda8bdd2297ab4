#!/usr/bin/env python3
"""Where a decode step's and a prefill chunk's device time goes:
torch.profiler over eager greedy decode steps of the Mistral-7B geometry
(synth_params, fused FP4), batch 1 and the engine's batch 8 over a 1024-row
cache, and over one 256-row chunk of a long prompt (positions 5632-5887) on
the 4352-row sliding-window rings of chunked prefill: fused, then unfused as
the CLI loads a checkpoint, without and with int8 prefill shadows (K5).
With ``--model mixtral_8x7b``: the 32-layer Mixtral-8x7B (fused gate|up
experts) at batch 1 (per-token dispatch, two experts per layer), batch 8
(all experts) and one 256-row chunk at position 4096 of an 8192-row cache
(all experts), with the device time of the K8 launches (the expert forms of
K2-K4, inside a ``record_function`` range around each expert call) beside the
rest.  With ``--layout splitk``: the Mistral-7B geometry with every linear
split-K (``synth_params(layout="splitk", tp=4)``: unfused, wo/w_down
K-sharded into 4) at batch 1 and one 256-row chunk at position 1024, K9b's
device time beside the rest.  Prints the host wall time per step, the summed
device time of the kernels per step, launches per step, and the kernels
ranked by device time, grouped as the port's kernels (K2 and its split
reduction, K3, K4, K5, K7, K9b and its split reduction), attention
(einsum/bmm, softmax, masking), the dense lm_head GEMM, and everything else.

    python3 benchmarks_torch/decode_profile.py [--model mixtral_8x7b | --layout splitk]
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_bnb_fp4_tpu_torch.models import transformer as T  # noqa: E402
from torch_bnb_fp4_tpu_torch.models.linear import attach_prefill_shadow  # noqa: E402
from torch_bnb_fp4_tpu_torch.ops import _build  # noqa: E402
from torch_bnb_fp4_tpu_torch.ops import kernels as K  # noqa: E402
from torch_bnb_fp4_tpu_torch.utils.synth import synth_params  # noqa: E402

STEPS = 8
K8_RANGE = "K8 expert forms"


def group(name: str) -> str:
    if "splitk" in name:
        return "split-K K9b (+split reduction)"
    if "matmul_pk" in name or "reduce_splits" in name:
        return "pair-K K2 (+split reduction)"
    if "minner" in name:
        return "pair-K K3"
    if "w4a8" in name:
        return "pair-K K4 (w4a8)"
    if "w8_kernel" in name:
        return "K5 int8-shadow GEMM"
    if "combine_terms" in name:
        return "K4/K5 K-split combine"
    if "flash_kernel" in name or "flash_combine" in name:
        return "K7 flash attention"
    if "gemm" in name.lower() or "gemv" in name.lower() or "cutlass" in name.lower() or "sm90" in name:
        return "cuBLAS GEMM (attention bmm, lm_head)"
    if "softmax" in name.lower():
        return "softmax"
    if "copy" in name.lower() or "cast" in name.lower() or "elementwise" in name.lower():
        return "elementwise / copies / casts"
    if "index" in name.lower() or "scatter" in name.lower() or "gather" in name.lower():
        return "indexing (KV writes, embedding)"
    return "other"


@contextlib.contextmanager
def k8_ranges():
    """Wrap every expert-form call of K2-K4 in a ``K8_RANGE`` profiler range
    (the 2-D calls are left alone), so the profile attributes the kernels
    launched inside to K8."""
    names = ("matmul_pk", "matmul_pk_minner", "matmul_pk_w4a8")
    originals = {n: getattr(K, n) for n in names}

    def ranged(fn):
        def call(*args, expert=None, **kw):
            if expert is None:
                return fn(*args, **kw)
            with record_function(K8_RANGE):
                return fn(*args, expert=expert, **kw)
        return call

    for n in names:
        setattr(K, n, ranged(originals[n]))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(K, n, fn)


def profile_steps(label: str, step) -> None:
    """Profile ``STEPS`` calls of ``step()`` after two warm-up calls."""
    with torch.no_grad(), k8_ranges():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / STEPS * 1e3
    averages = prof.key_averages()
    # the K8 ranges appear twice (the host range and its span on the device): neither is a kernel
    kernels = [e for e in averages if str(e.device_type).endswith("CUDA") and e.device_time_total > 0
               and e.key != K8_RANGE]
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3 / STEPS
    print(f"{label}: host wall {wall_ms:.3f} ms/step, "
          f"device kernels {dev_ms:.3f} ms/step (device idle {100 * (1 - dev_ms / wall_ms):.1f}%), "
          f"{sum(e.count for e in kernels) / STEPS:.0f} kernel launches/step")
    k8 = [e.device_time_total for e in averages if e.key == K8_RANGE]
    if k8:
        n8 = sum(v for n, v in K.launch_counts().items() if n.endswith("_expert"))
        print(f"    K8 (expert forms, {K8_RANGE!r} ranges): {n8 / STEPS:.0f} launches/step (+ K2's split reductions), "
              f"{max(k8) / 1e3 / STEPS:.3f} ms/step of device time (their span on the device)")
    groups = defaultdict(float)
    for e in kernels:
        groups[group(e.key)] += e.device_time_total / 1e3 / STEPS
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {g:40} {ms:8.3f} ms/step")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:12]:
        print(f"      {e.device_time_total / 1e3 / STEPS:8.3f} ms  x{e.count // STEPS:4}  {e.key[:90]}")


def profile_decode(params, cfg, batch: int, cache_rows: int, fill: int) -> None:
    cache = T.KVCache.zeros(cfg, batch, cache_rows, device=torch.device("cuda"))
    cache.length.fill_(fill)
    tok = [torch.zeros(batch, dtype=torch.int32, device=cache.length.device)]

    def step():  # every step rewrites the same cache row
        tok[0], _ = T.decode_step(params, cfg, tok[0], cache)

    profile_steps(f"decode, batch {batch}, {cache_rows}-row cache filled to {fill}", step)


def profile_chunk(params, cfg, chunk: int, max_len: int, fill: int, label: str = "") -> None:
    """One ``chunk``-row prefill chunk at position ``fill`` of a batch-1 cache
    with the engine's rings (write_chunk = chunk)."""
    cache = T.KVCache.zeros(cfg, 1, max_len, write_chunk=chunk, device=torch.device("cuda"))
    cache.length.fill_(fill)
    tokens = torch.randint(0, cfg.vocab_size, (1, chunk), dtype=torch.int32, device=cache.length.device)
    rows = sorted({a.shape[1] for a in cache.k})

    def step():  # every call rewrites the same ring rows
        T.forward(params, cfg, tokens, cache, last_index=chunk - 1)

    profile_steps(f"prefill chunk of {chunk} rows at position {fill}, {rows}-row KV caches{label}", step)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=("mistral_7b", "mixtral_8x7b"), default="mistral_7b")
    ap.add_argument("--layout", choices=("pairk", "splitk"), default="pairk")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_profile: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    if args.model == "mixtral_8x7b":
        cfg = T.ModelConfig.mixtral_8x7b()
        params = synth_params(cfg, seed=0, fuse=True)
        profile_decode(params, cfg, batch=1, cache_rows=97, fill=21)
        profile_decode(params, cfg, batch=8, cache_rows=1024, fill=500)
        profile_chunk(params, cfg, chunk=256, max_len=8192, fill=4096, label=", fused experts")
        return 0
    if args.layout == "splitk":
        cfg = T.ModelConfig.mistral_7b()
        params = synth_params(cfg, layout="splitk", tp=4, seed=0)
        profile_decode(params, cfg, batch=1, cache_rows=97, fill=21)
        profile_chunk(params, cfg, chunk=256, max_len=2048, fill=1024, label=", split-K (wo/w_down k_shards=4)")
        return 0
    cfg = T.ModelConfig.mistral_7b()
    params = synth_params(cfg, seed=0, fuse=True)
    profile_decode(params, cfg, batch=1, cache_rows=97, fill=21)
    profile_decode(params, cfg, batch=8, cache_rows=1024, fill=500)
    profile_chunk(params, cfg, chunk=256, max_len=8192, fill=5632, label=", fused")
    del params
    unfused = synth_params(cfg, seed=0)
    profile_chunk(unfused, cfg, chunk=256, max_len=8192, fill=5632, label=", unfused")
    profile_chunk(attach_prefill_shadow(unfused), cfg, chunk=256, max_len=8192, fill=5632,
                  label=", unfused with int8 prefill shadows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
