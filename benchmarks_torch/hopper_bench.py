#!/usr/bin/env python3
"""The warpgroup-MMA kernels on the card, at chip_smoke.py's cases, timed by
CUDA-graph replay (as chip_smoke.py times them):

  * K7 (csrc/flash_attention.cu) at phase 3b's cases (a)-(e), on the route a
    caller gets and at every key split from 1 to 8 (the sweep behind
    ops/attention.py::kernel_split);
  * K2 and K3 (csrc/matmul_pk.cu, matmul_pk_minner.cu) at phase 3's
    instances, per Mistral-7B layer (the fused or unfused matmuls of the run
    that makes each instance), and K8's K2/K3 forms at phase 3d's, per expert
    of a stack of 8; weights cycle through enough copies to exceed the 50 MB
    L2, as in a decode step that reads every layer once.  Then K2's K split
    swept at the fused and unfused shapes (the knob of
    ops/kernels.py::k2_plan);
  * K5 (csrc/matmul_w8.cu) at phase 3c's instances and K9b
    (csrc/matmul_splitk.cu, bf16 x) at phase 3e's, per Mistral-7B layer,
    weights cycled likewise; then K9b's K split swept at each unfused shape
    (the knob of ops/kernels.py::k9b_plan).

    python3 benchmarks_torch/hopper_bench.py [--root DIR]

--root DIR times the route of the package in DIR instead (another checkout,
e.g. an earlier commit unpacked with ``git archive``), with no sweeps: run
parent, change, change, parent in one call to compare two versions on the
same card.
"""

from __future__ import annotations

import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SPLITS = range(1, 9)
K2_SWEEP_M = (1, 8, 64, 128)
L2_BYTES = 50 * 2**20


def bench_k7(cases, A, K, P, synth_attention, dev, sweep):
    print("K7 case  us (route, graph)  TFLOP/s" + ("   us at split 1..8 (* the route's split)" if sweep else ""))
    for case, _what, b, lq, lk, hq, hk, d, lens, q_off, window, cap, scale in cases.FLASH_CASES:
        ops = synth_attention(b, lq, lk, hq, hk, d, lens=lens, q_offset=q_off, seed=lq + lk + d, device=dev)
        qpos, valid, kpos = ops[3:]
        pairs = P.visible_pairs(qpos, valid, kpos, window)
        us = P.time_graph(lambda: A.flash_attention(*ops, window, scale, cap), rep=10) * 1e6
        line = f"  ({case})    {us:12.1f} {4 * d * hq * pairs / (us * 1e-6) / 1e12:9.0f}"
        if sweep:
            chosen = A.kernel_split(b, lq, lk, hq, hk, K._sm_count(dev), d)
            times = [P.time_graph(lambda s=s: A._flash_attention(*ops, window, scale, cap, split=s), rep=10) * 1e6
                     for s in SPLITS if s <= -(-lk // A.BLOCK_K)]
            line += "   " + " ".join(f"{t:.1f}{'*' if s == chosen else ''}" for s, t in zip(SPLITS, times))
        print(line)
        del ops


def _operands(m, k, n, copies, dev, experts=None):
    g = torch.Generator(device=dev).manual_seed(k + n + m)
    lead = () if experts is None else (experts,)
    packed = [torch.randint(0, 256, (*lead, k // 2, n), generator=g, dtype=torch.uint8, device=dev)
              for _ in range(copies)]
    scale = [(torch.rand((*lead, k // 64, n), generator=g, device=dev) + 0.5) * (0.01 / 192.0) for _ in range(copies)]
    return torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16), packed, scale


def _cycled(fn, copies):
    state = {"i": 0}

    def call():
        state["i"] = (state["i"] + 1) % copies
        return fn(state["i"])

    return call


def bench_pk(cases, K, P, dev, sweep):
    print("K2/K3 instance (kernel, M, run)   ms per layer (graph)   [K8 forms: ms per expert]")
    for kname, m, run in cases.PK_INSTANCES:
        if kname not in ("K2", "K3"):
            continue
        fn = K.matmul_pk if kname == "K2" else K.matmul_pk_minner
        shapes = cases.UNFUSED_SHAPES if run in cases.UNFUSED_RUNS else cases.FUSED_SHAPES
        ms = 0.0
        for _, k, n, count in shapes:
            copies = max(1, math.ceil(2.5 * L2_BYTES / (k * n // 2 + (k // 64) * n * 4)))
            x, packed, scale = _operands(m, k, n, copies, dev)
            ms += count * P.time_graph(_cycled(lambda i: fn(x, packed[i], scale[i], variant="ramp"), copies),
                                       rep=30) * 1e3
            del x, packed, scale
        print(f"  {kname} M={m:<4} {run:11} {ms:10.4f}")
    experts = cases.MOE_EXPERTS
    for kname, m, run in cases.EXPERT_INSTANCES:
        if kname not in ("K2", "K3"):
            continue
        fn = K.matmul_pk if kname == "K2" else K.matmul_pk_minner
        idx = torch.arange(experts, dtype=torch.int32, device=dev)
        ms = 0.0
        for _, k, n, count in cases.MOE_UNFUSED_SHAPES if run == "moe_served" else cases.MOE_FUSED_SHAPES:
            x, (packed,), (scale,) = _operands(m, k, n, 1, dev, experts=experts)
            ms += count * P.time_graph(_cycled(lambda i: fn(x, packed, scale, variant="ramp", expert=idx[i]),
                                               experts), rep=30) * 1e3
            del x, packed, scale
        print(f"  K8/{kname} M={m:<4} {run:11} {ms:10.4f}")
        torch.cuda.empty_cache()
    if not sweep:
        return
    print("K2 K split sweep: us per call at each split dividing K/64 with >= 4 quant blocks (* k2_plan's)")
    shapes = list(cases.SHAPES) + [(sname, k, n) for sname, k, n, _ in cases.UNFUSED_SHAPES
                                   if (k, n) not in {(k2, n2) for _, k2, n2 in cases.SHAPES}]
    for m in K2_SWEEP_M:
        for sname, k, n in shapes:
            copies = max(1, math.ceil(2.5 * L2_BYTES / (k * n // 2 + (k // 64) * n * 4)))
            x, packed, scale = _operands(m, k, n, copies, dev)
            nb = k // 64
            chosen = K.k2_plan(m, k, n, K._sm_count(dev)).ksplit
            cells = []
            for s in (d for d in range(1, nb + 1) if nb % d == 0 and nb // d >= K.SPLIT_MIN_BLOCKS and d <= 32):
                us = P.time_graph(_cycled(lambda i, s=s: K._launch_matmul_pk(
                    x, packed[i], scale[i], None, None, torch.bfloat16, "ramp", ksplit=s), copies), rep=30) * 1e6
                cells.append(f"{s}:{us:.1f}{'*' if s == chosen else ''}")
            print(f"  M={m:<4} {sname:8} " + " ".join(cells))
            del x, packed, scale


def bench_k5_k9b(cases, K, P, dev):
    print("K5 instance (shapes, M) / K9b instance (M, run)   ms per layer (graph)")
    for kind, m in cases.K5_INSTANCES:
        ms = 0.0
        for _, k, n, count in cases.UNFUSED_SHAPES if kind == "unfused" else cases.FUSED_SHAPES:
            copies = max(1, math.ceil(2.5 * L2_BYTES / (k * n)))
            x, packed, scale = _operands(m, k, n, copies, dev)
            shadows = [K.make_int8_shadow(p, s, variant="ramp", block_k=1024) for p, s in zip(packed, scale)]
            del packed, scale
            x8, rs = K.quantize_activations(x, 1024)
            ms += count * P.time_graph(_cycled(lambda i: K.matmul_w8_int8(
                x8, rs, shadows[i][0], shadows[i][1], out_dtype=torch.bfloat16, block_k=1024), copies),
                rep=30 if m <= 256 else 5) * 1e3
            del x, x8, rs, shadows
            torch.cuda.empty_cache()
        print(f"  K5 {kind:8} M={m:<5} {ms:10.4f}")
    # phase 3e's instances: bf16 x at SPLITK_INSTANCES' M, f32 x (the CUDA-core stream) at 1 and 64
    for m, run, x_dtype in ([(m, run, torch.bfloat16) for m, run in cases.SPLITK_INSTANCES]
                            + [(1, "f32 x", torch.float32), (64, "f32 x", torch.float32)]):
        ms = 0.0
        for _, k, n, count in cases.UNFUSED_SHAPES:
            copies = max(1, math.ceil(2.5 * L2_BYTES / (k * n // 2 + (k // 64) * n * 4)))
            x, packed, scale = _operands(m, k, n, copies, dev)
            x = x.to(x_dtype)
            halves = [(s[: k // 128], s[k // 128:]) for s in scale]  # absmax of each half's 64-row blocks
            ms += count * P.time_graph(_cycled(lambda i: K.matmul_fp4(x, packed[i], halves[i]), copies),
                                       rep=100 if m < 64 else 30) * 1e3
            del x, packed, scale, halves
        print(f"  K9b M={m:<4} {run:11} {ms:10.4f}")
    torch.cuda.empty_cache()


def sweep_k9b(cases, K, P, dev):
    print("K9b K split sweep: us per call at each split dividing K/128 with >= 2 stages of 64 packed rows "
          "(* k9b_plan's)")
    for m, _ in cases.SPLITK_INSTANCES:
        for sname, k, n, _ in cases.UNFUSED_SHAPES:
            copies = max(1, math.ceil(2.5 * L2_BYTES / (k * n // 2 + (k // 64) * n * 4)))
            x, packed, scale = _operands(m, k, n, copies, dev)
            halves = [(s[: k // 128], s[k // 128:]) for s in scale]
            tab = K.code_table(None, dev)
            nb = k // 128
            chosen = K.k9b_plan(m, k, n, K._sm_count(dev)).ksplit
            cells = []
            for s in (d for d in range(1, nb + 1) if nb % d == 0 and 2 * (nb // d) >= K.SPLIT_MIN_BLOCKS and d <= 32):
                us = P.time_graph(_cycled(lambda i, s=s: K._launch_matmul_splitk(
                    x, packed[i], *halves[i], None, tab, torch.bfloat16, 1, ksplit=s), copies), rep=30) * 1e6
                cells.append(f"{s}:{us:.1f}{'*' if s == chosen else ''}")
            print(f"  M={m:<4} {sname:12} " + " ".join(cells))
            del x, packed, scale, halves


def main() -> int:
    if not torch.cuda.is_available():
        print("hopper_bench: needs a CUDA device", file=sys.stderr)
        return 1
    argv = sys.argv[1:]
    root = Path(argv[argv.index("--root") + 1]).resolve() if "--root" in argv else REPO
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", REPO / "chip_smoke.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    sys.path.insert(0, str(root))
    from torch_bnb_fp4_tpu_torch.ops import _build
    from torch_bnb_fp4_tpu_torch.ops import attention as A
    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.utils import profiling as P
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_attention

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"package {Path(A.__file__).parents[1]}")
    _build.build_all()
    dev = torch.device("cuda")
    sweep = root == REPO
    bench_k7(cases, A, K, P, synth_attention, dev, sweep)
    bench_pk(cases, K, P, dev, sweep)
    bench_k5_k9b(cases, K, P, dev)
    if sweep:
        sweep_k9b(cases, K, P, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
