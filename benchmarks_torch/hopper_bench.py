#!/usr/bin/env python3
"""K7 (csrc/flash_attention.cu) on the card at chip_smoke.py's phase-3b cases
(a)-(e), with that phase's case table and operands: its time by CUDA-graph
replay (as phase 3b times it) on the route a caller gets, and at every key
split from 1 to 8 (the sweep behind ops/attention.py::kernel_split).

    python3 benchmarks_torch/hopper_bench.py [--root DIR]

--root DIR times the route of the package in DIR instead (another checkout,
e.g. an earlier commit unpacked with ``git archive``), with no sweep: run both
in one call to compare two versions of K7 on the same card.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SPLITS = range(1, 9)


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
