#!/usr/bin/env python3
"""K2 (csrc/matmul_pk.cu) on the card: device time (CUDA-graph replay) at the
Mistral-7B fused shapes for M in {1, 8}, across the K-split occupancy target
(blocks per SM; the wrapper uses ops.kernels.K2_BLOCKS_PER_SM), for bf16 x
(the tensor-core kernel) and f32 x (the CUDA-core kernel), beside a dense bf16
torch.matmul of the same shape.  Weights rotate through enough copies to
exceed the 50 MB L2, as in a decode step that reads each layer once.

    python3 benchmarks_torch/k2_sweep.py
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_bnb_fp4_tpu_torch.ops import _build  # noqa: E402
from torch_bnb_fp4_tpu_torch.ops import kernels as K  # noqa: E402
from torch_bnb_fp4_tpu_torch.utils import profiling as P  # noqa: E402

SHAPES = (("qkv", 4096, 6144), ("o", 4096, 4096), ("gate_up", 4096, 28672), ("down", 14336, 4096))
TARGETS = (2, 4, 8, 16)


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print("kernel  shape     M  " + "  ".join(f"bps={t:<3} us   GB/s" for t in TARGETS) + "   bf16_us")
    for x_dtype, m in ((torch.bfloat16, 1), (torch.float32, 1), (torch.bfloat16, 8), (torch.float32, 8)):
        for sname, k, n in SHAPES:
            w_bytes = k * n // 2 + (k // 64) * n * 4
            copies = max(1, math.ceil(2.5 * 50 * 2**20 / w_bytes))
            packed = [torch.randint(0, 256, (k // 2, n), generator=gen, dtype=torch.uint8, device=dev)
                      for _ in range(copies)]
            scale = [torch.rand((k // 64, n), generator=gen, device=dev) * 1e-4 for _ in range(copies)]
            x = torch.randn((m, k), generator=gen, device=dev).to(x_dtype)
            x_bytes = m * k * x.element_size()
            cells = []
            for t in TARGETS:
                state = {"i": 0}

                def call(t=t, state=state):
                    state["i"] = (state["i"] + 1) % copies
                    return K._launch_matmul_pk(x, packed[state["i"]], scale[state["i"]], None, None, x_dtype,
                                               "ramp", t)

                us = P.time_graph(call, rep=100) * 1e6
                cells.append(f"{us:7.1f} {(w_bytes + x_bytes + m * n * x.element_size()) / us / 1e3:6.0f}")
            wd = [torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(max(1, math.ceil(2.5 * 50 * 2**20 / (2 * k * n))))]
            xb = x.to(torch.bfloat16)
            st = {"i": 0}

            def dense():
                st["i"] = (st["i"] + 1) % len(wd)
                return torch.matmul(xb, wd[st["i"]])

            bf16_us = P.time_graph(dense, rep=100) * 1e6
            kind = "tensor" if x_dtype == torch.bfloat16 else "cuda"
            print(f"{kind:7} {sname:8} {m:2}  " + "  ".join(cells) + f"   {bf16_us:7.1f}")
            del packed, scale, wd
    return 0


if __name__ == "__main__":
    sys.exit(main())
