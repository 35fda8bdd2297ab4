"""Correctness and speed sanity check of the port: parity with the reference's
sanity_check.py (the JAX package's examples/sanity_check.py, ported).

Correctness: a 1024 -> 1024 FP4 layer against its exact f32 twin at the
three dispatch shapes the reference probes ((1, 1, K) GEMV-3d, (1, K)
GEMV-2d, (1, 256, K) GEMM), mean |error| inside the reference's acceptance
band 0.045-0.065 with torch-style init.

Speed (the card only): the reference's TestModel geometry (768 -> 2048 x4 ->
64, padded to 128) as a dense bf16 MLP, the bnb-style path (dequantize each
FP4 weight to a temporary, then a dense matmul) and the fused FP4 kernels, at
1 and 256 rows, each time a CUDA-graph replay between CUDA events.  On the
CPU only the correctness half runs (the plain versions); no time is taken.

Usage: python examples_torch/sanity_check.py [--device cuda] [--skip-speed]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_bnb_fp4_tpu_torch.models import dense_linear, dequantize_weight, quantize_linear  # noqa: E402
from torch_bnb_fp4_tpu_torch.utils.device import resolve_device  # noqa: E402

GEOM = [(768, 2048), (2048, 2048), (2048, 2048), (2048, 2048), (2048, 2048), (2048, 128)]


def mlp(rng, quantized: bool, device, dtype=torch.float32):
    """The reference TestModel's layers (bias included), FP4 or dense."""
    layers = []
    for k_in, n_out in GEOM:
        bound = 1.0 / np.sqrt(k_in)
        w = rng.uniform(-bound, bound, (n_out, k_in)).astype(np.float32)
        b = rng.uniform(-bound, bound, n_out).astype(np.float32)
        layers.append(quantize_linear(w, b, device=device) if quantized else dense_linear(w, b, dtype=dtype,
                                                                                             device=device))
    return layers


def run(layers, x):
    for lin in layers:
        x = lin(x)
    return x


def run_bnb_style(layers, x):
    """The bitsandbytes GEMM strategy: the full weight dequantized to a
    temporary on the device, then a dense matmul."""
    for lin in layers:
        y = x.float() @ dequantize_weight(lin, out_dtype=x.dtype).T.float()
        x = (y + lin.bias.float()).to(x.dtype)
    return x


def check_correctness(rng, device) -> bool:
    k_in = 1024
    bound = 1.0 / np.sqrt(k_in)
    w = rng.uniform(-bound, bound, (1024, k_in)).astype(np.float32)
    b = rng.uniform(-bound, bound, 1024).astype(np.float32)
    q = quantize_linear(w, b, device=device)
    ok = True
    for shape in [(1, 1, k_in), (1, k_in), (1, 256, k_in)]:
        x = rng.standard_normal(shape).astype(np.float32)
        y = q(torch.from_numpy(x).to(device)).cpu().numpy()
        exact = x.reshape(-1, k_in) @ w.T + b
        err = float(np.abs(y.reshape(-1, 1024) - exact).mean())
        band = 0.045 <= err <= 0.065
        ok &= band
        print(f"  shape {str(shape):>14}  mean |err| = {err:.4f}  "
              f"{'OK (in reference band 0.045-0.065)' if band else 'OUT OF BAND'}", flush=True)
    return ok


def check_speed(rng, device):
    from torch_bnb_fp4_tpu_torch.utils.profiling import time_graph

    quant = mlp(rng, True, device)
    dense = mlp(rng, False, device, dtype=torch.bfloat16)
    print(f"\n  [bfloat16] ({torch.cuda.get_device_name(device)})")
    print(f"  {'mode':<6} {'dense us':>12} {'bnb-style us':>14} {'fp4 fused us':>14} {'vs dense':>9} {'vs bnb':>8}")
    for mode, m in (("gemv", 1), ("gemm", 256)):
        x = torch.from_numpy(rng.standard_normal((m, 768)).astype(np.float32)).to(device, torch.bfloat16)
        td, tb, tq = (time_graph(fn, x, rep=20) * 1e6 for fn in (lambda x: run(dense, x),
                                                                lambda x: run_bnb_style(quant, x),
                                                                lambda x: run(quant, x)))
        print(f"  {mode:<6} {td:>12.1f} {tb:>14.1f} {tq:>14.1f} {td / tq:>8.2f}x {tb / tq:>7.2f}x", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device (cpu runs the plain versions)")
    ap.add_argument("--skip-speed", action="store_true")
    args = ap.parse_args()
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    print("correctness (reference acceptance band):")
    ok = check_correctness(rng, device)
    if args.skip_speed:
        pass
    elif device.type == "cuda":
        print("speed (6-layer MLP, reference TestModel geometry):")
        check_speed(rng, device)
    else:
        print("speed: not measured (timing needs the card)")
    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
