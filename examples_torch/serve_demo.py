"""End-to-end serving demo of the port (the JAX package's
examples/serve_demo.py, ported): load a packed-FP4 checkpoint (or build a
small random-weight model in process), serve a batch of prompts through the
continuous-batching engine, and report tok/s of the FP4 engine beside its
bf16 twin.  On the card the engines decode by CUDA-graph replay; on the CPU
(``--device cpu``) the plain versions run and the times are host times.

Real HF weights need only a model dir:
    python -m torch_bnb_fp4_tpu_torch.convert <hf_dir> <packed_dir>
    python examples_torch/serve_demo.py --ckpt <packed_dir>
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_bnb_fp4_tpu_torch.models import ModelConfig, dense_params, quantize_params  # noqa: E402
from torch_bnb_fp4_tpu_torch.models import transformer as T  # noqa: E402
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request  # noqa: E402
from torch_bnb_fp4_tpu_torch.utils.device import resolve_device  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", help="packed checkpoint dir (from torch_bnb_fp4_tpu_torch.convert)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="torch device (cpu runs the plain versions)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    if args.ckpt:
        from torch_bnb_fp4_tpu_torch.convert import load_checkpoint

        cfg, params = load_checkpoint(args.ckpt, device=device)
        weights = None
    else:
        cfg = ModelConfig.tiny_test(n_layers=2)
        weights = T.random_weights(cfg, seed=0)
        params = quantize_params(cfg, weights, device=device)
    reqs = [dict(uid=i, prompt=rng.integers(0, cfg.vocab_size, rng.integers(3, 9)).tolist(),
                 max_new_tokens=args.max_new_tokens) for i in range(args.requests)]
    max_len = max(len(r["prompt"]) for r in reqs) + args.max_new_tokens + 1

    def serve(p, label):
        eng = Engine(p, cfg, EngineConfig(max_batch=args.max_batch, max_len=max_len))
        eng.warmup(prompt_lens=[len(r["prompt"]) for r in reqs])
        t0 = time.perf_counter()
        res = eng.run([Request(**r) for r in reqs])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        ntok = sum(len(c.tokens) for c in res.values())
        print(f"{label}: {len(res)} completions, {ntok} tokens in {dt:.2f}s -> {ntok / dt:.1f} tok/s", flush=True)
        return res

    fp4 = serve(params, "FP4 engine ")
    if weights is not None:
        bf16 = serve(dense_params(cfg, weights, device=device), "bf16 engine")
        agree = sum(fp4[u].tokens == bf16[u].tokens for u in fp4)
        print(f"token-identical completions fp4 vs bf16: {agree}/{len(fp4)} (disagreement expected: 4-bit weights)")
    for u in sorted(fp4)[:3]:
        print(f"  uid={u} -> {fp4[u].tokens[:12]}{'...' if len(fp4[u].tokens) > 12 else ''}")


if __name__ == "__main__":
    main()
