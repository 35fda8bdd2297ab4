"""Mistral-7B speed test of the port: parity with the reference's
examples/speed_test_mistral_7b.py (tok/s before and after enabling the
library; the JAX package's examples/speed_test_mistral_7b.py, ported).

The "before" is the dense bf16 model, the "after" the FP4 model; both serve
one request through the continuous-batching engine, which decodes by
CUDA-graph replay on the card.  Weights come from a packed checkpoint
(``--ckpt``, written by ``python -m torch_bnb_fp4_tpu_torch.convert HF_DIR
OUT``) or are synthesized on the device from a seed (decode speed does not
depend on the weight values).  On the CPU (``--device cpu``) the plain
versions run and the times are host times of the CPU, not of a card.

Usage:
    python examples_torch/speed_test_mistral_7b.py [--ckpt PACKED_DIR]
        [--max-new-tokens N] [--prompt-len N] [--model mistral_7b] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_bnb_fp4_tpu_torch.models import ModelConfig  # noqa: E402
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request  # noqa: E402
from torch_bnb_fp4_tpu_torch.utils.device import resolve_device  # noqa: E402
from torch_bnb_fp4_tpu_torch.utils.synth import synth_params  # noqa: E402


def time_generate(params, cfg, prompt_len: int, n_tokens: int, label: str, device) -> float:
    """Serve one request of ``prompt_len`` tokens for ``n_tokens`` new ones
    (after a warmup of every program); returns decode tok/s (p50 step)."""
    eng = Engine(params, cfg, EngineConfig(max_batch=1, max_len=prompt_len + n_tokens + 1, inner_steps=8))
    t0 = time.perf_counter()
    eng.warmup(prompt_lens=[prompt_len])
    warm_s = time.perf_counter() - t0
    req = Request(uid=0, prompt=[1] * prompt_len, max_new_tokens=n_tokens)
    done = eng.run([req])[0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    st = eng.stats()
    tok_s = 1.0 / st["step_p50_s"]
    print(f"{label}: warmup {warm_s:.1f}s, TTFT {done.ttft_s * 1e3:.1f} ms, decode {len(done.tokens)} tokens at "
          f"{st['step_p50_s'] * 1e3:.2f} ms/token p50 -> {tok_s:.1f} tok/s", flush=True)
    return tok_s


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", help="packed FP4 checkpoint dir (else synthetic weights)")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--model", default="mistral_7b", help="ModelConfig preset of the synthetic weights")
    ap.add_argument("--device", default="cuda", help="torch device (cpu runs the plain versions)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu (host times)'}",
          flush=True)

    if args.ckpt:
        from torch_bnb_fp4_tpu_torch.convert import load_checkpoint

        cfg, fp4_params = load_checkpoint(args.ckpt, fuse=True, device=device)
    else:
        print(f"no --ckpt: synthesizing {args.model}-geometry weights on the device", flush=True)
        cfg = dataclasses.replace(getattr(ModelConfig, args.model)(), quantize_lm_head=True)
        fp4_params = synth_params(cfg, seed=0, fuse=True, device=device)
    fp4 = time_generate(fp4_params, cfg, args.prompt_len, args.max_new_tokens, "FP4 (this library)", device)
    del fp4_params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    bf16_params = synth_params(cfg, quantized=False, seed=0, device=device)
    bf16 = time_generate(bf16_params, cfg, args.prompt_len, args.max_new_tokens, "bf16 baseline     ", device)
    print(f"speedup: {fp4 / bf16:.2f}x", flush=True)


if __name__ == "__main__":
    main()
