"""Teacher-forced perplexity of a packed-FP4 checkpoint against its bf16 twin
(the JAX package's examples/perplexity.py, ported).

Given a converted checkpoint and a token stream, reports the token-level
NLL and perplexity; with ``--hf-dir`` it also builds the bf16 twin from the
same floats and reports the difference, the quantity that must be ~0 for FP4
to be deployment-equivalent.  Without ``--tokens`` the stream is seeded
random tokens, so the script needs no dataset (it then measures FP4-vs-bf16
consistency, not a real perplexity).

Usage:
    python examples_torch/perplexity.py --ckpt PACKED_DIR [--hf-dir HF_DIR]
        [--tokens tokens.npy] [--seq-len 512] [--max-tokens 16384] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_bnb_fp4_tpu_torch.utils.device import resolve_device  # noqa: E402


@torch.no_grad()
def nll_of_stream(params, cfg, tokens: np.ndarray, seq_len: int, device) -> tuple[float, int]:
    """Mean next-token NLL over a flat token stream cut into segments of
    ``seq_len``, each teacher-forced through one forward on a fresh cache
    (the first position of a segment has no target).  Returns (mean NLL,
    tokens scored)."""
    from torch_bnb_fp4_tpu_torch.models import KVCache, forward

    total, count = 0.0, 0
    for i in range(len(tokens) // seq_len):
        seg = torch.as_tensor(tokens[i * seq_len : (i + 1) * seq_len], dtype=torch.int32, device=device)
        logits, _ = forward(params, cfg, seg[None, :], KVCache.zeros(cfg, 1, seq_len, device=device))
        logp = torch.log_softmax(logits[0, :-1].float(), dim=-1)
        total -= float(logp.gather(1, seg[1:, None].long()).sum())
        count += seq_len - 1
    return total / max(count, 1), count


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="packed checkpoint dir (the convert CLI's output)")
    ap.add_argument("--hf-dir", help="original HF dir: also score the bf16 twin and report the difference")
    ap.add_argument("--tokens", help=".npy int token stream; default: seeded random tokens")
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--max-tokens", type=int, default=16384)
    ap.add_argument("--device", default="cuda", help="torch device (cpu runs the plain versions)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    from torch_bnb_fp4_tpu_torch.convert import load_checkpoint

    cfg, params = load_checkpoint(args.ckpt, fuse=True, device=device)
    if args.tokens:
        tokens = np.load(args.tokens).astype(np.int64).reshape(-1)[: args.max_tokens]
    else:
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, args.max_tokens)
        print("note: random tokens — this measures fp4-vs-bf16 CONSISTENCY, not real PPL", flush=True)

    nll, n = nll_of_stream(params, cfg, tokens, args.seq_len, device)
    print(f"fp4:  nll {nll:.4f}  ppl {np.exp(nll):.2f}  ({n} tokens)", flush=True)

    if args.hf_dir:
        from torch_bnb_fp4_tpu_torch.convert.hf import config_from_hf, iter_hf_tensors
        from torch_bnb_fp4_tpu_torch.models import dense_params

        weights = {k: v.float().numpy() for k, v in iter_hf_tensors(args.hf_dir)}
        twin = dense_params(config_from_hf(args.hf_dir), weights, device=device)
        nll_b, _ = nll_of_stream(twin, cfg, tokens, args.seq_len, device)
        print(f"bf16: nll {nll_b:.4f}  ppl {np.exp(nll_b):.2f}", flush=True)
        print(f"delta nll (fp4 - bf16): {nll - nll_b:+.4f} (ppl ratio {np.exp(nll - nll_b):.4f})", flush=True)


if __name__ == "__main__":
    main()
