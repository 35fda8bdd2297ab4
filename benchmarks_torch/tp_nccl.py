#!/usr/bin/env python3
"""Tensor parallelism across four cards, one rank each (NCCL by the backend
rule of parallel/tp.py): Mistral-7B at tp = 4 and at data 2 x model 2 (fused
per shard, each rank building its shard on its card) against tp = 1 on card
0, with chip_smoke.py's phase-13 helpers: a 300- and a 160-token prefill and
4 teacher-forced decode steps (logits within 6e-2 of max and 3e-2 rel L2),
an engine of 4 requests against the tp = 1 engine's tokens (equal or
near-ties), and per rank the eager decode step beside its all-reduces alone.
The meshed engine decodes eagerly (no CUDA graphs yet, ROADMAP), so these
are eager times, not the graphed step of a single card.

    python3 benchmarks_torch/tp_nccl.py    # needs 4 cards
"""
import os, sys, time
from pathlib import Path
sys.path.insert(0, os.getcwd())
import chip_smoke as CS


def main():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch_bnb_fp4_tpu_torch.ops import _build
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_params
    t = time.perf_counter(); _build.build_all(); print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = T.ModelConfig.mistral_7b()
    g = torch.Generator().manual_seed(13)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in (300, 160)]
    eprompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in (20, 100, 200, 300)]
    full = synth_params(cfg, seed=13, fuse=True, device=dev)
    ref = CS.tp_forwards(full, cfg, prompts, None, dev)
    ecfg = dict(max_batch=4, max_len=512, inner_steps=8)
    eng = Engine(full, cfg, EngineConfig(**ecfg))
    t = time.perf_counter()
    ref_eng = {u: c.tokens for u, c in eng.run([Request(uid=i, prompt=p, max_new_tokens=32)
                                                 for i, p in enumerate(eprompts)]).items()}
    print(f"tp=1: eager decode step {ref['step_ms']:.2f} ms; graphed engine {eng.stats()['step_p50_s'] * 1e3:.2f} ms/step p50")
    del eng, full
    torch.cuda.empty_cache()
    jobs = [dict(kind="mistral", tp=tp, device=None, cfg=cfg, builds=[("pairk", dict(seed=13, fuse=True))],
                 prompts=prompts, forced={"pairk": ref["tokens"]}, steps=4,
                 engine=dict(ecfg=ecfg, new=32, prompts=eprompts, ref=ref_eng)) for tp in (4, 2)]
    t = time.perf_counter()
    ranks = CS.run_ranks(Path(os.getcwd()), 4, jobs, "[nccl]")
    print(f"ranks ran in {time.perf_counter() - t:.1f} s")
    for r, outs in enumerate(ranks):
        for job, o in zip(jobs, outs):
            a = o["pairk"]
            worst = [CS.hold_logits(f"rank {r} tp {job['tp']}", ref["logits"][i], a["logits"][i]) for i in range(2)]
            same = sum(a["engine_margins"][u] is None for u in ref_eng)
            print(f"rank {r} mesh {4 // job['tp']}x{job['tp']} ({o['backend']}): logits worst {max(w[0] for w in worst):.4g} "
                  f"of max, rel L2 {max(w[1] for w in worst):.3g}; {a['ar_per_step']} all-reduces per step; eager "
                  f"decode step {a['step_ms']:.2f} ms, its all-reduces alone {a.get('ar_ms_per_step', 0):.2f} ms; engine "
                  f"{same}/4 token-equal, margins {a['engine_margins']}, {a['engine_stats']['step_p50_s'] * 1e3:.2f} "
                  f"ms/step p50 (eager)")


if __name__ == "__main__":
    main()
