#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. card name and power limit; build every CUDA kernel from csrc/ (nvcc,
     one process per source, in parallel) and print the build time;
  2. K1: all 256 bytes x {exact, zramp, ramp, lut(NF4)} through the CUDA test
     kernel vs the plain version, bit-exact; timed on a gate|up-sized matrix;
  3. K2/K3/K4 vs their plain versions at the Mistral-7B fused shapes
     (qkv 4096->6144, o 4096->4096, gate_up 4096->28672, down 14336->4096)
     and every kernel instance the main path runs: M in {1, 8} (decode) and
     {32, 128} (prefill buckets) for K2, 224 for K3, 320 and 704 for K4;
     kernel time, bound, plain time and a dense bf16 torch.matmul of the same
     shape as the yardstick;
  4. a 2-layer model at full Mistral-7B width from seeded weights, on the
     card (kernels) and on the CPU (plain versions): 300-token prompt and 4
     decode steps, logits within the stated tolerance;
  5. the main path: the full 32-layer Mistral-7B geometry (synth_params,
     fused) served by the Engine (max_batch 8, max_len 1024, inner_steps 8)
     with 6 requests (prompts 20..700 tokens, 32 new tokens each) plus a
     batch-1 generate; every kernel's launch count must be > 0.  The
     engine's logits for the 20-token request are held against generate's at
     every step up to the first token where the two differ (if any), which
     must be a near-tie.  Then batch-1 decode tok/s of the FP4 model beside
     its dense bf16 twin.
Prints the kernel table as one JSON line, then the final status line.
Kernel times are CUDA-graph replays timed with CUDA events (the card's own
time, without the Python wrappers' launch cost, which is printed beside them
as eager_us); serving times are host clocks around synchronized work.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

SHAPES = (("qkv", 4096, 6144), ("o", 4096, 4096), ("gate_up", 4096, 28672), ("down", 14336, 4096))
L2_BYTES = 50 * 2**20
PROMPTS = (20, 100, 200, 300, 500, 700)
NEW_TOKENS = 32


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def engine_vs_generate(T, Engine, params, cfg, ecfg, reqs, eng_tokens, gen_tokens, dev):
    """Hold the engine's logits for request 0 (served in slot 0 beside the
    other requests) against batch-1 ``generate``'s at every step up to the
    first token where they differ; that token must be a near-tie: each run's
    winner leads the other's by at most 2^-7 * max|logit| (bf16 resolution).
    The engine is rerun with ``T.forward`` wrapped to keep slot 0's logits
    (its prefill is the first call, then row 0 of each batched decode step);
    generate's steps are replayed fed its own tokens."""
    import torch

    rec, forward = [], T.forward

    def recording(p, c, tokens, cache, **kw):
        lg, cache = forward(p, c, tokens, cache, **kw)
        if not rec or tokens.shape[0] == ecfg.max_batch:
            rec.append(lg[0, -1].float().cpu())
        return lg, cache

    T.forward = recording
    try:
        rerun = Engine(params, cfg, ecfg).run(reqs)[0].tokens
    finally:
        T.forward = forward
    eng_lg = rec[:NEW_TOKENS]
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

    j = next((t for t, (a, b) in enumerate(zip(eng_tokens, gen_tokens)) if a != b), None)
    last = NEW_TOKENS - 1 if j is None else j
    worst_d = worst_rel = 0.0
    for t in range(last + 1):  # the two runs share their context up to here
        e, g = eng_lg[t], gen_lg[t]
        d, rel = (e - g).abs().max().item(), ((e - g).norm() / g.norm()).item()
        check(d <= 6e-2 * g.abs().max().item() and rel <= 3e-2,
              f"engine vs generate logits at step {t}: max|d| {d}, rel L2 {rel}")
        worst_d, worst_rel = max(worst_d, d), max(worst_rel, rel)
    same = sum(a == b for a, b in zip(eng_tokens, gen_tokens))
    print(f"[5] engine vs batch-1 generate, 20-token prompt: {same}/{NEW_TOKENS} tokens equal; logits over "
          f"steps 0..{last}: worst max|d| {worst_d:.4g}, worst rel L2 {worst_rel:.3g}")
    if j is not None:
        e, g, a, b = eng_lg[j], gen_lg[j], gen_tokens[j], eng_tokens[j]
        tie = 2.0**-7 * g.abs().max().item()
        m_gen, m_eng = (g[a] - g[b]).item(), (e[b] - e[a]).item()
        print(f"[5] first differing token at step {j}: generate {a} leads engine's {b} by {m_gen:.4g} in its "
              f"logits, the engine's by {m_eng:.4g} in its own; max|d| there {(e - g).abs().max().item():.4g}, "
              f"near-tie limit 2^-7*max|logit| = {tie:.4g}")
        check(m_gen <= tie and m_eng <= tie, f"step {j}: not a near-tie ({m_gen}, {m_eng} > {tie})")


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
    _build.build_all()
    for src in _build.SOURCES:
        _build.kernel(src)
    print(f"[1] built {len(_build.SOURCES)} CUDA sources in {time.perf_counter() - t0:.1f} s")
    for src, log in _build.build_log.items():
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines() if "Used " in ln]
        spills = sum("0 bytes spill" not in ln for ln in log.splitlines() if "spill stores" in ln)
        print(f"    {src}: registers per instantiation {sorted(set(regs))}, instantiations with spills {spills}")

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
    def kernel_calls(kname, x, packed, scale, k):
        """(kernel on weight copy i, plain version on copy 0, activation bytes)."""
        if kname == "K2":
            return (lambda i: K.matmul_pk(x, packed[i], scale[i], variant="ramp"),
                    lambda: K.matmul_pk_plain(x, packed[0], scale[0], variant="ramp"), x.numel() * 2)
        if kname == "K3":
            return (lambda i: K.matmul_pk_minner(x, packed[i], scale[i], variant="ramp"),
                    lambda: K.matmul_pk_minner_plain(x, packed[0], scale[0], variant="ramp"), x.numel() * 2)
        bk = K.a8_block_k(k, torch.float32)
        x8, rs = K.quantize_activations(x, bk)
        kw = dict(out_dtype=torch.bfloat16, variant="ramp", a8_block_k=bk)
        return (lambda i: K.matmul_pk_w4a8(x8, rs, packed[i], scale[i], **kw),
                lambda: K.matmul_pk_w4a8_plain(x8, rs, packed[0], scale[0], **kw), x8.numel() + rs.numel() * 4)

    print("[3] kernel  shape     M    us      GB/s    bound_us  by          eager_us   plain_us   bf16_matmul_us"
          "  max_abs_err   (us: CUDA-graph replay; eager_us: back-to-back Python calls)")
    rows = {}
    for kname, m in (("K2", 1), ("K2", 8), ("K2", 32), ("K2", 128), ("K3", 224), ("K4", 320), ("K4", 704)):
        tot = dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0, bf16_ms=0.0, err=0.0)
        for sname, k, n in SHAPES:
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
            bnd, by = P.bound_s(nbytes, ops, P.H100_INT8_OPS if kname == "K4" else P.H100_BF16_FLOPS)
            print(f"    {kname:6} {sname:8} {m:4} {ms * 1e3:8.1f} {nbytes / (ms * 1e-3) / 1e9:7.0f} "
                  f"{bnd * 1e6:9.1f}  {by:10} {eager_ms * 1e3:8.1f} {plain_ms * 1e3:10.1f} {bf16_ms * 1e3:12.1f}"
                  f"   {err:.3g}")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes", nbytes), ("ops", ops),
                           ("bf16_ms", bf16_ms)):
                tot[key] += v
            tot["err"] = max(tot["err"], err)
            del x, packed, scale
        rows[(kname, m)] = tot
    torch.cuda.empty_cache()

    # -- phase 4: 2-layer full-width model, card vs CPU -------------------------------
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

    cfg2 = T.ModelConfig.mistral_7b()
    cfg2 = T.ModelConfig(**{**cfg2.__dict__, "n_layers": 2})
    p_gpu = synth_params(cfg2, seed=1, fuse=True, device=dev)
    p_cpu = T.params_to(p_gpu, "cpu")
    g_cpu = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg2.vocab_size, (1, 300), generator=g_cpu, dtype=torch.int32)
    c_gpu = T.KVCache.zeros(cfg2, 1, 304, device=dev)
    c_cpu = T.KVCache.zeros(cfg2, 1, 304, device="cpu")
    toks = prompt
    for step in range(5):  # prefill, then 4 decode steps fed the CPU run's greedy token
        with torch.no_grad():
            lg_gpu, c_gpu = T.forward(p_gpu, cfg2, toks.to(dev), c_gpu, last_only=True)
            lg_cpu, c_cpu = T.forward(p_cpu, cfg2, toks, c_cpu, last_only=True)
        lg_gpu = lg_gpu.cpu()
        d = (lg_gpu - lg_cpu).abs().max().item()
        rel = ((lg_gpu - lg_cpu).norm() / lg_cpu.norm()).item()
        # prefill takes the w4a8 path: a bf16 flip of one activation can move
        # its K-tile's int8 scale (one step ~ 1/127 of the tile)
        check(bool(torch.isfinite(lg_gpu).all()), "2-layer model: non-finite logits")
        check(d <= 6e-2 * lg_cpu.abs().max().item() and rel <= 3e-2,
              f"2-layer model step {step}: max|d| {d}, rel L2 {rel}")
        print(f"[4] 2-layer full-width model step {step}: max|dlogit| {d:.4g} of max {lg_cpu.abs().max().item():.4g}, "
              f"rel L2 {rel:.3g}, argmax gpu {int(lg_gpu.argmax())} cpu {int(lg_cpu.argmax())}")
        toks = lg_cpu[:, -1].argmax(-1).to(torch.int32)[:, None]
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

    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
    for name in ("matmul_pk", "matmul_pk_minner", "matmul_pk_w4a8"):
        check(launches[name] > 0, f"main path never launched {name}")
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

    # -- kernel table ------------------------------------------------------------------
    k_launch = launches["matmul_pk"] + launches["matmul_pk_minner"] + launches["matmul_pk_w4a8"]
    kernels_json.append(dict(
        name="K1 decode_pairs (ramp, 4096x28672 bytes; on the main path inlined in K2-K4)", route="cuda",
        source="torch_bnb_fp4_tpu_torch/csrc/pairk_decode.cuh",
        replaces="torch_bnb_fp4_tpu/ops/kernels.py:573", launches=k_launch, max_abs_err=0.0,
        ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound * 1e3, bound_by=k1_by, library_ms=None))
    meta = {"K2": ("matmul_pk", "matmul_pk.cu", 655), "K3": ("matmul_pk_minner", "matmul_pk_minner.cu", 702),
            "K4": ("matmul_pk_w4a8", "matmul_pk_w4a8.cu", 750)}
    for (kname, m), tot in rows.items():
        wrapper, src, line = meta[kname]
        bnd, by = P.bound_s(tot["bytes"], tot["ops"], P.H100_INT8_OPS if kname == "K4" else P.H100_BF16_FLOPS)
        kernels_json.append(dict(
            name=f"{kname} {wrapper} (M={m}, the 4 fused matmuls of one Mistral-7B layer)", route="cuda",
            source=f"torch_bnb_fp4_tpu_torch/csrc/{src}", replaces=f"torch_bnb_fp4_tpu/ops/kernels.py:{line}",
            launches=launches[wrapper], max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=bnd * 1e3, bound_by=by, library_ms=None, bf16_matmul_ms=tot["bf16_ms"]))
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
