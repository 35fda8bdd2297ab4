"""Chunked prefill on the engine's static prefill cache (CPU).

Every chunk of a chunked admission runs one program per chunk width and row
count over the engine's static buffers: one batch-1 prefill cache with the
slot cache's rows per layer, of which a chunk attends over leading rows, the
chunk's tokens and last index in, the draw and its logprob out.  On the card
the program is a CUDA graph; here it runs eagerly, so these tests hold what
the graph replays:

* the tokens and logprobs of a plain prompt, a prefix-cache fork and a
  multi-LoRA engine equal those of the bucket-sized private cache that the
  static cache replaced (:func:`_bucket_path`: a cache of the prompt's 32-row
  bucket, its chunks through ``T.forward`` with an integer last index, its
  rows spliced into a cache of the slot's geometry, then greedy one-token
  forwards), also where K7's threshold falls inside the prompts;
* every chunk keeps, layer by layer, the attention route of the bucket-sized
  cache, and the dense route reads at most twice the rows the chunk needs;
* ``warmup()`` runs the program of every chunk width and row count whatever
  prompt lengths it is given, and prompts of other buckets then add no
  program;
* ``Engine._pf`` (read by ``perfbench/loadgen.py``) keeps ``req``, ``done``
  and ``lp_pad`` and advances one chunk per ``step()``;
* ``stats()`` counts every chunk as eager on the CPU.

Tolerances: greedy tokens identical; logprobs 1e-5 (the static cache only
adds masked rows, whose probabilities are exactly 0).
"""

import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu_torch.models import lora as LoRA
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request

CFG_W = T.ModelConfig.tiny_test(n_layers=2, sliding_window=64)  # rings of (64/32 + 1) * 32 = 96 rows at chunk 32
CFG_G = T.ModelConfig.tiny_test(n_layers=1)  # global attention: the prefill cache has max_len rows


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params_w():
    return T.quantize_params(CFG_W, T.random_weights(CFG_W, seed=4), fuse=True, device="cpu")


@pytest.fixture(scope="module")
def params_g():
    return T.quantize_params(CFG_G, T.random_weights(CFG_G, seed=9), fuse=True, device="cpu")


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, CFG_W.vocab_size, n).tolist()


@torch.no_grad()
def _bucket_path(params, cfg, ecfg, prompt, n, aidx=None):
    """Greedy tokens and logprobs of ``prompt`` prefilled in chunks on a
    private cache of its bucket and decoded at batch 1 (what the engine ran
    before its prefill cache was static)."""
    c, ml = ecfg.prefill_chunk, ecfg.max_len
    ring = c if ecfg.sliding_kv and cfg.sliding_window is not None else 0
    lp = len(prompt)
    lp_pad = min((lp + 31) // 32 * 32, ml)
    kw = {} if aidx is None else dict(adapter_idx=torch.tensor([aidx], dtype=torch.int32))
    small = T.KVCache.zeros(cfg, 1, lp_pad, write_chunk=ring, device="cpu")
    for lo in range(0, lp_pad, c):
        hi = min(lo + c, lp_pad)
        toks = torch.zeros((1, hi - lo), dtype=torch.int32)
        toks[0, : min(lp, hi) - lo] = torch.tensor(prompt[lo:hi])
        logits, small = T.forward(params, cfg, toks, small, last_index=min(lp, hi) - 1 - lo, **kw)
    slot = T.KVCache.zeros(cfg, 1, ml, write_chunk=ring, device="cpu")
    for big, sm in zip(slot.k + slot.v, small.k + small.v):
        big[:, : sm.shape[1]].copy_(sm)
    slot.length.fill_(lp)
    out, lps = [], []
    for j in range(n):
        lg = logits[0, -1]
        t = int(lg.argmax())
        out.append(t)
        lps.append(float(torch.log_softmax(lg.float(), -1)[t]))
        if j < n - 1:
            logits, slot = T.forward(params, cfg, torch.tensor([[t]], dtype=torch.int32), slot, **kw)
    return out, lps


def _hold(res, want):
    tokens, lps = want
    assert res.tokens == tokens
    np.testing.assert_allclose(res.logprobs, lps, rtol=0, atol=1e-5)


def test_plain_prompts_equal_the_bucket_cache(params_w):
    """Prompts of one to five chunks, the longest wrapping the 96-row rings,
    served one after another on the one prefill cache."""
    ecfg = EngineConfig(max_batch=1, max_len=192, inner_steps=2, prefill_chunk=32, logprobs=True)
    eng = Engine(params_w, CFG_W, ecfg)
    assert [a.shape[1] for a in eng._pcache.k] == [96, 96]
    ptr = eng._pcache.k[0].data_ptr()
    prompts = {i: _prompt(n, i) for i, n in enumerate((20, 75, 150, 33))}
    res = eng.run([Request(uid=i, prompt=p, max_new_tokens=6) for i, p in prompts.items()])
    assert eng._pcache.k[0].data_ptr() == ptr  # one static cache, never rebound
    for i, p in prompts.items():
        _hold(res[i], _bucket_path(params_w, CFG_W, ecfg, p, 6))


def test_prefix_fork_equals_the_bucket_cache(params_w):
    """A stored donor's leading 64 rows forked into the prefill cache: the
    suffix chunks then give the tokens of the whole prompt prefilled on its
    own bucket-sized cache."""
    ecfg = EngineConfig(max_batch=1, max_len=192, inner_steps=2, prefill_chunk=32, logprobs=True,
                        prefix_cache=True, prefix_store=1)
    eng = Engine(params_w, CFG_W, ecfg)
    base = _prompt(70, 5)
    prompts = {0: base, 1: base[:66] + _prompt(20, 6)}
    res = {}
    for i, p in prompts.items():
        res.update(eng.run([Request(uid=i, prompt=p, max_new_tokens=5)]))
    st = eng.stats()
    assert st["prefix_hits"] == 1 and st["prefix_tokens_reused"] == 64
    for i, p in prompts.items():
        _hold(res[i], _bucket_path(params_w, CFG_W, ecfg, p, 5))


def test_multi_lora_chunks_equal_the_bucket_cache():
    """The adapter index rides in the static buffer: requests under two
    adapters and none, each against the bucket-sized path with its index."""
    rng = np.random.default_rng(3)
    kv = CFG_G.n_kv_heads * CFG_G.head_dim
    shapes = {"self_attn.q_proj": (CFG_G.dim, CFG_G.dim), "self_attn.v_proj": (kv, CFG_G.dim)}

    def adapter(r):
        return LoRA.PEFTAdapter(r=r, alpha=2.0 * r, weights={
            f"model.layers.0.{t}": ((rng.standard_normal((r, s[1])) * 0.05).astype(np.float32),
                                    (rng.standard_normal((s[0], r)) * 0.05).astype(np.float32))
            for t, s in shapes.items()})

    base = T.quantize_params(CFG_G, T.random_weights(CFG_G, seed=9), device="cpu")  # adapters wrap unfused linears
    mp, ids = LoRA.attach_multi_lora(base, CFG_G, {"a": adapter(8), "b": adapter(4)})
    ecfg = EngineConfig(max_batch=1, max_len=128, inner_steps=2, prefill_chunk=64, logprobs=True)
    eng = Engine(mp, CFG_G, ecfg, adapter_ids=ids)
    reqs = {0: (_prompt(90, 7), "a"), 1: (_prompt(40, 8), "b"), 2: (_prompt(90, 7), None)}
    res = eng.run([Request(uid=i, prompt=p, max_new_tokens=5, adapter=a) for i, (p, a) in reqs.items()])
    for i, (p, a) in reqs.items():
        _hold(res[i], _bucket_path(mp, CFG_G, ecfg, p, 5, aidx=0 if a is None else ids[a]))
    assert res[0].tokens != res[2].tokens  # the adapter took part


def test_warmup_runs_every_width_and_serving_adds_none(params_g):
    """warmup(prompt_lens=[40]) runs the chunk program of every width 32-128
    over 128 and 256 rows; prompts of other buckets (final chunks 32, 64, 96
    and 128 wide) add no program, and the chunk counts start at warmup's
    end."""
    eng = Engine(params_g, CFG_G, EngineConfig(max_batch=2, max_len=256, inner_steps=2, prefill_chunk=128))
    warm = eng.warmup(prompt_lens=[40])
    keys = {k for k in eng._programs if k[0] == "chunk"}
    assert keys == {("chunk", w, (r,), False) for w in (32, 64, 96, 128) for r in (128, 256)}
    assert warm["prefill"] == 8
    assert eng.stats()["prefill_chunks_eager"] == 0
    eng.run([Request(uid=i, prompt=_prompt(n, i), max_new_tokens=3) for i, n in enumerate((30, 150, 200, 250))])
    assert eng.traces == warm and {k for k in eng._programs if k[0] == "chunk"} == keys


def test_widths_include_the_tail_of_a_clamped_bucket(params_g):
    """max_len 100 clamps a 99-token prompt's bucket to 100 rows: chunks of
    64 and 36, and warmup runs the 36-wide program too."""
    eng = Engine(params_g, CFG_G, EngineConfig(max_batch=1, max_len=100, inner_steps=1, prefill_chunk=64))
    assert eng._chunk_keys() == {(32, (64,)), (64, (64,)), (32, (100,)), (36, (100,))}
    warm = eng.warmup(prompt_lens=[10])
    res = eng.run([Request(uid=0, prompt=_prompt(99, 2), max_new_tokens=1)])
    assert eng.traces == warm and res[0].finish_reason == "length"
    ecfg = EngineConfig(max_batch=1, max_len=100, prefill_chunk=64, logprobs=True)
    assert res[0].tokens == _bucket_path(params_g, CFG_G, ecfg, _prompt(99, 2), 1)[0]


@pytest.mark.parametrize("alt", [False, True], ids=["rings", "rings_and_global"])
def test_chunk_rows_keep_the_bucket_caches_route(alt):
    """Mistral-7B's geometry (4096-token window, 4352-row rings at chunk
    256, max_len 8192; with ``alt`` every other layer global): for every
    chunk of every bucket, each layer's rows take K7 exactly where the
    prompt's bucket-sized cache did, hold the chunk's keys (rows at least
    its end, or the whole ring), and on the dense route number at most
    twice the chunk's end; 48 (rings) or 51 programs in all."""
    cfg = T.ModelConfig.tiny_test(n_layers=2, sliding_window=4096, alt_sliding=alt)
    params = T.quantize_params(cfg, T.random_weights(cfg, seed=1), fuse=True, device="cpu")
    eng = Engine(params, cfg, EngineConfig(max_batch=1, max_len=8192, prefill_chunk=256))
    full = [a.shape[1] for a in eng._pcache.k]
    assert full == ([4352, 8192] if alt else [4352, 4352])
    flash = 0
    for lp_pad in range(32, 8193, 32):
        for lo in range(0, lp_pad, 256):
            hi = min(lo + 256, lp_pad)
            w = hi - lo
            for i, r in enumerate(eng._chunk_rows(w, hi, lp_pad)):
                bucket = T.ring_rows(lp_pad, cfg.layer_sliding_window(i), 256)
                assert T._use_flash(w, r) == T._use_flash(w, bucket), (lp_pad, lo, i, r)
                assert r >= hi or r == full[i] < hi, (lp_pad, lo, i, r)
                if T._use_flash(w, r):
                    flash += 1
                    assert r == full[i]
                else:
                    assert r <= max(256, 2 * hi - 1), (lp_pad, lo, i, r)
    assert flash > 0
    assert len(eng._chunk_keys()) == (51 if alt else 48)


def test_k7_threshold_inside_the_prompts_keeps_the_bucket_route(monkeypatch):
    """With K7's threshold at 128 x 385 cells, 128-row rings around a
    512-row global layer (whose output feeds the next layer's K/V) at chunk
    128: on the bucket-sized cache a global layer takes K7 (probabilities
    rounded to bf16) for the 128-row chunks of a bucket over 384 rows, the
    dense route (f32 probabilities) below.  Every chunk's attention calls
    take the routes of the bucket-sized path, call for call, and the tokens
    agree.  The third chunk of the 384-row bucket ends at row 384, whose
    power-of-two bound (512 rows) would cross the threshold: it attends
    over 384.  Logprobs are held at 1e-5 for the dense-route prompts, whose
    row counts (128, 256, 384, 512 against 320 and 384) let the CPU's f32
    sums over the masked rows agree; at other counts they differ by
    summation order alone (about 1e-7 in f32, then flipped bf16 roundings),
    so the K7 prompt's are not compared."""
    monkeypatch.setattr(T, "_FLASH_MIN_CELLS", 128 * 385)
    calls = []
    for name in ("flash_attention", "_attention_chunked"):
        def spy(q, *a, _f=getattr(T, name), _n=name, **kw):
            calls.append((_n, q.shape[1])) if q.shape[1] > 1 else None
            return _f(q, *a, **kw)
        monkeypatch.setattr(T, name, spy)
    cfg = T.ModelConfig.tiny_test(n_layers=3, sliding_window=128, alt_sliding=True)
    params = T.quantize_params(cfg, T.random_weights(cfg, seed=6), fuse=True, device="cpu")
    ecfg = EngineConfig(max_batch=1, max_len=512, inner_steps=2, prefill_chunk=128, logprobs=True)
    eng = Engine(params, cfg, ecfg)
    assert [a.shape[1] for a in eng._pcache.k] == [256, 512, 256]
    for i, n in enumerate((300, 380, 440)):
        p = _prompt(n, 20 + i)
        del calls[:]
        res = eng.run([Request(uid=i, prompt=p, max_new_tokens=3)])[i]
        got = calls[:]
        del calls[:]
        want = _bucket_path(params, cfg, ecfg, p, 3)
        assert got == calls and (("flash_attention", 128) in got) == (n == 440), (n, got, calls)
        if n == 440:
            assert res.tokens == want[0]
        else:
            _hold(res, want)
    routes = {k[1:3] for k in eng._programs if k[0] == "chunk"}
    assert (128, (256, 384, 256)) in routes and (128, (256, 512, 256)) in routes  # dense below the threshold, K7 above


def test_pf_advances_one_chunk_per_step(params_g):
    """The benchmark's view of an admission: ``_pf`` holds the request, the
    rows done and the bucket, one chunk more after every step, and the tick's
    ``last_prefill`` names the chunk."""
    eng = Engine(params_g, CFG_G, EngineConfig(max_batch=1, max_len=128, inner_steps=1, prefill_chunk=32))
    prompt = _prompt(89, 1)  # bucket 96: three chunks
    eng.submit(Request(uid=7, prompt=prompt, max_new_tokens=2))
    for done in (32, 64):
        eng.step()
        pf = eng._pf
        assert pf["req"].uid == 7 and pf["done"] == done and pf["lp_pad"] == 96 and pf["slot"] == 0
        assert eng.last_prefill == [(7, 32, done - 32, 32)]
        assert eng.slot_req == [None]
    eng.step()
    assert eng._pf is None and eng.last_prefill == [(7, 32, 64, 25)] and eng.slot_req[0].uid == 7


def test_stats_count_every_chunk_eager_on_the_cpu(params_g):
    eng = Engine(params_g, CFG_G, EngineConfig(max_batch=2, max_len=128, inner_steps=2, prefill_chunk=32))
    eng.run([Request(uid=i, prompt=_prompt(n, i), max_new_tokens=2) for i, n in enumerate((10, 70, 100))])
    st = eng.stats()
    assert st["prefill_chunks_eager"] == 1 + 3 + 4 and st["prefill_chunks_graphed"] == 0


def test_forward_takes_the_last_index_as_a_tensor(params_g):
    """The index a CUDA graph reads from a static buffer: the same logits as
    the Python int."""
    toks = torch.tensor([_prompt(40, 3)], dtype=torch.int32)
    got = [T.forward(params_g, CFG_G, toks, T.KVCache.zeros(CFG_G, 1, 64, device="cpu"), last_index=li)[0]
           for li in (17, torch.tensor([17]))]
    assert got[0].shape == (1, 1, CFG_G.vocab_size) and torch.equal(got[0], got[1])
