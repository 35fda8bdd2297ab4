"""The port's rolling sliding-window KV rings and its model-level flash route.

* ``ring_rows`` and ``KVCache.zeros(write_chunk)`` give the JAX package's row
  counts (tests/test_sliding.py:24-35, :127-132).
* Ring vs full cache on the port, token for token: decode far past the
  window, chunked prefill, and two sequences of different ages in one batch
  (tests/test_sliding.py:89-166).  Every position a ring evicts was already
  masked by the window.
* Ring chunked prefill on the port vs the JAX package's ``forward`` on the
  same weights (carried across with convert/from_numpy.py), logits within
  2e-2 * max|logit| (tests/test_torch_transformer.py states why).
* The flash route inside the model: with the port's ``_FLASH_MIN_CELLS`` set
  low and JAX's ``_use_flash`` routing to its interpreted kernel, both run
  flash attention on the CPU; logits within 2e-2 * max|logit|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import transformer as T

from test_torch_transformer import flatten_jax_params


@pytest.mark.parametrize("cap,window,chunk", [(2048, None, 256), (2048, 512, 0), (8192, 4096, 256),
                                              (1024, 4096, 256), (10_000, 24, 8), (10_000, 100, 32),
                                              (10_000, 4096, 256), (10_000, 7, 4)])
def test_ring_rows_match_jax(cap, window, chunk):
    r = T.ring_rows(cap, window, chunk)
    assert r == JT.ring_rows(cap, window, chunk)
    if window is not None and chunk and r < cap:  # a chunk multiple, >= window + chunk
        assert r % chunk == 0 and r >= window + chunk


@pytest.mark.parametrize("kw,max_len,chunk", [(dict(sliding_window=24, n_layers=2), 64, 8),
                                              (dict(sliding_window=24, alt_sliding=True, n_layers=4), 128, 8),
                                              (dict(n_layers=2), 64, 8),
                                              (dict(sliding_window=4096, n_layers=2), 8192, 256)])
def test_cache_rows_match_jax(kw, max_len, chunk):
    cfg = JT.ModelConfig.tiny_test(**kw)
    want = [a.shape[1] for a in JT.KVCache.zeros(cfg, 1, max_len, write_chunk=chunk).k]
    cache = T.KVCache.zeros(T.ModelConfig(**cfg.__dict__), 1, max_len, write_chunk=chunk, device="cpu")
    assert [a.shape[1] for a in cache.k] == want == [a.shape[1] for a in cache.v]
    assert cache.max_len == max(want) and cache.min_rows == min(want)


def test_slot_positions_recover_the_latest_position():
    """Slot s of an R-row cache holds the latest p < L with p % R == s."""
    for rows in (8, 12):
        lens = torch.tensor([0, 1, 5, 8, 9, 20, 24], dtype=torch.int32)
        pos, valid = T.kv_slot_positions(lens, rows)
        for b, n in enumerate(lens.tolist()):
            for s in range(rows):
                want = max((p for p in range(n) if p % rows == s), default=None)
                assert bool(valid[b, s]) == (want is not None), (rows, n, s)
                if want is not None:
                    assert int(pos[b, s]) == want, (rows, n, s)


CFG_W = T.ModelConfig.tiny_test(sliding_window=24, n_layers=2)


@pytest.fixture(scope="module")
def dense_w():
    """bf16 dense params (the ring mechanics do not depend on the linear's
    kind, and dense linears keep these CPU runs fast)."""
    w = T.random_weights(CFG_W, seed=3, scale=0.5)

    def bf16(name):
        return torch.from_numpy(w[name]).to(torch.bfloat16)

    def lin(name):
        return L.dense_linear(w[name + ".weight"], device="cpu")

    layers = []
    for i in range(CFG_W.n_layers):
        p = f"model.layers.{i}."
        layers.append(T.LayerParams(
            attn_norm=bf16(p + "input_layernorm.weight"), wq=lin(p + "self_attn.q_proj"),
            wk=lin(p + "self_attn.k_proj"), wv=lin(p + "self_attn.v_proj"), wo=lin(p + "self_attn.o_proj"),
            mlp_norm=bf16(p + "post_attention_layernorm.weight"), w_gate=lin(p + "mlp.gate_proj"),
            w_up=lin(p + "mlp.up_proj"), w_down=lin(p + "mlp.down_proj")))
    return T.ModelParams(embed=bf16("model.embed_tokens.weight"), layers=layers,
                         final_norm=bf16("model.norm.weight"), lm_head=lin("lm_head"))


def _greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


@torch.no_grad()
def _decode(params, prompt, cache, n):
    logits, cache = T.forward(params, CFG_W, prompt, cache, last_only=True)
    toks = [_greedy(logits)]
    for _ in range(n):
        logits, cache = T.forward(params, CFG_W, toks[-1][:, None], cache)
        toks.append(_greedy(logits))
    return torch.stack(toks, dim=1).tolist()


def test_ring_decode_matches_full_cache(dense_w):
    """Greedy decode far past the window: ring == full, token for token."""
    prompt = torch.tensor([[3, 7, 11, 2, 9, 4, 8, 1]], dtype=torch.int32)
    ring = T.KVCache.zeros(CFG_W, 1, 64, write_chunk=8, device="cpu")
    assert [a.shape[1] for a in ring.k] == [32, 32]  # ceil(24/8 + 1) * 8
    full = _decode(dense_w, prompt, T.KVCache.zeros(CFG_W, 1, 64, device="cpu"), 48)
    assert _decode(dense_w, prompt, ring, 48) == full


def test_ring_chunked_prefill_matches_full(dense_w):
    """A 40-token prompt in ring-aligned 8-token chunks (the 32-row ring wraps),
    then decode: ring == full."""
    prompt = torch.from_numpy(np.random.default_rng(5).integers(1, CFG_W.vocab_size, (1, 40)).astype(np.int32))

    @torch.no_grad()
    def run(cache):
        for lo in range(0, 40, 8):
            logits, cache = T.forward(dense_w, CFG_W, prompt[:, lo : lo + 8], cache, last_only=True)
        tok, out = _greedy(logits), []
        for _ in range(24):
            out.append(int(tok[0]))
            logits, cache = T.forward(dense_w, CFG_W, tok[:, None], cache)
            tok = _greedy(logits)
        return out

    full = run(T.KVCache.zeros(CFG_W, 1, 96, device="cpu"))
    assert run(T.KVCache.zeros(CFG_W, 1, 96, write_chunk=8, device="cpu")) == full


def test_ring_batched_mixed_ages(dense_w):
    """Two sequences decode together after 16 extra steps: ring == full at
    identical batch shapes (per-sequence lengths, per-sequence ring phases)."""
    prompts = torch.tensor([[3, 7, 11, 2, 9, 4, 8, 1], [5, 1, 13, 6, 2, 2, 7, 9]], dtype=torch.int32)
    assert _decode(dense_w, prompts, T.KVCache.zeros(CFG_W, 2, 80, write_chunk=8, device="cpu"), 40) == \
        _decode(dense_w, prompts, T.KVCache.zeros(CFG_W, 2, 80, device="cpu"), 40)


def _carried(cfg, seed):
    jp = JT.quantize_params(cfg, JT.random_weights(cfg, seed=seed), fuse=True)
    arrays, meta = flatten_jax_params(jp)
    return jp, params_from_numpy(arrays, meta, T.ModelConfig(**cfg.__dict__), device="cpu")


def _check_logits(got, want):
    got, want = got.numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want), 2e-2 * np.abs(want).max())


def test_ring_chunked_prefill_matches_jax():
    """Chunked prefill through 32-row rings past the wrap, then one decode
    step, on both packages from the same quantized weights."""
    cfg = JT.ModelConfig.tiny_test(sliding_window=24, n_layers=2)
    tcfg = T.ModelConfig(**cfg.__dict__)
    jp, tp = _carried(cfg, seed=21)
    prompt = np.random.default_rng(8).integers(1, cfg.vocab_size, (1, 40)).astype(np.int32)
    jc = JT.KVCache.zeros(cfg, 1, 96, write_chunk=8)
    tc = T.KVCache.zeros(tcfg, 1, 96, write_chunk=8, device="cpu")
    assert [a.shape[1] for a in tc.k] == [a.shape[1] for a in jc.k] == [32, 32]
    for lo in range(0, 40, 8):
        jl, jc = JT.forward(jp, cfg, jnp.asarray(prompt[:, lo : lo + 8]), jc, last_only=True)
        with torch.no_grad():
            tl, tc = T.forward(tp, tcfg, torch.from_numpy(prompt[:, lo : lo + 8]), tc, last_only=True)
        _check_logits(tl, jl)
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [40]
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    jl, _ = JT.forward(jp, cfg, jnp.asarray(nxt), jc)
    with torch.no_grad():
        tl, _ = T.forward(tp, tcfg, torch.from_numpy(nxt), tc)
    _check_logits(tl, jl)


def test_use_flash_threshold():
    assert T._FLASH_MIN_CELLS == JT._FLASH_MIN_CELLS == 256 * 4096
    assert T._use_flash(256, 4096) and T._use_flash(6016, 6016) and T._use_flash(128, 8192)
    assert not T._use_flash(256, 4095) and not T._use_flash(127, 10**6) and not T._use_flash(1, 8192)


def test_model_flash_route_matches_jax(monkeypatch):
    """A 136-token prefill with a 64-token window takes the flash route on both
    sides (the port's plain K7, JAX's interpreted Pallas kernel); then a
    decode step on the dense route."""
    cfg = JT.ModelConfig.tiny_test(sliding_window=64, n_layers=2)
    tcfg = T.ModelConfig(**cfg.__dict__)
    jp, tp = _carried(cfg, seed=23)
    monkeypatch.setattr(T, "_FLASH_MIN_CELLS", 128 * 128)
    monkeypatch.setattr(JT, "_use_flash", lambda lq, lk: lq * lk >= 128 * 128 and lq >= 128)
    calls = []
    flash = T.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return flash(*a, **kw)

    monkeypatch.setattr(T, "flash_attention", counted)
    prompt = np.random.default_rng(9).integers(1, cfg.vocab_size, (1, 136)).astype(np.int32)
    jl, jc = JT.forward(jp, cfg, jnp.asarray(prompt), JT.KVCache.zeros(cfg, 1, 144), last_only=True)
    with torch.no_grad():
        tl, tc = T.forward(tp, tcfg, torch.from_numpy(prompt), T.KVCache.zeros(tcfg, 1, 144, device="cpu"),
                           last_only=True)
    assert len(calls) == cfg.n_layers and calls[0] == (1, 136, cfg.n_heads, cfg.head_dim)
    _check_logits(tl, jl)
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    jl, _ = JT.forward(jp, cfg, jnp.asarray(nxt), jc)
    with torch.no_grad():
        tl, _ = T.forward(tp, tcfg, torch.from_numpy(nxt), tc)
    assert len(calls) == cfg.n_layers  # Lq = 1 stays dense
    _check_logits(tl, jl)
