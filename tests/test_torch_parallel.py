"""Tensor and data parallelism (``torch_bnb_fp4_tpu_torch.parallel``) against
the JAX package's ``parallel``, at ``ModelConfig.tiny_test`` size on the CPU.

Single-process cases compare structure and bytes: ``validate_tp``'s verdicts,
``param_specs`` leaf by leaf against JAX's PartitionSpecs (a dimension in
place of each spec), ``fuse_params(tp=)``, ``quantize_params_tp``,
``shard_params`` against ``addressable_shards`` of JAX's on a (1, tp) and a
(2, 2) mesh of the conftest's virtual CPU devices, the int8 shadow at tp = 2
and ``load_checkpoint(tp=2)``: all exact.

Multi-process cases start ranks as ``torch.multiprocessing`` spawn workers
(functions of this file) on gloo CPU groups of 2 (model 2; data 2) and of 4
(data 2 x model 2), one torch thread each, at half tiny_test's width (MoE:
tests/test_torch_moe.py's tiny_test(n_experts=4)).  JAX's ``tp_forward_fn`` runs on
the same mesh shape in this process, its Pallas kernels in interpret mode.
Tolerance on logits and KV (f32 partial sums in another order, one bf16
rounding of each row-parallel output on either side): the port's tp = 1
model bound against JAX, |d| <= 2e-2 * max|ref|, and JAX's own TP bound,
max|d| < 0.05 and correlation > 0.999, both at once.  Engines at tp = 2 and
at data 2 against the port's tp = 1 engine (greedy): tokens equal, or the
first differing token a near-tie (each run's winner leads the other's by at
most 2^-7 * max|logit| in its own teacher-forced logits).
"""

import dataclasses
import functools
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec

from torch_bnb_fp4_tpu import parallel as JP
from torch_bnb_fp4_tpu.convert import checkpoint as JC
from torch_bnb_fp4_tpu.models import linear as JL
from torch_bnb_fp4_tpu.models import lora as JLoRA
from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu_torch import parallel as PP
from torch_bnb_fp4_tpu_torch.convert import load_checkpoint, save_checkpoint
from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import lora as LoRA
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.parallel import tp as TP

CFG = T.ModelConfig.tiny_test(n_layers=1)
JCFG = JT.ModelConfig.tiny_test(n_layers=1)
# the dense, LoRA and engine cases run at half tiny_test's width (tp = 2 still splits every axis); the MoE case
# at tests/test_torch_moe.py's geometry
SMALL = dict(n_layers=1, dim=512, ffn_dim=1024, n_heads=4, n_kv_heads=2)
MOE = dict(n_experts=4, experts_per_tok=2, n_layers=1)
LORA_GEOM = SMALL
ENG_CFG = dict(SMALL, n_layers=2)
SEED = 7
TOKS = np.array([[3, 1, 4, 9, 2], [1, 5, 9, 0, 3], [7, 7, 2, 8, 1], [4, 0, 6, 6, 5]], np.int32)
FORCED = np.array([[11, 12], [13, 14], [15, 16], [17, 18]], np.int32)  # teacher-forced decode tokens
PROMPTS = [[i % 250 + 1 for i in range(n)] for n in (19, 35, 3, 70)]
NEW = 6
LORA_IDX = np.array([1, 0, 2, 1], np.int32)
WORKER_TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, what):
    """The port's tp = 1 bound against JAX and JAX's own TP bound, both."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    d = np.abs(got - want).max()
    assert d <= 2e-2 * np.abs(want).max() and d < 0.05, (what, d, np.abs(want).max())
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999, what


# -- single process: geometry, specs and bytes -----------------------------------

ZOO = ("mistral_7b", "tinyllama_1b", "llama2_70b", "qwen3_8b", "qwen2_7b", "phi3_mini", "gemma_7b", "mixtral_8x7b")


@pytest.mark.parametrize("name", ZOO)
def test_validate_tp_agrees_with_jax(name):
    """Over tests/test_parallel.py's zoo and more families, tp 1-8 and 16:
    the port accepts exactly what JAX accepts (tinyllama at 4 and qwen2 at 8
    are rejects there)."""
    jcfg, cfg = getattr(JT.ModelConfig, name)(), getattr(T.ModelConfig, name)()
    verdicts = []
    for tp in (1, 2, 3, 4, 8, 16):
        try:
            JP.validate_tp(jcfg, tp)
            want = True
        except ValueError:
            want = False
        try:
            PP.validate_tp(cfg, tp)
            got = True
        except ValueError:
            got = False
        assert got == want, (name, tp)
        verdicts.append(got)
    assert verdicts[0] and not all(verdicts)


def _jax_specs(jparams):
    """{key path: split dim or None} of JAX's param_specs (the model axis's
    position in each PartitionSpec)."""
    specs = JP.param_specs(jparams)
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for path, spec in flat:
        key = tuple(getattr(k, "name", getattr(k, "idx", None)) for k in path)
        out[key] = spec.index(JP.MODEL_AXIS) if JP.MODEL_AXIS in spec else None
    return out


def _port_specs(params, specs, path=(), owner=None, out=None):
    """{key path under JAX's field names: split dim} of the port's tree."""
    out = {} if out is None else out
    if isinstance(params, torch.Tensor):
        name = path[-1]
        if not isinstance(owner, L.MultiLoRALinear):
            name = {"scale": "absmax_hi", "scale_lo": "absmax_lo"}.get(name, name)
        out[path[:-1] + (name,)] = specs
    elif isinstance(params, list):
        for i, (p, s) in enumerate(zip(params, specs)):
            _port_specs(p, s, path + (i,), owner, out)
    elif dataclasses.is_dataclass(params):
        for f in dataclasses.fields(params):
            _port_specs(getattr(params, f.name), getattr(specs, f.name), path + (f.name,), params, out)
    return out


@functools.lru_cache(maxsize=None)
def _quantized(geom: tuple):
    """(JAX config, port config, weights, JAX params, port params) of the
    tiny_test geometry ``geom`` (sorted items), quantized once per module
    (nothing here mutates params)."""
    jcfg, cfg = JT.ModelConfig.tiny_test(**dict(geom)), T.ModelConfig.tiny_test(**dict(geom))
    w = JT.random_weights(jcfg, seed=SEED)
    return jcfg, cfg, w, JT.quantize_params(jcfg, w), T.quantize_params(cfg, w, device="cpu")


def _spec_models(kind):
    """(JAX params, port params) of one kind from the same weights."""
    geom = dict(MOE) if kind == "moe" else dict(LORA_GEOM) if "lora" in kind else {}
    if kind == "quant_lm_head":
        geom["quantize_lm_head"] = True
    if kind == "splitk":
        jcfg, cfg = JT.ModelConfig.tiny_test(**geom), T.ModelConfig.tiny_test(**geom)
        w = JT.random_weights(jcfg, seed=SEED)
        return (JP.quantize_params_tp(jcfg, w, tp=2), PP.quantize_params_tp(cfg, w, tp=2, device="cpu"))
    jcfg, cfg, w, jp, tp = _quantized(tuple(sorted(geom.items())))
    if kind in ("fused", "moe"):
        return JT.fuse_params(jp, tp=2), T.fuse_params(tp, tp=2)
    if kind == "shadow":
        return JL.attach_prefill_shadow(jp, interpret=True, tp=2), L.attach_prefill_shadow(tp, tp=2)
    if kind in ("lora", "multi_lora"):
        from test_torch_lora import ALL, adapter_weights

        wa, wb = adapter_weights(cfg, 7, 8, ALL), adapter_weights(cfg, 21, 4, ALL[:1] + ALL[2:3])
        if kind == "lora":
            return (JLoRA.attach_lora(jp, jcfg, JLoRA.PEFTAdapter(r=8, alpha=16.0, weights=wa)),
                    LoRA.attach_lora(tp, cfg, LoRA.PEFTAdapter(r=8, alpha=16.0, weights=wa)))
        return (JLoRA.attach_multi_lora(jp, jcfg, {"a": JLoRA.PEFTAdapter(r=8, alpha=16.0, weights=wa),
                                                   "b": JLoRA.PEFTAdapter(r=4, alpha=8.0, weights=wb)})[0],
                LoRA.attach_multi_lora(tp, cfg, {"a": LoRA.PEFTAdapter(r=8, alpha=16.0, weights=wa),
                                                 "b": LoRA.PEFTAdapter(r=4, alpha=8.0, weights=wb)})[0])
    return jp, tp


@pytest.mark.parametrize("kind", ["plain", "fused", "splitk", "moe", "lora", "multi_lora", "quant_lm_head",
                                  "shadow"])
def test_param_specs_match_jax(kind, monkeypatch):
    """Every tensor's split dimension equals JAX's PartitionSpec's, for both
    kinds of lm_head (dense: the plain cases; quantized).  Split-K params
    come from quantize_params_tp with every layer quantized split-K (JAX's
    quantize_params makes pair-K only)."""
    if kind == "splitk":
        monkeypatch.setattr(JT, "quantize_linear", functools.partial(JL.quantize_linear, layout="splitk"))
        monkeypatch.setattr(T, "quantize_linear", functools.partial(L.quantize_linear, layout="splitk"))
    jp, tp = _spec_models(kind)
    want = _jax_specs(jp)
    got = _port_specs(tp, PP.param_specs(tp))
    assert got == want
    assert any(v is not None for v in got.values()) and any(v is None for v in got.values())


@pytest.mark.parametrize("tp", [2, 4])
def test_fuse_params_tp_bytes_match_jax(tp):
    """wqkv, w_gateup and a MoE gateup stack interleaved per shard: the bytes
    of JAX's fuse_params(tp=)."""
    for geom in ({}, MOE):
        _, _, _, jp, tq = _quantized(tuple(sorted(geom.items())))
        jf, tf = JT.fuse_params(jp, tp=tp), T.fuse_params(tq, tp=tp)
        for jl, tl in zip(jf.layers, tf.layers):
            pairs = [(jl.wqkv, tl.wqkv)] + ([(jl.moe.gateup, tl.moe.gateup)] if geom else
                                           [(jl.w_gateup, tl.w_gateup)])
            for j, t in pairs:
                np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
                np.testing.assert_array_equal(t.scale.float().numpy(), _f32(j.absmax_hi))
                assert (t.n_out, t.k_in) == (j.n_out, j.k_in)
        # tp = 1 interleaves nothing
        assert torch.equal(T.fuse_params(tq).layers[0].wqkv.packed, T.fuse_params(tq, tp=1).layers[0].wqkv.packed)


def test_quantize_params_tp_splitk_bytes_match_jax(monkeypatch):
    """With every layer split-K, wo and w_down are requantized with k_shards
    = tp: JAX's bytes at tp 2 and 4; pair-K params are returned as
    quantize_params makes them, fused per shard on request."""
    w = JT.random_weights(JCFG, seed=SEED)
    pk = PP.quantize_params_tp(CFG, w, tp=2, fuse=True, device="cpu")
    np.testing.assert_array_equal(pk.layers[0].wqkv.packed.numpy(),
                                  np.asarray(JP.quantize_params_tp(JCFG, w, tp=2, fuse=True).layers[0].wqkv.packed))
    monkeypatch.setattr(JT, "quantize_linear", functools.partial(JL.quantize_linear, layout="splitk"))
    monkeypatch.setattr(T, "quantize_linear", functools.partial(L.quantize_linear, layout="splitk"))
    for tp in (2, 4):
        jp, tpar = JP.quantize_params_tp(JCFG, w, tp=tp), PP.quantize_params_tp(CFG, w, tp=tp, device="cpu")
        for f in ("wq", "wo", "w_down"):
            j, t = getattr(jp.layers[0], f), getattr(tpar.layers[0], f)
            assert t.layout == j.layout == "splitk" and t.k_shards == j.k_shards == (1 if f == "wq" else tp)
            np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
            np.testing.assert_array_equal(t.scale.numpy(), _f32(j.absmax_hi))
            np.testing.assert_array_equal(t.scale_lo.numpy(), _f32(j.absmax_lo))
    with pytest.raises(ValueError, match="pairk-only"):
        PP.quantize_params_tp(CFG, w, tp=2, fuse=True, device="cpu")
    with pytest.raises(ValueError, match="does not shard"):
        PP.quantize_params_tp(CFG, w, tp=3, device="cpu")


def _rank_mesh(n_data, n_model, rank):
    """Rank ``rank``'s Mesh without process groups: enough for shard_params
    and shard_cache, which issue no collective."""
    d, m = divmod(rank, n_model)
    return TP.Mesh(n_data=n_data, n_model=n_model, rank=rank, data_index=d, model_index=m, model_group=None,
                   data_group=None, backend="gloo", device=torch.device("cpu"))


def _jax_shard(arr, mesh, rank):
    dev = mesh.devices.reshape(-1)[rank]
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (1, 4), (2, 2)])
def test_shard_params_match_jax_shards(n_data, n_model):
    """Every tensor of rank r's shard_params (fused, with prefill shadows)
    equals addressable_shards of JAX's shard_params on device r of a
    (n_data, n_model) mesh; shard_cache's K rows likewise.  The local static
    shapes are JAX's _localize_params's."""
    w = JT.random_weights(JCFG, seed=SEED)
    jfull = JL.attach_prefill_shadow(JP.quantize_params_tp(JCFG, w, tp=n_model, fuse=True), interpret=True,
                                     tp=n_model)
    tfull = L.attach_prefill_shadow(PP.quantize_params_tp(CFG, w, tp=n_model, fuse=True, device="cpu"), tp=n_model)
    jmesh = JP.make_mesh(n_model=n_model, n_data=n_data)
    jsh = JP.shard_params(jfull, jmesh)
    jleaves = jax.tree_util.tree_flatten_with_path(jsh)[0]
    jcache = JP.shard_cache(JT.KVCache.zeros(JCFG, 2 * n_data, 8), jmesh)
    tcache = T.KVCache.zeros(CFG, 2 * n_data, 8, device="cpu")
    tcache.k[0].copy_(torch.arange(tcache.k[0].numel(), dtype=torch.float32).reshape(tcache.k[0].shape))
    jcache = dataclasses.replace(jcache, k=[JP.shard_cache(JT.KVCache(k=[jnp.asarray(tcache.k[0].float().numpy()
                                                                                     ).astype(jnp.bfloat16)],
                                                                      v=[jnp.zeros_like(jcache.v[0])],
                                                                      length=jcache.length), jmesh).k[0]])
    for rank in range(n_data * n_model):
        mesh = _rank_mesh(n_data, n_model, rank)
        local = PP.shard_params(tfull, mesh)
        got = {k: v for k, v in _port_specs(local, local).items()}
        for path, leaf in jleaves:
            key = tuple(getattr(k, "name", getattr(k, "idx", None)) for k in path)
            t = got[key]
            want = _jax_shard(leaf, jmesh, rank)
            np.testing.assert_array_equal(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
                                          want.astype(np.float32) if t.dtype == torch.bfloat16 else want)
        lp = local.layers[0]
        assert lp.wqkv.n_out == (CFG.n_heads + 2 * CFG.n_kv_heads) * CFG.head_dim // n_model
        assert (lp.wo.k_in, lp.w_down.k_in) == (CFG.q_dim // n_model, CFG.ffn_dim // n_model)
        assert local.lm_head.n_out == CFG.vocab_size // n_model
        kc = PP.shard_cache(tcache, mesh).k[0]
        np.testing.assert_array_equal(kc.float().numpy(), _f32(_jax_shard(jcache.k[0], jmesh, rank)))


def test_attach_int8_shadow_tp_matches_jax():
    """At tp = 2 the tile depth divides the per-shard K: JAX's bytes and
    w8_block_k; the k_pad refusal is JAX's; attach_local_shadow on the
    shards gives the shards of the shadowed model."""
    rng = np.random.default_rng(3)
    for k, tp, bk in ((2048, 2, 1024), (1536, 2, 256), (3072, 4, 256)):
        w = (rng.standard_normal((256, k)) * 0.02).astype(np.float32)
        j = JL.attach_int8_shadow(JL.quantize_linear(w), interpret=True, tp=tp)
        t = L.attach_int8_shadow(L.quantize_linear(w, device="cpu"), tp=tp)
        assert t.w8_block_k == j.w8_block_k == bk
        np.testing.assert_array_equal(t.w8.numpy(), np.asarray(j.w8))
        np.testing.assert_array_equal(t.w8_scale.numpy(), np.asarray(j.w8_scale))
    q = L.quantize_linear(np.zeros((128, 512), np.float32), device="cpu")
    jq = JL.quantize_linear(np.zeros((128, 512), np.float32))
    with pytest.raises(ValueError) as je:
        JL.attach_int8_shadow(jq, interpret=True, tp=4)
    with pytest.raises(ValueError) as te:
        L.attach_int8_shadow(q, tp=4)
    assert str(te.value) == str(je.value) == "k_pad=512 does not shard into 256-multiples over tp=4"
    w = JT.random_weights(JCFG, seed=SEED)
    full = PP.quantize_params_tp(CFG, w, tp=2, fuse=True, device="cpu")
    want = L.attach_prefill_shadow(full, tp=2)
    for rank in range(2):
        mesh = _rank_mesh(1, 2, rank)
        got = TP.attach_local_shadow(PP.shard_params(full, mesh), 2)
        ref = PP.shard_params(want, mesh)
        for f in ("wqkv", "wo", "w_gateup", "w_down"):
            a, b = getattr(got.layers[0], f), getattr(ref.layers[0], f)
            assert a.w8_block_k == b.w8_block_k and torch.equal(a.w8, b.w8) and torch.equal(a.w8_scale, b.w8_scale)


@pytest.mark.parametrize("layout", ["pairk", "splitk"])
def test_load_checkpoint_tp_matches_jax(tmp_path, layout, monkeypatch):
    """load_checkpoint(tp=2) of one checkpoint in both packages: split-K
    row-parallel layers repacked to k_shards = 2 and pair-K fused per shard,
    byte for byte."""
    if layout == "splitk":
        monkeypatch.setattr(T, "quantize_linear", functools.partial(L.quantize_linear, layout="splitk"))
    w = JT.random_weights(JCFG, seed=SEED)
    save_checkpoint(str(tmp_path), CFG, T.quantize_params(CFG, w, device="cpu"))
    fuse = layout == "pairk"
    _, jp = JC.load_checkpoint(str(tmp_path), tp=2, fuse=fuse)
    _, tp = load_checkpoint(str(tmp_path), tp=2, fuse=fuse, device="cpu")
    names = ("wqkv", "wo", "w_gateup", "w_down") if fuse else ("wq", "wo", "w_gate", "w_down")
    for f in names:
        j, t = getattr(jp.layers[0], f), getattr(tp.layers[0], f)
        assert (t.layout, t.k_shards, t.n_out, t.k_in) == (j.layout, j.k_shards, j.n_out, j.k_in)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        np.testing.assert_array_equal(t.scale.float().numpy(), _f32(j.absmax_hi))
    if not fuse:
        assert tp.layers[0].wo.k_shards == tp.layers[0].w_down.k_shards == 2


def test_backend_rule():
    """nccl only when every rank has a CUDA device no other rank on its host
    uses; CPU ranks, and ranks sharing a card, take gloo."""
    assert TP.mesh_backend([("h", "cuda:0"), ("h", "cuda:1")]) == "nccl"
    assert TP.mesh_backend([("a", "cuda:0"), ("b", "cuda:0")]) == "nccl"
    assert TP.mesh_backend([("h", "cuda:0"), ("h", "cuda:0")]) == "gloo"
    assert TP.mesh_backend([("h", "cpu"), ("h", "cpu")]) == "gloo"
    assert TP.mesh_backend([("h", "cuda:0"), ("h", "cpu")]) == "gloo"


def test_local_view_contract():
    """local_view rewrites a local shard's static shapes (pair-K: n_out and
    k_in; split-K: k_shards too), passes through adapters to their base,
    and refuses widths that do not split."""
    w = np.zeros((256, 1024), np.float32)
    q = L.quantize_linear(w, device="cpu")
    assert (L.local_view(q, n_parts=2).n_out, L.local_view(q, k_parts=4).k_in) == (128, 256)
    s = L.quantize_linear(w, k_shards=4, device="cpu")
    v = L.local_view(s, k_parts=2)
    assert (v.k_in, v.k_shards) == (512, 2)
    lo = L.lora_linear(q, np.zeros((4, 1024), np.float32), np.zeros((256, 4), np.float32), alpha=8.0)
    assert L.local_view(lo, n_parts=2).base.n_out == 128
    for bad in (dict(n_parts=3), dict(k_parts=3)):
        with pytest.raises(ValueError):
            L.local_view(q, **bad)
    with pytest.raises(ValueError, match="k_shards=4"):
        L.local_view(L.quantize_linear(np.zeros((256, 2048), np.float32), k_shards=4, device="cpu"), k_parts=8)


# -- multi-process: gloo CPU groups ---------------------------------------------


def _teacher_forced(fwd, params, cfg, prompts, tokens, gather):
    """Full-vocabulary logits of each request's prompt + its tokens, one
    forward each, at the positions that chose its tokens."""
    out = {}
    for uid, p in enumerate(prompts):
        seq = p + tokens[uid]
        cache = T.KVCache.zeros(cfg, 1, len(seq) + 1, device="cpu")
        with torch.no_grad():
            lg, _ = fwd(params, torch.tensor([seq], dtype=torch.int32), cache)
        out[uid] = gather(lg[0, len(p) - 1 : len(seq) - 1]).numpy()
    return out


def _engine_case(mesh):
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request

    cfg = T.ModelConfig.tiny_test(**ENG_CFG)
    w = T.random_weights(cfg, seed=SEED)
    params = PP.shard_params(PP.quantize_params_tp(cfg, w, tp=mesh.n_model, fuse=True, device="cpu"), mesh)
    eng = Engine(params, cfg, EngineConfig(max_batch=4, max_len=128, inner_steps=4), mesh=mesh)
    res = eng.run([Request(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(PROMPTS)])
    tokens = {u: c.tokens for u, c in res.items()}
    lcfg = dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // mesh.n_model)

    def fwd(p, t, c):
        return PP.tp_forward_fn(p, cfg, c, mesh)(p, t, c)

    lg = _teacher_forced(lambda p, t, c: fwd(p, t, T.KVCache.zeros(lcfg, 1, c.max_len, device="cpu")), params, cfg,
                         PROMPTS, tokens, lambda x: TP.gather_vocab(x, mesh))
    return dict(tokens=tokens, logits=lg, stats=eng.stats())


def _fwd_case(mesh, cfg, params, toks, forced, adapter_idx=None):
    """Prefill ``toks`` and teacher-force ``forced`` through tp_forward_fn:
    this rank's logits of every call, its K cache of layer 0 and lengths."""
    b = toks.shape[0] // mesh.n_data
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    cache = PP.shard_cache(T.KVCache.zeros(cfg, toks.shape[0], 8, device="cpu"), mesh)
    extra = () if adapter_idx is None else (torch.from_numpy(adapter_idx[rows]),)
    fwd = PP.tp_forward_fn(params, cfg, cache, mesh, with_adapter_idx=adapter_idx is not None)
    out = []
    with torch.no_grad():
        lg, cache = fwd(params, torch.from_numpy(toks[rows]), cache, *extra)
        out.append(lg.numpy())
        for i in range(forced.shape[1]):
            lg, cache = fwd(params, torch.from_numpy(forced[rows, i : i + 1]), cache, *extra)
            out.append(lg.numpy())
    return dict(logits=out, k0=cache.k[0].float().numpy(), length=cache.length.numpy())


def _dense_case(mesh):
    TP.reset_collective_counts()
    cfg = T.ModelConfig.tiny_test(**SMALL)
    w = T.random_weights(cfg, seed=SEED)
    p = PP.shard_params(PP.quantize_params_tp(cfg, w, tp=mesh.n_model, fuse=True, device="cpu"), mesh)
    out = _fwd_case(mesh, cfg, p, TOKS[: 2 * mesh.n_data], FORCED[: 2 * mesh.n_data])
    out["collectives"] = TP.collective_counts()
    return out


def _moe_case(mesh):
    cfg = T.ModelConfig.tiny_test(**MOE)
    w = T.random_weights(cfg, seed=SEED)
    p = PP.shard_params(PP.quantize_params_tp(cfg, w, tp=mesh.n_model, fuse=True, device="cpu"), mesh)
    return _fwd_case(mesh, cfg, p, TOKS[:2], FORCED[:2, :0])


def _lora_case(mesh):
    from test_torch_lora import ALL, adapter_weights

    cfg = T.ModelConfig.tiny_test(**LORA_GEOM)
    w = T.random_weights(cfg, seed=SEED)
    wa, wb = adapter_weights(cfg, 7, 8, ALL), adapter_weights(cfg, 21, 4, ALL[:1] + ALL[2:3])
    full, _ = LoRA.attach_multi_lora(T.quantize_params(cfg, w, device="cpu"), cfg,
                                     {"a": LoRA.PEFTAdapter(r=8, alpha=16.0, weights=wa),
                                      "b": LoRA.PEFTAdapter(r=4, alpha=8.0, weights=wb)})
    return _fwd_case(mesh, cfg, PP.shard_params(full, mesh), TOKS, FORCED[:, :1], LORA_IDX)


def _greedy_case(mesh):
    """make_decode_step / make_prefill: argmax of the gathered logits."""
    cfg = T.ModelConfig.tiny_test(**SMALL)
    w = T.random_weights(cfg, seed=SEED)
    p = PP.shard_params(PP.quantize_params_tp(cfg, w, tp=mesh.n_model, fuse=True, device="cpu"), mesh)
    cache = PP.shard_cache(T.KVCache.zeros(cfg, 2, 8, device="cpu"), mesh)
    pre, step = PP.make_prefill(p, cfg, cache, mesh), PP.make_decode_step(p, cfg, cache, mesh)
    tok, cache = pre(p, torch.from_numpy(TOKS[:2]), cache)
    toks = [tok.numpy()]
    for _ in range(2):
        tok, cache = step(p, tok, cache)
        toks.append(tok.numpy())
    return np.stack(toks, 1)


CASES = {"dense": _dense_case, "moe": _moe_case, "lora": _lora_case, "engine": _engine_case,
         "greedy": _greedy_case}


def _worker(rank, world, port, jobs, q):
    """One rank: join the job, then run each (case, n_data, n_model) on a
    mesh of that shape; puts (rank, {case@shape: result}) or (rank, error)."""
    try:
        torch.set_num_threads(1)
        PP.init_multihost(f"127.0.0.1:{port}", world, rank)
        out = {}
        for case, n_data, n_model in jobs:
            mesh = PP.make_mesh(n_model=n_model, n_data=n_data, device="cpu")
            out[f"{case}@{n_data}x{n_model}"] = CASES[case](mesh)
        q.put((rank, out))
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported to the test, which fails with it
        q.put((rank, traceback.format_exc()))


def _start(world, jobs):
    """Start ``world`` ranks running ``jobs``; returns (processes, queue)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, world, port, jobs, q)) for r in range(world)]
    for p in procs:
        p.start()
    return procs, q


def _collect(procs, q):
    """Each rank's results (the queue drained before the joins); a rank's
    error or a non-zero exit fails the test."""
    try:
        res = dict(q.get(timeout=WORKER_TIMEOUT) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: v for r, v in res.items() if isinstance(v, str)}
    assert not errors, errors
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return res


@pytest.fixture(scope="module")
def ranks():
    """Two jobs started together: two ranks (a (1, 2) mesh for the dense,
    MoE and greedy cases and an engine at tp = 2, then a (2, 1) mesh for an
    engine at data 2) and four ranks (a (2, 2) mesh for the dense and
    multi-LoRA cases)."""
    two = _start(2, [("dense", 1, 2), ("moe", 1, 2), ("greedy", 1, 2), ("engine", 1, 2), ("engine", 2, 1)])
    four = _start(4, [("dense", 2, 2), ("lora", 2, 2)])
    return _collect(*two), _collect(*four)


@pytest.fixture(scope="module")
def ranks2(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def ranks4(ranks):
    return ranks[1]


def _jax_run(jcfg, jparams, n_data, n_model, toks, forced, adapter_idx=None):
    """JAX's tp_forward_fn on a (n_data, n_model) mesh: the global logits of
    the prefill and each teacher-forced step, and the K cache of layer 0."""
    mesh = JP.make_mesh(n_model=n_model, n_data=n_data)
    p = JP.shard_params(jparams, mesh)
    cache = JP.shard_cache(JT.KVCache.zeros(jcfg, toks.shape[0], 8), mesh)
    fwd = jax.jit(JP.tp_forward_fn(p, jcfg, cache, mesh, with_adapter_idx=adapter_idx is not None))
    extra = () if adapter_idx is None else (jnp.asarray(adapter_idx),)
    lg, cache = fwd(p, jnp.asarray(toks), cache, *extra)
    out = [np.asarray(lg)]
    for i in range(forced.shape[1]):
        lg, cache = fwd(p, jnp.asarray(forced[:, i : i + 1]), cache, *extra)
        out.append(np.asarray(lg))
    return out, _f32(cache.k[0]), np.asarray(cache.length)


def _held(port_out, jax_out, n_data, n_model, vocab, what):
    """Rank r's logits and KV against its slice of JAX's global arrays."""
    jlg, jk, jlen = jax_out
    b = jlg[0].shape[0] // n_data
    heads = jk.shape[2] // n_model
    for rank, r in port_out.items():
        d, m = divmod(rank, n_model)
        rows, cols = slice(d * b, (d + 1) * b), slice(m * vocab // n_model, (m + 1) * vocab // n_model)
        for step, (got, want) in enumerate(zip(r["logits"], jlg)):
            _close(got, want[rows, :, cols], f"{what} rank {rank} step {step}")
        _close(r["k0"], jk[rows, :, m * heads : (m + 1) * heads], f"{what} rank {rank} K cache")
        np.testing.assert_array_equal(r["length"], jlen[rows])


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_tp_forward_and_decode_match_jax(ranks2, ranks4, n_data, n_model):
    """The dense model (fused per shard): prefill of 5 tokens, then 2
    teacher-forced decode steps, each rank's vocabulary shard of the logits
    and its KV heads of its batch rows against JAX's tp_forward_fn on the
    same mesh shape; 2 all-reduces per layer and forward."""
    res = ranks2 if n_data == 1 else ranks4
    port = {r: v[f"dense@{n_data}x{n_model}"] for r, v in res.items()}
    jcfg = JT.ModelConfig.tiny_test(**SMALL)
    jp = JP.quantize_params_tp(jcfg, JT.random_weights(jcfg, seed=SEED), tp=n_model, fuse=True)
    b = 2 * n_data
    _held(port, _jax_run(jcfg, jp, n_data, n_model, TOKS[:b], FORCED[:b]), n_data, n_model, jcfg.vocab_size, "dense")
    calls = 1 + FORCED.shape[1]
    assert all(v["collectives"]["all_reduce"] == 2 * jcfg.n_layers * calls for v in port.values())


def test_moe_tp2_matches_jax(ranks2):
    """Mixtral-style experts at tp = 2 (stacks split on their trailing axes,
    router replicated, one all-reduce of the weighted expert sum): a
    5-token prefill of 2 rows against JAX."""
    port = {r: v["moe@1x2"] for r, v in ranks2.items()}
    jcfg = JT.ModelConfig.tiny_test(**MOE)
    jp = JP.quantize_params_tp(jcfg, JT.random_weights(jcfg, seed=SEED), tp=2, fuse=True)
    _held(port, _jax_run(jcfg, jp, 1, 2, TOKS[:2], FORCED[:2, :0]), 1, 2, jcfg.vocab_size, "moe")


def test_multi_lora_2x2_matches_jax(ranks4):
    """Two adapters stacked on one base, rows under a, none, b and a, on a
    (2, 2) mesh: column-parallel targets split b, row-parallel ones a."""
    port = {r: v["lora@2x2"] for r, v in ranks4.items()}
    from test_torch_lora import ALL, adapter_weights

    jcfg, cfg = JT.ModelConfig.tiny_test(**LORA_GEOM), T.ModelConfig.tiny_test(**LORA_GEOM)
    wa, wb = adapter_weights(cfg, 7, 8, ALL), adapter_weights(cfg, 21, 4, ALL[:1] + ALL[2:3])
    jp, _ = JLoRA.attach_multi_lora(JT.quantize_params(jcfg, JT.random_weights(jcfg, seed=SEED)), jcfg,
                                    {"a": JLoRA.PEFTAdapter(r=8, alpha=16.0, weights=wa),
                                     "b": JLoRA.PEFTAdapter(r=4, alpha=8.0, weights=wb)})
    _held(port, _jax_run(jcfg, jp, 2, 2, TOKS, FORCED[:, :1], LORA_IDX), 2, 2, jcfg.vocab_size, "multi-LoRA")


def test_greedy_steps_take_the_global_argmax(ranks2):
    """make_prefill / make_decode_step at tp = 2: both ranks emit the same
    tokens, JAX's make_prefill / make_decode_step's on a (1, 2) mesh."""
    got = [v["greedy@1x2"] for v in ranks2.values()]
    assert np.array_equal(got[0], got[1])
    jcfg = JT.ModelConfig.tiny_test(**SMALL)
    mesh = JP.make_mesh(n_model=2, n_data=1)
    p = JP.shard_params(JP.quantize_params_tp(jcfg, JT.random_weights(jcfg, seed=SEED), tp=2, fuse=True), mesh)
    cache = JP.shard_cache(JT.KVCache.zeros(jcfg, 2, 8), mesh)
    tok, cache = JP.make_prefill(p, jcfg, cache, mesh)(p, jnp.asarray(TOKS[:2]), cache)
    step = JP.make_decode_step(p, jcfg, cache, mesh)
    want = [np.asarray(tok)]
    for _ in range(2):
        tok, cache = step(p, tok, cache)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(got[0], np.stack(want, 1))


@pytest.fixture(scope="module")
def tp1_engine():
    """The port's tp = 1 engine on the engine cases' model, with its
    teacher-forced logits."""
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request

    cfg = T.ModelConfig.tiny_test(**ENG_CFG)
    params = T.quantize_params(cfg, T.random_weights(cfg, seed=SEED), fuse=True, device="cpu")
    eng = Engine(params, cfg, EngineConfig(max_batch=4, max_len=128, inner_steps=4))
    tokens = {u: c.tokens for u, c in eng.run([Request(uid=i, prompt=p, max_new_tokens=NEW)
                                                for i, p in enumerate(PROMPTS)]).items()}
    lg = _teacher_forced(lambda p, t, c: T.forward(p, cfg, t, c), params, cfg, PROMPTS, tokens, lambda x: x)
    return tokens, lg


@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_engine_matches_tp1_engine(ranks2, tp1_engine, shape):
    """Engines at tp = 2 and at data 2 (slots split over the replicas): every
    rank returns the same completions, and each request's tokens equal the
    tp = 1 engine's or first differ at a near-tie."""
    ref_tokens, ref_lg = tp1_engine
    runs = [v[f"engine@{shape}"] for v in ranks2.values()]
    assert runs[0]["tokens"] == runs[1]["tokens"]
    assert runs[0]["stats"]["completions"] == len(PROMPTS)
    for uid, want in ref_tokens.items():
        got = runs[0]["tokens"][uid]
        assert len(got) == len(want) == NEW
        j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if j is None:
            continue
        g, e = ref_lg[uid][j], runs[0]["logits"][uid][j]
        tie = 2.0**-7 * np.abs(g).max()
        assert g[want[j]] - g[got[j]] <= tie and e[got[j]] - e[want[j]] <= tie, (shape, uid, j)
