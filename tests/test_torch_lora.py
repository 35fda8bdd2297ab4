"""The port's LoRA adapters against the JAX package's (CPU).

The same seeded weights and adapters (numpy) go through both packages:
``LoRALinear`` / ``MultiLoRALinear`` (bf16 and f32 x, rank padding, ``None``
slots), ``load_peft_adapter`` on a PEFT directory written by the port's own
safetensors writer (both key spellings), ``merge_lora`` (packed bytes and
scales equal), and a tiny model's logits with one adapter attached and with
three stacked ones picked per row.  Attach then detach gives the base's
logits bit for bit.  Every refusal of the JAX package is the port's too.

The engine: per-request adapters give each adapter's single-attach
``generate`` tokens, with and without speculation; the prefix cache keys its
donors and store entries by adapter (ROADMAP R7: the JAX engine matches
tokens alone, so it is not the oracle there; the port's single-attach
``generate`` is).  The CLI parses ``--lora`` under the JAX CLI's rules,
serves named adapters over HTTP (an unknown one is a 400), attaches or merges
one, and ``--prefill-shadow`` shadows the bases inside the adapters.

Tolerances: a linear, as tests/test_torch_linear.py: |dy| <= 2^-7 * max|y|
for bf16 x, 1e-5 * max|y| for f32 x; logits as tests/test_torch_transformer.py:
|dlogit| <= 2e-2 * max|logit|; greedy tokens identical.
"""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.models import linear as JL
from torch_bnb_fp4_tpu.models import lora as JLoRA
from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.convert.safetensors_io import save_file
from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import lora as LoRA
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.ops import kernels as K
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, EngineServer, Request
from torch_bnb_fp4_tpu_torch.serve import __main__ as cli

from test_torch_transformer import flatten_jax_params

GEOM = dict(n_layers=2, dim=512, ffn_dim=1024, n_heads=4, n_kv_heads=2)
CFG = T.ModelConfig.tiny_test(**GEOM)
JCFG = JT.ModelConfig.tiny_test(**GEOM)
TOKS = np.array([[3, 7, 2, 9, 11, 5]], np.int32)
ALL = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj", "mlp.gate_proj",
       "mlp.up_proj", "mlp.down_proj")
SYS = [7, 3, 9, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3,
       8, 4, 6, 2, 6, 4, 3, 3, 8, 3, 2, 7, 9, 5, 0, 2]  # tests/test_prefix.py's 36-token prompt


def _lin_tol(want, dtype):
    return (1e-5 if dtype == "float32" else 2.0**-7) * np.abs(want).max()


def adapter_weights(cfg, seed, r, targets, scale=0.05, layers=None):
    """{module stem: (lora_A (r, k_in), lora_B (n_out, r))}, f32, seeded."""
    rng = np.random.default_rng(seed)
    kv = cfg.n_kv_heads * cfg.head_dim
    shapes = {"self_attn.q_proj": (cfg.q_dim, cfg.dim), "self_attn.k_proj": (kv, cfg.dim),
              "self_attn.v_proj": (kv, cfg.dim), "self_attn.o_proj": (cfg.dim, cfg.q_dim),
              "mlp.gate_proj": (cfg.ffn_dim, cfg.dim), "mlp.up_proj": (cfg.ffn_dim, cfg.dim),
              "mlp.down_proj": (cfg.dim, cfg.ffn_dim)}
    w = {}
    for i in range(cfg.n_layers if layers is None else layers):
        for t in targets:
            n, k = shapes[t]
            w[f"model.layers.{i}.{t}"] = ((rng.standard_normal((r, k)) * scale).astype(np.float32),
                                          (rng.standard_normal((n, r)) * scale).astype(np.float32))
    return w


def write_peft_dir(path, weights, r, alpha, default_key=False):
    """A PEFT adapter directory: adapter_config.json + adapter_model.safetensors
    written with the port's own writer (``.lora_A.default.weight`` keys with
    ``default_key``)."""
    path.mkdir(parents=True, exist_ok=True)
    mid = ".default" if default_key else ""
    tensors = {}
    for stem, (a, b) in weights.items():
        tensors[f"base_model.model.{stem}.lora_A{mid}.weight"] = a
        tensors[f"base_model.model.{stem}.lora_B{mid}.weight"] = b
    save_file(tensors, str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(json.dumps({"peft_type": "LORA", "r": r, "lora_alpha": alpha,
                                                          "target_modules": ["q_proj", "v_proj"]}))
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its many small CPU ops slow down
    sharply when several test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """JAX and port params of one tiny model (the port's carried across), and
    adapters a (r 8, alpha 16, every projection) and b (r 4, alpha 8, q and
    v only) in both packages' PEFTAdapter."""
    jp = JT.quantize_params(JCFG, JT.random_weights(JCFG, seed=5))
    tp = params_from_numpy(*flatten_jax_params(jp), CFG, device="cpu")
    wa, wb = adapter_weights(CFG, 7, 8, ALL), adapter_weights(CFG, 21, 4, ALL[:1] + ALL[2:3])
    return dict(jp=jp, tp=tp, ja=JLoRA.PEFTAdapter(r=8, alpha=16.0, weights=wa),
                jb=JLoRA.PEFTAdapter(r=4, alpha=8.0, weights=wb), ta=LoRA.PEFTAdapter(r=8, alpha=16.0, weights=wa),
                tb=LoRA.PEFTAdapter(r=4, alpha=8.0, weights=wb))


def _jfw(params, toks=TOKS, **kw):
    out, _ = JT.forward(params, JCFG, jnp.asarray(toks), JT.KVCache.zeros(JCFG, toks.shape[0], 8), **kw)
    return np.asarray(out, np.float32)


def _tfw(params, toks=TOKS, **kw):
    with torch.no_grad():
        out, _ = T.forward(params, CFG, torch.from_numpy(toks), T.KVCache.zeros(CFG, toks.shape[0], 8, device="cpu"),
                           **kw)
    return out


# -- the adapter linears ---------------------------------------------------------


def _base_pair(n, k, seed):
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.02).astype(np.float32)
    jq, tq = JL.quantize_linear(w), L.quantize_linear(w, device="cpu")
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    return jq, tq


def _ab(rng, r, n, k):
    return (rng.standard_normal((r, k)) * 0.05).astype(np.float32), (rng.standard_normal((n, r)) * 0.05).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lora_linear_matches_jax(dtype):
    jq, tq = _base_pair(384, 1024, 1)
    a, b = _ab(np.random.default_rng(2), 8, 384, 1024)
    jl, tl = JL.lora_linear(jq, a, b, alpha=16.0), L.lora_linear(tq, a, b, alpha=16.0)
    assert (tl.n_out, tl.k_in, tl.rank, tl.scale, tl.bias) == (jl.n_out, jl.k_in, jl.rank, jl.scale, None)
    np.testing.assert_array_equal(tl.a.float().numpy(), np.asarray(jl.a, np.float32))
    for shape in ((1, 1024), (2, 3, 1024)):
        x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
        for out in (None, "float32"):
            want = np.asarray(jl(jnp.asarray(x, getattr(jnp, dtype)), out_dtype=out and jnp.float32), np.float32)
            got = tl(torch.from_numpy(x).to(getattr(torch, dtype)), out_dtype=out and torch.float32)
            assert got.dtype == getattr(torch, out or dtype) and tuple(got.shape) == want.shape
            np.testing.assert_array_less(np.abs(got.float().numpy() - want), _lin_tol(want, dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_multi_lora_linear_matches_jax(dtype):
    """Slots: 0 reserved, 1 rank 8, 2 a None entry, 3 rank 4 (padded to 8);
    one row per slot, 2-D and (B, L, k) inputs."""
    jq, tq = _base_pair(384, 1024, 4)
    rng = np.random.default_rng(5)
    (a1, b1), (a3, b3) = _ab(rng, 8, 384, 1024), _ab(rng, 4, 384, 1024)
    entries = [(a1, b1, 16.0), None, (a3, b3, 8.0)]
    jm, tm = JL.multi_lora_linear(jq, entries), L.multi_lora_linear(tq, entries)
    assert (tm.n_adapters, tm.rank) == (jm.n_adapters, jm.rank) == (4, 8)
    for mine, theirs in ((tm.a, jm.a), (tm.b, jm.b), (tm.scale, jm.scale)):
        np.testing.assert_array_equal(mine.float().numpy(), np.asarray(theirs, np.float32))
    idx = np.array([1, 2, 3, 0], np.int32)
    for shape in ((4, 1024), (4, 3, 1024)):
        x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
        want = np.asarray(jm(jnp.asarray(x, getattr(jnp, dtype)), adapter_idx=jnp.asarray(idx)), np.float32)
        got = tm(torch.from_numpy(x).to(getattr(torch, dtype)), adapter_idx=torch.from_numpy(idx))
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_less(np.abs(got.float().numpy() - want), _lin_tol(want, dtype))
        # the None slot and the reserved slot are the base exactly
        base = tq(torch.from_numpy(x).to(getattr(torch, dtype)))
        for row in (1, 3):
            assert torch.equal(got[row], base[row])
    with pytest.raises(ValueError, match="adapter_idx"):
        tm(torch.zeros((1, 1024)))


# -- PEFT files ------------------------------------------------------------------


@pytest.mark.parametrize("default_key", [False, True], ids=["lora_A.weight", "lora_A.default.weight"])
def test_load_peft_adapter_matches_jax(tmp_path, default_key):
    w = adapter_weights(CFG, 11, 8, ALL[:3])
    d = write_peft_dir(tmp_path / "ad", w, 8, 16.0, default_key=default_key)
    mine, theirs = LoRA.load_peft_adapter(d), JLoRA.load_peft_adapter(d)
    assert (mine.r, mine.alpha) == (theirs.r, theirs.alpha) == (8, 16.0)
    assert sorted(mine.weights) == sorted(theirs.weights) == sorted(w)
    for stem, (a, b) in mine.weights.items():
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, theirs.weights[stem][0])
        np.testing.assert_array_equal(b, theirs.weights[stem][1])
        np.testing.assert_array_equal(a, w[stem][0])


def _bad_dirs(tmp_path):
    w = adapter_weights(CFG, 12, 4, ALL[:1], layers=1)
    out = {}
    for name, cfg_extra, tensors in (
            ("peft_type", {"peft_type": "IA3"}, None),
            ("rank_pattern", {"rank_pattern": {"q_proj": 4}}, None),
            ("incomplete", {}, {"base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight": w[
                "model.layers.0.self_attn.q_proj"][0]}),
            ("unknown key", {}, {"base_model.model.model.layers.0.self_attn.q_proj.lora_C.weight": w[
                "model.layers.0.self_attn.q_proj"][0]})):
        d = tmp_path / name.replace(" ", "_")
        write_peft_dir(d, w, 4, 8.0)
        if cfg_extra:
            c = json.loads((d / "adapter_config.json").read_text())
            (d / "adapter_config.json").write_text(json.dumps({**c, **cfg_extra}))
        if tensors is not None:
            save_file(tensors, str(d / "adapter_model.safetensors"))
        out[name] = str(d)
    return out


def test_load_peft_adapter_refusals_match_jax(tmp_path):
    for name, d in _bad_dirs(tmp_path).items():
        with pytest.raises(ValueError) as want:
            JLoRA.load_peft_adapter(d)
        with pytest.raises(ValueError) as got:
            LoRA.load_peft_adapter(d)
        assert str(got.value) == str(want.value), name


# -- the model ---------------------------------------------------------------------


def test_single_adapter_logits_match_jax(models):
    m = models
    want = _jfw(JLoRA.attach_lora(m["jp"], JCFG, m["ja"]))
    got = _tfw(LoRA.attach_lora(m["tp"], CFG, m["ta"])).numpy()
    tol = 2e-2 * np.abs(want).max()
    np.testing.assert_array_less(np.abs(got - want), tol)
    assert np.abs(got - _tfw(m["tp"]).numpy()).max() > 4 * tol  # the adapter moves the logits past the tolerance


def test_multi_adapter_logits_match_jax(models):
    """Rows under a, none and b in one batch: JAX's forward, and each row
    against the port's single-attach (or base) forward within 5e-3 of max
    (tests/test_lora.py's bound)."""
    m = models
    toks, idx = np.repeat(TOKS, 3, axis=0), np.array([1, 0, 2], np.int32)
    jmp, jids = JLoRA.attach_multi_lora(m["jp"], JCFG, {"a": m["ja"], "b": m["jb"]})
    tmp, tids = LoRA.attach_multi_lora(m["tp"], CFG, {"a": m["ta"], "b": m["tb"]})
    assert tids == jids == {"a": 1, "b": 2} and T.has_multi_lora(tmp) and not T.has_multi_lora(m["tp"])
    assert tmp.layers[0].wk.a.shape[0] == 3 and not tmp.layers[0].wk.b[2].any()  # b skips k: a zero slot
    want = _jfw(jmp, toks, adapter_idx=jnp.asarray(idx))
    got = _tfw(tmp, toks, adapter_idx=torch.from_numpy(idx)).numpy()
    np.testing.assert_array_less(np.abs(got - want), 2e-2 * np.abs(want).max())
    singles = [LoRA.attach_lora(m["tp"], CFG, m["ta"]), m["tp"], LoRA.attach_lora(m["tp"], CFG, m["tb"])]
    for row, p in enumerate(singles):
        ref = _tfw(p).numpy()[0]
        assert np.abs(got[row] - ref).max() <= 5e-3 * np.abs(ref).max(), row


def test_attach_then_detach_is_the_base_bit_for_bit(models):
    m = models
    base = _tfw(m["tp"])
    assert torch.equal(_tfw(LoRA.detach_lora(LoRA.attach_lora(m["tp"], CFG, m["ta"]))), base)
    mp, _ = LoRA.attach_multi_lora(m["tp"], CFG, {"a": m["ta"], "b": m["tb"]})
    assert torch.equal(_tfw(LoRA.detach_lora(mp)), base)


@pytest.mark.parametrize("kind", ["fp4", "nf4", "dense"])
def test_merge_lora_matches_jax(kind):
    """merge_lora on the same base in both packages: every merged linear's
    packed bytes and scales (FP4 and NF4 pair-K), or bf16 weights (dense),
    equal."""
    cfg_kw = dict(GEOM, n_layers=1, quant_type=kind if kind != "dense" else "fp4")
    jcfg, tcfg = JT.ModelConfig.tiny_test(**cfg_kw), T.ModelConfig.tiny_test(**cfg_kw)
    weights = JT.random_weights(jcfg, seed=13)
    if kind == "dense":
        jp, tp = JT.dense_params(jcfg, weights), T.dense_params(tcfg, weights, device="cpu")
    else:
        jp = JT.quantize_params(jcfg, weights)
        tp = params_from_numpy(*flatten_jax_params(jp), tcfg, device="cpu")
    w = adapter_weights(tcfg, 17, 8, ALL)
    jm = JLoRA.merge_lora(jp, jcfg, JLoRA.PEFTAdapter(r=8, alpha=16.0, weights=w))
    tm = LoRA.merge_lora(tp, tcfg, LoRA.PEFTAdapter(r=8, alpha=16.0, weights=w))
    for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        mine, theirs = getattr(tm.layers[0], f), getattr(jm.layers[0], f)
        if kind == "dense":
            np.testing.assert_array_equal(mine.w.float().numpy(), np.asarray(theirs.w, np.float32))
            continue
        assert mine.variant == theirs.variant == ("lut" if kind == "nf4" else "ramp")
        np.testing.assert_array_equal(mine.packed.numpy(), np.asarray(theirs.packed))
        np.testing.assert_array_equal(mine.scale.float().numpy(), np.asarray(theirs.absmax_hi, np.float32))
        assert not torch.equal(mine.packed, getattr(tp.layers[0], f).packed)


def test_refusals(models):
    """The JAX package's refusals, with its messages where it has the same
    one: fused params, expert and lm_head targets; a double attach; a missing
    or unexpected adapter_idx; Engine params and ids that disagree; an
    unknown adapter.  The port also refuses a target past the model's
    layers (JAX indexes past its list) and an attach over a stacked adapter."""
    m = models
    bad = {"expert": {"model.layers.0.block_sparse_moe.experts.0.w1": (np.zeros((8, 8)), np.zeros((8, 8)))},
           "outside the decoder": {"lm_head": (np.zeros((8, 8)), np.zeros((8, 8)))}}
    for match, w in bad.items():
        for attach, p, cfg, mk in ((JLoRA.attach_lora, m["jp"], JCFG, JLoRA.PEFTAdapter),
                                   (LoRA.attach_lora, m["tp"], CFG, LoRA.PEFTAdapter)):
            with pytest.raises(ValueError, match=match):
                attach(p, cfg, mk(r=8, alpha=16.0, weights=w))
    with pytest.raises(ValueError, match="unfused"):
        JLoRA.attach_lora(JT.fuse_params(m["jp"]), JCFG, m["ja"])
    for attach in (LoRA.attach_lora, lambda p, c, a: LoRA.attach_multi_lora(p, c, {"a": a})):
        with pytest.raises(ValueError, match="unfused"):
            attach(T.fuse_params(m["tp"]), CFG, m["ta"])
    single = LoRA.attach_lora(m["tp"], CFG, m["ta"])
    multi, ids = LoRA.attach_multi_lora(m["tp"], CFG, {"a": m["ta"]})
    for p in (single, multi):
        with pytest.raises(ValueError, match="already has an adapter attached"):
            LoRA.attach_lora(p, CFG, m["tb"])
        with pytest.raises(ValueError, match="already has an adapter attached"):
            LoRA.attach_multi_lora(p, CFG, {"b": m["tb"]})
    with pytest.raises(ValueError, match="the model has 2 layers"):
        LoRA.attach_lora(m["tp"], CFG, LoRA.PEFTAdapter(r=4, alpha=8.0, weights=adapter_weights(
            T.ModelConfig.tiny_test(**dict(GEOM, n_layers=3)), 1, 4, ALL[:1])))
    jmulti, _ = JLoRA.attach_multi_lora(m["jp"], JCFG, {"a": m["ja"]})
    for (fw, pm, pb, idx) in ((_jfw, jmulti, m["jp"], jnp.zeros((1,), jnp.int32)),
                              (_tfw, multi, m["tp"], torch.zeros(1, dtype=torch.int32))):
        with pytest.raises(ValueError, match="needs adapter_idx"):
            fw(pm)
        with pytest.raises(ValueError, match="no MultiLoRALinear"):
            fw(pb, adapter_idx=idx)
    ecfg = EngineConfig(max_batch=2, max_len=16)
    with pytest.raises(ValueError, match="disagree"):
        Engine(multi, CFG, ecfg)
    with pytest.raises(ValueError, match="disagree"):
        Engine(m["tp"], CFG, ecfg, adapter_ids=ids)
    eng = Engine(multi, CFG, ecfg, adapter_ids=ids)
    for e in (eng, Engine(m["tp"], CFG, ecfg)):
        with pytest.raises(ValueError, match="unknown adapter 'nope'"):
            e.submit(Request(uid=9, prompt=[1], adapter="nope"))
        assert not e.pending


# -- the engine ----------------------------------------------------------------------


def _gen(params, prompt, n):
    return T.generate(params, CFG, torch.tensor([prompt], dtype=torch.int32), n)[0].tolist()


@pytest.mark.parametrize("spec", [0, 2])
def test_engine_per_request_adapters_match_single_attach(models, spec):
    """Three requests at once under a, b and no adapter (slots compact through
    batch buckets); each gives its single-attach generate's tokens."""
    m = models
    mp, ids = LoRA.attach_multi_lora(m["tp"], CFG, {"a": m["ta"], "b": m["tb"]})
    eng = Engine(mp, CFG, EngineConfig(max_batch=4, max_len=32, inner_steps=2, spec_tokens=spec,
                                       batch_buckets=True), adapter_ids=ids)
    prompts = {0: ([3, 7, 2], "a"), 1: ([5, 9, 1], "b"), 2: ([6, 5, 3], None), 3: ([3, 7, 2], "b")}
    res = eng.run([Request(uid=u, prompt=p, max_new_tokens=6 + u, adapter=a) for u, (p, a) in prompts.items()])
    oracles = {"a": LoRA.attach_lora(m["tp"], CFG, m["ta"]), "b": LoRA.attach_lora(m["tp"], CFG, m["tb"]),
               None: m["tp"]}
    for u, (p, a) in prompts.items():
        assert res[u].tokens == _gen(oracles[a], p, 6 + u), (u, a)
    assert res[0].tokens != res[3].tokens  # one prompt, two adapters


@pytest.mark.parametrize("chunk", [0, 32])
def test_prefix_cache_keys_donors_by_adapter(models, chunk):
    """ROADMAP R7: one prompt under a and b together, then under a and b
    again.  b's KV rows are never forked from a's (no hit while only a's
    rows share the prefix), the later requests hit their own adapter's store
    entry, and every request gives its single-attach generate's tokens."""
    m = models
    mp, ids = LoRA.attach_multi_lora(m["tp"], CFG, {"a": m["ta"], "b": m["tb"]})
    eng = Engine(mp, CFG, EngineConfig(max_batch=2, max_len=64, inner_steps=2, prefill_chunk=chunk,
                                       prefix_cache=True, prefix_store=2), adapter_ids=ids)
    want = {a: _gen(LoRA.attach_lora(m["tp"], CFG, m["t" + a]), SYS, 5) for a in ("a", "b")}
    assert want["a"] != want["b"]
    res = eng.run([Request(uid=0, prompt=SYS, max_new_tokens=5, adapter="a"),
                   Request(uid=1, prompt=SYS, max_new_tokens=5, adapter="b")])
    assert eng.stats()["prefix_hits"] == 0
    assert [res[0].tokens, res[1].tokens] == [want["a"], want["b"]]
    assert sorted(e["aidx"] for e in eng._store) == [1, 2]
    for uid, a in ((2, "a"), (3, "b")):
        before = eng.stats()["prefix_hits"]
        got = eng.run([Request(uid=uid, prompt=SYS, max_new_tokens=5, adapter=a)])[uid].tokens
        assert eng.stats()["prefix_hits"] == before + 1 and got == want[a], a
    assert sorted(e["aidx"] for e in eng._store) == [1, 2]


# -- the CLI, the server and the shadow -------------------------------------------------


def test_cli_lora_flags_follow_the_jax_rules():
    ap = cli._parser()
    parse = lambda *a: cli.lora_specs(ap.parse_args(list(a)))  # noqa: E731
    assert parse() == (None, None)
    assert parse("--lora", "d") == (None, "d")
    assert parse("--lora", "d", "--lora-merge") == (None, "d")
    assert parse("--lora", "a=x") == ({"a": "x"}, None)
    assert parse("--lora", "a=x", "--lora", "b=y=z") == ({"a": "x", "b": "y=z"}, None)
    with pytest.raises(ValueError, match="multi-adapter --lora needs NAME=DIR, got 'y'"):
        parse("--lora", "a=x", "--lora", "y")
    with pytest.raises(ValueError, match="--lora-merge only applies to a single unnamed --lora"):
        parse("--lora", "a=x", "--lora-merge")
    # the multi-process flags have rules of their own (tests/test_torch_multihost.py serves them)
    with pytest.raises(ValueError, match="--tp 2 needs --multihost"):
        cli.multihost_rules(ap.parse_args(["--lora", "a=x", "--tp", "2"]))


@pytest.fixture(scope="module")
def cli_adapters(tmp_path_factory):
    """Adapter dirs for the CLI's own tiny model (tiny_test(n_layers=2))."""
    cfg = T.ModelConfig.tiny_test(n_layers=2)
    root = tmp_path_factory.mktemp("cli_lora")
    wa, wb = adapter_weights(cfg, 31, 8, ALL), adapter_weights(cfg, 32, 4, ALL[:1] + ALL[2:3])
    return cfg, dict(a=(write_peft_dir(root / "a", wa, 8, 16.0), wa), b=(write_peft_dir(root / "b", wb, 4, 8.0), wb))


def _post(srv, body):
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_cli_serves_named_adapters_over_http(cli_adapters):
    """--lora a=DIR --lora b=DIR --prefill-shadow: per-request adapters over
    HTTP equal their single-attach generate; no adapter is the base; an
    unknown one is a 400 and the server keeps serving; every base inside an
    adapter carries its shadow."""
    cfg, dirs = cli_adapters
    argv = ["--device", "cpu", "--max-len", "64", "--lora", f"a={dirs['a'][0]}", "--lora", f"b={dirs['b'][0]}",
            "--prefill-shadow"]
    eng = cli.build_engine(cli._parser().parse_args(argv))
    assert eng.adapter_ids == {"a": 1, "b": 2}
    multis = [getattr(lp, f) for lp in eng.params.layers for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                                                    "w_down")]
    assert all(isinstance(q, L.MultiLoRALinear) and q.base.w8 is not None for q in multis)
    base = T.quantize_params(cfg, T.random_weights(cfg, seed=0), device="cpu")
    srv = EngineServer(eng, port=0).start()
    try:
        prompt = [3, 1, 4, 1, 5]
        for name in ("a", "b", None):
            body = {"prompt": prompt, "max_tokens": 5} | ({"adapter": name} if name else {})
            want = base if name is None else LoRA.attach_lora(base, cfg, LoRA.load_peft_adapter(dirs[name][0]))
            assert _post(srv, body)["tokens"] == T.generate(want, cfg, torch.tensor([prompt]), 5)[0].tolist(), name
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, {"prompt": prompt, "max_tokens": 5, "adapter": "c"})
        assert ei.value.code == 400 and "unknown adapter 'c'" in json.loads(ei.value.read())["error"]
        assert len(_post(srv, {"prompt": prompt, "max_tokens": 3, "adapter": "a"})["tokens"]) == 3
    finally:
        srv.stop()


def test_cli_attaches_or_merges_one_adapter(cli_adapters):
    cfg, dirs = cli_adapters
    d = dirs["b"][0]
    common = ["--device", "cpu", "--max-len", "64", "--lora", d]
    attached = cli.build_engine(cli._parser().parse_args(common))
    merged = cli.build_engine(cli._parser().parse_args(common + ["--lora-merge"]))
    assert attached.adapter_ids is None and merged.adapter_ids is None
    assert isinstance(attached.params.layers[0].wq, L.LoRALinear) and attached.params.layers[0].wk.__class__ is \
        L.QuantLinear
    assert all(isinstance(getattr(lp, f), L.QuantLinear) for lp in merged.params.layers for f in ("wq", "wv"))
    base = T.quantize_params(cfg, T.random_weights(cfg, seed=0), device="cpu")
    adapter = LoRA.load_peft_adapter(d)
    want_m = LoRA.merge_lora(base, cfg, adapter)
    assert torch.equal(merged.params.layers[1].wv.packed, want_m.layers[1].wv.packed)
    prompt = torch.tensor([[3, 1, 4, 1, 5]])
    res = attached.run([Request(uid=0, prompt=prompt[0].tolist(), max_new_tokens=5)])
    assert res[0].tokens == T.generate(LoRA.attach_lora(base, cfg, adapter), cfg, prompt, 5)[0].tolist()


def test_prefill_shadow_under_adapter_bases(models, monkeypatch):
    """attach_prefill_shadow after attach_lora / attach_multi_lora puts the
    int8 shadow on each adapter's base (the factors untouched), and a
    256-row prompt then runs the bases through K5's route; its logits stay
    within the shadow's tolerance of the unshadowed ones (K4's route), as
    tests/test_torch_shadow.py states it: |dlogit| <= 6e-2 * max|logit| and
    rel L2 <= 3e-2."""
    m = models
    single = LoRA.attach_lora(m["tp"], CFG, m["ta"])
    multi, _ = LoRA.attach_multi_lora(m["tp"], CFG, {"a": m["ta"], "b": m["tb"]})
    toks = np.random.default_rng(8).integers(0, CFG.vocab_size, (1, 256)).astype(np.int32)
    calls = []
    real = K.matmul_w8
    monkeypatch.setattr(K, "matmul_w8", lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    for p, kw in ((single, {}), (multi, dict(adapter_idx=torch.tensor([1], dtype=torch.int32)))):
        sh = L.attach_prefill_shadow(p)
        for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            lin, orig = getattr(sh.layers[0], f), getattr(p.layers[0], f)
            assert lin.base.w8 is not None and lin.a is orig.a and lin.b is orig.b
        calls.clear()
        with torch.no_grad():
            got = T.forward(sh, CFG, torch.from_numpy(toks), T.KVCache.zeros(CFG, 1, 256, device="cpu"), **kw)[0]
            want = T.forward(p, CFG, torch.from_numpy(toks), T.KVCache.zeros(CFG, 1, 256, device="cpu"), **kw)[0]
        assert len(calls) == 7 * CFG.n_layers
        assert (got - want).abs().max().item() <= 6e-2 * want.abs().max().item()
        assert ((got - want).norm() / want.norm()).item() <= 3e-2
