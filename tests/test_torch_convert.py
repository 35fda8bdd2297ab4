"""The port's HF converter (convert/hf.py and its CLI), its safetensors reader
and writer, and its native packer, against the JAX package's.

* ``config_from_hf_dict``: field for field equal to JAX's for every family of
  tests/test_hf_oracle.py, and the same ValueError for an unsupported
  ``rope_scaling``.
* ``convert/safetensors_io.py`` against the ``safetensors`` package, both
  ways (f32, f16, bf16, u8, i32, i64), and ``iter_hf_tensors``' order over
  two shards against JAX's.
* ``convert_hf_model``: the port's output directory against JAX's from the
  same HF directory: the same manifest (parsed) and, in every npz, the same
  keys in the same order, dtypes, shapes and bytes.  Cases: FP4 ramp and
  exact, NF4, a quantized embedding, a quantized lm_head, an ignore list, a
  tied lm_head, a bf16 source in two shards, Qwen2 biases, Phi-3's fused
  projections, a 4-expert Mixtral, and bitsandbytes-serialized FP4 and NF4
  sources (one layer's absmax double-quantized), imported and requantized.
  The streaming statistics equal JAX's; the CLI runs as a subprocess.
* The native C packer bit-identical to the torch packers and to JAX's
  golden, built under build/.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("safetensors")

from torch_bnb_fp4_tpu.convert import hf as JH  # noqa: E402
from torch_bnb_fp4_tpu.models import transformer as JT  # noqa: E402
from torch_bnb_fp4_tpu.ops import format as jfmt  # noqa: E402
from torch_bnb_fp4_tpu_torch.convert import hf as H  # noqa: E402
from torch_bnb_fp4_tpu_torch.convert import native  # noqa: E402
from torch_bnb_fp4_tpu_torch.convert import quantize as Q  # noqa: E402
from torch_bnb_fp4_tpu_torch.convert import safetensors_io as st  # noqa: E402
from torch_bnb_fp4_tpu_torch.ops import format as fmt  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CFG = JT.ModelConfig.tiny_test(dim=512, ffn_dim=1024, n_heads=4, n_kv_heads=2)
_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _hf_config(cfg, **extra):
    d = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.dim, num_hidden_layers=cfg.n_layers,
             num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads, intermediate_size=cfg.ffn_dim,
             rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps)
    d.update(extra)
    return d


def _write_hf(path, hf_cfg, tensors, n_shards=1):
    """An HF directory written with the port's safetensors writer; tensors cut
    into ``n_shards`` files in name order (groups straddle the shards)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    names = sorted(tensors)
    per = -(-len(names) // n_shards)
    for s in range(n_shards):
        st.save_file({k: tensors[k] for k in names[s * per:(s + 1) * per]},
                     os.path.join(path, f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"))


def _bnb_source(weights, quant_type):
    """HF-serialized bitsandbytes state of every linear (o_proj's absmax
    double-quantized), the rest as f32."""
    from test_convert import _bnb_serialize

    t = {}
    for name, w in weights.items():
        if any(s in name for s in _LINEARS):
            _bnb_serialize(name[: -len(".weight")], np.asarray(w, np.float32), t, quant_type=quant_type,
                           nested="o_proj" in name)
        else:
            t[name] = np.asarray(w, np.float32)
    return t


def _phi3_source(cfg, weights):
    """Phi-3's fused projections: qkv_proj = [q; k; v], gate_up_proj = [gate; up]."""
    t = dict(weights)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        t[p + "self_attn.qkv_proj.weight"] = np.concatenate(
            [t.pop(p + f"self_attn.{n}_proj.weight") for n in "qkv"])
        t[p + "mlp.gate_up_proj.weight"] = np.concatenate([t.pop(p + f"mlp.{n}_proj.weight") for n in ("gate", "up")])
    return t


def _source(case):
    """(HF config dict, tensors, n_shards) of one case's source."""
    if case == "mixtral":
        cfg = dataclasses.replace(CFG, n_experts=4, experts_per_tok=2)
        return _hf_config(cfg, num_local_experts=4, num_experts_per_tok=2), JT.random_weights(cfg, seed=5), 1
    if case == "qwen2_bias":
        cfg = dataclasses.replace(CFG, attn_bias=True)
        return _hf_config(cfg, model_type="qwen2"), JT.random_weights(cfg, seed=6), 1
    w = JT.random_weights(CFG, seed=len(case))
    if case == "phi3":
        return _hf_config(CFG, model_type="phi3"), _phi3_source(CFG, w), 1
    if case == "tied":
        del w["lm_head.weight"]
    if case == "bf16_two_shards":
        return _hf_config(CFG), {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in w.items()}, 2
    if case.startswith("bnb_"):
        return _hf_config(CFG), _bnb_source(w, case.split("_")[1]), 2
    return _hf_config(CFG), w, 1


CASES = {
    "fp4_ramp": dict(),
    "fp4_exact": dict(variant="exact"),
    "nf4": dict(quant_type="nf4"),
    "quantize_embed": dict(quantize_embed=True),
    "quantize_lm_head": dict(quantize_lm_head=True),
    "ignore": dict(ignore=("layers.0.self_attn", "mlp.down_proj", "embed_tokens"), quantize_embed=True),
    "tied": dict(quantize_lm_head=True),
    "bf16_two_shards": dict(quant_type="nf4", quantize_embed=True),
    "qwen2_bias": dict(),
    "phi3": dict(),
    "mixtral": dict(),
    "bnb_fp4": dict(),
    "bnb_nf4": dict(quantize_embed=True),
    "bnb_fp4_requantize": dict(requantize=True, variant="zramp"),
    "bnb_nf4_requantize": dict(requantize=True),
}


def assert_same_checkpoint(a, b):
    """Two checkpoint directories: the same files, the same manifest (parsed)
    and the same arrays in every npz (keys in order, dtypes, shapes, bytes)."""
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    with open(os.path.join(a, "manifest.json")) as fa, open(os.path.join(b, "manifest.json")) as fb:
        assert json.load(fa) == json.load(fb)
    for name in sorted(os.listdir(a)):
        if not name.endswith(".npz"):
            continue
        with np.load(os.path.join(a, name)) as za, np.load(os.path.join(b, name)) as zb:
            assert za.files == zb.files, name
            for k in za.files:
                x, y = za[k], zb[k]
                assert x.dtype == y.dtype and x.shape == y.shape, (name, k, x.dtype, y.dtype, x.shape, y.shape)
                assert x.tobytes() == y.tobytes(), (name, k)


@pytest.mark.parametrize("case", list(CASES))
def test_convert_matches_jax(tmp_path, case):
    hf_cfg, tensors, n_shards = _source(case)
    _write_hf(tmp_path / "hf", hf_cfg, tensors, n_shards)
    kw = CASES[case]
    jstats, tstats = {}, {}
    jcfg = JH.convert_hf_model(str(tmp_path / "hf"), str(tmp_path / "jax"), verbose=False, stats_out=jstats, **kw)
    tcfg = H.convert_hf_model(str(tmp_path / "hf"), str(tmp_path / "port"), verbose=False, stats_out=tstats, **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tstats == jstats
    assert_same_checkpoint(tmp_path / "jax", tmp_path / "port")


def test_streaming_bound_matches_jax(tmp_path):
    """12 layers over 5 shards: the peak of pending tensor bytes stays a
    fraction of the total (the streaming bound), and equals JAX's."""
    cfg = dataclasses.replace(CFG, n_layers=12)
    weights = JT.random_weights(cfg, seed=11)
    _write_hf(tmp_path / "hf", _hf_config(cfg), weights, n_shards=5)
    stats, jstats = {}, {}
    H.convert_hf_model(str(tmp_path / "hf"), str(tmp_path / "port"), verbose=False, stats_out=stats)
    JH.convert_hf_model(str(tmp_path / "hf"), str(tmp_path / "jax"), verbose=False, stats_out=jstats)
    layer_bytes = sum(v.nbytes for k, v in weights.items() if k.startswith("model.layers.3."))
    assert stats == jstats and stats["groups"] == cfg.n_layers + 3
    assert stats["total_bytes"] > 8 * layer_bytes and stats["peak_pending_bytes"] <= stats["total_bytes"] / 3, stats
    assert_same_checkpoint(tmp_path / "jax", tmp_path / "port")


def test_convert_rejects_incomplete(tmp_path):
    weights = JT.random_weights(CFG, seed=13)
    del weights["model.layers.1.mlp.up_proj.weight"]
    _write_hf(tmp_path / "hf", _hf_config(CFG), weights)
    with pytest.raises(ValueError, match="layers.1"):
        H.convert_hf_model(str(tmp_path / "hf"), str(tmp_path / "out"), verbose=False)


def test_cli_subprocess_matches_jax(tmp_path):
    weights = JT.random_weights(CFG, seed=17)
    _write_hf(tmp_path / "hf", _hf_config(CFG), weights, n_shards=2)
    r = subprocess.run([sys.executable, "-m", "torch_bnb_fp4_tpu_torch.convert", str(tmp_path / "hf"),
                        str(tmp_path / "port"), "--quant-type", "nf4", "--quantize-embed", "--quantize-lm-head",
                        "--ignore", "layers.1.mlp.up_proj"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "wrote packed checkpoint" in r.stdout and "packer " in r.stdout
    JH.convert_hf_model(str(tmp_path / "hf"), str(tmp_path / "jax"), quant_type="nf4", quantize_embed=True,
                        quantize_lm_head=True, ignore=("layers.1.mlp.up_proj",), verbose=False)
    assert_same_checkpoint(tmp_path / "jax", tmp_path / "port")


# --------------------------------------------------------------------------
# config_from_hf_dict
# --------------------------------------------------------------------------

def _family_dicts():
    pytest.importorskip("transformers")
    from test_hf_oracle import FAMILIES

    return {name: cls(**kw).to_dict() for name, (cls, _, kw) in FAMILIES.items()}


def test_config_from_hf_dict_matches_jax():
    for name, hf in _family_dicts().items():
        want = dataclasses.asdict(JH.config_from_hf_dict(hf))
        assert dataclasses.asdict(H.config_from_hf_dict(hf)) == want, name
    hf = _family_dicts()["llama"]
    assert H.config_from_hf_dict(hf, quant_type="nf4").quant_type == "nf4"
    hf["rope_scaling"] = {"rope_type": "yarn", "factor": 4.0}
    with pytest.raises(ValueError) as je:
        JH.config_from_hf_dict(hf)
    with pytest.raises(ValueError) as te:
        H.config_from_hf_dict(hf)
    assert str(te.value) == str(je.value)


# --------------------------------------------------------------------------
# safetensors reader and writer
# --------------------------------------------------------------------------

def _mixed_tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "w.f32": torch.randn((3, 5), generator=g),
        "w.f16": torch.randn((4, 2), generator=g).half(),
        "w.bf16": torch.randn((2, 3, 2), generator=g).to(torch.bfloat16),
        "b.u8": torch.randint(0, 256, (7,), generator=g, dtype=torch.uint8),
        "i.i32": torch.randint(-9, 9, (2, 2), generator=g, dtype=torch.int32),
        "i.i64": torch.randint(-9, 9, (3,), generator=g, dtype=torch.int64),
        "empty": torch.zeros((0, 4)),
    }


def test_safetensors_reader_reads_package_files(tmp_path):
    from safetensors.torch import save_file

    want = _mixed_tensors(0)
    save_file(want, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got = st.load_file(str(tmp_path / "a.safetensors"))
    assert list(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_safetensors_writer_read_by_package(tmp_path):
    from safetensors import safe_open

    want = _mixed_tensors(1)
    st.save_file(want, str(tmp_path / "b.safetensors"), metadata={"format": "pt"})
    with safe_open(str(tmp_path / "b.safetensors"), framework="pt") as f:
        assert list(f.keys()) == st.shard_keys(str(tmp_path / "b.safetensors"))
        assert f.metadata() == {"format": "pt"}
        for k, v in want.items():
            got = f.get_tensor(k)
            assert got.dtype == v.dtype and torch.equal(got, v), k
    # numpy arrays are stored too
    st.save_file({"n": np.arange(6, dtype=np.float32).reshape(2, 3)}, str(tmp_path / "c.safetensors"))
    with safe_open(str(tmp_path / "c.safetensors"), framework="np") as f:
        np.testing.assert_array_equal(f.get_tensor("n"), np.arange(6, dtype=np.float32).reshape(2, 3))


def test_iter_hf_tensors_order_matches_jax(tmp_path):
    tensors = {f"model.layers.{i}.x.{n}": torch.randn((2, 3)).to(dt) for i in range(3) for n, dt in
               (("a", torch.float32), ("b", torch.bfloat16), ("c", torch.float16))}
    _write_hf(tmp_path, {}, tensors, n_shards=2)
    got = list(H.iter_hf_tensors(str(tmp_path)))
    want = list(JH.iter_hf_tensors(str(tmp_path)))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        list(H.iter_hf_tensors(str(tmp_path / "empty")))


# --------------------------------------------------------------------------
# the native packer
# --------------------------------------------------------------------------

@pytest.fixture
def cc():
    """The native packer, built (skips on a host without a C compiler)."""
    if not native.available():
        pytest.skip("no C compiler: the converter packs with torch")


def test_native_builds_under_build_dir(cc):
    so = Path(native._build_lib())
    assert so.parent == ROOT / "build" / "torch_bnb_fp4_tpu_torch" / "host" and so.exists()


@pytest.mark.parametrize("variant", fmt.PAIRK_VARIANTS)
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_native_pairk_bit_identical(cc, variant, scale_dtype):
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((48, 512)) * 0.02).astype(np.float32)
    w[0] = 0.0  # a zero block (absmax 0)
    w[1, :16] = fmt.FP4_CODE  # values exactly on the codebook
    got = native.quantize_pack_pairk_native(w, 64, variant, scale_dtype)
    golden = fmt.pack_tpu_pairk(w, 64, variant=variant, scale_dtype=scale_dtype)
    lib, native._lib = native._lib, None  # the torch path
    try:
        via_torch = Q.quantize_pack_pairk(w, 64, variant, scale_dtype)
    finally:
        native._lib = lib
    jp, js = jfmt.pack_tpu_pairk(w, 64, variant=variant,
                                 scale_dtype=np.float32 if scale_dtype == torch.float32 else jfmt._BF16)
    for p, s in (golden, via_torch):
        assert torch.equal(got[0], p) and s.dtype == got[1].dtype and torch.equal(got[1], s)
    np.testing.assert_array_equal(got[0].numpy(), jp)
    np.testing.assert_array_equal(got[1].float().numpy(), np.asarray(js, np.float32))


@pytest.mark.parametrize("blocksize", [32, 64, 128])
def test_native_lut_bit_identical(cc, blocksize):
    rng = np.random.default_rng(blocksize)
    w = (rng.standard_normal((40, 1024)) * 3).astype(np.float32)
    w[2, :blocksize] = 0.0
    got = native.quantize_pack_pairk_lut_native(w, fmt.NF4_CODE, blocksize)
    lib, native._lib = native._lib, None
    try:
        via_torch = Q.quantize_pack_pairk_lut(w, fmt.NF4_CODE, blocksize)
    finally:
        native._lib = lib
    jp, js = jfmt.pack_tpu_pairk_lut(w, jfmt.NF4_CODE, blocksize)
    for p, s in (fmt.pack_tpu_pairk_lut(w, fmt.NF4_CODE, blocksize), via_torch):
        assert torch.equal(got[0], p) and torch.equal(got[1], s)
    np.testing.assert_array_equal(got[0].numpy(), jp)
    np.testing.assert_array_equal(got[1].numpy(), js)


def test_format_flat_golden_matches_jax():
    """dequantize_codes, quantize_fp4, dequantize_fp4 and tpu_layout_from_bnb
    against the JAX package's numpy golden."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((64, 256)) * 0.1).astype(np.float32)
    for code in (fmt.FP4_CODE, fmt.NF4_CODE):
        p, a = fmt.quantize_fp4(w, code=code)
        jp, ja = jfmt.quantize_fp4(w, code=code)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(fmt.dequantize_fp4(p, a, w.shape, code=code),
                                      jfmt.dequantize_fp4(jp, ja, w.shape, code=code))
        codes = fmt.unpack_flat(p)
        np.testing.assert_array_equal(fmt.dequantize_codes(codes, a, 64, code),
                                      jfmt.dequantize_codes(codes, a, 64, code))
        for got, want in zip(fmt.tpu_layout_from_bnb(p, a, w.shape), jfmt.tpu_layout_from_bnb(jp, ja, w.shape)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
