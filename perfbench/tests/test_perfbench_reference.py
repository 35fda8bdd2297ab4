"""The plain reference against the port's plain CPU forward at a tiny size
(the test imports the port; the reference does not), and its weight decode
against the port's golden pair-K decode."""

from __future__ import annotations

import math
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.refs.decoder import Decoder, decode_pairk, to_e4m3
from perfbench.weights import WeightStream


def test_decode_matches_the_ports_golden_unpack():
    from torch_bnb_fp4_tpu_torch.ops import format as fmt

    gen = torch.Generator().manual_seed(3)
    packed = torch.randint(0, 256, (64, 256), generator=gen, dtype=torch.uint8)
    scale = torch.rand((2, 256), generator=gen) + 0.5
    want = fmt.unpack_tpu_pairk(packed, scale, 64, variant="ramp")
    assert torch.equal(decode_pairk(packed, scale), torch.from_numpy(want))


def test_weights_are_made_again_alike_from_the_seed():
    from perfbench.work import Geometry

    tiny = Geometry(vocab=64, dim=128, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=64, ffn=256, n_experts=4)
    scales = {"absmax": 0.01, "qk_absmax": 0.2, "embed_std": 0.01, "lm_head_std": 0.01, "router_std": 0.1}
    a, b = WeightStream(tiny, scales, 2**40 + 3, "cpu"), WeightStream(tiny, scales, 2**40 + 3, "cpu")
    assert torch.equal(a.head()["embed"], b.head()["embed"])
    for _ in range(2):
        la, lb = a.layer(), b.layer()
        assert la.keys() == lb.keys() and all(torch.equal(la[k][0], lb[k][0]) for k in ("wq", "gate", "down"))
    with pytest.raises(RuntimeError):
        a.layer()


@pytest.mark.parametrize("config", ["mistral-7b", "tiny"])
def test_attention_scores_are_peaked(config):
    """``qk_absmax`` gives the scores q.k/sqrt(head_dim) a spread of about 3
    over unit-RMS inputs, so each softmax is peaked and the check sees
    attention; one absmax for all would give about 0.1 (near uniform)."""
    from perfbench.refs.decoder import RAMP_MAGS192
    from perfbench.spec import HERE, geometry, load_json

    data = Path(__file__).resolve().parent / "data"
    c = load_json((HERE / "configs" if config == "mistral-7b" else data / "configs") / f"{config}.json")
    g = geometry(c)
    # a weight's RMS: absmax * RMS(magnitude / 192) * RMS(u + 0.5), u uniform on [0, 1)
    unit = math.sqrt(sum(m * m for m in RAMP_MAGS192) / 8) / 192 * math.sqrt((1.5**3 - 0.5**3) / 3)
    assert 2.0 < g.dim * (unit * c["weights"]["qk_absmax"]) ** 2 < 4.0  # the scores' std: (sqrt(dim) * rms)^2
    assert g.dim * (unit * c["weights"]["absmax"]) ** 2 < 0.2
    if config == "tiny":  # and on the weights themselves
        stream = WeightStream(g, c["weights"], 5, "cpu")
        stream.head()
        lw = stream.layer()
        h = torch.randn(200, g.dim, generator=torch.Generator().manual_seed(0))
        q = (h @ decode_pairk(*lw["wq"])).view(200, g.n_heads, g.head_dim)[:, : g.n_kv_heads]
        k = (h @ decode_pairk(*lw["wk"])).view(200, g.n_kv_heads, g.head_dim)
        assert 2.0 < float(torch.einsum("ahd,bhd->hab", q, k).std()) / g.head_dim**0.5 < 4.0


@pytest.mark.parametrize("workload", ["tiny-chat", "tinymoe-chat"])
def test_reference_agrees_with_the_ports_forward(tiny_spec, workload):
    from torch_bnb_fp4_tpu_torch.models import transformer as T

    spec = tiny_spec(workload)
    g = spec.geometry
    params = harness.build_params(spec, 7, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    seqs = [torch.randint(0, g.vocab, (n,), generator=gen) for n in (60, 23)]
    want = [torch.arange(len(s)) for s in seqs]
    ref = Decoder(g, spec.config["rope_theta"], spec.config["rms_norm_eps"]).run(
        WeightStream(g, spec.config["weights"], 7, "cpu"), seqs, want)
    for s, r in zip(seqs, ref):
        cache = T.KVCache.zeros(harness.model_config(spec), 1, len(s), device="cpu")
        logits, _ = T.forward(params, harness.model_config(spec), s[None].to(torch.int32), cache)
        port = logits[0].float()
        # bf16 activations in the port against f32 here: a few bf16 ulps of the logits' scale
        assert (port - r).abs().max() < 0.02 * r.abs().max()
        assert torch.corrcoef(torch.stack([port.flatten(), r.flatten()]))[0, 1] > 0.999


def test_fp8_control_rounds_every_matmul_operand():
    x = torch.tensor([[1.0, 1.06, 300.0, -0.3]])
    y = to_e4m3(x, -1)
    assert y[0, 2] == 300.0 and y[0, 1] != 1.06  # three mantissa bits, scaled so the largest maps to 448
    assert (y - x).abs().max() <= 300 * 2 ** -4
