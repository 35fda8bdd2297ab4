"""Random weights of a configuration, made on the card from the seed.

The weights are the benchmark's input, handed to the program and, made
again from the same seed, to the reference: uniform FP4 pair-K bytes (byte
(i, n) of a (K/2, N) layer holds row 2i in its low nibble and row 2i+1 in its
high nibble) and f32 scales (absmax / 192, one per 64 rows of K and column),
a dense bf16 embedding and lm_head, and for a mixture of experts a bf16
router and stacked (E, K/2, N) experts.  The query and key projections take
their own absmax (``qk_absmax``), large enough that a score q.k/sqrt(d) has a
spread of about 3 and every softmax is peaked, as in a trained model: with
one absmax for all, attention on random weights is near uniform and returns
about the mean of V, so a wrong position, cache row or K/V rounding would
not show in the served tokens.  The embedding's ``embed_std`` keeps the
residual stream larger than one layer's update, so that rounding does not
grow from layer to layer through peaked attention.  One ``torch.Generator`` on the
device makes them in a fixed order with two calls per layer (all its bytes,
then all its scales), so the same seed gives the same bytes, and the
reference can make them again one layer at a time.
"""

from __future__ import annotations

import torch

from .work import Geometry


class WeightStream:
    """``head()`` first, then ``layer()`` once per layer, in order.  Each
    layer is a dict of name -> (packed uint8, scale f32) for the FP4
    linears (stacked on a leading expert axis for ``gate``, ``up``,
    ``down`` of a MoE layer) and, for MoE, ``router`` -> bf16 (dim, E)."""

    def __init__(self, g: Geometry, scales: dict, seed: int, device):
        self.g, self.s, self.device = g, scales, torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed % 2**63)
        self._next = -1  # -1: the head is due

    def _randn(self, shape, std: float) -> torch.Tensor:
        return (torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device) * std).to(
            torch.bfloat16)

    def head(self) -> dict:
        if self._next != -1:
            raise RuntimeError("head() comes first, once")
        self._next = 0
        g = self.g
        return {"embed": self._randn((g.vocab, g.dim), self.s["embed_std"]),
                "lm_head": self._randn((g.dim, g.vocab), self.s["lm_head_std"])}

    def shapes(self) -> list[tuple[str, int, int, int]]:
        """(name, experts or 0, K, N) of one layer's FP4 linears, in the order
        their bytes are made."""
        g = self.g
        out = [("wq", 0, g.dim, g.q_dim), ("wk", 0, g.dim, g.kv_dim), ("wv", 0, g.dim, g.kv_dim),
               ("wo", 0, g.q_dim, g.dim)]
        e = g.n_experts
        if e:
            return out + [("gate", e, g.dim, g.ffn), ("up", e, g.dim, g.ffn), ("down", e, g.ffn, g.dim)]
        return out + [("w_gate", 0, g.dim, g.ffn), ("w_up", 0, g.dim, g.ffn), ("w_down", 0, g.ffn, g.dim)]

    def layer(self) -> dict:
        if self._next < 0 or self._next >= self.g.n_layers:
            raise RuntimeError("layer() follows head(), once per layer")
        self._next += 1
        g, bs = self.g, self.g.blocksize
        shapes = self.shapes()
        n_bytes = sum(max(e, 1) * k * n // 2 for _, e, k, n in shapes)
        n_scales = sum(max(e, 1) * (k // bs) * n for _, e, k, n in shapes)
        packed = torch.randint(0, 256, (n_bytes,), generator=self.gen, dtype=torch.uint8, device=self.device)
        u = torch.rand((n_scales,), generator=self.gen, dtype=torch.float32, device=self.device)
        scale = (u + 0.5) * (self.s["absmax"] / 192.0)
        out, pb, ps = {}, 0, 0
        for name, e, k, n in shapes:
            lead = (e,) if e else ()
            nb, ns = max(e, 1) * k * n // 2, max(e, 1) * (k // bs) * n
            if name in ("wq", "wk"):
                scale[ps : ps + ns] *= self.s["qk_absmax"] / self.s["absmax"]
            out[name] = (packed[pb : pb + nb].view(*lead, k // 2, n), scale[ps : ps + ns].view(*lead, k // bs, n))
            pb, ps = pb + nb, ps + ns
        if g.n_experts:
            out["router"] = self._randn((g.dim, g.n_experts), self.s["router_std"])
        return out
