"""Plain PyTorch reference of a Mistral-family decoder (dense MLP or sparse
mixture of experts) over FP4 pair-K weights, for the check that decides a
run's ``correct``.

It decodes the weight bytes itself, from a frozen copy of the ``ramp``
codebook and the pair-K nibble order, and computes in float32 with TF32 off:
RMSNorm (eps from the configuration; the benchmark's norm weights are ones),
rotary embeddings (half-split, theta from the configuration), causal GQA
attention inside the sliding window where there is one, SwiGLU, for a
mixture of experts a softmax router whose top-k weights are renormalised
(HF ``MixtralSparseMoeBlock``), a final RMSNorm and the lm_head.  No cache,
no batching: each sequence runs whole.  It imports nothing of the program.

``precision="fp8"`` is the control: every matmul's operands (linears,
router, lm_head, and q, k, v of attention) rounded to float8 e4m3, scaled
per row of the activations and per column of the weights, with float32
accumulation.
"""

from __future__ import annotations

import math

import torch

# the ramp codebook's magnitudes times 192 by rank (bit 3 of a nibble is the
# sign); a weight is the value of its nibble times its f32 scale
RAMP_MAGS192 = (16.0, 24.0, 32.0, 48.0, 64.0, 96.0, 128.0, 192.0)
E4M3_MAX = 448.0
QUERY_CHUNK = 256


def decode_pairk(packed: torch.Tensor, scale: torch.Tensor, blocksize: int = 64) -> torch.Tensor:
    """(..., K/2, N) pair-K bytes and (..., K/blocksize, N) scales ->
    (..., K, N) float32: byte (i, n) holds row 2i in its low nibble and row
    2i+1 in its high nibble."""
    table = torch.tensor(RAMP_MAGS192 + tuple(-m for m in RAMP_MAGS192), dtype=torch.float32, device=packed.device)
    p = packed.long()
    w = torch.stack([table[p & 0xF], table[p >> 4]], dim=-2)  # (..., K/2, 2, N)
    *lead, kp, _, n = w.shape
    w = w.reshape(*lead, 2 * kp, n)
    return w * scale.float().repeat_interleave(blocksize, dim=-2)


def to_e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale per slice along ``dim``
    that maps the slice's largest magnitude to 448, returned in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Decoder:
    """``run(stream, seqs, want)``: the logits at positions ``want[i]`` of
    token sequence ``seqs[i]``, layer by layer over all sequences, the
    weights made again from ``stream`` (a ``perfbench.weights.WeightStream``
    at the run's seed) one layer at a time."""

    def __init__(self, g, rope_theta: float, eps: float, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {precision!r}")
        self.g, self.theta, self.eps, self.fp8 = g, rope_theta, eps, precision == "fp8"

    def _w(self, packed, scale) -> torch.Tensor:
        w = decode_pairk(packed, scale, self.g.blocksize)
        return to_e4m3(w, -2) if self.fp8 else w

    def _dense(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return to_e4m3(w, -2) if self.fp8 else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (to_e4m3(x, -1) if self.fp8 else x) @ w

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (L, H, D) at positions 0..L-1, half-split rotation."""
        d = x.shape[-1]
        freqs = self.theta ** (-torch.arange(0, d // 2, dtype=torch.float32, device=x.device) / (d // 2))
        ang = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., : d // 2], x[..., d // 2 :]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attend(self, q, k, v) -> torch.Tensor:
        """Causal GQA attention, q (L, H, D), k and v (L, Hk, D), inside the
        sliding window where there is one."""
        g = self.g
        L, h, d = q.shape
        if self.fp8:
            q, k, v = to_e4m3(q, -1), to_e4m3(k, -1), to_e4m3(v, -1)
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
        out = torch.empty_like(q)
        pos = torch.arange(L, device=q.device)
        for c0 in range(0, L, QUERY_CHUNK):
            c1 = min(c0 + QUERY_CHUNK, L)
            lo = 0 if g.window is None else max(0, c0 - g.window + 1)
            s = torch.einsum("chd,khd->hck", q[c0:c1], k[lo:c1]) / math.sqrt(d)
            qp, kp = pos[c0:c1, None], pos[None, lo:c1]
            ok = kp <= qp
            if g.window is not None:
                ok &= kp > qp - g.window
            p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
            out[c0:c1] = torch.einsum("hck,khd->chd", p, v[lo:c1])
        return out

    def _ffn(self, x, gate, up, down) -> torch.Tensor:
        return self._mm(torch.nn.functional.silu(self._mm(x, gate)) * self._mm(x, up), down)

    def _layer(self, lw: dict, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        g = self.g
        wq, wk, wv, wo = (self._w(*lw[n]) for n in ("wq", "wk", "wv", "wo"))
        out = []
        for x in xs:
            h = self._norm(x)
            L = x.shape[0]
            q = self._rope(self._mm(h, wq).view(L, g.n_heads, g.head_dim))
            k = self._rope(self._mm(h, wk).view(L, g.n_kv_heads, g.head_dim))
            v = self._mm(h, wv).view(L, g.n_kv_heads, g.head_dim)
            out.append(x + self._mm(self._attend(q, k, v).reshape(L, g.q_dim), wo))
        del wq, wk, wv, wo
        hs = [self._norm(x) for x in out]
        if not g.n_experts:
            gate, up, down = (self._w(*lw[n]) for n in ("w_gate", "w_up", "w_down"))
            return [x + self._ffn(h, gate, up, down) for x, h in zip(out, hs)]
        router = self._dense(lw["router"])
        routes = []
        for h in hs:
            probs = torch.softmax(self._mm(h, router), dim=-1)
            top_w, top_i = torch.topk(probs, g.top_k, dim=-1)
            routes.append((top_w / top_w.sum(-1, keepdim=True), top_i))
        ys = [torch.zeros_like(x) for x in out]
        for e in range(g.n_experts):  # one expert's weights at a time
            gate, up, down = (self._w(lw[n][0][e], lw[n][1][e]) for n in ("gate", "up", "down"))
            for y, h, (top_w, top_i) in zip(ys, hs, routes):
                rows, slot = torch.nonzero(top_i == e, as_tuple=True)
                if rows.numel():
                    y[rows] += top_w[rows, slot, None] * self._ffn(h[rows], gate, up, down)
        return [x + y for x, y in zip(out, ys)]

    @torch.no_grad()
    def run(self, stream, seqs: list[torch.Tensor], want: list[torch.Tensor]) -> list[torch.Tensor]:
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            head = stream.head()
            xs = [head["embed"][s.long()].float() for s in seqs]
            lm_head = self._dense(head["lm_head"])
            del head
            for _ in range(self.g.n_layers):
                xs = self._layer(stream.layer(), xs)
            return [self._mm(self._norm(x[w.long()]), lm_head) for x, w in zip(xs, want)]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
