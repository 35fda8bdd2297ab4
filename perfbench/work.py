"""The yardstick: the H100's published peaks, and the operations and bytes
that a kernel call or a whole forward pass of a Mistral-family decoder needs.

Copied from the port's ``utils/profiling.py`` (``bound_s``,
``pk_matmul_bound_s``, the peaks) and the kernel choice of its
``ops/kernels.py::select_path``, so that a change to the program cannot move
the yardstick.  Every count is of what the inputs need: each input byte read
once, each output byte written once, 2 operations per multiply-add.
"""

from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM data sheet, dense rates (a card below its 700 W limit runs slower)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

# the port's path choice for bf16 activations on an FP4 pair-K layer
A8_MIN_M = 256  # rows at which a call takes K4 (int8 activations)
K2_MAX_M = 128  # rows up to which a call takes K2; K3 between
A8_BLOCK_K = 1024  # K4's activation tile: one f32 row scale per tile


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Sizes of a Mistral-family decoder, read from a configuration file."""

    vocab: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn: int
    n_experts: int = 0
    top_k: int = 2
    window: int | None = None
    blocksize: int = 64

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def kv_row_bytes(self) -> int:
        """K and V of one position in one layer, bf16."""
        return 2 * self.kv_dim * 2


@dataclasses.dataclass
class Work:
    """Operations (split by the peak that they run at) and bytes."""

    ops_bf16: float = 0.0
    ops_int8: float = 0.0
    nbytes: float = 0.0

    def __iadd__(self, other: "Work") -> "Work":
        self.ops_bf16 += other.ops_bf16
        self.ops_int8 += other.ops_int8
        self.nbytes += other.nbytes
        return self

    def least_s(self) -> float:
        """Least time the card could take: the larger of the operations at
        their peaks and the bytes at the HBM rate."""
        return max(self.ops_bf16 / BF16_FLOPS + self.ops_int8 / INT8_OPS, self.nbytes / HBM_BYTES_PER_S)


def kernel_of(m: int) -> str:
    """The port's kernel for a bf16 call of ``m`` rows on a pair-K layer."""
    if m >= A8_MIN_M:
        return "K4"
    return "K3" if m > K2_MAX_M else "K2"


def weight_bytes(k: int, n: int, blocksize: int = 64, scale_bytes: int = 4) -> float:
    """FP4 pair-K weights of a (K, N) layer: K*N/2 packed bytes and
    (K/blocksize)*N scales."""
    return k * n / 2 + (k // blocksize) * n * scale_bytes


def linear_call(m: float, k: int, n: int, *, out_bytes: int = 2, blocksize: int = 64, weights: float = 1.0,
                kernel: str | None = None) -> Work:
    """One FP4 pair-K matmul of ``m`` rows (K2, K3 or K4, and their expert
    forms, which read one expert of the stack): the weights (``weights`` of
    them: the chance that a routed expert is read at all), the activations
    and the output once; 2*m*K*N operations, at the int8 rate on K4 (int8
    activations plus one f32 row scale per 1024-wide K tile), else at the
    bf16 rate."""
    kern = kernel or kernel_of(math.ceil(m))
    w = weights * weight_bytes(k, n, blocksize)
    ops = 2.0 * m * k * n
    if kern == "K4":
        return Work(ops_int8=ops, nbytes=w + m * k + m * (k // A8_BLOCK_K) * 4 + m * n * out_bytes)
    return Work(ops_bf16=ops, nbytes=w + m * k * 2 + m * n * out_bytes)


def dense_call(m: float, k: int, n: int, *, out_bytes: int = 4) -> Work:
    """A dense bf16 matmul (lm_head, router): bf16 weights and input, f32 out."""
    return Work(ops_bf16=2.0 * m * k * n, nbytes=k * n * 2 + m * k * 2 + m * n * out_bytes)


def visible_keys(pos: int, window: int | None) -> int:
    """Keys a query at ``pos`` attends to (causal, inside the window)."""
    return pos + 1 if window is None else min(pos + 1, window)


def attention_work(g: Geometry, start: int, rows: int) -> Work:
    """One layer's attention for ``rows`` new positions after ``start``
    cached ones: K/V of every visible position read once, the new rows'
    K/V written once, q read and the output written once; 4 * head_dim *
    n_heads operations per visible (query, key) pair."""
    end = start + rows
    lo = 0 if g.window is None else max(0, start - g.window + 1)  # the first query's oldest key
    pairs = sum(visible_keys(p, g.window) for p in range(start, end)) if rows <= 64 else \
        _pairs_closed(start, end, g.window)
    kv_read = (end - lo) * g.kv_row_bytes()
    io = rows * g.kv_row_bytes() + 2 * rows * g.q_dim * 2
    return Work(ops_bf16=4.0 * g.head_dim * g.n_heads * pairs, nbytes=kv_read + io)


def _pairs_closed(start: int, end: int, window: int | None) -> int:
    """Sum of visible_keys(p) over p in [start, end), in closed form."""
    def tri(a, b):  # sum of (p + 1) for p in [a, b)
        return (b * (b + 1) - a * (a + 1)) // 2

    if window is None:
        return tri(start, end)
    cut = min(max(window - 1, start), end)  # below cut: p + 1 <= window
    return tri(start, cut) + (end - cut) * window


def expert_hit(tokens: float, g: Geometry) -> float:
    """Expected share of a layer's experts that ``tokens`` routed tokens
    reach, each choosing top_k of n_experts (uniform routing)."""
    return 1.0 - (1.0 - g.top_k / g.n_experts) ** tokens


def layer_linears(g: Geometry) -> list[tuple[str, int, int]]:
    """(name, K, N) of the fused non-expert FP4 linears of one layer."""
    out = [("wqkv", g.dim, g.q_dim + 2 * g.kv_dim), ("wo", g.q_dim, g.dim)]
    if not g.n_experts:
        out += [("w_gateup", g.dim, 2 * g.ffn), ("w_down", g.ffn, g.dim)]
    return out


def expert_work(g: Geometry, tokens: int, kernel: str | None = None) -> Work:
    """What ``tokens`` routed tokens need of one pass's expert linears: per
    layer and expert, tokens * top_k / n_experts rows on average, and the
    expert's weights only when a routed token reaches it (their expected
    share, ``expert_hit``), whatever the program's dispatch runs."""
    w = Work()
    if not g.n_experts or tokens <= 0:
        return w
    routed, hit = tokens * g.top_k / g.n_experts, expert_hit(tokens, g)
    for kk, nn, ob in ((g.dim, 2 * g.ffn, 2), (g.ffn, g.dim, 4)):
        one = linear_call(routed, kk, nn, out_bytes=ob, blocksize=g.blocksize, weights=hit, kernel=kernel)
        w += Work(one.ops_bf16 * g.n_layers * g.n_experts, one.ops_int8 * g.n_layers * g.n_experts,
                  one.nbytes * g.n_layers * g.n_experts)
    return w


def pass_work(g: Geometry, seqs: list[tuple[int, int]], kernel_rows: int | None = None,
              logits_rows: int | None = None) -> Work:
    """What one forward pass needs: ``seqs`` lists (cached positions, new
    rows) of each sequence that the pass serves; the FP4 linears' kernels are
    those of ``kernel_rows`` rows (the program's M; default the served rows)
    but the work is the served rows'.  Weights are read once per pass; an
    expert's only when a routed token reaches it (``expert_work``).
    ``logits_rows``: rows through the lm_head (default one per sequence)."""
    t = sum(r for _, r in seqs)
    kern = kernel_of(kernel_rows if kernel_rows is not None else t)
    layer = Work()  # every layer needs the same
    for _, k, n in layer_linears(g):
        layer += linear_call(t, k, n, blocksize=g.blocksize, kernel=kern)
    for start, rows in seqs:
        layer += attention_work(g, start, rows)
    if g.n_experts:
        layer += dense_call(t, g.dim, g.n_experts)
    w = Work(layer.ops_bf16 * g.n_layers, layer.ops_int8 * g.n_layers, layer.nbytes * g.n_layers + t * g.dim * 2)
    w += expert_work(g, t, kern)
    w += dense_call(len(seqs) if logits_rows is None else logits_rows, g.dim, g.vocab)
    return w


def pass_calls(g: Geometry, m: int) -> list[tuple[str, int, int, int, int]]:
    """The non-expert FP4 kernel calls of one forward pass whose linears get
    ``m`` rows: (kernel, m, K, N, out bytes), one per fused linear and layer.
    Expert calls depend on the program's dispatch and are not listed: their
    work is ``expert_work``'s."""
    kern = kernel_of(m)
    return [(kern, m, k, n, 2) for _ in range(g.n_layers) for _, k, n in layer_linears(g)]
