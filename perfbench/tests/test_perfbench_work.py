"""The yardstick against the bounds that PERF.md's kernel table gives, and
the kernel calls of a forward pass against the port's dispatch."""

from __future__ import annotations

import pytest

from perfbench import work
from perfbench.spec import Spec


def mistral():
    return Spec("mistral7b-chat").geometry


def per_layer_ms(g, m, kernel):
    return 1e3 * sum(work.linear_call(m, k, n, kernel=kernel).least_s() for _, k, n in work.layer_linears(g))


def test_k2_and_k4_bounds_match_the_kernel_table():
    g = mistral()
    assert per_layer_ms(g, 1, "K2") == pytest.approx(0.0367, abs=5e-5)  # bytes-bound GEMV
    assert per_layer_ms(g, 8, "K2") == pytest.approx(0.0370, abs=5e-5)
    assert per_layer_ms(g, 32, "K2") == pytest.approx(0.0380, abs=1e-4)
    assert per_layer_ms(g, 256, "K4") == pytest.approx(0.056, abs=5e-4)  # int8 operations
    assert per_layer_ms(g, 6016, "K4") == pytest.approx(1.326, abs=2e-3)


def test_kernel_choice_by_rows():
    assert [work.kernel_of(m) for m in (1, 128, 129, 255, 256, 6144)] == ["K2", "K2", "K3", "K3", "K4", "K4"]


def test_attention_pairs_closed_form():
    for window in (None, 7, 50):
        g = work.Geometry(vocab=8, dim=64, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=32, ffn=64, window=window)
        for start, rows in ((0, 100), (30, 65), (90, 200)):
            loop = sum(work.visible_keys(p, window) for p in range(start, start + rows))
            assert work._pairs_closed(start, start + rows, window) == loop
            assert work.attention_work(g, start, rows).ops_bf16 == 4 * 32 * 2 * loop


def test_ring_reads_only_the_window():
    g = work.Geometry(vocab=8, dim=64, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=32, ffn=64, window=100)
    w = work.attention_work(g, 1000, 1)
    assert w.nbytes == 100 * g.kv_row_bytes() + g.kv_row_bytes() + 2 * g.q_dim * 2


def mixtral():
    from perfbench.spec import HERE, geometry, load_json

    return geometry(load_json(HERE / "configs" / "mixtral-8x7b.json"))


def test_pass_calls_follow_the_moe_dispatch():
    """One call per fused non-expert linear and layer, whatever the expert
    dispatch; the expert forms' work is the routed tokens' (``expert_work``)."""
    g = mixtral()
    for m, kern in ((1, "K2"), (32, "K2"), (512, "K4")):
        calls = work.pass_calls(g, m)
        assert len(calls) == 32 * 2 and {c[0] for c in calls} == {kern}
    assert len(work.pass_calls(mistral(), 32)) == 32 * 4


def test_expert_work_counts_the_routed_rows_not_the_dispatch():
    g = mixtral()
    e = work.expert_work(g, 32, "K2")
    routed = 32 * 2 / 8
    one = work.linear_call(routed, g.dim, 2 * g.ffn, weights=work.expert_hit(32, g), kernel="K2")
    down = work.linear_call(routed, g.ffn, g.dim, out_bytes=4, weights=work.expert_hit(32, g), kernel="K2")
    assert e.nbytes == pytest.approx(32 * 8 * (one.nbytes + down.nbytes))
    assert e.ops_bf16 == pytest.approx(2 * 32 * 2 * 32 * 3 * g.dim * g.ffn)  # each token's top-2 experts only
    assert work.expert_work(mistral(), 32).nbytes == 0


def test_expert_weights_count_when_routed_tokens_reach_them():
    g = mixtral()
    assert work.expert_hit(1, g) == pytest.approx(0.25)
    assert work.expert_hit(32, g) > 0.9998
    one = work.pass_work(g, [(100, 1)])
    dense_part = g.n_layers * sum(work.weight_bytes(k, n) for _, k, n in work.layer_linears(g))
    expert = work.weight_bytes(g.dim, 2 * g.ffn) + work.weight_bytes(g.ffn, g.dim)
    assert one.nbytes == pytest.approx(dense_part + g.n_layers * 2 * expert + g.dim * g.vocab * 2, rel=0.01)
