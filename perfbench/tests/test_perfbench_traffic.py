"""The traffic generator: deterministic per seed, the stated distributions,
and the same work for every seed."""

from __future__ import annotations

import math
import statistics

import pytest

from perfbench import loadgen
from perfbench.spec import HERE, load_json


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def draw(t: dict, seed: int, n: int, rate=None):
    s = loadgen.Schedule(t, seed, 32000, rate)
    return [s.next() for _ in range(n)]


@pytest.mark.parametrize("name", ["chat", "longdoc"])
def test_same_seed_same_requests(name):
    t = traffic(name)
    a, b = draw(t, 2**31 + 11, 70, 2.5), draw(t, 2**31 + 11, 70, 2.5)
    assert [(r.prompt, r.n_out, g) for r, g in a] == [(r.prompt, r.n_out, g) for r, g in b]
    c = draw(t, 2**31 + 12, 70, 2.5)
    assert [r.prompt for r, _ in a] != [r.prompt for r, _ in c]


@pytest.mark.parametrize("name", ["chat", "longdoc"])
def test_every_block_holds_the_same_work(name):
    """Seeds differ in order only: each block of ``block`` requests holds the
    stratified quantiles of the lengths and gaps."""
    t = traffic(name)
    n = t["block"]
    blocks = []
    for seed in (1, 2**33 + 5):
        reqs = draw(t, seed, 2 * n, 2.0)
        for b in (reqs[:n], reqs[n:]):
            blocks.append((sorted(len(r.prompt) for r, _ in b), sorted(r.n_out for r, _ in b),
                           sorted(round(g, 12) for _, g in b)))
    assert all(b == blocks[0] for b in blocks)
    assert blocks[0][0] == sorted(loadgen.block_values(t["prompt_len"], n))


def test_chat_lengths_follow_their_lognormals():
    """Medians of the Azure 2023 conversation trace: prompts 1020, answers
    129 tokens."""
    t = traffic("chat")
    vals = loadgen.block_values(t["prompt_len"], 64)
    assert min(vals) >= 32 and max(vals) <= 2560 and sum(v == 2560 for v in vals) <= 3
    assert abs(statistics.median(vals) - 1020) <= 20
    outs = loadgen.block_values(t["output_len"], 64)
    assert min(outs) >= 4 and max(outs) <= 512 and abs(statistics.median(outs) - 129) <= 5
    assert max(vals) + max(outs) <= t["engine"]["max_len"]
    # the log of the unclipped middle is normal with the stated sigma
    logs = [math.log(v) for v in vals[8:-8]]
    want = [0.5 * statistics.NormalDist().inv_cdf((j + 0.5) / 64) for j in range(8, 56)]
    assert max(abs(a - math.log(1020) - b) for a, b in zip(logs, want)) < 0.05


def test_uniform_lengths_and_poisson_gaps():
    t = traffic("longdoc")
    vals = loadgen.block_values(t["prompt_len"], 64)
    assert min(vals) >= 3072 and max(vals) <= 6144 and abs(statistics.mean(vals) - 4608) < 10
    gaps = [g for _, g in draw(traffic("chat"), 3, 64, 2.5)]
    assert abs(statistics.mean(gaps) - 1 / 2.5) < 0.02  # exponential quantiles: mean 1/rate
    assert statistics.median(gaps) == pytest.approx(math.log(2) / 2.5, rel=0.05)


def test_token_ids_cover_the_vocabulary():
    reqs = draw(traffic("longdoc"), 9, 8)
    ids = [i for r, _ in reqs for i in r.prompt]
    assert min(ids) >= 0 and max(ids) < 32000
    expected_distinct = 32000 * (1 - math.exp(-len(ids) / 32000))  # uniform draws
    assert len(set(ids)) > 0.97 * expected_distinct
