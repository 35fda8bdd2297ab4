"""Tiny cells for the benchmark's CPU tests: the configurations, traffic and
cell files in ``data/`` added to a copy of ``BENCHMARK.json``."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"
REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CELLS = {"tiny-chat": ("tiny", "tinychat"), "tiny-doc": ("tiny", "tinydoc"),
              "tinymoe-chat": ("tiny-moe", "tinychat")}


def tiny_bench() -> dict:
    from perfbench.spec import load_json

    bench = copy.deepcopy(load_json(REPO / "BENCHMARK.json"))
    bench["configs"] += [{"name": n, "file": str(DATA / "configs" / f"{n}.json")} for n in ("tiny", "tiny-moe")]
    bench["workloads"] += [{"name": w, "config": c, "traffic": t, "chips": 1} for w, (c, t) in TINY_CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        w = m.get("workloads")
        if w is not None and "mistral7b-chat" in w:
            w += ["tiny-chat", "tinymoe-chat"]
        if w is not None and "mistral7b-longdoc" in w:
            w += ["tiny-doc"]
    return bench


@pytest.fixture
def tiny_spec():
    from perfbench.spec import Spec

    return lambda workload: Spec(workload, tiny_bench(), dirs=(DATA,))
