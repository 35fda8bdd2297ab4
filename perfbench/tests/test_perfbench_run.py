"""``run.py`` and the contract's checks: no card, no result; no JAX loaded;
the reference imports nothing of the program; BENCHMARK.json as the
contract shapes it; new cells, mixes and metrics found by name."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.spec import HERE, REPO, Spec, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def cpu_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_run_exits_nonzero_without_a_card():
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "mistral7b-chat", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, env=cpu_env(),
                       cwd=REPO, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("torch_bnb_fp4_tpu_torch", "torch_bnb_fp4_tpu_torch.serve", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == [m for m in sorted(sys.modules) if m.split(".")[0] in harness.FORBIDDEN]
    assert "torch_bnb_fp4_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "torch_bnb_fp4_tpu.ops", sys)
    assert "torch_bnb_fp4_tpu.ops" in harness.forbidden_modules()


def test_a_whole_cpu_run_loads_no_jax():
    """A tiny cell through set-up, window, check and readers, in a fresh
    interpreter: JAX, jaxlib, flax and the JAX package stay unloaded."""
    code = ("import sys, time, torch; sys.path[:0] = [%r, %r]\n"
            "from conftest import tiny_bench, DATA\n"
            "from perfbench import harness\nfrom perfbench.spec import Spec\n"
            "out = harness.run_cell(Spec('tiny-chat', tiny_bench(), dirs=(DATA,)), 5, 1.0, True, torch.device('cpu'),"
            " time.perf_counter())\n"
            "print(out['correct'], harness.forbidden_modules())\n") % (str(REPO), str(HERE / "tests"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=cpu_env(), cwd=REPO,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "True []"


def imports_of(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    for p in (HERE / "refs").glob("*.py"):
        assert imports_of(p) <= {"__future__", "math", "torch", "numpy"}, p
    for p in (HERE / "weights.py", HERE / "work.py", HERE / "check.py"):
        assert not {m for m in imports_of(p) if m.startswith("torch_bnb_fp4_tpu")}, p
    code = f"import sys; sys.path.insert(0, {str(REPO)!r}); import perfbench.check, perfbench.refs.decoder; " \
           "print(sorted(m for m in sys.modules if m.startswith('torch_bnb') or m.split('.')[0] in ('jax', 'flax')))"
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=cpu_env(), timeout=120)
    assert p.stdout.strip() == "[]", p.stderr[-2000:]


def test_no_module_of_the_benchmark_imports_jax():
    for p in HERE.rglob("*.py"):
        assert not imports_of(p) & {"jax", "jaxlib", "flax", "torch_bnb_fp4_tpu"}, p


def test_benchmark_json_keeps_to_the_contract():
    b = load_json(REPO / "BENCHMARK.json")
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for c in b["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).exists() and set(c) == {"name", "source", "file",
                                                                                    "reduced", "why"}
        assert load_json(REPO / c["file"])["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        spec = Spec(w["name"], b)
        reported = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and spec.per_layer
        assert all(m["moves"] in reported for m in spec.per_layer)
        for m in spec.end_to_end + spec.per_layer:
            spec.reader(m["name"])
    layers = {}
    for m in b["per_layer"]:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_new_files_are_found_by_name(tmp_path):
    """A later PR adds a mix, a cell and a metric as files and entries only."""
    b = load_json(REPO / "BENCHMARK.json")
    for kind in ("traffic", "cells", "metrics"):
        (tmp_path / kind).mkdir()
    t = load_json(HERE / "traffic" / "chat.json")
    t["prompt_len"]["median"] = 1000
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps(t))
    (tmp_path / "cells" / "mistral7b-burst.json").write_text(json.dumps({"rate": 1.5}))
    (tmp_path / "metrics" / "queue_wait_ms.py").write_text("def read(rec, spec):\n    return 42.0\n")
    b["workloads"].append({"name": "mistral7b-burst", "config": "mistral-7b", "traffic": "burst", "chips": 1,
                           "why": "bursts"})
    b["per_layer"].append({"name": "queue_wait_ms.burst", "unit": "ms", "better": "lower", "source": "host_clock",
                           "layer": "engine prefill", "moves": "ttft_p95_ms", "workloads": ["mistral7b-burst"]})
    b["end_to_end"][0]["workloads"].append("mistral7b-burst")
    spec = Spec("mistral7b-burst", b, dirs=(tmp_path,))
    assert spec.traffic["prompt_len"]["median"] == 1000 and spec.params == {"rate": 1.5}
    assert [m["name"] for m in spec.per_layer] == ["queue_wait_ms.burst"]
    assert spec.reader("queue_wait_ms.burst")(None, spec) == 42.0
    # a metric of an existing quantity for the new cell takes the shared reader of its base name
    assert spec.reader("decode_step_ms.burst").__globals__["__file__"] == str(HERE / "metrics" / "decode_step_ms.py")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.burst")
