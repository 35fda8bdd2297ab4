"""What a cell is made of, found by name.

``BENCHMARK.json`` names each cell's configuration (its ``file``) and
traffic mix.  The rest is found by name in the benchmark's folder:
``traffic/<traffic>.json`` (loop, lengths, engine settings),
``cells/<workload>.json`` (what belongs to one cell alone: an open loop's
rate, the limits of its check) and ``metrics/<metric>.py`` or, for a
metric named ``<base>.<cells>``, ``metrics/<base>.py`` (its reader).
Adding a configuration, a mix, a cell or a metric adds files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from .work import Geometry

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def geometry(c: dict) -> Geometry:
    """A configuration file's sizes (HF ``config.json`` keys)."""
    return Geometry(vocab=c["vocab_size"], dim=c["hidden_size"], n_layers=c["num_hidden_layers"],
                    n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
                    head_dim=c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"],
                    ffn=c["intermediate_size"], n_experts=c.get("num_local_experts", 0),
                    top_k=c.get("num_experts_per_tok", 2), window=c.get("sliding_window"),
                    blocksize=c["quantization"]["blocksize"])


def metric_applies(m: dict, workload: str, e2e_names: set[str]) -> bool:
    """A metric with ``workloads`` is read in those cells; one without, in
    every cell (end to end) or every cell that reports what it moves."""
    if "workloads" in m:
        return workload in m["workloads"]
    return "moves" not in m or m["moves"] in e2e_names


class Spec:
    """One cell: ``cell`` (its BENCHMARK.json entry), ``config``,
    ``geometry``, ``traffic``, ``params`` (``cells/<name>.json``, empty when
    there is none), ``end_to_end`` and ``per_layer`` (the metric entries that
    this cell reports).  ``dirs``: where traffic, cells and metrics are
    looked for, in order (the benchmark's folder last)."""

    def __init__(self, workload: str, bench: dict | None = None, dirs: tuple[Path, ...] = ()):
        self.bench = load_json(REPO / "BENCHMARK.json") if bench is None else bench
        self.dirs = tuple(dirs) + (HERE,)
        cells = [w for w in self.bench["workloads"] if w["name"] == workload]
        if not cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[0]
        conf = [c for c in self.bench["configs"] if c["name"] == self.cell["config"]][0]
        self.config = load_json(REPO / conf["file"])
        self.geometry = geometry(self.config)
        self.traffic = load_json(self.find("traffic", self.cell["traffic"] + ".json"))
        p = self.find("cells", workload + ".json", required=False)
        self.params = load_json(p) if p else {}
        self.end_to_end = [m for m in self.bench["end_to_end"] if metric_applies(m, workload, set())]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.bench["per_layer"] if metric_applies(m, workload, names)]

    def find(self, kind: str, filename: str, required: bool = True) -> Path | None:
        for d in self.dirs:
            p = d / kind / filename
            if p.exists():
                return p
        if required:
            raise FileNotFoundError(f"{kind}/{filename} not found in {[str(d) for d in self.dirs]}")
        return None

    def reader(self, metric: str):
        """The ``read(record)`` function of a metric's reader file."""
        for fname in (metric + ".py", metric.split(".")[0] + ".py"):
            p = self.find("metrics", fname, required=False)
            if p:
                mod_spec = importlib.util.spec_from_file_location("perfbench_metric_" + p.stem.replace(".", "_"), p)
                mod = importlib.util.module_from_spec(mod_spec)
                mod_spec.loader.exec_module(mod)
                return mod.read
        raise FileNotFoundError(f"no reader for metric {metric!r} (metrics/{metric}.py or its base name)")
