"""Readings that set a cell's limit; not run by the benchmark's runs.

    python3 perfbench/control.py --workload <name> --seeds 1,2,... [--control-seeds 1,2,3]
        [--kv-seeds 1,2,3] [--faults altered_slot,unchanged_state] [--fault-seeds 1] [--seconds 15]

Each run, in one process: the cell's set-up, a short window at the cell's
own load and its drain, then the check's sample through the float32
reference, judged by the same comparison as the benchmark's runs
(``harness.compare``).  One JSON line per run on standard output, with its
readings (``check.readings``), ``compared`` and ``correct``:

* ``program``: the program as the cell runs it (the lower readings);
* ``control``: on the control seeds, the tokens that the reference computed
  in float8 e4m3 puts first at the same positions;
* ``kv_e4m3``: on the KV seeds, the program with its own e4m3 KV cache
  switched on, the step below the cell's bfloat16 KV;
* ``fault:<name>``: on the fault seeds, the program with a fault of
  ``faults.py`` planted in its timed path.

Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--kv-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import check, faults, harness
    from perfbench.spec import Spec
    from torch_bnb_fp4_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    _build.build_all()
    spec = Spec(args.workload)
    dev = torch.device("cuda", 0)
    controls = set(seeds(args.control_seeds))

    def one(kind: str, seed: int, engine=None, fault=None) -> None:
        t0 = time.perf_counter()
        patch = faults.Patcher()
        if fault is not None:
            faults.FAULTS[fault](patch, spec)
        try:
            p = harness.prepare(spec, seed, dev, engine=engine)
            rec = harness.drive(p, args.seconds)
        finally:
            patch.undo()
        harness.free(p)
        due = rec.due_in_window
        done = [r for r in due if r.done is not None and r.tokens]
        ck = spec.traffic["check"]
        reqs = check.sample(done, seed, ck["served_tokens"], ck["max_rows"])
        t1 = time.perf_counter()
        gaps, ref = check.program_gaps(spec, seed, reqs, dev)
        base = dict(unfinished_requests=len(due) - len(done), due=len(due), sampled=len(reqs),
                    sampled_tokens=sum(len(r.tokens) for r in reqs),
                    sampled_rows=sum(len(r.prompt) + len(r.tokens) for r in reqs), reference_s=time.perf_counter() - t1)
        runs = [(kind, check.readings(gaps, reqs))]
        if kind == "program" and seed in controls:
            runs.append(("control", check.readings(check.control_gaps(spec, seed, reqs, ref, dev), reqs)))
        for k, readings in runs:
            readings = dict(readings, **base)
            compared, correct = harness.compare(spec, readings)
            print(json.dumps(dict(workload=args.workload, kind=k, seed=seed, correct=correct, readings=readings,
                                  compared=compared, seconds=time.perf_counter() - t0)), flush=True)
        del ref
        torch.cuda.empty_cache()

    for seed in seeds(args.seeds):
        one("program", seed)
    for seed in seeds(args.kv_seeds):
        one("kv_e4m3", seed, engine={"kv_dtype": "float8_e4m3fn"})
    for name in (f for f in args.faults.split(",") if f):
        if not faults.applies(name, spec):
            print(json.dumps(dict(workload=args.workload, kind=f"fault:{name}", applies=False)), flush=True)
            continue
        for seed in seeds(args.fault_seeds):
            one(f"fault:{name}", seed, fault=name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
