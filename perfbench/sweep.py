"""The knee of an open-loop cell: one set-up, then the cell's window at each
of a few fixed rates; not run by the benchmark's runs.

    python3 perfbench/sweep.py --workload <name> --seed <n> --rates 2,2.5,3 [--seconds 40]

Per rate, one JSON line: requests due and finished, the queue of requests
waiting for a slot over each third of the window, and the TTFT tails of the
requests due in the first and the last third.  A rate whose queue and TTFT
grow from third to third is past the knee.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.readers import tail_ms
    from perfbench.spec import Spec
    from torch_bnb_fp4_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    _build.build_all()
    spec = Spec(args.workload)
    p = harness.prepare(spec, args.seed, torch.device("cuda", 0))
    for rate in (float(r) for r in args.rates.split(",")):
        rec = harness.drive(p, args.seconds, rate=rate)
        third = rec.window_s / 3
        cuts = [rec.open + i * third for i in range(4)]
        queued, ttft = [], []
        for a, b in zip(cuts, cuts[1:]):
            q = [t.queued for t in rec.ticks if a <= t.t1 < b]
            queued.append(sum(q) / len(q) if q else None)
            ttft.append(tail_ms([r.t_first - r.due if r.t_first is not None else float("inf")
                                 for r in rec.reqs if a <= r.due < b]))
        due = rec.due_in_window
        print(json.dumps(dict(workload=args.workload, rate=rate, due=len(due),
                              finished=sum(r.done is not None and r.reason == "length" for r in due),
                              queued_by_third=queued, ttft_p95_ms_by_third=ttft,
                              tpot_p95_ms=tail_ms([(r.times[-1] - r.times[0]) / (len(r.times) - 1) for r in due
                                                   if r.done is not None and len(r.times) > 1]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
