"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells are the ``workloads`` of ``BENCHMARK.json``.  Set-up (weights
made on the card from the seed, engine, warm-up, the ramp-in of the load)
is ``setup_s``; the window lasts ``--seconds``; after it the requests due in
it are drained, the program is freed and a sample of its served tokens is
checked against the plain reference.  ``--trace 1`` profiles the window's
last seconds and reports the per-layer metrics instead of the end-to-end
ones.  The last line on standard output is one JSON object; the last lines
on standard error are each compared number beside its limit.  Needs a CUDA
card: without one it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)  # this folder's modules are imported as perfbench.*, never by their bare names
sys.path.insert(0, str(REPO))

# every build and kernel cache at a fixed path inside the checkout (the port builds its
# kernels into build/ beside its pyproject.toml)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(REPO / "build" / "perfbench" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.spec import Spec

    spec = Spec(args.workload)
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from torch_bnb_fp4_tpu_torch.ops import _build

    def log(msg):
        print(f"perfbench: {msg}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    log(f"start-up {t0 - T_START:.2f} s, kernel build or load {time.perf_counter() - t0:.2f} s")
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START, log)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
