"""One run of one cell: set-up, the window, the check and the result line.

Set-up makes the weights on the device from the seed (``weights.py``),
hands them to the port through ``QuantLinear`` and its own fusion
(``models.transformer.fuse_layer``), builds ``serve.engine.Engine`` with the
traffic file's ``EngineConfig`` and warms only the cell's own shapes
(``Engine.warmup(prompt_lens=...)``: one prefill per listed length, the
decode graphs at the one batch bucket).  The window is driven by
``loadgen.Driver``.  Then the peak memory is read, the program is freed and
the check (``check.py``) runs the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from . import check
from .devtrace import Slice
from .loadgen import Driver, Record, Schedule
from .spec import Spec
from .weights import WeightStream

FORBIDDEN = ("jax", "jaxlib", "flax", "torch_bnb_fp4_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def model_config(spec: Spec):
    from torch_bnb_fp4_tpu_torch.models import transformer as T

    c, g = spec.config, spec.geometry
    return T.ModelConfig(vocab_size=g.vocab, dim=g.dim, n_layers=g.n_layers, n_heads=g.n_heads,
                         n_kv_heads=g.n_kv_heads, ffn_dim=g.ffn, rope_theta=float(c["rope_theta"]),
                         rms_eps=float(c["rms_norm_eps"]), sliding_window=g.window, blocksize=g.blocksize,
                         variant=c["quantization"]["variant"], head_dim=g.head_dim, n_experts=g.n_experts,
                         experts_per_tok=g.top_k)


def build_params(spec: Spec, seed: int, device):
    """The benchmark's weights, handed to the port: ``QuantLinear`` per
    linear, a dense bf16 embedding, router and lm_head, then the port's own
    fusion, one layer at a time."""
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.models.linear import DenseLinear, QuantLinear

    g = spec.geometry
    variant = spec.config["quantization"]["variant"]
    stream = WeightStream(g, spec.config["weights"], seed, device)
    head = stream.head()

    def ql(pair, own=False):
        packed, scale = pair
        if own:  # a view into the layer's generated buffer that fusion keeps as it is
            packed, scale = packed.clone(), scale.clone()
        return QuantLinear(packed=packed, scale=scale, bias=None, n_out=packed.shape[-1], k_in=2 * packed.shape[-2],
                           blocksize=g.blocksize, variant=variant)

    def ones():
        return torch.ones(g.dim, dtype=torch.bfloat16, device=device)

    layers = []
    for _ in range(g.n_layers):
        lw = stream.layer()
        lp = T.LayerParams(attn_norm=ones(), wq=ql(lw["wq"]), wk=ql(lw["wk"]), wv=ql(lw["wv"]),
                           wo=ql(lw["wo"], own=True), mlp_norm=ones())
        if g.n_experts:
            lp.moe = T.MoEParams(router=DenseLinear(w=lw["router"], bias=None, n_out=g.n_experts, k_in=g.dim),
                                 gate=ql(lw["gate"]), up=ql(lw["up"]), down=ql(lw["down"], own=True))
        else:
            lp.w_gate, lp.w_up, lp.w_down = ql(lw["w_gate"]), ql(lw["w_up"]), ql(lw["w_down"], own=True)
        layers.append(T.fuse_layer(lp))
        del lw, lp
    return T.ModelParams(embed=head["embed"], layers=layers, final_norm=ones(),
                         lm_head=DenseLinear(w=head["lm_head"], bias=None, n_out=g.vocab, k_in=g.dim))


class Profiler:
    """A ``torch.profiler`` session over a slice of the window, which the
    driver starts and stops at tick boundaries; ``launches`` is the port's
    launch counts over it (None until it has stopped)."""

    def __init__(self, launch_counts):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=acts):  # the profiler's first start initialises it: keep that out of the slice
            torch.ones(8, device="cuda" if self.cuda else "cpu").sum().item()
        self.prof = profile(activities=acts)
        self.launch_counts, self.on, self.launches = launch_counts, False, None

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self._before = self.launch_counts()
        self.prof.start()
        self.on = True

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        after = self.launch_counts()
        self.launches = {k: n - self._before.get(k, 0) for k, n in after.items()}
        self.on = False


@dataclasses.dataclass
class Prepared:
    spec: Spec
    seed: int
    device: torch.device
    engine: object


def prepare(spec: Spec, seed: int, device, log=None, engine: dict | None = None) -> Prepared:
    """Weights, engine and warm-up of one cell at one seed; ``engine``
    overrides fields of the traffic file's engine settings (the control's
    e4m3 KV)."""
    from torch_bnb_fp4_tpu_torch.serve.engine import Engine, EngineConfig

    log = log or (lambda *_: None)
    device = torch.device(device)
    t0 = time.perf_counter()
    params = build_params(spec, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    ecfg = EngineConfig(**dict(spec.traffic["engine"], **(engine or {})))
    engine = Engine(params, model_config(spec), ecfg)
    engine.warmup(prompt_lens=spec.traffic["warm_prompt_lens"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"weights {t1 - t0:.2f} s, engine and warm-up {time.perf_counter() - t1:.2f} s")
    return Prepared(spec, seed, device, engine)


def drive(p: Prepared, seconds: float, trace: bool = False, rate: float | None = None) -> Record:
    """The window (after the ramp-in) and the drain."""
    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.serve.engine import Request

    spec = p.spec
    sched = Schedule(spec.traffic, p.seed, spec.geometry.vocab, rate or spec.params.get("rate"))
    prof = Profiler(K.launch_counts) if trace else None
    rec = Driver(p.engine, spec, sched, seconds, Request, prof).run()
    if prof is not None and prof.launches is not None:
        rec.slice, rec.slice_launches = Slice.from_profiler(prof.prof), prof.launches
    return rec


def free(p: Prepared) -> None:
    p.engine = None  # the engine holds the params, caches and graphs
    gc.collect()
    if p.device.type == "cuda":
        torch.cuda.synchronize(p.device)
        torch.cuda.empty_cache()


def verify(spec: Spec, seed: int, rec: Record, device) -> dict:
    """The check's readings: the logit gaps of a sample of the finished
    requests (``check.readings``), and the requests due in the window that
    never finished."""
    due = rec.due_in_window
    done = [r for r in due if r.done is not None and r.tokens]
    ck = spec.traffic["check"]
    reqs = check.sample(done, seed, ck["served_tokens"], ck["max_rows"])
    if reqs:
        out = check.readings(check.program_gaps(spec, seed, reqs, device)[0], reqs)
    else:
        out = dict.fromkeys(("widest_logit_gap", "mean_logit_gap"), float("inf"))
    return dict(out, unfinished_requests=len(due) - len(done), sampled=len(reqs),
                sampled_tokens=sum(len(r.tokens) for r in reqs))


def compare(spec: Spec, readings: dict) -> tuple[dict, bool]:
    """Each number that the cell's limits name beside its limit, and
    whether every one is within it: ``correct``."""
    compared = {name: {"value": readings[name], "limit": limit} for name, limit in spec.params["limits"].items()}
    compared["unfinished_requests"] = {"value": readings["unfinished_requests"], "limit": 0}
    return compared, all(c["limit"] is not None and c["value"] <= c["limit"] for c in compared.values())


def result(spec: Spec, rec: Record, trace: bool, readings: dict, device, memory_peak: int) -> dict:
    """The result line's object; ``compared`` (each number beside its
    limit) comes last."""
    compared, correct = compare(spec, readings)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = spec.reader(m["name"])(rec, spec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    out = {"correct": correct, "attempted": len(rec.due_in_window), "failed": readings["unfinished_requests"],
           "metrics": metrics, "device": dev}
    if trace and rec.slice is not None:
        dev.update(busy_s=rec.slice.busy_s, window_s=rec.slice.window_s)
        out["breakdown"] = {"device_ops": rec.slice.device_ops(), "idle_gaps": rec.slice.idle_gaps()}
    out["compared"] = compared
    return out


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device, t_start: float, log=None) -> dict:
    """Set-up, window, drain, check; returns the result object."""
    log = log or (lambda *_: None)
    p = prepare(spec, seed, device, log=log)
    rec = drive(p, seconds, trace)
    rec.setup_s = rec.open - t_start
    t0 = time.perf_counter()
    log(f"set-up {rec.setup_s:.2f} s (ramp-in {spec.traffic['ramp_s']} s), drain {t0 - rec.close:.2f} s")
    peak = torch.cuda.max_memory_allocated(p.device) if p.device.type == "cuda" else 0
    free(p)
    readings = verify(spec, seed, rec, p.device)
    log(f"check {time.perf_counter() - t0:.2f} s over {readings['sampled']} requests, "
        f"{readings['sampled_tokens']} served tokens: {readings}")
    return result(spec, rec, trace, readings, p.device, peak)
