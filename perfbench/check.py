"""The comparison that decides a run's ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests that the window's load finished, drawn from the seed and with
the longest of them in it, is run through the plain reference: one forward
pass over each prompt and its served tokens.  A served token's gap is how
far the reference's logit of that token lies below the reference's best
logit at that position.  Served tokens are greedy, so a sound program
serves the reference's best token or one within rounding of it.  A cell's
``limits`` (``cells/<workload>.json``) name the readings it is held to:
the mean gap over the sample's served tokens, because the widest gap swings
with the rarest near-tie that a sample happens to hold (PERF.md).

The control (``control_gaps``) puts the reference itself, computed in float8
e4m3 (``refs/decoder.py``), in the program's place: the gap of the token that
it puts first at each position of the same prompts and tokens.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .weights import WeightStream


def sample(done: list, seed: int, served_tokens: int, max_rows: int) -> list:
    """The longest finished request (most served tokens), then others in an
    order drawn from ``seed`` while the served tokens stay under
    ``served_tokens`` and the reference's rows (prompt and served tokens)
    under ``max_rows``."""
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), len(r.prompt), -r.uid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed % 2**63, 1]).permutation(len(rest))
    out, served, rows = [longest], len(longest.tokens), len(longest.prompt) + len(longest.tokens)
    for i in order:
        r = rest[i]
        n = len(r.prompt) + len(r.tokens)
        if served >= served_tokens:
            break
        if rows + n > max_rows:
            continue
        out.append(r)
        served, rows = served + len(r.tokens), rows + n
    return out


def reference_inputs(reqs: list, device) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Each request's prompt and served tokens but the last, and the
    positions whose logits predict the served tokens."""
    seqs, want = [], []
    for r in reqs:
        toks = list(r.prompt) + list(r.tokens[:-1])
        seqs.append(torch.tensor(toks, dtype=torch.long, device=device))
        want.append(torch.arange(len(r.prompt) - 1, len(toks), device=device))
    return seqs, want


def reference_logits(spec, seed: int, reqs: list, device, precision: str = "f32") -> list[torch.Tensor]:
    """The configuration's reference (``refs/<reference>.py``) at the
    positions that predict the served tokens, its weights made again from
    the seed."""
    mod = importlib.import_module(f"perfbench.refs.{spec.config['reference']}")
    ref = mod.Decoder(spec.geometry, spec.config["rope_theta"], spec.config["rms_norm_eps"], precision)
    return ref.run(WeightStream(spec.geometry, spec.config["weights"], seed, device), *reference_inputs(reqs, device))


def gaps(logits: list[torch.Tensor], tokens: list[torch.Tensor]) -> torch.Tensor:
    """Per position: the best logit less the logit of ``tokens`` there."""
    return torch.cat([(lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0]) for lg, t in zip(logits, tokens)])


def program_gaps(spec, seed: int, reqs: list, device) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Each served token's gap under the float32 reference, request after
    request; also the reference's logits."""
    ref = reference_logits(spec, seed, reqs, device)
    return gaps(ref, [torch.tensor(r.tokens, dtype=torch.long, device=device) for r in reqs]), ref


def control_gaps(spec, seed: int, reqs: list, ref: list[torch.Tensor], device) -> torch.Tensor:
    """The gap, under the float32 reference's logits ``ref``, of the token
    that the float8 reference puts first at each position of the same
    prompts and served tokens."""
    low = reference_logits(spec, seed, reqs, device, "fp8")
    return gaps(ref, [lg.argmax(-1) for lg in low])


def readings(g: torch.Tensor, reqs: list) -> dict:
    """The numbers a gap vector gives: the widest and the mean gap over all
    positions, the mean over requests of each request's mean gap, the 99th
    percentile, the share of positions off the reference's best token, and
    the widest gap of the requests' first tokens (the prefill's)."""
    per = torch.split(g, [len(r.tokens) for r in reqs])
    first = torch.stack([p[0] for p in per])
    return dict(widest_logit_gap=float(g.max()), mean_logit_gap=float(g.mean()),
                request_mean_logit_gap=float(torch.stack([p.mean() for p in per]).mean()),
                p99_logit_gap=float(torch.quantile(g.float(), 0.99)), off_best_share=float((g > 0).float().mean()),
                first_token_widest_gap=float(first.max()))
