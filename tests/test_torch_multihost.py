"""Multi-process serving through the CLI: ``python -m torch_bnb_fp4_tpu_torch.serve
--multihost --coordinator HOST:PORT`` as two processes (``RANK`` /
``WORLD_SIZE`` in their environment) with ``--device cpu``, over real
sockets, against the single-process CLI serving the same model (its tiny
2-layer random model, with ``--prefill-shadow``: a 300-token prompt takes
the int8 path).

At ``--tp 1`` (data 2: the slots split over the two ranks) the HTTP tokens
equal the single-process CLI's.  At ``--tp 2`` the row-parallel outputs are
summed in f32 before one bf16 rounding, so a greedy token may flip where the
model is torn: the tokens equal the single-process CLI's, or first differ
where the single-process model's own teacher-forced logits put the two
tokens within 2^-7 * max|logit| of each other.  Each case also aborts a
streaming request on its first event, and SIGINT to rank 0 stops its server,
which releases the follower: both processes exit 0.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.models.linear import attach_prefill_shadow

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [[(7 * i + 3) % 250 + 1 for i in range(n)] for n in (5, 40, 300)]
MAX_TOKENS = 8
COMMON = ["--device", "cpu", "--port", "0", "--max-batch", "4", "--prefill-shadow"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(extra, env_extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-m", "torch_bnb_fp4_tpu_torch.serve", *COMMON, *extra], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _serving_url(proc) -> str:
    """The URL of the serving line (read with a timeout)."""
    box = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout=180)
    line = box[0] if box else ""
    assert line.startswith("serving on http://"), (line, proc.poll())
    return line.split()[-1]


def _post(url, body, path="/v1/completions"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=180) as r:
        return json.loads(r.read())


def _stop(procs, timeout=120):
    """SIGINT to the first process (rank 0 or the single server); every
    process must then exit 0.  Returns their stderr tails."""
    procs[0].send_signal(signal.SIGINT)
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err
    return errs


def _abort_on_first_event(url) -> dict:
    """A streaming request aborted on its first event: (abort reply, final
    completion)."""
    req = urllib.request.Request(url + "/v1/completions", data=json.dumps(
        dict(prompt=PROMPTS[1], max_tokens=200, stream=True)).encode(), headers={"Content-Type": "application/json"})
    reply, done = None, None
    with urllib.request.urlopen(req, timeout=180) as r:
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[6:])
            if reply is None and "uid" in ev:
                reply = _post(url, {"uid": ev["uid"]}, "/v1/abort")
            if "done" in ev:
                done = ev["done"]
    return dict(reply=reply, done=done)


@pytest.fixture(scope="module")
def single():
    """The single-process CLI's tokens for PROMPTS."""
    proc = _start([])
    url = _serving_url(proc)
    try:
        toks = [_post(url, dict(prompt=p, max_tokens=MAX_TOKENS))["tokens"] for p in PROMPTS]
    finally:
        _stop([proc])
    return toks


def _ref_logits(prompt, tokens):
    """The CLI's model (tiny_test(n_layers=2), seed 0, shadows) on the CPU:
    full logits of prompt + tokens at the positions that chose the tokens."""
    cfg = T.ModelConfig.tiny_test(n_layers=2)
    params = attach_prefill_shadow(T.quantize_params(cfg, T.random_weights(cfg, seed=0), device="cpu"))
    seq = prompt + tokens
    with torch.no_grad():
        lg, _ = T.forward(params, cfg, torch.tensor([seq], dtype=torch.int32),
                          T.KVCache.zeros(cfg, 1, len(seq), device="cpu"))
    return lg[0, len(prompt) - 1 : len(seq) - 1].numpy()


@pytest.mark.parametrize("tp", ["2", "1"])
def test_two_process_cli_matches_single_process(single, tp):
    coord = f"127.0.0.1:{_free_port()}"
    procs = [_start(["--multihost", "--tp", tp, "--coordinator", coord], dict(RANK=str(r), WORLD_SIZE="2"))
             for r in range(2)]
    try:
        url = _serving_url(procs[0])
        got = [_post(url, dict(prompt=p, max_tokens=MAX_TOKENS))["tokens"] for p in PROMPTS]
        aborted = _abort_on_first_event(url)
        stats = json.loads(urllib.request.urlopen(url + "/v1/stats", timeout=60).read())
    finally:
        _stop(procs)
    for prompt, want, toks in zip(PROMPTS, single, got):
        assert len(toks) == len(want) == MAX_TOKENS
        j = next((i for i, (a, b) in enumerate(zip(want, toks)) if a != b), None)
        if j is None:
            continue
        assert tp == "2", (prompt[:3], want, toks)  # data parallelism alone changes no arithmetic
        g = _ref_logits(prompt, want)[j]
        assert g[want[j]] - g[toks[j]] <= 2.0**-7 * np.abs(g).max(), (j, want, toks)
    assert aborted["reply"]["aborted"] is True and aborted["done"]["finish_reason"] == "abort"
    assert stats["completions"] == len(PROMPTS) + 1


def test_follower_needs_a_rank_zero(monkeypatch):
    """follow() refuses rank 0 and the server refuses other ranks (checked
    without a job: the rank is read from torch.distributed)."""
    import torch.distributed as dist

    from torch_bnb_fp4_tpu_torch.serve import MultihostEngineServer, follow

    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    with pytest.raises(RuntimeError, match="rank 0 runs MultihostEngineServer"):
        follow(None)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    with pytest.raises(RuntimeError, match="HTTP front-end lives on rank 0"):
        MultihostEngineServer(None)
