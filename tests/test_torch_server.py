"""The port's HTTP server and CLI: real sockets, real threads, a CPU engine.

The cases of tests/test_server.py, ported: non-streaming and streaming
completions equal the port's greedy ``generate`` token for token, concurrent
requests batch, stop ids, text prompts through a tokenizer, bad sampling
parameters and bad requests are 400s after which the server still serves,
abort over HTTP, 404.  The CLI refuses the JAX flags it has not ported, runs
as a subprocess on the CPU (serving line, one prompt, SIGINT, exit code 0)
and, without ``--device cpu``, needs a card.
"""

import json
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, EngineServer
from torch_bnb_fp4_tpu_torch.serve import __main__ as cli

ROOT = Path(__file__).resolve().parent.parent
CFG = T.ModelConfig.tiny_test(n_layers=1, dim=512, ffn_dim=1024, n_heads=4, n_kv_heads=2)


@pytest.fixture(scope="module")
def params():
    return T.quantize_params(CFG, T.random_weights(CFG, seed=5), device="cpu")


@pytest.fixture(scope="module")
def server(params):
    srv = EngineServer(Engine(params, CFG, EngineConfig(max_batch=2, max_len=48, inner_steps=2)), port=0).start()
    yield srv
    srv.stop()


def _oracle(params, prompt, n):
    return T.generate(params, CFG, torch.tensor([prompt], dtype=torch.int32), max_new_tokens=n)[0].tolist()


def _post(srv, body, timeout=120, path="/v1/completions"):
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _events(srv, body, on_event=None):
    """The server-sent events of a streaming completion, in order."""
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}/v1/completions",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    out = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for line in r:  # urllib de-chunks; SSE "data: {...}" lines and blanks
            line = line.strip()
            if line.startswith(b"data: "):
                out.append(json.loads(line[6:]))
                if on_event is not None:
                    on_event(out[-1])
    return out


def test_health_and_stats(server):
    with urllib.request.urlopen(f"http://{server.host}:{server.port}/health") as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(f"http://{server.host}:{server.port}/v1/stats") as r:
        st = json.loads(r.read())
    assert "tokens_out" in st and "avg_batch_occupancy" in st and st["launches"]["matmul_w8"] == 0


def test_completion_matches_generate(server, params):
    got = _post(server, {"prompt": [1, 2, 3, 4], "max_tokens": 7})
    assert got["tokens"] == _oracle(params, [1, 2, 3, 4], 7)
    assert got["finish_reason"] == "length" and got["prompt_len"] == 4 and got["total_s"] > 0
    assert "logprobs" not in got


def test_streaming_completion(server, params):
    ev = _events(server, {"prompt": [5, 6, 7], "max_tokens": 5})
    want = _oracle(params, [5, 6, 7], 5)
    assert "uid" in ev[0] and "done" in ev[-1] and ev[-1]["done"]["tokens"] == want
    # streamed tokens may run past the budget inside a tick; the completion is
    # the source of truth and the stream must cover it
    assert [e["token"] for e in ev[1:-1]][: len(want)] == want


def test_concurrent_requests_batch(server, params):
    prompts = {1: [9, 8, 7, 6], 2: [4, 4, 2, 1, 3], 3: [11, 12]}
    out = {}
    ts = [threading.Thread(target=lambda u=u: out.__setitem__(u, _post(server, {"prompt": prompts[u],
                                                                              "max_tokens": 6})))
          for u in prompts]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    for uid, prompt in prompts.items():
        assert out[uid]["tokens"] == _oracle(params, prompt, 6), uid


class _FakeTok:
    """Duck-typed tokenizer: encode/decode and eos_token_id."""

    eos_token_id = 97

    def encode(self, s):
        return [ord(c) % 250 for c in s]

    def decode(self, ids):
        return "".join(chr(t) for t in ids)


def test_text_prompt_roundtrip(params):
    srv = EngineServer(Engine(params, CFG, EngineConfig(max_batch=2, max_len=48, inner_steps=2)), port=0,
                       tokenizer=_FakeTok()).start()
    try:
        got = _post(srv, {"text": "ab", "max_tokens": 6})
    finally:
        srv.stop()
    want = _oracle(params, _FakeTok().encode("ab"), 6)
    eos = _FakeTok.eos_token_id
    want = want[: want.index(eos) + 1] if eos in want else want
    assert got["tokens"] == want and got["text"] == _FakeTok().decode(want) and got["prompt_len"] == 2


def test_text_prompt_without_tokenizer_rejected(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, {"text": "hello"})
    assert ei.value.code == 400 and "tokenizer" in json.loads(ei.value.read())["error"]


def test_stop_ids_over_http(server, params):
    want = _oracle(params, [1, 2, 3, 4], 7)
    got = _post(server, {"prompt": [1, 2, 3, 4], "max_tokens": 7, "stop_ids": [want[3]]})
    assert got["finish_reason"] == "stop" and got["tokens"] == want[: want.index(want[3]) + 1]
    with pytest.raises(urllib.error.HTTPError):
        _post(server, {"prompt": [1, 2], "stop_ids": "x"})


@pytest.mark.parametrize("bad", [{"temperature": "hot"}, {"temperature": 0.9}, {"top_p": 0.0}, {"adapter": "a"},
                                 {"prompt": [CFG.vocab_size]}])
def test_bad_sampling_params_do_not_kill_server(server, params, bad):
    """Each is a 400 and the engine thread survives: the next request still
    completes as generate does, and one in flight beside it is not failed."""
    done = {}
    t = threading.Thread(target=lambda: done.__setitem__("r", _post(server, {"prompt": [3, 1], "max_tokens": 8})))
    t.start()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, dict({"prompt": [1, 2]}, **bad))
    assert ei.value.code == 400
    t.join(timeout=120)
    assert done["r"]["tokens"] == _oracle(params, [3, 1], 8)
    assert _post(server, {"prompt": [7, 7, 2], "max_tokens": 4})["tokens"] == _oracle(params, [7, 7, 2], 4)


def test_abort_over_http(server):
    """A streaming client reads its uid from the first event and aborts its
    own request; the stream ends with finish_reason "abort"."""

    def on_event(e):
        if set(e) == {"uid"}:
            assert _post(server, {"uid": e["uid"]}, path="/v1/abort") == {"uid": e["uid"], "aborted": True}

    ev = _events(server, {"prompt": [2, 2, 2], "max_tokens": 40}, on_event)
    done = ev[-1]["done"]
    assert done["finish_reason"] == "abort" and len(done["tokens"]) < 40
    assert _post(server, {"uid": done["uid"]}, path="/v1/abort")["aborted"] is False
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, {"uid": "x"}, path="/v1/abort")
    assert ei.value.code == 400


def test_bad_requests(server):
    for body in ({"prompt": "not token ids"}, {"prompt": []}, {"prompt": list(range(100))}, [1, 2]):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server, body)
        assert ei.value.code == 400, body
    for path in ("/v1/nope", "/v1/stats/x"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(f"http://{server.host}:{server.port}{path}", data=b"{}"),
                                   timeout=60)
        assert ei.value.code == 404


@pytest.mark.parametrize("argv", [["--temperature", "0.7"], ["--top-p", "0.9"], ["--top-k", "5"],
                                  ["--spec-tokens", "2"], ["--prefix-cache"], ["--prefix-store", "2"],
                                  ["--logprobs"], ["--multihost"], ["--coordinator", "h:1"], ["--tp", "2"],
                                  ["--kv-dtype", "float8_e4m3fn"], ["--lora", "d"], ["--lora-merge"],
                                  ["--warmup-prompt-len", "64"]], ids=lambda a: a[0])
def test_cli_refuses_unported_flags(capsys, argv):
    with pytest.raises(SystemExit) as ei:
        cli.main(["--device", "cpu", *argv])
    assert ei.value.code == 2 and "not yet ported" in capsys.readouterr().err


def test_cli_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--port", "0"])


def test_cli_serves_and_stops_on_sigint():
    """python -m torch_bnb_fp4_tpu_torch.serve --device cpu --port 0: the
    serving line, one completion over HTTP with the prefill shadow attached,
    then SIGINT and exit code 0."""
    proc = subprocess.Popen([sys.executable, "-m", "torch_bnb_fp4_tpu_torch.serve", "--device", "cpu", "--port", "0",
                             "--max-len", "512", "--prefill-shadow"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), (line, proc.stderr.read() if proc.poll() else "")
        url = line.split()[-1]
        req = urllib.request.Request(url + "/v1/completions",
                                     data=json.dumps({"prompt": [i % 250 + 1 for i in range(260)],
                                                      "max_tokens": 3}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())
        assert len(got["tokens"]) == 3 and got["finish_reason"] == "length" and got["prompt_len"] == 260
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-2000:]
        assert "shutting down" in out and "attached int8 prefill shadows" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
