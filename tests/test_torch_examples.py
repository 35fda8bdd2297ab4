"""The six scripts of examples_torch/ run on the CPU (``--device cpu``, the
plain versions) at the tiny_test size, each in a subprocess, with their
printed results checked: the sanity check's error band, the speed test's
two engines, the perplexity of a converted tiny checkpoint beside its bf16
twin, the serving demo, the HTTP client against the CLI server (with an
adapter, streaming, stats and a 400 for an unknown adapter) and the compat
workflow.  Timing lines are printed by the scripts but not judged: a CPU
run's time is no device measurement.
"""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from torch_bnb_fp4_tpu_torch.convert import convert_hf_model
from torch_bnb_fp4_tpu_torch.convert.safetensors_io import save_file
from torch_bnb_fp4_tpu_torch.models import lora as LoRA
from torch_bnb_fp4_tpu_torch.models import transformer as T

from test_torch_lora import ALL, adapter_weights, write_peft_dir

ROOT = Path(__file__).resolve().parent.parent
EX = ROOT / "examples_torch"


# each script and server runs on one CPU thread: tiny shapes gain nothing from more, and several test
# workers share the cores
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _run(script, *args, timeout=300):
    out = subprocess.run([sys.executable, str(EX / script), *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout, env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_sanity_check_in_band():
    out = _run("sanity_check.py", "--device", "cpu")
    assert out.count("OK (in reference band 0.045-0.065)") == 3 and out.rstrip().endswith("PASSED")
    errs = [float(x) for x in re.findall(r"mean \|err\| = ([\d.]+)", out)]
    assert len(errs) == 3 and all(0.045 <= e <= 0.065 for e in errs)
    assert "speed: not measured" in out


def test_speed_test_runs_both_engines():
    out = _run("speed_test_mistral_7b.py", "--device", "cpu", "--model", "tiny_test", "--max-new-tokens", "8",
               "--prompt-len", "8")
    rates = re.findall(r"decode (\d+) tokens at [\d.]+ ms/token p50 -> ([\d.]+) tok/s", out)
    assert [int(n) for n, _ in rates] == [8, 8] and all(float(r) > 0 for _, r in rates)
    assert re.search(r"speedup: [\d.]+x", out) and "cpu (host times)" in out


def test_perplexity_fp4_tracks_bf16_twin(tmp_path):
    """A tiny HF directory (the port's writer), converted by the port, scored
    on seeded random tokens: the FP4 NLL within 0.05 of the bf16 twin's
    (tests/test_perplexity.py's bound) and near log(vocab)."""
    cfg = T.ModelConfig.tiny_test(n_layers=1, dim=512, ffn_dim=1024, n_heads=4, n_kv_heads=2)
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps(dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads, intermediate_size=cfg.ffn_dim,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps)))
    save_file({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in T.random_weights(cfg, seed=24).items()},
              str(hf / "model.safetensors"))
    convert_hf_model(str(hf), str(tmp_path / "out"), verbose=False)
    out = _run("perplexity.py", "--ckpt", str(tmp_path / "out"), "--hf-dir", str(hf), "--seq-len", "32",
               "--max-tokens", "128", "--device", "cpu")
    nll_q = float(re.search(r"fp4:  nll ([\d.]+)", out).group(1))
    nll_b = float(re.search(r"bf16: nll ([\d.]+)", out).group(1))
    assert "(124 tokens)" in out and abs(nll_q - nll_b) < 0.05, out
    assert 0.5 * np.log(cfg.vocab_size) < nll_q < 1.5 * np.log(cfg.vocab_size)


def test_serve_demo():
    out = _run("serve_demo.py", "--device", "cpu", "--requests", "4", "--max-new-tokens", "6")
    assert "FP4 engine : 4 completions, 24 tokens" in out and "bf16 engine: 4 completions, 24 tokens" in out
    assert "token-identical completions fp4 vs bf16:" in out


def test_serve_client_against_the_cli_server(tmp_path):
    """The CLI serves the tiny random model with an adapter (--lora a=DIR);
    the client's completion under ``--adapter a`` equals the single-attach
    generate, streaming gives the same tokens, --stats answers, an unknown
    adapter exits 1 with the server's 400, and SIGINT stops the server
    with 0."""
    cfg = T.ModelConfig.tiny_test(n_layers=2)
    w = adapter_weights(cfg, 41, 4, ALL[:3])
    d = write_peft_dir(tmp_path / "a", w, 4, 8.0)
    cmd = [sys.executable, "-m", "torch_bnb_fp4_tpu_torch.serve", "--device", "cpu", "--port", "0", "--max-len",
           "64", "--lora", f"a={d}"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=ENV)
    try:
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
        line = lines.get(timeout=240)
        assert line.startswith("serving on http://"), line
        port = line.strip().rsplit(":", 1)[1]
        client = ("serve_client.py", "--port", port)
        got = json.loads(_run(*client, "--prompt", "3,1,4,1,5", "--max-tokens", "5", "--adapter", "a"))
        base = T.quantize_params(cfg, T.random_weights(cfg, seed=0), device="cpu")
        params = LoRA.attach_lora(base, cfg, LoRA.PEFTAdapter(r=4, alpha=8.0, weights=w))
        want = T.generate(params, cfg, torch.tensor([[3, 1, 4, 1, 5]]), 5)[0].tolist()
        assert got["tokens"] == want and got["finish_reason"] == "length"
        streamed = _run(*client, "--prompt", "3,1,4,1,5", "--max-tokens", "5", "--adapter", "a", "--stream")
        assert [int(t) for t in streamed.split("\n")[0].split()] == want
        assert json.loads(_run(*client, "--stats"))["completions"] == 2
        bad = subprocess.run([sys.executable, str(EX / "serve_client.py"), "--port", port, "--prompt", "1",
                              "--adapter", "zz"], cwd=ROOT, capture_output=True, text=True, timeout=120, env=ENV)
        assert bad.returncode == 1 and "error 400: unknown adapter 'zz'" in bad.stderr
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_compat_migration():
    out = _run("compat_migration.py", "--device", "cpu")
    assert out.count("OK") == 3 and out.rstrip().endswith("PASS")
    assert "packed bytes: 65536" in out  # pair-K pads K = 256 to 512: (512 / 2) x 256 bytes
