"""Static and device-selection checks of the PyTorch port.

* No file of the port (nor chip_smoke.py, benchmarks_torch/ or
  examples_torch/) imports jax, ml_dtypes or the JAX package: the port must
  run on a machine that has none of them.  Nor does one import safetensors or transformers at module level
  (the card's machine has neither; the server's --tokenizer imports
  transformers when asked).
* Entry points default to CUDA and raise on a host without it, unless the
  caller asks for the CPU.
* The package surface: each ``__all__`` of the port equals the JAX
  package's, less the names written in ``NOT_YET_PORTED``, and importing
  the whole port in a fresh interpreter loads neither jax nor the JAX
  package.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.utils import synth

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "torch_bnb_fp4_tpu_torch").rglob("*.py")) + sorted((ROOT / "benchmarks_torch").glob("*.py"))
              + sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "torch_bnb_fp4_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path.name} imports {mod}"


def _module_level_imports(path: Path):
    """Modules imported by statements outside any function or class body."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(nodes):
        for node in nodes:
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                yield node.module
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                yield from walk(ast.iter_child_nodes(node))

    yield from walk(tree.body)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_safetensors_or_transformers_at_module_level(path):
    for mod in _module_level_imports(path):
        assert mod.split(".")[0] not in ("safetensors", "transformers"), f"{path.name} imports {mod}"


def test_cuda_sources_present():
    csrc = ROOT / "torch_bnb_fp4_tpu_torch" / "csrc"
    from torch_bnb_fp4_tpu_torch.ops import _build

    for src in _build.SOURCES:
        text = (csrc / src).read_text()
        assert 'extern "C"' in text and _build.SIGNATURES[src][0] in text
        # the pair-K kernels share the K1 decode routine; K7 and K10 have no
        # weights, K5 reads the int8 shadow and K9a/K9b decode split-K nibbles
        # through a 16-entry table, taking only the dtype helpers
        assert ('#include "pairk_decode.cuh"' in text) == (src not in ("flash_attention.cu", "decode_attention.cu"))
        assert ("pk::decode_pairs<" in text) == (src not in ("flash_attention.cu", "decode_attention.cu", "matmul_w8.cu",
                                                             "dequant_splitk.cu", "matmul_splitk.cu")), src


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.ModelConfig.tiny_test(n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synth.synth_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.KVCache.zeros(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        L.quantize_linear(np.zeros((128, 512), np.float32))
    # an explicit CPU request runs the plain versions
    p = synth.synth_params(cfg, device="cpu", fuse=True)
    assert p.layers[0].wqkv.packed.device.type == "cpu"


def test_slice_entry_points_default_to_cuda(monkeypatch):
    """The converter's in-memory path, the quantized table, the bf16 twin,
    the oracle and the reference API go to the card unless asked for the
    CPU."""
    from torch_bnb_fp4_tpu_torch import compat as C
    from torch_bnb_fp4_tpu_torch.convert import hf as H
    from torch_bnb_fp4_tpu_torch.ops import format as fmt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.ModelConfig.tiny_test(n_layers=1)
    weights = T.random_weights(cfg, seed=1)
    packed, absmax = fmt.quantize_fp4(np.ones((128, 128), np.float32))

    class State:
        blocksize, quant_type, shape, code = 64, "fp4", (128, 128), fmt.FP4_CODE

    State.absmax = absmax
    calls = {
        "quantize_embedding": lambda: T.quantize_embedding(np.zeros((4, 64), np.float32)),
        "dense_params": lambda: T.dense_params(cfg, weights),
        "reference_forward": lambda: T.reference_forward(cfg, weights, np.zeros((1, 2), np.int32)),
        "quantize_hf_weights": lambda: H.quantize_hf_weights(cfg, dict(weights)),
        "TorchFP4Linear": lambda: C.TorchFP4Linear.from_linear(torch.nn.Linear(128, 128)),
        "QuantData": lambda: C.QuantData(packed, State(), (128, 128)),
        "dequantize_fp4": lambda: C.dequantize_fp4(packed, absmax, 64, 128, 128),
        "gemm_4bit_inference": lambda: C.gemm_4bit_inference(np.ones((1, 128), np.float32), packed, absmax, None,
                                                             64, Bshape=(128, 128)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # a torch tensor's own device decides for the functional wrappers
    assert C.dequantize_fp4(torch.from_numpy(packed), torch.from_numpy(absmax), 64, 128, 128).device.type == "cpu"
    assert T.quantize_embedding(np.zeros((4, 64), np.float32), device="cpu").device.type == "cpu"


# names of the JAX package's __all__s the port has not ported yet: none (tensor
# parallelism and multi-host serving were the last)
NOT_YET_PORTED: set = set()
SURFACES = ("", ".models", ".ops", ".utils", ".serve", ".convert", ".compat", ".parallel")


@pytest.mark.parametrize("sub", SURFACES, ids=lambda s: s or "top")
def test_all_equals_jax_less_not_yet_ported(sub):
    jax_mod = importlib.import_module("torch_bnb_fp4_tpu" + sub)
    port = importlib.import_module("torch_bnb_fp4_tpu_torch" + sub)
    assert set(port.__all__) == set(jax_mod.__all__) - NOT_YET_PORTED
    assert len(port.__all__) == len(set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_not_yet_ported_names_are_jax_names():
    """Every name the list excuses is in some JAX __all__ (the list holds no
    stale entry) and in no port __all__."""
    jax_names = set().union(*(importlib.import_module("torch_bnb_fp4_tpu" + s).__all__ for s in SURFACES))
    port_names = set().union(*(importlib.import_module("torch_bnb_fp4_tpu_torch" + s).__all__ for s in SURFACES))
    assert NOT_YET_PORTED <= jax_names and not NOT_YET_PORTED & port_names


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib\n"
            f"for s in {SURFACES!r} + ('.models.lora', '.serve.__main__', '.convert.hf', '.utils.synth'):\n"
            "    importlib.import_module('torch_bnb_fp4_tpu_torch' + s)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'torch_bnb_fp4_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    import torch_bnb_fp4_tpu_torch as P

    assert P.__version__ == "0.1.0"


def test_profiling_surface(tmp_path, monkeypatch):
    """The JAX utils names with their CUDA meanings: the roofline on the
    H100's peaks (bytes: packed K*N/2 + f32 scales + bf16 x and out;
    2*M*K*N operations), the card's name or the default, a round trip on the
    device asked for, and a torch.profiler trace written to log_dir."""
    from torch_bnb_fp4_tpu_torch.utils import calibrate_rtt, detect_chip, fp4_matmul_roofline, trace
    from torch_bnb_fp4_tpu_torch.utils import profiling as P

    m, k, n = 8, 4096, 14336
    r = fp4_matmul_roofline(m, k, n, achieved_s=1e-4)
    t_mem = (k * n / 2 + (k // 64) * n * 4 + m * k * 2 + m * n * 2) / P.H100_HBM_BYTES_PER_S
    assert r["bound"] == "memory" and r["t_mem_us"] == pytest.approx(t_mem * 1e6)
    assert r["t_mxu_us"] == pytest.approx(2 * m * k * n / P.H100_BF16_FLOPS * 1e6)
    assert r["fraction_of_roofline"] == pytest.approx(t_mem / 1e-4)
    big = fp4_matmul_roofline(8192, k, n, int8=True)
    assert big["bound"] == "compute" and big["t_mxu_us"] == pytest.approx(2 * 8192 * k * n / P.H100_INT8_OPS * 1e6)
    with pytest.raises(ValueError, match="H100"):
        fp4_matmul_roofline(m, k, n, chip="v5e")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert detect_chip() == "H100" and detect_chip("none") == "none"
    assert calibrate_rtt("cpu") > 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibrate_rtt()
    with trace(str(tmp_path / "tr")) as d:
        torch.ones(4).sum()
    assert d == str(tmp_path / "tr") and (tmp_path / "tr" / "trace.json").stat().st_size > 0
