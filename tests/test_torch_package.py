"""Static and device-selection checks of the PyTorch port.

* No file of the port (nor chip_smoke.py or benchmarks_torch/) imports jax,
  ml_dtypes or the JAX package: the port must run on a machine that has none
  of them.
* Entry points default to CUDA and raise on a host without it, unless the
  caller asks for the CPU.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.utils import synth

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "torch_bnb_fp4_tpu_torch").rglob("*.py")) + sorted((ROOT / "benchmarks_torch").glob("*.py"))
              + [ROOT / "chip_smoke.py"])
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


def test_cuda_sources_present():
    csrc = ROOT / "torch_bnb_fp4_tpu_torch" / "csrc"
    from torch_bnb_fp4_tpu_torch.ops import _build

    for src in _build.SOURCES:
        text = (csrc / src).read_text()
        assert 'extern "C"' in text and _build.SIGNATURES[src][0] in text
        # the pair-K kernels share the K1 decode routine; K7 has no weights,
        # K5 reads the int8 shadow and K9a/K9b decode split-K nibbles through
        # a 16-entry table, taking only the dtype helpers
        assert ('#include "pairk_decode.cuh"' in text) == (src != "flash_attention.cu")
        assert ("pk::decode_pairs<" in text) == (src not in ("flash_attention.cu", "matmul_w8.cu", "dequant_splitk.cu",
                                                             "matmul_splitk.cu")), src


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
