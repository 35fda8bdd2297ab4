"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, for ``sm_90a``.
Libraries go to ``build/torch_bnb_fp4_tpu_torch/<hash>/`` at the repository
root when the package sits in a checkout, else (an installed copy) to
``torch_bnb_fp4_tpu_torch/<hash>/`` under the user's cache directory
(``$XDG_CACHE_HOME`` or ``~/.cache``).  The hash covers every source and the
flags, so the first call builds everything and later calls reuse it.  A
failed build raises with nvcc's stderr.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("decode_pairs.cu", "matmul_pk.cu", "matmul_pk_minner.cu", "matmul_pk_w4a8.cu", "flash_attention.cu",
           "matmul_w8.cu", "dequant_pk.cu", "dequant_splitk.cu", "matmul_splitk.cu", "decode_attention.cu")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C entry point of each source: (function name, argtypes)
SIGNATURES = {
    "decode_pairs.cu": ("pk_decode_pairs", [_P, _P, _I64, _I, _P, _P]),
    # K2-K4 end in (expert index pointer or None, n_experts, stream): the K8 forms
    "matmul_pk.cu": ("pk_matmul_pk", [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                                      _P]),
    "matmul_pk_minner.cu": ("pk_matmul_pk_minner", [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                                    _P, _I, _P]),
    "matmul_pk_w4a8.cu": ("pk_matmul_pk_w4a8", [_P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                                                _P]),
    "flash_attention.cu": ("pk_flash_attention", [_P] * 9 + [_I] * 8 + [_I64] * 9 + [_F, _F, _I, _I, _I, _I, _P]),
    "matmul_w8.cu": ("pk_matmul_w8", [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P]),
    "dequant_pk.cu": ("pk_dequant_pk", [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P]),
    "dequant_splitk.cu": ("pk_dequant_splitk", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "matmul_splitk.cu": ("pk_matmul_splitk", [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                              _I, _P]),
    "decode_attention.cu": ("pk_decode_attention", [_P] * 9 + [_I] * 8 + [_I64] * 8 + [_F, _F, _I, _I, _I, _I, _P]),
}
# other C functions a source exports: name -> (source, argtypes)
QUERIES = {"pk_matmul_pk_w4a8_regs": ("matmul_pk_w4a8.cu", [_I]), "pk_matmul_pk_smem": ("matmul_pk.cu", [_I]),
           "pk_matmul_pk_minner_smem": ("matmul_pk_minner.cu", []), "pk_matmul_w8_regs": ("matmul_w8.cu", []),
           "pk_matmul_splitk_smem": ("matmul_splitk.cu", [_I, _I])}

_lock = threading.Lock()
_funcs: dict[str, ctypes._CFuncPtr] = {}
build_log: dict[str, str] = {}  # source -> nvcc stderr (ptxas register/spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (PATH or /usr/local/cuda)")


def _build_root() -> Path:
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").exists():
        return checkout / "build" / "torch_bnb_fp4_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "torch_bnb_fp4_tpu_torch"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet, all in parallel; return
    the build directory.  Raises RuntimeError with nvcc's stderr on failure."""
    out_dir = _build_root() / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [s for s in SOURCES if not (out_dir / (Path(s).stem + ".so")).exists()]
    if not todo:
        return out_dir
    nvcc = _nvcc()
    procs = {}
    for src in todo:
        tmp = out_dir / f"{Path(src).stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(_CSRC / src)]
        procs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for src, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        build_log[src] = err
        if proc.returncode != 0:
            failed.append(f"--- nvcc {src} (exit {proc.returncode}) ---\n{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / (Path(src).stem + ".so"))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out_dir


def _load(src: str, name: str, argtypes) -> ctypes._CFuncPtr:
    with _lock:
        if name not in _funcs:
            out_dir = build_all()
            fn = getattr(ctypes.CDLL(str(out_dir / (Path(src).stem + ".so"))), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _funcs[name] = fn
        return _funcs[name]


def kernel(src: str) -> ctypes._CFuncPtr:
    """The C entry point of ``csrc/<src>``, building on first use."""
    name, argtypes = SIGNATURES[src]
    return _load(src, name, argtypes)


def query(name: str) -> ctypes._CFuncPtr:
    """One of the ``QUERIES`` functions, building on first use."""
    src, argtypes = QUERIES[name]
    return _load(src, name, argtypes)
