"""ctypes loader for the native pair-K packer (``csrc/host/qpack.c``).

Counterpart of ``torch_bnb_fp4_tpu/convert/native.py``: the converter's
quantize+pack loop in C, bit-identical to the numpy golden
(``ops/format.pack_tpu_pairk[_lut]``) and to the torch path of
``convert/quantize.py``.  It is a host quantizer, not a device kernel.  It is
compiled at first use with the system C compiler (``$CC``, ``cc``, ``gcc`` or
``clang``) into ``build/torch_bnb_fp4_tpu_torch/host/`` at the repository
root when the package sits in a checkout, else into
``torch_bnb_fp4_tpu_torch/host/`` under the user's cache directory (the CUDA
kernels' rule, ``ops/_build.py``); the library's name carries a hash of the
source and of the host CPU's feature flags (the build is ``-march=native``).
With no compiler (or ``TORCH_BNB_FP4_TPU_NO_NATIVE`` set) ``available()`` is
False and ``convert/quantize.py`` packs with torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import format as fmt

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host" / "qpack.c"
_ABI = 2
_lib = None
_tried = False


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (a -march=native library runs only where they match)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return platform.machine().encode()


def _build_lib() -> str | None:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")
    if cc is None:
        return None
    out_dir = _build._build_root() / "host"
    out = out_dir / f"qpack-{hashlib.sha1(_SRC.read_bytes() + _cpu_flags()).hexdigest()[:12]}.so"
    if out.exists():
        return str(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: concurrent builds race safely
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    r = subprocess.run([cc, "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, str(_SRC)], capture_output=True)
    if r.returncode != 0:
        os.unlink(tmp)
        return None
    os.replace(tmp, out)
    return str(out)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("TORCH_BNB_FP4_TPU_NO_NATIVE"):
        return None
    try:
        so = _build_lib()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.qpack_abi_version.restype = ctypes.c_int64
        if lib.qpack_abi_version() != _ABI:
            return None
        lib.qpack_pairk.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.qpack_pairk.restype = ctypes.c_int
        _lib = lib
    except (OSError, AttributeError):
        _lib = None
    return _lib


def available() -> bool:
    """True when the C packer is built (or was built now) and loads."""
    return _load() is not None


def _mids_map(code: np.ndarray, remap: np.ndarray | None):
    """The golden's midpoint table and sorted-position -> nibble map
    (``ops/format.quantize_codes``; the same numpy arithmetic, so the
    (a+b)/2 f32 roundings match bit for bit)."""
    order = np.argsort(code, kind="stable").astype(np.uint8)
    sorted_code = code[order]
    mids = ((sorted_code[1:] + sorted_code[:-1]) / 2).astype(np.float32)
    map16 = order if remap is None else remap[order]
    return np.ascontiguousarray(mids), np.ascontiguousarray(map16.astype(np.uint8))


def _run(w: np.ndarray, blocksize: int, mids: np.ndarray, map16: np.ndarray, bf16_scale: bool,
         value_scale: float):
    lib = _load()
    if lib is None:
        raise RuntimeError("the native packer is not available (no C compiler, or TORCH_BNB_FP4_TPU_NO_NATIVE set)")
    w = np.ascontiguousarray(w, dtype=np.float32)
    n_out, k_in = w.shape
    if k_in % (2 * blocksize) != 0:
        raise ValueError(f"K={k_in} not divisible by 2*blocksize={2 * blocksize}")
    if blocksize > 4096:
        raise ValueError(f"blocksize {blocksize} > native max 4096")
    packed = np.empty((k_in // 2, n_out), np.uint8)
    scale = np.empty((k_in // blocksize, n_out), np.float32)
    rc = lib.qpack_pairk(w.ctypes.data, n_out, k_in, blocksize, mids.ctypes.data, map16.ctypes.data,
                         1 if bf16_scale else 0, ctypes.c_float(value_scale), packed.ctypes.data, scale.ctypes.data)
    if rc != 0:
        raise MemoryError("native qpack workspace allocation failed")
    return torch.from_numpy(packed), torch.from_numpy(scale)


def quantize_pack_pairk_native(w: np.ndarray, blocksize: int = 64, variant: str = "exact",
                               scale_dtype: torch.dtype = torch.float32):
    """Native ``format.pack_tpu_pairk``: (packed uint8 (K/2, N), scale
    (K/blocksize, N) in ``scale_dtype``), CPU tensors."""
    if scale_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scale_dtype must be torch.float32 or torch.bfloat16, got {scale_dtype}")
    if variant == "exact":
        mids, map16 = _mids_map(fmt.FP4_CODE, fmt.RANK_REMAP)
    elif variant in fmt.PAIRK_VARIANTS:
        mids, map16 = _mids_map(fmt.pairk_code(variant), None)
    else:
        raise ValueError(f"unknown pairk variant {variant!r}; expected one of {fmt.PAIRK_VARIANTS}")
    packed, scale = _run(w, blocksize, mids, map16, scale_dtype == torch.bfloat16, fmt.PAIRK_VALUE_SCALE)
    return packed, scale.to(scale_dtype)  # bf16 scales are bf16 values already: the cast is exact


def quantize_pack_pairk_lut_native(w: np.ndarray, codebook: np.ndarray, blocksize: int = 64):
    """Native ``format.pack_tpu_pairk_lut`` (any strictly increasing
    16-entry codebook, NF4): (packed, scale = absmax f32), CPU tensors."""
    code = np.asarray(codebook, np.float32)
    if code.shape != (16,) or not np.all(np.diff(code) > 0):
        raise ValueError("codebook must be 16 strictly-increasing entries")
    # quantize against the bf16-rounded table (what decode multiplies by)
    mids, map16 = _mids_map(fmt.bf16_round(code), None)
    return _run(w, blocksize, mids, map16, False, 1.0)
