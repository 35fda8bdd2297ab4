"""Reference-API compatibility layer: the public surface of
aredden/torch-bnb-fp4 (``torch_bnb_fp4/__init__.py``), name for name, on the
port (the JAX package's ``compat.py``).

    reference (CUDA, bitsandbytes)             here (H100, the port's kernels)
    ------------------------------------------ -----------------------------------------
    from torch_bnb_fp4 import X                from torch_bnb_fp4_tpu_torch.compat import X

Seven functional wrappers, ``QuantData``, ``TorchFP4Linear`` and the model
conversion entry point, with the reference's names, argument orders and
dispatch.  ``TorchFP4Linear`` and ``QuantData`` are ``torch.nn.Module``s whose
``forward`` runs :func:`models.linear.apply_linear` (the pair-K kernels K2-K4
on the card, K6 for ``dequantize``).  Arrays may be torch tensors or numpy
arrays; results are torch tensors, on the layer's device for the modules and
on the input's device (numpy: ``device``, default CUDA) for the functions.
Deliberate differences from the reference, as in the JAX package:

- ``dequantize_fp4_codebook_*`` and ``gemm_4bit_inference*`` HONOR the
  ``code`` argument (the reference ignores it), so NF4 states work;
- float16 activations compute in bfloat16 and the output is cast back to
  float16;
- ``allow_reduced_precision_linear`` is accepted and inert;
- ``ScalarType.torch_dtype`` works (the reference's is dead code);
- ``recursively_replace_with_fp4_linear`` converts FUNCTIONALLY and returns
  ``(cfg, params)`` for ``models.transformer.generate`` or the serving
  engine; it does not rewrite the module tree.

The one-shot functions decode bnb's flat packing on each call
(``ops.kernels.dequantize_fp4_flat``, plain torch, then a ``torch.matmul``);
hot loops should build a ``QuantData`` / ``TorchFP4Linear`` once, which packs
into the pair-K kernel layout at construction.
"""

from __future__ import annotations

import enum
from typing import Tuple

import numpy as np
import torch

from .convert.bnb import dequantize_nested_absmax, from_bnb_state
from .convert.hf import _np as _to_np
from .models.linear import QuantLinear, apply_linear, dequantize_weight, quantize_linear
from .ops.kernels import dequantize_fp4_flat
from .utils.device import resolve_device

__all__ = [
    "ScalarType",
    "dequantize_fp4",
    "dequantize_fp4_qtype",
    "dequantize_fp4_codebook_invoke",
    "dequantize_fp4_codebook_invoke_qtype",
    "gemm_4bit_inference",
    "gemm_4bit_inference_qtype",
    "QuantData",
    "TorchFP4Linear",
    "recursively_replace_with_fp4_linear",
    "check_if_name_contained_in_list",
]


def _device_of(a, device) -> torch.device:
    """``a``'s device when it is a tensor, else ``device`` (default CUDA)."""
    return a.device if isinstance(a, torch.Tensor) else resolve_device(device)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


class ScalarType(enum.Enum):
    """Activation dtype enum (reference torch_bnb_fp4/__init__.py:22-84)."""

    bfloat16 = "bfloat16"
    float16 = "float16"
    float32 = "float32"

    @classmethod
    def from_torch_dtype(cls, dtype) -> "ScalarType":
        """Accepts a torch dtype, a numpy dtype or a string."""
        name = str(dtype).replace("torch.", "")
        name = {"half": "float16", "float": "float32"}.get(name, name)
        if name not in cls._value2member_map_:
            try:
                name = np.dtype(dtype).name
            except TypeError:
                pass
        if name not in cls._value2member_map_:
            raise ValueError(f"Unsupported dtype {dtype!r}")
        return cls(name)

    @classmethod
    def from_str(cls, dtype: str) -> "ScalarType":
        aliases = {"bf16": "bfloat16", "fp16": "float16", "half": "float16", "fp32": "float32", "float": "float32"}
        name = aliases.get(dtype, dtype)
        if name not in cls._value2member_map_:
            raise ValueError(f"Unsupported dtype string {dtype!r}")
        return cls(name)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}[self.value]


def _resolve_dtype(dtype) -> ScalarType:
    if isinstance(dtype, ScalarType):
        return dtype
    if isinstance(dtype, str):
        return ScalarType.from_str(dtype)
    return ScalarType.from_torch_dtype(dtype)


# --------------------------------------------------------------------------
# functional wrappers (reference __init__.py:88-337)
# --------------------------------------------------------------------------

def dequantize_fp4(qweight, absmax, blocksize: int, M: int, N: int, dtype="float16", device=None):
    """Blockwise FP4 dequantize (reference ``dequantize_fp4``): ``qweight``
    uint8 bytes in bnb's flat packing (two codes per byte, high nibble
    first), ``absmax`` one scale per ``blocksize`` weights -> the (M, N)
    weight in ``dtype``."""
    dev = _device_of(qweight, device)
    return dequantize_fp4_flat(_tensor(qweight, dev), _tensor(absmax, dev, torch.float32), (M, N),
                               blocksize=blocksize, out_dtype=_resolve_dtype(dtype).torch_dtype)


def dequantize_fp4_qtype(qweight, absmax, blocksize: int, M: int, N: int, dtype: ScalarType = ScalarType.bfloat16,
                         device=None):
    """Reference ``dequantize_fp4_qtype``."""
    return dequantize_fp4(qweight, absmax, blocksize, M, N, dtype, device=device)


def dequantize_fp4_codebook_invoke(qweight, absmax, code, blocksize: int, M: int, N: int, numel: int, qtype,
                                   device=None):
    """Reference ``dequantize_fp4_codebook_invoke``, with the passed codebook
    used (NF4 states dequantize correctly)."""
    if numel != M * N:
        raise ValueError(f"numel={numel} does not match M*N={M * N}")
    dev = _device_of(qweight, device)
    return dequantize_fp4_flat(_tensor(qweight, dev), _tensor(absmax, dev, torch.float32), (M, N),
                               blocksize=blocksize, out_dtype=_resolve_dtype(qtype).torch_dtype,
                               codebook=_tensor(code, dev, torch.float32))


def dequantize_fp4_codebook_invoke_qtype(qweight, absmax, code, blocksize: int, M: int, N: int, numel: int,
                                         qtype: ScalarType, device=None):
    """Reference ``dequantize_fp4_codebook_invoke_qtype``."""
    return dequantize_fp4_codebook_invoke(qweight, absmax, code, blocksize, M, N, numel, qtype, device=device)


def _gemm_4bit(A, B, absmax, code, blocksize, st: ScalarType, Bshape, device):
    if Bshape is None:
        raise ValueError("Bshape (out_features, in_features) is required")
    out_f, in_f = int(Bshape[0]), int(Bshape[1])
    dev = _device_of(A, device)
    a = _tensor(A, dev)
    if a.shape[-1] != in_f:
        raise ValueError(f"A feature dim {a.shape[-1]} != Bshape[1]={in_f}")
    w = dequantize_fp4_flat(_tensor(B, dev), _tensor(absmax, dev, torch.float32), (out_f, in_f), blocksize=blocksize,
                            out_dtype=torch.float32, codebook=None if code is None else _tensor(code, dev, torch.float32))
    compute = torch.float32 if st is ScalarType.float32 else torch.bfloat16
    y = torch.matmul(a.reshape(-1, in_f).to(compute), w.T.to(compute))
    return y.reshape(*a.shape[:-1], out_f).to(st.torch_dtype)


def gemm_4bit_inference(A, B, absmax, code, blocksize: int, dtype="float16", Bshape=None, device=None):
    """Dequantize-then-matmul of activations ``A`` (..., in_features) with
    the flat-packed weight ``B`` of ``Bshape`` (out_features, in_features)
    (reference ``gemm_4bit_inference``; any shape of ``B``, only its bytes
    matter)."""
    return _gemm_4bit(A, B, absmax, code, blocksize, _resolve_dtype(dtype), Bshape, device)


def gemm_4bit_inference_qtype(A, B, absmax, code, blocksize: int, dtype: ScalarType = ScalarType.bfloat16,
                              Bshape=None, device=None):
    """Reference ``gemm_4bit_inference_qtype``."""
    return _gemm_4bit(A, B, absmax, code, blocksize, _resolve_dtype(dtype), Bshape, device)


# --------------------------------------------------------------------------
# QuantData / TorchFP4Linear (reference __init__.py:340-714)
# --------------------------------------------------------------------------

def _state_absmax(state) -> np.ndarray:
    """f32 per-block absmax of a bnb QuantState (duck-typed), a double
    quantization (``state.state2``) decoded."""
    state2 = getattr(state, "state2", None)
    if state2 is not None:
        return dequantize_nested_absmax(_to_np(state.absmax), _to_np(state2.absmax), _to_np(state2.code),
                                        float(state.offset), nested_blocksize=int(state2.blocksize))
    return np.asarray(_to_np(state.absmax), np.float32)


@torch.no_grad()
def _apply(q: QuantLinear, x) -> torch.Tensor:
    """``apply_linear`` on the layer's device; f16 x computes in bf16 and
    returns f16."""
    x = _tensor(x, q.packed.device)
    if x.dtype == torch.float16:
        return apply_linear(q, x.to(torch.bfloat16)).to(torch.float16)
    return apply_linear(q, x)


class QuantData(torch.nn.Module):
    """Quantized weight with the reference's forward dispatch (reference
    ``QuantData``).  Packs ONCE at construction into the pair-K kernel
    layout (codes and absmax preserved exactly, on ``device``, default
    CUDA); ``forward`` chooses the kernel by row count in ``apply_linear``
    and takes any activation dtype per call.

    ``state`` is a bnb ``QuantState`` or any object with ``absmax``,
    ``blocksize``, ``code``, ``shape`` (and optionally ``quant_type``,
    ``state2``/``offset`` for double quantization).  ``original_lin`` stays
    reachable as ``.original_lin`` without becoming a submodule."""

    def __init__(self, A, state, shape: Tuple[int, int], original_lin=None, bias=None,
                 use_codebook_dequant: bool = True, allow_reduced_precision_linear: bool = False, device=None):
        super().__init__()
        del use_codebook_dequant  # one decoder: the codebook is data
        del allow_reduced_precision_linear  # inert: the fused GEMM has no such trade-off
        self.M, self.N = int(shape[0]), int(shape[1])
        self.blocksize = int(state.blocksize)
        self.numel = self.M * self.N
        if bias is None and original_lin is not None:
            bias = getattr(original_lin, "bias", None)
        self._original = [original_lin]
        self._q = from_bnb_state(_to_np(A).reshape(-1), _state_absmax(state), (self.M, self.N),
                                 blocksize=self.blocksize, quant_type=getattr(state, "quant_type", "fp4"),
                                 bias=None if bias is None else _to_np(bias), device=device)

    @property
    def original_lin(self):
        return self._original[0]

    @property
    def quant_linear(self) -> QuantLinear:
        return self._q

    @property
    def device(self) -> torch.device:
        return self._q.packed.device

    def dequantize(self, dtype="bfloat16") -> torch.Tensor:
        """The (M, N) weight (K6 on the card)."""
        return dequantize_weight(self._q, out_dtype=_resolve_dtype(dtype).torch_dtype)

    def forward(self, A) -> torch.Tensor:
        """A (..., N) -> (..., M); zero rows give an empty result."""
        return _apply(self._q, A)


class TorchFP4Linear(torch.nn.Module):
    """Drop-in quantized linear (reference ``TorchFP4Linear``) wrapping a
    live torch layer on ``device`` (default CUDA): a bnb ``Linear4bit`` /
    ``LinearFP4`` imports exactly (codes and absmax kept, double
    quantization decoded); a plain ``torch.nn.Linear`` (or anything with
    ``.weight`` and ``.bias``) is quantized fresh with the exact FP4
    codebook.  The original layer stays reachable as ``.lin[0]``, not as a
    submodule."""

    def __init__(self, lin, use_codebook_dequant: bool = True, name: str = "", device=None):
        super().__init__()
        self.lin = [lin]
        self.name = name
        self.use_codebook_dequant = use_codebook_dequant
        w = getattr(lin, "weight", None)
        if w is None:
            raise ValueError("layer has no .weight to quantize")
        if getattr(w, "quant_state", None) is not None:  # bnb-quantized
            from .convert.bnb import from_bnb_torch_layer

            self._q = from_bnb_torch_layer(lin, device=device)
        else:
            bias = getattr(lin, "bias", None)
            self._q = quantize_linear(np.asarray(_to_np(w), np.float32),
                                      None if bias is None else np.asarray(_to_np(bias), np.float32),
                                      variant="exact", device=device)  # bit-exact bnb FP4 codes
        self.out_features, self.in_features = self._q.n_out, self._q.k_in
        self.quant_data = QuantDataView(self._q)

    @classmethod
    def from_linear(cls, linear, use_codebook_dequant: bool = False, name: str = "", device=None) -> "TorchFP4Linear":
        """Reference ``TorchFP4Linear.from_linear``."""
        return cls(linear, use_codebook_dequant=use_codebook_dequant, name=name, device=device)

    @property
    def quant_linear(self) -> QuantLinear:
        return self._q

    @property
    def device(self) -> torch.device:
        return self._q.packed.device

    def forward(self, x) -> torch.Tensor:
        return _apply(self._q, x)

    def __repr__(self) -> str:
        return (f"TorchFP4Linear(in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self._q.bias is not None})")


class QuantDataView:
    """The ``.quant_data`` attribute surface (M, N, blocksize, numel,
    forward) that code reaching into ``TorchFP4Linear.quant_data`` uses."""

    def __init__(self, q: QuantLinear):
        self._q = q
        self.M, self.N = q.n_out, q.k_in
        self.blocksize = q.blocksize
        self.numel = q.n_out * q.k_in

    def forward(self, A) -> torch.Tensor:
        return _apply(self._q, A)

    __call__ = forward


# --------------------------------------------------------------------------
# model conversion (reference __init__.py:717-922)
# --------------------------------------------------------------------------

def check_if_name_contained_in_list(name: str, names_list) -> bool:
    """Reference ignore-list predicate: any entry is a substring of ``name``."""
    return any(s in name for s in names_list)


def recursively_replace_with_fp4_linear(model, as_dtype=None, use_codebook_dequant: bool = True,
                                        ignore_layer_names=(), only_replace_bnb_layers: bool = False,
                                        quantize_lm_head: bool = False, debug: bool = False, device=None):
    """Convert a LIVE HF transformers causal LM (anything with ``.config``
    (``to_dict()``) and ``.state_dict()``) into ``(cfg, params)`` on
    ``device`` (default CUDA) for ``models.transformer.generate`` or the
    serving engine, with the streaming converter's rules
    (``convert.hf.quantize_hf_weights``): plain linears quantized fresh, bnb
    4-bit layers imported exactly.  The module tree is left as it is.

    ``ignore_layer_names``: substrings of layer names kept unquantized;
    ``only_replace_bnb_layers`` refuses a model whose non-ignored linears
    are not all bnb-quantized; ``as_dtype``, ``use_codebook_dequant`` and
    ``debug`` are accepted for the reference's signature.  For disk to disk
    conversion use ``python -m torch_bnb_fp4_tpu_torch.convert``."""
    del as_dtype, use_codebook_dequant, debug
    from .convert.hf import _BNB_META, config_from_hf_dict, quantize_hf_weights

    if not hasattr(model, "config") or not hasattr(model, "state_dict"):
        raise ValueError("expected a HuggingFace transformers model (needs .config and .state_dict()); for a single "
                         "layer use TorchFP4Linear.from_linear")
    hf = model.config.to_dict()
    tensors = dict(model.state_dict())
    if only_replace_bnb_layers:
        missing = sorted(
            k[: -len(".weight")] for k in tensors
            if k.endswith("_proj.weight") and not check_if_name_contained_in_list(k, ignore_layer_names)
            and not any(f"{k[:-len('.weight')]}{_BNB_META}{qt}" in tensors for qt in ("fp4", "nf4"))
        )
        if missing:
            raise ValueError(f"only_replace_bnb_layers=True but these linears are not bnb-quantized: "
                             f"{missing[:4]}{'...' if len(missing) > 4 else ''}")
    cfg = config_from_hf_dict(hf)
    params = quantize_hf_weights(cfg, tensors, quantize_lm_head=quantize_lm_head, ignore=tuple(ignore_layer_names),
                                 device=device)
    return cfg, params


# the name says what happens: a functional conversion
convert_torch_model = recursively_replace_with_fp4_linear
