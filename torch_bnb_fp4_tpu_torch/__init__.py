"""PyTorch/CUDA port of torch_bnb_fp4_tpu for NVIDIA Hopper (sm_90a).

FP4 weight-only serving of Llama/Mistral-family decoders and Mixtral's
sparse mixture of experts: pair-K packed linears (ops/format.py),
hand-written CUDA kernels for the pair-K matmuls (and their expert forms),
the int8 prefill shadow and attention (csrc/, bound in ops/), the decoder
(models/), a continuous-batching engine (sampling, speculation, prefix cache,
fp8 KV cache; decode as CUDA graphs) with its HTTP server and CLI
(serve/: ``python -m torch_bnb_fp4_tpu_torch.serve``), packed checkpoints in
the JAX package's format (convert/checkpoint.py), quantized embedding tables
(models/transformer.py), the streaming HF safetensors converter
(convert/hf.py: ``python -m torch_bnb_fp4_tpu_torch.convert``, with its own
safetensors reader and the native C packer), the reference library's API
(compat.py: ``TorchFP4Linear``, ``QuantData``, the functional wrappers and
``recursively_replace_with_fp4_linear``), LoRA adapters attached, merged or
stacked for per-request serving (models/lora.py), a weight carrier from
the JAX package's layout (convert/from_numpy.py), and tensor and data
parallelism over torch.distributed with multi-process serving
(parallel/tp.py, serve/multihost.py).  Entry points default to
``device="cuda"`` and raise without a card unless given ``device="cpu"``.

The names below follow the JAX package's ``__init__``.
"""

from . import compat, convert, models, ops, parallel, serve, utils
from .models import (
    DenseLinear,
    KVCache,
    ModelConfig,
    ModelParams,
    QuantEmbedding,
    QuantLinear,
    apply_linear,
    dequantize_weight,
    forward,
    generate,
    quantize_embedding,
    quantize_linear,
    quantize_params,
)

__version__ = "0.1.0"

__all__ = [
    "compat",
    "convert",
    "models",
    "ops",
    "parallel",
    "serve",
    "utils",
    "QuantLinear",
    "DenseLinear",
    "ModelConfig",
    "ModelParams",
    "KVCache",
    "quantize_linear",
    "QuantEmbedding",
    "quantize_embedding",
    "apply_linear",
    "dequantize_weight",
    "quantize_params",
    "forward",
    "generate",
    "__version__",
]
