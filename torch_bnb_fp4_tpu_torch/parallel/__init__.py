"""Tensor and data parallelism over torch.distributed (the JAX package's
``parallel`` names)."""

from .tp import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    cache_specs,
    init_multihost,
    make_decode_step,
    make_mesh,
    make_prefill,
    param_specs,
    quantize_params_tp,
    shard_cache,
    shard_params,
    tp_forward_fn,
    validate_tp,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "init_multihost",
    "make_mesh",
    "validate_tp",
    "quantize_params_tp",
    "param_specs",
    "cache_specs",
    "shard_params",
    "shard_cache",
    "tp_forward_fn",
    "make_decode_step",
    "make_prefill",
]
