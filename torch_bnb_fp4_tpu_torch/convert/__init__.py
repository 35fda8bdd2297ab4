"""Packed checkpoints, the HF converter and weight carriers into the port."""

from .bnb import dequantize_nested_absmax, from_bnb_state, from_bnb_torch_layer
from .checkpoint import CheckpointWriter, load_checkpoint, save_checkpoint
from .hf import config_from_hf, config_from_hf_dict, convert_hf_model, iter_hf_tensors, quantize_hf_weights
from .quantize import quantize_pack_pairk, quantize_pack_pairk_lut, quantize_pack_sharded, repack_k_shards

__all__ = [
    "CheckpointWriter",
    "config_from_hf",
    "config_from_hf_dict",
    "convert_hf_model",
    "dequantize_nested_absmax",
    "from_bnb_state",
    "from_bnb_torch_layer",
    "iter_hf_tensors",
    "load_checkpoint",
    "quantize_hf_weights",
    "quantize_pack_pairk",
    "quantize_pack_pairk_lut",
    "quantize_pack_sharded",
    "repack_k_shards",
    "save_checkpoint",
]
