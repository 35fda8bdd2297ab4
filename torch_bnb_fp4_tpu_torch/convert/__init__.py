"""Packed checkpoints and weight carriers into the port."""

from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
