"""Checkpoints: parameter trees to ``.npz`` files and back."""
from .checkpoint import load_checkpoint, save_checkpoint, tree_from_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "tree_from_checkpoint"]
