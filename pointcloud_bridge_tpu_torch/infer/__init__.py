"""Inference layer of the PyTorch port."""

from .blocks import run_block_inference, save_metrics_csv

__all__ = ["run_block_inference", "save_metrics_csv"]
