"""Inference layer of the PyTorch port."""

from .blocks import run_block_inference, save_metrics_csv
from .figures import file_comparison_charts, save_inference_figures, scatter_3d_comparison
from .las_export import export_predicted_las
from .vote import whole_scene_vote_predict

__all__ = [
    "export_predicted_las",
    "file_comparison_charts",
    "run_block_inference",
    "save_inference_figures",
    "save_metrics_csv",
    "scatter_3d_comparison",
    "whole_scene_vote_predict",
]
