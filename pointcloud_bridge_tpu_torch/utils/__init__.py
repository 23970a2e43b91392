"""Weights conversion and metrics of the PyTorch port."""
