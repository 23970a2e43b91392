"""pointcloud_bridge_tpu_torch — the PyTorch/CUDA port of pointcloud_bridge_tpu.

A second package beside the JAX one, which stays the reference. It imports
torch and numpy, never JAX; of the JAX package it imports only the
numpy-only ``pointcloud_bridge_tpu.data``. Module paths mirror the JAX
package's, and public functions keep its layout (xyz [B, N, 3], features
[B, N, C], channel-last, int32 indices).

Layout:
    csrc/      hand-written CUDA kernels for sm_90a (FPS, ball query,
               grouping, k-NN interpolation), plain C entry points
    ops/       point-cloud ops; each kernel's ctypes wrapper sits beside its
               plain PyTorch version (ops/_kernels.py builds and binds)
    models/    PointNet++ SSG (nn.Modules with the reference torch names)
    utils/     JAX-variables -> state_dict conversion, metrics
    infer/     block inference and metric CSVs
"""

__version__ = "0.1.0"
