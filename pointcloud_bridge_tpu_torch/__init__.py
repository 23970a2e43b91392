"""pointcloud_bridge_tpu_torch — the PyTorch/CUDA port of pointcloud_bridge_tpu.

A second package beside the JAX one, which stays the reference. It imports
torch and numpy, never JAX. Of the JAX package it shares only modules that
import no JAX: the numpy data layer, the ``Config`` tree, the training
CLI's ``build_datasets`` and the experiment logger. Module paths mirror the
JAX package's, and public functions keep its layout (xyz [B, N, 3],
features [B, N, C], channel-last, int32 indices).

Layout:
    csrc/      hand-written CUDA kernels for sm_90a (FPS, ball query,
               grouping and its backward, k-NN interpolation and its
               backward), plain C entry points
    ops/       point-cloud ops; each kernel's ctypes wrapper sits beside its
               plain PyTorch version (ops/_kernels.py builds and binds);
               grouping and interpolation are autograd Functions
    models/    PointNet++ SSG (nn.Modules with the reference torch names,
               flax-semantics BatchNorm)
    losses.py  the segmentation losses
    train/     single-device training engine and lr schedules
    utils/     weights conversion to and from the JAX variables, metrics,
               checkpoints
    infer/     block inference and metric CSVs
    train_cli.py  the training entry point
"""

__version__ = "0.1.0"
