"""pointcloud_bridge_tpu_torch — the PyTorch/CUDA port of pointcloud_bridge_tpu.

A second package beside the JAX one, which stays the reference. It imports
torch and numpy, never JAX, and nothing of the JAX package: the numpy data
layer, the ``Config`` tree, the class names and the experiment logger are
the port's own copies. Module paths mirror the JAX package's, and public
functions keep its layout (xyz [B, N, 3], features [B, N, C], channel-last,
int32 indices).

Layout:
    csrc/      hand-written CUDA kernels for sm_90a (FPS, ball query, exact
               k-NN, grouping and its backward, k-NN interpolation and its
               backward, flash attention and its backward), plain C entry
               points
    ops/       point-cloud ops; each kernel's ctypes wrapper sits beside its
               plain PyTorch version (ops/_kernels.py builds and binds);
               grouping, interpolation and attention are autograd Functions;
               structure.py holds the closed-form 3x3 eigenvalues and the
               local shape descriptor
    models/    PointNet++ SSG (nn.Modules with the reference torch names),
               BriStruNet and the PTv3 family (named after the flax
               modules), with flax-semantics BatchNorm
    data/      LAS/H5 IO, block samplers, BlockDataset, synthetic scenes
    config.py  the typed config tree; class_names.py the label maps
    losses.py  the segmentation losses
    train/     single-device training engine and lr schedules
    utils/     weights conversion to and from the JAX variables, metrics,
               checkpoints, experiment logging
    infer/     block inference, whole-scene vote inference, metric CSVs,
               figures, predicted-LAS export
    bench/     the cross-model speed and size sweep (eva_model.py) and the
               from-scratch convergence run of SSG (convergence_parity.py)
    train_cli.py, infer_cli.py  the entry points
"""

__version__ = "0.1.0"
