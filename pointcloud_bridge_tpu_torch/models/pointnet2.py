"""PointNet++ segmentation in PyTorch (counterpart of
pointcloud_bridge_tpu/models/pointnet2.py): SSG (``PointNet2SSG``) and the
Partsize 9-channel MSG model (``PointNet2MSG``)."""

from __future__ import annotations

from typing import Optional

import torch

from .common import (
    FeaturePropagation,
    MultiScaleSetAbstractionMsg,
    SegHead,
    SetAbstraction,
    sync_batchnorms,
)
from ..utils.collectives import all_gather


class PointNet2SSG(SegHead):
    """PointNet++ SSG semantic segmentation (reference model.py:12-56).

    forward(xyz [B, N, 3], features [B, N, in_features] or None) -> logits
    [B, N, num_classes], float32. SA levels (npoint, radius, nsample, mlp):
    (1024, 0.1, 32, (64, 64, 128)), (256, 0.2, 32, (128, 128, 256)),
    (64, 0.4, 32, (256, 256, 512)); FP widths (256, 256), (256, 128),
    (128, 128, 128); head 128. ``sa_npoints`` shrinks the SA levels for
    tests. The head's layers sit at the top of the state_dict (conv1, bn1,
    conv2) as in the reference, so the model extends SegHead. ``axis_name``
    syncs every BatchNorm over that mesh axis (:func:`sync_batchnorms`).
    ``sp_axis`` runs the query axis of every level sliced over that mesh
    axis, the inputs whole on every rank (models/common.py; JAX
    pointnet2.py:49-87): fp1's output stays sliced through the head and the
    logits are gathered once.

    On CUDA the model expects full float32 matmuls: set
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` (``run_block_inference``
    does so). TF32 keeps about three decimal digits, too few for the 2e-4
    band the port is held to against the JAX package.
    """

    def __init__(
        self,
        num_classes: int = 5,
        sa_npoints: tuple = (1024, 256, 64),
        dropout_rate: float = 0.5,
        in_features: int = 3,
        generator: Optional[torch.Generator] = None,
        axis_name: Optional[str] = None,
        sp_axis: Optional[str] = None,
    ):
        super().__init__(128, num_classes, 128, dropout_rate, generator)
        n1, n2, n3 = sa_npoints
        g, sp = generator, sp_axis
        self.sp_axis = sp
        self.sa1 = SetAbstraction(n1, 0.1, 32, 3 + in_features, (64, 64, 128), g, sp)
        self.sa2 = SetAbstraction(n2, 0.2, 32, 3 + 128, (128, 128, 256), g, sp)
        self.sa3 = SetAbstraction(n3, 0.4, 32, 3 + 256, (256, 256, 512), g, sp)
        self.fp3 = FeaturePropagation(256 + 512, (256, 256), g, sp)
        self.fp2 = FeaturePropagation(128 + 256, (256, 128), g, sp)
        self.fp1 = FeaturePropagation(128, (128, 128, 128), g, sp, sp_gather=False)
        sync_batchnorms(self, axis_name)

    def forward(
        self, xyz: torch.Tensor, features: Optional[torch.Tensor]
    ) -> torch.Tensor:
        l1_xyz, l1 = self.sa1(xyz, features)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        l3_xyz, l3 = self.sa3(l2_xyz, l2)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp1(xyz, l1_xyz, None, l1)
        return sharded_head(self, l0)


def sharded_head(model: SegHead, x: torch.Tensor) -> torch.Tensor:
    """The SegHead of ``model`` on x, its logits gathered over the model's
    ``sp_axis`` where it has one."""
    logits = SegHead.forward(model, x)
    return all_gather(logits, model.sp_axis) if model.sp_axis else logits


class PointNet2MSG(SegHead):
    """The Partsize PointNet++ MSG segmentation model
    (Partsize-identical/models/pointnet2_sem_seg_msg.py:7-42;
    models/pointnet2.py:90-144 of the JAX package), the repo's north star.

    forward(xyz [B, N, 3], features [B, N, in_features] or None) -> logits
    [B, N, num_classes] (the reference returns log-probs). Four MSG levels,
    each two radii with K 16 and 32: 1024 centres at (0.05, 0.1), 256 at
    (0.1, 0.2), 64 at (0.2, 0.4), 16 at (0.4, 0.8); FP widths (256, 256)
    twice, (256, 128), (128, 128, 128) with no skip into fp1; a head of 128
    with dropout 0.5. Flax reads the input width from the first call;
    PyTorch needs it up front: ``in_features`` is 3 for the colours that
    both CLIs feed a model, 9 for the Partsize column contract [x_c, y_c, z,
    r, g, b, x_norm, y_norm, z_norm] (bench.py's ``feature_dim=9``).
    ``axis_name`` syncs every BatchNorm over that mesh axis; ``sp_axis``
    slices the query axis as in PointNet2SSG (JAX pointnet2.py:90-144). On
    CUDA it expects full float32 matmuls, as PointNet2SSG does.
    """

    BRANCHES = (
        ((16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 96, 128)),
        ((128, 196, 256), (128, 196, 256)),
        ((256, 256, 512), (256, 384, 512)),
    )
    LEVELS = ((1024, (0.05, 0.1)), (256, (0.1, 0.2)), (64, (0.2, 0.4)), (16, (0.4, 0.8)))
    NSAMPLES = (16, 32)

    def __init__(
        self,
        num_classes: int = 5,
        dropout_rate: float = 0.5,
        in_features: int = 3,
        axis_name: Optional[str] = None,
        sp_axis: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(128, num_classes, 128, dropout_rate, generator)
        g, sp = generator, sp_axis
        self.sp_axis = sp
        c = in_features
        for i, ((npoint, radii), mlps) in enumerate(zip(self.LEVELS, self.BRANCHES), start=1):
            setattr(self, f"sa{i}", MultiScaleSetAbstractionMsg(
                npoint, radii, self.NSAMPLES, 3 + c, mlps, g, sp))
            c = sum(m[-1] for m in mlps)
        self.fp4 = FeaturePropagation(512 + 1024, (256, 256), g, sp)
        self.fp3 = FeaturePropagation(256 + 256, (256, 256), g, sp)
        self.fp2 = FeaturePropagation(96 + 256, (256, 128), g, sp)
        self.fp1 = FeaturePropagation(128, (128, 128, 128), g, sp, sp_gather=False)
        sync_batchnorms(self, axis_name)

    def forward(
        self, xyz: torch.Tensor, features: Optional[torch.Tensor]
    ) -> torch.Tensor:
        l1_xyz, l1 = self.sa1(xyz, features)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        l3_xyz, l3 = self.sa3(l2_xyz, l2)
        l4_xyz, l4 = self.sa4(l3_xyz, l3)
        l3 = self.fp4(l3_xyz, l4_xyz, l3, l4)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp1(xyz, l1_xyz, None, l1)
        return sharded_head(self, l0)
