"""Whole-scene K-vote inference (counterpart of
pointcloud_bridge_tpu/infer/vote.py).

The scene is covered ``num_votes`` times by the sliding-grid sampler (a
fresh random pad-resampling each vote), every block is classified, and
per-point class votes weighted by ``labelweights`` are accumulated at the
ORIGINAL point indices; the final label is the argmax of the vote pool.

Of the JAX version this is the device-gather path: the scene's per-point
feature table goes to the device once, each vote sends its int32 block
indices and XY centres, and the device gathers the rows and centres each
block. The next vote's host gridding runs on a background thread under the
current vote's device work and fetch. The votes of a pass are scattered with
one ``np.bincount`` into a float64 pool on the host. With ``mesh`` (a
device mesh with a "data" axis, one rank a device) the block batches split
over the axis, pure data parallelism: each rank classifies its rows of a
batch (the batch size rounded up to a multiple of the axis, a short batch
padded with copies of its last block) and the predictions are gathered,
so every rank builds the same vote pool as the single-rank vote
(vote.py:59-146). Not ported: the host-assembly path, and the fixed-shape
chunking that the JAX version needs for its compiled executables (PyTorch
runs eagerly, so a vote's indices go up in one copy and the last batch is
simply shorter).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import numpy as np
import torch

from ..data.blocks import (
    normalize_points,
    precompute_grid_cells,
    scene_feature_table,
    whole_scene_grid_indices,
)
from ..utils import metrics as M
from ..utils.collectives import gather_list


def whole_scene_vote_predict(
    model: torch.nn.Module,
    points6: np.ndarray,
    labels: np.ndarray,
    labelweights: np.ndarray,
    num_classes: int,
    block_points: int = 4096,
    block_size: float = 1.0,
    stride: float = 0.5,
    num_votes: int = 5,
    batch_size: int = 16,
    feature_mode: str = "xyz_rgb",
    normalize_scene: bool = False,
    seed: int = 0,
    collect_timings: bool = False,
    mesh=None,
) -> Dict[str, Any]:
    """Predict a label for every point of one scene.

    Args:
      model: the scene is served on the device that holds its parameters
        (move it to the card first to serve there); it is put in eval mode.
      points6: [N, 6] xyzrgb scene; labels: [N]; labelweights: [C] vote
        weights.
      feature_mode: 'xyz_rgb' feeds (xyz = the block's centred coordinates,
        features = rgb); 'nine' feeds the 9-channel block (centred xyz, rgb,
        xyz / scene extent) as features.
      normalize_scene: centre the scene on its centroid and divide by its
        largest radius before gridding, as the Highway-style training blocks
        are; block_size and stride are then in normalised units and blocks
        are not centred in XY.
      seed: vote v draws its pad-resampling from numpy's rng at
        ``seed + 1009 * v``, as the JAX version does, so the two see the
        same blocks.
      mesh: a ``DeviceMesh`` with a "data" axis (parallel/mesh.py): the
        block batches split over it, every rank of the axis calls this
        with the same arguments and gets the same result.
      collect_timings: also return host wall times of the phases:
        'table_upload_s' and, a vote, 'grid_s' (host gridding, on the
        background thread), 'h2d_s' (index and centre copies), 'dispatch_s'
        (enqueueing the forward batches), 'fetch_s' (the blocking fetch,
        which waits out the device), 'scatter_s' (host vote bincount).
    Returns {pred [N] int32, metrics, vote_pool [N, C] float64[, timings]}.
    On CUDA this turns TF32 off for matmuls and cuDNN.
    """
    if feature_mode not in ("xyz_rgb", "nine"):
        raise ValueError(f"feature_mode must be 'xyz_rgb' or 'nine', got {feature_mode!r}")
    device = next(model.parameters()).device
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model.eval()
    n = len(points6)
    if normalize_scene:
        points6 = points6.copy()
        points6[:, :3] = normalize_points(points6[:, :3].astype(np.float64))
    vote_pool = np.zeros((n, num_classes), np.float64)
    flat_pool = vote_pool.reshape(-1)
    # predictions come back as uint8 when the classes fit
    pred_dtype = torch.uint8 if num_classes <= 255 else torch.int32
    ncols = 9 if feature_mode == "nine" else 6
    group = None
    if mesh is not None:
        group = mesh.get_group("data")
        ndev, me = mesh.size(mesh.mesh_dim_names.index("data")), mesh.get_local_rank("data")
        batch_size = -(-batch_size // ndev) * ndev

    timings: Dict[str, Any] = {
        "table_upload_s": 0.0,
        "grid_s": [], "h2d_s": [], "dispatch_s": [], "fetch_s": [], "scatter_s": [],
    }

    def sync() -> None:
        if collect_timings and device.type == "cuda":
            torch.cuda.synchronize(device)

    def forward_idx(table, idx, centers):
        """Gather the blocks' rows of the scene table and centre each block
        in XY: the host assembly of whole_scene_grid_blocks, bit for bit."""
        g = table[idx.long()]  # [B, P, 6 or 9]
        offs = torch.cat([centers, torch.zeros_like(centers[:, :1])], dim=-1)
        xyz = g[..., :3] - offs[:, None, :]
        feats = torch.cat([xyz, g[..., 3:]], dim=-1) if feature_mode == "nine" else g[..., 3:6]
        return model(xyz, feats).argmax(-1).to(pred_dtype)

    def predict(table, idx, centers):
        """A batch's predictions; with a mesh, this rank's rows of it,
        gathered from the ranks."""
        if group is None:
            return forward_idx(table, idx, centers)
        nb_b = idx.shape[0]
        pad = (-nb_b) % ndev
        if pad:
            idx = torch.cat([idx, idx[-1:].expand(pad, -1)])
            centers = torch.cat([centers, centers[-1:].expand(pad, -1)])
        rows = slice(me * idx.shape[0] // ndev, (me + 1) * idx.shape[0] // ndev)
        return torch.cat(gather_list(forward_idx(table, idx[rows], centers[rows]), group))[:nb_b]

    cells = [None]  # seed-independent grid membership, computed with vote 0

    def grid(vote: int):
        t0 = time.perf_counter()
        if cells[0] is None:
            cells[0] = precompute_grid_cells(points6, block_size, stride, padding=0.001)
        out = whole_scene_grid_indices(
            points6, labels, labelweights, block_points=block_points,
            block_size=block_size, stride=stride, center_xy=not normalize_scene,
            seed=seed + vote * 1009, cells=cells[0],
        )
        timings["grid_s"].append(time.perf_counter() - t0)
        return out

    with ThreadPoolExecutor(max_workers=1) as gridder, torch.inference_mode():
        fut = gridder.submit(grid, 0)  # overlaps the table build and upload
        t0 = time.perf_counter()
        table = torch.from_numpy(
            np.ascontiguousarray(scene_feature_table(points6)[:, :ncols])
        ).to(device)
        sync()
        timings["table_upload_s"] = time.perf_counter() - t0
        for vote in range(num_votes):
            idxs, weights, centers = fut.result()
            if vote + 1 < num_votes:
                fut = gridder.submit(grid, vote + 1)
            nb = len(idxs)
            if nb == 0:
                continue
            t0 = time.perf_counter()
            idx_dev = torch.from_numpy(idxs.astype(np.int32)).to(device)
            ctr_dev = torch.from_numpy(np.ascontiguousarray(centers)).to(device)
            sync()
            t1 = time.perf_counter()
            parts = [
                predict(table, idx_dev[s : s + batch_size], ctr_dev[s : s + batch_size])
                for s in range(0, nb, batch_size)
            ]
            t2 = time.perf_counter()
            preds = torch.cat(parts).cpu().numpy()  # the vote's one fetch
            t3 = time.perf_counter()
            flat = idxs.reshape(-1) * num_classes + preds.reshape(-1)
            flat_pool[:] += np.bincount(
                flat, weights=weights.reshape(-1), minlength=flat_pool.size
            )
            timings["h2d_s"].append(t1 - t0)
            timings["dispatch_s"].append(t2 - t1)
            timings["fetch_s"].append(t3 - t2)
            timings["scatter_s"].append(time.perf_counter() - t3)

    pred = vote_pool.argmax(axis=1).astype(np.int32)
    cm = np.bincount(
        labels.astype(np.int64) * num_classes + pred, minlength=num_classes * num_classes
    ).reshape(num_classes, num_classes).astype(np.int64)
    out = {"pred": pred, "metrics": M.metrics_from_confusion(cm), "vote_pool": vote_pool}
    if collect_timings:
        out["timings"] = timings
    return out
