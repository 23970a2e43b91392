"""Large-scene streaming inference on the card (the JAX package's
examples/large_scene_stream.py).

Whole-scene K-vote segmentation over a multi-million-point synthetic
bridge scene, reporting END-TO-END points/s: gridding, the index and
centre copies, the device forward and the host vote scatter all included.
The vote loop (infer/vote.py) uploads the scene table once, streams int32
block indices, gathers the blocks on the card and grids the next vote on a
host thread while the card runs this one.

    python -m pointcloud_bridge_tpu_torch.examples.large_scene_stream \
        [n_points_millions] [model] [block_points] [--workdir D] [--device cuda]

``model`` defaults to pointnet2_ssg; ``ptv3_pooled`` serves the
hierarchical transformer at blocks of 16384 points. The model is first
quick-trained for 4 epochs on a 300k-point scene (the recipe of
full_pipeline.py) so that the quality numbers mean something. The phase
split goes to <workdir>/large_scene_phases_<n>M[_<model>].json.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict

import numpy as np

NUM_CLASSES = 5
NUM_VOTES = 3


def run(n_points: int, model_name: str = "pointnet2_ssg", block_points: int = 0,
        workdir: str = "", device: str = "cuda") -> Dict:
    """Quick-train, then the timed NUM_VOTES-vote serve; returns the phase
    artifact (also written under ``workdir``)."""
    from ..config import Config
    from ..data import BlockDataset, make_training_blocks
    from ..data.synthetic import toy_bridge_scene
    from ..infer.vote import whole_scene_vote_predict
    from ..train import train
    from ..train.loop import resolve_device
    from ..utils.hostmem import retain_freed_pages

    resolve_device(device)
    # keep numpy's big buffers warm across the per-vote gridding passes
    retain_freed_pages()
    workdir = workdir or os.path.join(tempfile.gettempdir(), "pcb_stream_demo")
    os.makedirs(workdir, exist_ok=True)
    block_points = block_points or (16384 if model_name == "ptv3_pooled" else 4096)
    # keep points-per-device-batch constant as blocks grow
    vote_batch = max(1, (32 * 4096) // block_points)
    model_extra = {}
    if model_name == "ptv3_pooled":
        # levels block_points / 4 / 16, window 1024
        model_extra = {"dims": (64, 128, 256), "enc_depths": (2, 2, 6),
                       "dec_depths": (1, 1), "strides": (4, 4), "window_size": 1024}

    print(f"generating {n_points:,}-point synthetic bridge scene...", flush=True)
    xyz, rgb, labels = toy_bridge_scene(n_points, seed=0)
    points6 = np.concatenate([xyz, rgb], axis=1).astype(np.float32)

    # block spatial size scales as sqrt(points-per-block) so density matches
    train_bs = 6.0 * (block_points / 4096) ** 0.5
    txyz, trgb, tlabels = toy_bridge_scene(300_000, seed=1)
    blocks = make_training_blocks(
        txyz, trgb, tlabels, num_points=block_points, block_size=train_bs,
        sample_rate=1.0, file_name="toy", seed=0,
    )
    tr = BlockDataset.from_blocks(blocks, ["toy"], augment=True)
    cfg = Config.from_dict({
        "case": "stream_demo", "num_classes": NUM_CLASSES, "batch_size": 4,
        "num_epochs": 4, "learning_rate": 1e-3, "model": model_name,
        "num_points": block_points, "device": device,
    })
    if model_extra:
        cfg.model.extra = dict(model_extra)
    print("quick-training on a 300k-point scene (4 epochs)...", flush=True)
    t0 = time.perf_counter()
    res = train(cfg, tr, None, exp_dir=os.path.join(workdir, "stream_demo_exp"))
    train_s = time.perf_counter() - t0
    model = res["model"]

    # Inference matches the training contract: the model was trained on
    # whole-scene-NORMALIZED coordinates (make_training_blocks), so the vote
    # gridder normalizes the scene too and block sizes are in normalized
    # units (8 m raw / scene radius). Training has already loaded the
    # kernels and the card's libraries: the first vote is no cold start.
    centered = xyz - xyz.mean(axis=0, keepdims=True)
    radius = float(np.sqrt((centered**2).sum(axis=1)).max())
    bs_norm = 8.0 * (block_points / 4096) ** 0.5 / radius
    stride_norm = 0.75 * bs_norm

    t0 = time.perf_counter()
    out = whole_scene_vote_predict(
        model, points6, labels, np.ones(NUM_CLASSES), NUM_CLASSES,
        block_points=block_points, block_size=bs_norm, stride=stride_norm,
        num_votes=NUM_VOTES, batch_size=vote_batch, normalize_scene=True,
        collect_timings=True,
    )
    wall = time.perf_counter() - t0
    covered = int((out["vote_pool"].sum(axis=1) > 0).sum())
    m = out["metrics"]
    print(
        f"scene: {n_points:,} pts | votes: {NUM_VOTES} | wall: {wall:.1f} s | "
        f"end-to-end: {n_points / wall:,.0f} pts/s "
        f"(x{NUM_VOTES} votes = {NUM_VOTES * n_points / wall:,.0f} block-pts/s)"
    )
    print(f"coverage: {covered / n_points:.1%} | OA {m['OA']:.3f} | mIoU {m['mIoU']:.3f}")

    # the phase split localizes a regression that end-to-end wall time
    # hides: grid_s runs on the gridding thread, overlapped with the card;
    # fetch_s is the blocking copy back, which waits out the vote's forwards
    tm = out["timings"]
    artifact = {
        "n_points": n_points,
        "model": model_name,
        "device": device,
        "num_votes": NUM_VOTES,
        "block_points": block_points,
        "train_s": train_s,
        "wall_s": wall,
        "end_to_end_pts_per_s": n_points / wall,
        "phases": tm,
        "oa": float(m["OA"]),
        "miou": float(m["mIoU"]),
        "coverage": covered / n_points,
    }
    tag = "" if model_name == "pointnet2_ssg" else f"_{model_name}"
    out_path = os.path.join(workdir, f"large_scene_phases_{n_points / 1e6:g}M{tag}.json")
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    print("phase artifact ->", out_path)
    return artifact


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_points_millions", nargs="?", type=float, default=5.0)
    ap.add_argument("model", nargs="?", default="pointnet2_ssg",
                    choices=("pointnet2_ssg", "ptv3_pooled"))
    ap.add_argument("block_points", nargs="?", type=int, default=0)
    ap.add_argument("--workdir", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(int(args.n_points_millions * 1e6), args.model, args.block_points,
               args.workdir, args.device)


if __name__ == "__main__":
    main()
