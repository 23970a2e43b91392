"""End-to-end example on the card: synthetic bridge LAS scenes -> training
-> whole-scene vote inference -> predicted LAS -> deck width/length
measurement (the JAX package's examples/full_pipeline.py, same recipe).

    python -m pointcloud_bridge_tpu_torch.examples.full_pipeline [workdir] [--device cuda]

pointnet2_ssg with sa_npoints (256, 64, 16) on 1024-point blocks, batch 4,
8 epochs, 8 train steps a dispatch (a CUDA graph on the card); 3 training
scenes, 1 validation and 1 test scene of 40,000 points; the test scene
voted 3 times with blocks of 0.65 and a stride of 0.33 (normalised units),
exported as LAS, and its deck (class 3) measured by run_wl_identification
against the ground-truth deck points.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict

import numpy as np

NUM_CLASSES = 5
DECK_CLASS = 3
# the measurement hyperparameters of the JAX example
MEASURE_HYPERPARAMS = {
    "voxel_size": 0.05,
    "isolation_forest_contamination": 0.1,
    "lof_n_neighbors": 20,
    "lof_contamination": 0.05,
}


def run(workdir: str, device: str = "cuda") -> Dict:
    """The pipeline; returns each stage's wall seconds ("walls"), the
    vote's metrics, the measurement row, the best validation OA and the
    deck's point counts."""
    from ..config import Config
    from ..data import read_las, scene_labelweights, write_las
    from ..data.dataset import _load_scene
    from ..data.synthetic import toy_bridge_scene
    from ..infer import export_predicted_las, whole_scene_vote_predict
    from ..measure import run_wl_identification
    from ..train import train
    from ..train.loop import resolve_device
    from ..train_cli import build_datasets

    resolve_device(device)  # no card: fail before any work
    walls: Dict[str, float] = {}

    def sync() -> None:
        if device != "cpu":
            import torch

            torch.cuda.synchronize()

    os.makedirs(workdir, exist_ok=True)
    for sub in ("train", "val", "test"):
        os.makedirs(os.path.join(workdir, sub), exist_ok=True)

    # 1) synthesize labeled scenes (stand-in for real LiDAR scans)
    print("== generating scenes ==", flush=True)
    t0 = time.perf_counter()
    for split, seeds in [("train", (0, 1, 2)), ("val", (10,)), ("test", (20,))]:
        for s in seeds:
            xyz, rgb, labels = toy_bridge_scene(40000, seed=s)
            write_las(os.path.join(workdir, split, f"scene{s}.las"), xyz, rgb, labels)
    walls["scenes_s"] = time.perf_counter() - t0

    # 2) train
    print("== training ==", flush=True)
    t0 = time.perf_counter()
    cfg = Config.from_dict(
        {
            "case": "example",
            "model": "pointnet2_ssg",
            "num_classes": NUM_CLASSES,
            "num_points": 1024,
            "block_size": 8.0,
            "sample_rate": 0.3,
            "batch_size": 4,
            "num_epochs": 8,
            "learning_rate": 0.001,
            "device": device,
            "train_dir": os.path.join(workdir, "train"),
            "val_dir": os.path.join(workdir, "val"),
            "exp_dir_root": os.path.join(workdir, "experiments"),
        }
    )
    cfg.model.extra = {"sa_npoints": (256, 64, 16)}
    cfg.data.augment = False
    cfg.train.steps_per_dispatch = 8
    tr, va = build_datasets(cfg)
    out = train(cfg, tr, va)
    sync()
    walls["train_s"] = time.perf_counter() - t0
    print(f"best val OA: {out['best_val_acc']:.4f}")

    # 3) whole-scene vote inference + LAS export
    print("== inference ==", flush=True)
    t0 = time.perf_counter()
    test_file = os.path.join(workdir, "test", "scene20.las")
    pts, cols, labels = _load_scene(test_file)
    lw = scene_labelweights([labels], NUM_CLASSES)
    pts6 = np.concatenate([pts, cols], axis=1)
    # normalize_scene matches the training contract (blocks carry whole-scene
    # normalized coordinates); block sizes are in normalized units (~scene
    # radius 12 m -> 8 m raw ~ 0.65 normalized)
    res = whole_scene_vote_predict(
        out["model"], pts6, labels, lw, NUM_CLASSES,
        block_points=1024, block_size=0.65, stride=0.33, num_votes=3,
        normalize_scene=True,
    )
    m = res["metrics"]
    walls["vote_s"] = time.perf_counter() - t0
    print(f"scene mIoU={m['mIoU']:.4f} OA={m['OA']:.4f}")
    t0 = time.perf_counter()
    pred_las = os.path.join(workdir, "scene20_pred.las")
    export_predicted_las(pred_las, pts, cols, res["pred"])
    walls["export_s"] = time.perf_counter() - t0

    # 4) deck width/length measurement from the predicted LAS
    print("== measurement ==", flush=True)
    t0 = time.perf_counter()
    raw = pts[labels == DECK_CLASS]
    pred_scan = read_las(pred_las)
    pred_deck = pred_scan.xyz[pred_scan.classification == DECK_CLASS]
    rows = run_wl_identification(
        [("scene20", raw, pred_deck)],
        out_csv=os.path.join(workdir, "evaluation_results.csv"),
        hyperparams=MEASURE_HYPERPARAMS,
        device=device,
    )
    walls["measure_s"] = time.perf_counter() - t0
    r = rows[0]
    print(
        f"deck GT {r['length_raw']:.2f} x {r['width_raw']:.2f} m, "
        f"measured {r['length_pred']:.2f} x {r['width_pred']:.2f} m, "
        f"rel err {r['relative_error']:.4f}"
    )
    print("stage walls: " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()), flush=True)
    return {"walls": walls, "metrics": m, "row": r,
            "best_val_acc": out["best_val_acc"], "raw_deck_points": len(raw),
            "pred_deck_points": len(pred_deck)}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("workdir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "pcb_example"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.workdir, args.device)


if __name__ == "__main__":
    main()
