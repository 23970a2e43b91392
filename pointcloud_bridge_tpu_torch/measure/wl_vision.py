"""WL identification with a figure after every stage, on the card.

The counterpart of the JAX package's measure/wl_vision.py
(Partsize-identical/WL_iden_vision.py): the SAME chain as
``wl_iden.process_bridge_deck`` (its stage functions, in its order), with a
figure saved after every denoising stage: a 3D scatter coloured by height
next to the 2D xy projection, the fitted minimum bounding rectangle
overlaid once it exists (WL_iden_vision.py:231-349 visualize_step).
matplotlib is imported only to draw; where it is missing the chain still
runs and the figure list is empty.

CLI:
  python -m pointcloud_bridge_tpu_torch.measure.wl_vision \
      raw.las pred.las --label 3 --out out_dir [--voxel 0.02 ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .wl_iden import (
    calculate_dimensions,
    data_voxel,
    default_hyperparams,
    detect_and_trim_edges,
    evaluate_result,
    isolation_forest_outlier_removal,
    lof_outlier_removal,
    minimum_bounding_rectangle,
    process_raw,
    project_to_plane,
    ransac_plane_fit,
)


def visualize_step(
    points: np.ndarray,
    step_name: str,
    rect: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
    dpi: int = 150,
) -> Optional[str]:
    """One per-stage figure: 3D height-colored scatter + 2D xy projection
    (WL_iden_vision.py:231-349). 2-D inputs (post-projection stages) show
    the xy panel only."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    has_z = points.shape[1] >= 3
    fig = plt.figure(figsize=(12, 4))
    if has_z:
        ax1 = fig.add_subplot(1, 2, 1, projection="3d")
        sc = ax1.scatter(
            points[:, 0], points[:, 1], points[:, 2], c=points[:, 2],
            s=1, cmap="viridis",
        )
        fig.colorbar(sc, ax=ax1, label="height (m)", shrink=0.7)
        ax1.set_title(f"{step_name} (3D)")
        ax2 = fig.add_subplot(1, 2, 2)
    else:
        ax2 = fig.add_subplot(1, 1, 1)
    ax2.scatter(points[:, 0], points[:, 1], s=1, alpha=0.5)
    if rect is not None:
        closed = np.vstack([rect, rect[:1]])
        ax2.plot(closed[:, 0], closed[:, 1], "r-", lw=2)
    ax2.set_aspect("equal")
    ax2.set_title(f"{step_name} ({len(points):,} pts)")
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return save_path


def process_bridge_deck_visualized(
    points: np.ndarray,
    output_dir: str,
    voxel_size: float = 0.02,
    ransac_max_trials: int = 1000,
    ransac_residual_threshold: float = 0.3,
    isolation_forest_contamination: float = 0.3,
    lof_n_neighbors: int = 30,
    lof_contamination: float = 0.4,
    percentile: float = 20,
    dpi: int = 150,
    device="cuda",
) -> Tuple[float, float, np.ndarray, np.ndarray, List[str]]:
    """process_bridge_deck (wl_iden.py) with a figure after every stage —
    IDENTICAL math/ordering, plus the saved per-step figure list (empty
    where matplotlib is not installed)."""
    figs: List[str] = []
    draw = importlib.util.find_spec("matplotlib") is not None

    def snap(pts, name, rect=None):
        if draw:
            figs.append(visualize_step(
                pts, name, rect,
                os.path.join(output_dir, f"{len(figs):02d}_{name}.png"), dpi,
            ))

    result = points[:, :3]
    snap(result, "input")
    result = data_voxel(result, voxel_size=voxel_size)
    snap(result, "voxel_downsample")
    result = ransac_plane_fit(
        result, ransac_max_trials, ransac_residual_threshold, device
    )
    snap(result, "ransac_plane")
    result = isolation_forest_outlier_removal(
        result, isolation_forest_contamination, device
    )
    snap(result, "isolation_forest")
    result = lof_outlier_removal(result, lof_n_neighbors, lof_contamination, device)
    snap(result, "lof")
    result = project_to_plane(result)
    snap(result, "projected_xy")
    points_trimmed = detect_and_trim_edges(result, percentile)
    result = detect_and_trim_edges(result)
    rect = minimum_bounding_rectangle(result)
    snap(result, "edge_trim_mbr", rect)
    length, width = calculate_dimensions(result, rect)
    return (
        max(width, length), min(width, length), points_trimmed, rect, figs
    )


def run_vision(
    raw_las: str,
    pred_las: str,
    label: int,
    out_dir: str,
    hyperparams: Optional[Dict] = None,
    device="cuda",
) -> Dict:
    """Load raw+pred LAS, filter the class, run the visualized chain, and
    report dimensions + relative error (the WL_iden_vision __main__ flow)."""
    from ..data.lasio import read_las

    hp = default_hyperparams()
    if hyperparams:
        hp.update(hyperparams)

    def cls_points(path):
        las = read_las(path)
        return las.xyz[las.classification == label]

    raw_pts = cls_points(raw_las)
    pred_pts = cls_points(pred_las)
    if len(raw_pts) == 0 or len(pred_pts) == 0:
        raise ValueError(
            f"label {label}: raw has {len(raw_pts)} pts, pred has "
            f"{len(pred_pts)} pts — nothing to measure"
        )

    l_raw, w_raw, _, _ = process_raw(raw_pts, percentile=hp["percentile"], device=device)
    l_pred, w_pred, _, rect, figs = process_bridge_deck_visualized(
        pred_pts, out_dir, dpi=150,
        **{k: v for k, v in hp.items() if k != "percentile"},
        percentile=hp["percentile"], device=device,
    )
    err = evaluate_result(l_raw, w_raw, l_pred, w_pred)
    return {
        "length_raw": l_raw, "width_raw": w_raw,
        "length_pred": l_pred, "width_pred": w_pred,
        "relative_error": err, "figures": figs,
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("raw_las")
    ap.add_argument("pred_las")
    ap.add_argument("--label", type=int, default=3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--percentile", type=float, default=20)
    ap.add_argument("--device", default="cuda",
                    help="where the PyTorch stages run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run_vision(
        args.raw_las, args.pred_las, args.label, args.out,
        {"voxel_size": args.voxel, "percentile": args.percentile}, device=args.device,
    )
    print(
        f"raw:  {res['length_raw']:.3f} x {res['width_raw']:.3f} m\n"
        f"pred: {res['length_pred']:.3f} x {res['width_pred']:.3f} m\n"
        f"relative error: {res['relative_error']:.4f}\n"
        f"{len(res['figures'])} step figures -> {args.out}"
    )
    return res


if __name__ == "__main__":
    main()
