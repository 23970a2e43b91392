"""Cross-model speed and size sweep of the port (counterpart of
pointcloud_bridge_tpu/bench/eva_model.py, the reference's
Highway_bridge/eva_model.py:53-382).

Per model: parameter count and size (:38-51), warm-up, timed inference ->
ms and points/s (:147-172), the allocator's peak over one forward
(:174-182), host RSS (:184-186), timed train steps -> an estimated epoch
time (:188-264); the rows go to ``model_performance_comparison.csv`` (the
reference's schema) and, where matplotlib imports, bar and radar charts.

Timing: every forward and every train step is timed alone, between CUDA
events on the card (a host clock on the CPU), after warm-up, and the row
takes the median. The models run eagerly, as the trainer and the serve
run them.

Usage (on the card; ``--device cpu`` runs on the host):
    python -m pointcloud_bridge_tpu_torch.bench.eva_model [--device cuda] \
        [--out results_torch]
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..models import get_model
from ..train.loop import make_optimizer, make_train_step, resolve_device

# The reference zoo (eva_model.py:463-527): PointNet, DGCNN (k=32 in the
# benchmark config), PointNet2, SPG, RandLA, PTv3 (depth=12, heads=6),
# BridgeSeg, with the JAX package's rows and kwargs. A row's "_model" key
# overrides the registry name so one architecture can appear in several
# configs; "_feature_dim" is the width of the features fed beside xyz (3,
# the colours, by default); "_note" documents the config.
DEFAULT_ZOO: Dict[str, Dict[str, Any]] = {
    "pointnet": {},
    "dgcnn": {"k": 20, "_note": "trained variant (k=20); no same-config ref row"},
    "dgcnn_k32": {"_model": "dgcnn_global", "k": 32,
                  "_note": "reference CSV variant (model.py:372-482, k=32)"},
    "pointnet2_ssg": {},
    "pointnet2_msg": {"_feature_dim": 9,
                      "_note": "BASELINE north-star model (Partsize MSG); fed "
                               "its 9-ch S3DIS column contract"},
    "spg": {},
    "spt": {"_note": "SuperPointTransformer point-level segmenter"},
    "randlanet": {},
    "ptv3": {"embed_dim": 384, "depth": 8, "num_heads": 2,
             "_note": "trained config (train_PTV3.py:123-128)"},
    "ptv3_big": {"_model": "ptv3", "embed_dim": 384, "depth": 12,
                 "num_heads": 6,
                 "_note": "reference benchmark config (eva_model.py:506-513)"},
    "ptv3_big_bf16": {"_model": "ptv3", "embed_dim": 384, "depth": 12,
                      "num_heads": 6, "stream_dtype": "bfloat16",
                      "_note": "bf16 residual stream serving config (params f32)"},
    "ptv3_win_bf16": {"_model": "ptv3", "embed_dim": 384, "depth": 8,
                      "num_heads": 2, "window_size": 512,
                      "stream_dtype": "bfloat16",
                      "_note": "Morton-windowed w=512 + bf16 stream serving config"},
    "ptv3_pooled": {"dims": (64, 128, 256), "enc_depths": (2, 2, 6),
                    "dec_depths": (1, 1), "strides": (4, 4),
                    "window_size": 1024,
                    "_note": "true-PTv3 hierarchical U-Net: serialized grid "
                             "pooling, depth at the coarse levels "
                             "(train_ptv3_pooled.yaml config)"},
    "bristrunet": {},
}

# The reference repository's own figures (its model_performance_comparison.csv
# rows 2-5, BASELINE.md), which name no card; the CSV's DGCNN row is the k=32
# eva config (1,546,245 params). Printed beside the port's as
# reference_gpu_points_per_sec; vs_reference is the port's points/s over it.
REFERENCE_POINTS_PER_SEC: Dict[str, float] = {
    "pointnet": 5_852_032.0,
    "dgcnn_k32": 2_916.0,
    "pointnet2_ssg": 35_557.0,
    "pointnet2": 35_557.0,
    "bristrunet": 43_465.0,
    "bridgeseg": 43_465.0,
}

WARMUP = 3  # untimed calls before the timed ones, forwards and train steps


def timed_median(fn: Callable, calls: int, dev: torch.device) -> float:
    """Median seconds of ``calls`` calls of ``fn``, each between CUDA events
    on the card, on the host clock on the CPU."""
    times = []
    for _ in range(calls):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def host_rss_mb() -> float:
    """This process's resident set, VmRSS of /proc/self/status, in MiB."""
    with open("/proc/self/status") as f:
        kib = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return round(kib / 1024, 1)


def build_row(
    name: str,
    num_classes: int = 5,
    batch_size: int = 4,
    num_points: int = 4096,
    model_kwargs: Optional[Dict] = None,
    device: str = "auto",
) -> tuple:
    """One zoo row on ``device`` (the card unless "cpu") -> (model in eval
    mode, its batch {"points", "colors", "labels"} from seed 0, its train
    step (a call is one step of plain cross-entropy and Adam, wd 1e-4, lr
    1e-3), the row's config note). The model's init draws from
    ``torch.Generator().manual_seed(0)`` on the host."""
    dev = resolve_device(device)
    if dev.type == "cuda":  # the port computes in full float32 (train/loop.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model_kwargs = dict(model_kwargs or {})
    registry_name = model_kwargs.pop("_model", name)
    config_note = model_kwargs.pop("_note", None)
    feature_dim = 3
    if "_feature_dim" in model_kwargs:
        feature_dim = model_kwargs.pop("_feature_dim")
        model_kwargs["in_features"] = feature_dim
    model = get_model(registry_name, num_classes, generator=torch.Generator().manual_seed(0),
                      **model_kwargs)
    model.to(dev).eval()
    rng = np.random.default_rng(0)
    xyz = rng.uniform(size=(batch_size, num_points, 3)).astype(np.float32)
    feats = rng.uniform(size=(batch_size, num_points, feature_dim)).astype(np.float32)
    labels = rng.integers(0, num_classes, (batch_size, num_points))
    batch = {"points": torch.from_numpy(xyz).to(dev), "colors": torch.from_numpy(feats).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    loss_cfg = Config().loss
    loss_cfg.name = "ce"
    loss_cfg.use_class_weights = False
    train_step = make_train_step(model, loss_cfg, make_optimizer(model.parameters()))
    cw = torch.ones(num_classes, device=dev)
    return model, batch, lambda: train_step(batch, 1e-3, cw), config_note


def evaluate_model(
    name: str,
    num_classes: int = 5,
    batch_size: int = 4,
    num_points: int = 4096,
    iters: int = 10,
    train_iters: int = 5,
    steps_per_epoch: int = 100,
    model_kwargs: Optional[Dict] = None,
    device: str = "auto",
) -> Dict[str, Any]:
    """Benchmark one model on ``device`` (the card unless "cpu"); returns
    the eva_model CSV row fields. ``device_peak_mb`` is the allocator's
    peak over one forward, on the card only. A row runs WARMUP + ``iters``
    + 1 forwards and WARMUP + ``train_iters`` train steps."""
    dev = resolve_device(device)
    model, batch, step, config_note = build_row(name, num_classes, batch_size, num_points,
                                                model_kwargs, device)
    n_params = sum(p.numel() for p in model.parameters())
    xyz, feats = batch["points"], batch["colors"]

    with torch.inference_mode():
        for _ in range(WARMUP):
            model(xyz, feats)
        fwd_s = timed_median(lambda: model(xyz, feats), iters, dev)
        device_mem_mb = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            model(xyz, feats)
            torch.cuda.synchronize(dev)
            device_mem_mb = round(torch.cuda.max_memory_allocated(dev) / 1024 / 1024, 1)
    pts_per_sec = batch_size * num_points / fwd_s

    for _ in range(WARMUP):
        step()
    train_s = timed_median(step, train_iters, dev)

    row = {
        "model": name,
        "params": int(n_params),
        "model_size_mb": round(n_params * 4 / 1024 / 1024, 2),
        "inference_ms": round(fwd_s * 1e3, 3),
        "points_per_sec": round(pts_per_sec, 1),
        "train_step_ms": round(train_s * 1e3, 2),
        "est_epoch_time_s": round(train_s * steps_per_epoch, 1),
    }
    if device_mem_mb is not None:
        row["device_peak_mb"] = device_mem_mb
    if config_note:
        row["config_note"] = config_note
    ref = REFERENCE_POINTS_PER_SEC.get(name)
    if ref:
        row["reference_gpu_points_per_sec"] = ref
        row["vs_reference"] = round(pts_per_sec / ref, 2)
    row["host_rss_mb"] = host_rss_mb()
    return row


def run_benchmark(
    zoo: Optional[Dict[str, Dict]] = None,
    out_dir: str = "results_torch",
    **kwargs,
) -> List[Dict[str, Any]]:
    """Every row of ``zoo`` (DEFAULT_ZOO) through :func:`evaluate_model`; a
    row that raises becomes {"model", "error"} and the sweep goes on. Writes
    ``out_dir/model_performance_comparison.csv`` and, where matplotlib
    imports, the charts."""
    zoo = zoo if zoo is not None else DEFAULT_ZOO
    rows = []
    for name, mkw in zoo.items():
        try:
            row = evaluate_model(name, model_kwargs=mkw, **kwargs)
        except Exception as e:  # keep the sweep alive (eva_model.py behavior)
            row = {"model": name, "error": str(e)[:200]}
        rows.append(row)
        print(row, flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    os.makedirs(out_dir, exist_ok=True)
    save_results_csv(rows, os.path.join(out_dir, "model_performance_comparison.csv"))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return rows
    _charts(rows, out_dir)
    return rows


def save_results_csv(rows: List[Dict[str, Any]], path: str) -> None:
    fields = sorted({k for r in rows for k in r})
    lead = [f for f in ("model", "params", "model_size_mb", "inference_ms",
                        "points_per_sec", "train_step_ms", "est_epoch_time_s")
            if f in fields]
    fields = lead + [f for f in fields if f not in lead]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def _charts(rows: List[Dict[str, Any]], out_dir: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ok = [r for r in rows if "points_per_sec" in r]
    if not ok:
        return
    names = [r["model"] for r in ok]
    for key, title in [
        ("points_per_sec", "Inference throughput (points/sec)"),
        ("inference_ms", "Inference latency (ms)"),
        ("params", "Parameters"),
        ("train_step_ms", "Train step (ms)"),
    ]:
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.bar(names, [r[key] for r in ok])
        ax.set_title(title)
        ax.tick_params(axis="x", rotation=30)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{key}.png"), dpi=150)
        plt.close(fig)

    # radar chart of normalized metrics (eva_model.py:281-382 radar)
    axes_keys = ["points_per_sec", "inference_ms", "params", "train_step_ms"]
    vals = np.array([[r[k] for k in axes_keys] for r in ok], float)
    # lower-is-better columns inverted, then max-normalize
    for j, k in enumerate(axes_keys):
        if k != "points_per_sec":
            vals[:, j] = 1.0 / np.maximum(vals[:, j], 1e-9)
    vals = vals / np.maximum(vals.max(axis=0, keepdims=True), 1e-12)
    ang = np.linspace(0, 2 * np.pi, len(axes_keys), endpoint=False).tolist()
    ang += ang[:1]
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, polar=True)
    for name, row in zip(names, vals):
        data = row.tolist() + row[:1].tolist()
        ax.plot(ang, data, label=name)
        ax.fill(ang, data, alpha=0.08)
    ax.set_xticks(ang[:-1])
    ax.set_xticklabels(["throughput", "1/latency", "1/params", "1/train_ms"])
    ax.legend(loc="upper right", bbox_to_anchor=(1.25, 1.1), fontsize=8)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "radar.png"), dpi=150)
    plt.close(fig)


def main(argv=None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="auto", help="auto or cuda (the card), or cpu")
    ap.add_argument("--out", default="results_torch", help="directory of the CSV and charts")
    args = ap.parse_args(argv)
    return run_benchmark(DEFAULT_ZOO, out_dir=args.out, device=args.device)


if __name__ == "__main__":
    main()
