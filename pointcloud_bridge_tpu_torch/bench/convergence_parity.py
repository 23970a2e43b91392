"""From-scratch convergence of the port's SSG on the JAX package's synthetic
task (counterpart of pointcloud_bridge_tpu/bench/convergence_parity.py).

The same synthetic scenes, splits and hyperparameters as the JAX module: 4
classes given by fixed height slabs of z + 0.08 * r, batches of 4 x 512
points, SA levels (128, 64, 16), 25 steps x 6 epochs of Adam (lr 1e-3, L2
1e-4 folded in before the moments), plain cross-entropy, seeds 0-2. After
each epoch the model is evaluated in eval mode on 4 held-out batches and
the mean mIoU over them is the curve's point.

:func:`run_port` is the counterpart of the JAX module's ``run_ours``. It
builds SSG through the port's registry with a ``torch.Generator`` seeded
from ``seed`` (the init, and on the run's device the dropout masks), or
from a flax variables tree (``init``, through ``utils/weights.py``), so
that the tests can start both packages from the same weights. The JAX
module's ``run_torch`` executes a checkout of the reference repository
that this repository does not hold; it has no counterpart here.

Usage (on the card; ``--device cpu`` for a host run):
    python -m pointcloud_bridge_tpu_torch.bench.convergence_parity \
        [--device cuda] [--out results_torch] [--streams K]
Writes ``<out>/convergence_parity.json`` and prints each curve. With
``--streams K`` each seed runs K times from its init, the dropout masks
drawn from K streams, which shows how far one run's final mIoU spreads.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..models import Dropout, get_model
from ..train.loop import make_optimizer, make_train_step, resolve_device
from ..utils.weights import flax_to_state_dict

NUM_CLASSES = 4
B, N = 4, 512
SA = (128, 64, 16)
STEPS_PER_EPOCH = 25
EPOCHS = 6
LR, WD = 1e-3, 1e-4
SEEDS = (0, 1, 2)
# How far two float32 runs of SSG's first steps from one init may part, at
# dropout 0: the largest relative gap of the loss at step t + 1. Adam's
# first steps follow the sign of each gradient, so a parameter whose
# gradient is rounding noise moves by a whole lr in the noise's sign, and 17
# train-mode BatchNorms carry that on: two runs that differ only in the
# order of their float32 sums part by about 10x a step at first. Step 1 is
# held to a train step's own loss tolerance; steps 2-8 to four times the
# largest gap measured so far, rounded up, and never below an earlier
# step's band. The readings: the card against the CPU (chip_smoke.py phase
# 46a, H100) 8.2e-8, 3.9e-5, 2.3e-3, 6.4e-3, 8.6e-3, 3.8e-3, 9.4e-3,
# 3.9e-3; the CPU at 1, 2, 3, 4 and 8 threads (tests/
# test_torch_bench_convergence.py, slow) up to 0, 1.7e-6, 1.6e-4, 7.2e-4,
# 1.6e-3, 3.8e-3, 7.4e-3, 5.7e-3. Dropping 1/32 of sa2's or sa3's input
# gradient parts the loss by 1.1e-3 or more at step 2 (the same test)
FLOAT32_LOSS_BANDS = (1e-5, 2e-4, 1e-2, 3e-2, 4e-2, 4e-2, 4e-2, 4e-2)


def make_data(seed):
    rng = np.random.default_rng(seed)

    def batch():
        xyz = rng.uniform(size=(B, N, 3)).astype(np.float32)
        rgb = rng.uniform(size=(B, N, 3)).astype(np.float32)
        z = xyz[..., 2] + 0.08 * rgb[..., 0]
        # fixed global slab edges (z in (0, 1.08)) so the label function is
        # identical across batches/seeds — a genuinely learnable target
        edges = np.array([0.27, 0.54, 0.81])
        labels = np.digitize(z, edges).astype(np.int64)
        return xyz, rgb, labels

    train = [batch() for _ in range(STEPS_PER_EPOCH * EPOCHS)]
    val = [batch() for _ in range(4)]
    return train, val


def miou_from_preds(preds, labels):
    ious = []
    for c in range(NUM_CLASSES):
        inter = np.sum((preds == c) & (labels == c))
        union = np.sum((preds == c) | (labels == c))
        if union:
            ious.append(inter / union)
    return float(np.mean(ious)) if ious else 0.0


def _tensors(xyz, rgb, dev, dtype):
    return (torch.from_numpy(xyz).to(dev, dtype), torch.from_numpy(rgb).to(dev, dtype))


def evaluate(model: torch.nn.Module, val, dtype=torch.float32) -> tuple:
    """(mean mIoU over the batches, their argmax predictions) in eval mode."""
    dev = next(model.parameters()).device
    model.eval()
    preds, ious = [], []
    with torch.inference_mode():
        for xyz, rgb, labels in val:
            p = model(*_tensors(xyz, rgb, dev, dtype)).argmax(-1).cpu().numpy()
            preds.append(p)
            ious.append(miou_from_preds(p, labels))
    return float(np.mean(ious)), preds


def make_port(seed: int, device: str = "auto", init: Optional[Dict] = None,
              dtype: torch.dtype = torch.float32, dropout_seed: Optional[int] = None,
              **model_kwargs):
    """SSG at the convergence configuration and its train step -> (model,
    step), where ``step(xyz, rgb, labels)`` runs one Adam step on a numpy
    batch and returns its loss (a tensor on the device).

    The init draws from ``torch.Generator().manual_seed(seed)``; ``init`` (a
    flax variables tree of the JAX SSG) replaces it. The dropout masks draw
    from a generator on the device seeded from ``dropout_seed`` (``seed``
    when None). ``dtype`` is the model's and the batches' type (float64 in
    the tests that hold the port to the JAX package's float64 steps).
    ``model_kwargs`` go to the registry (``dropout_rate=0.0`` in those
    tests)."""
    dev = resolve_device(device)
    if dev.type == "cuda":  # the port computes in full float32 (train/loop.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    model = get_model("pointnet2_ssg", NUM_CLASSES, sa_npoints=SA, generator=gen,
                      **model_kwargs)
    if init is not None:
        model.load_state_dict(flax_to_state_dict(init), strict=True)
    model.to(dev, dtype)
    dropout_gen = torch.Generator(device=dev).manual_seed(
        seed if dropout_seed is None else dropout_seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = dropout_gen
    loss_cfg = Config().loss
    loss_cfg.name = "ce"
    loss_cfg.use_class_weights = False
    train_step = make_train_step(model, loss_cfg, make_optimizer(model.parameters(), WD))
    cw = torch.ones(NUM_CLASSES, device=dev, dtype=dtype)

    def step(xyz, rgb, labels):
        points, colors = _tensors(xyz, rgb, dev, dtype)
        batch = {"points": points, "colors": colors, "labels": torch.from_numpy(labels).to(dev)}
        return train_step(batch, LR, cw)["loss"]

    return model, step


def train_port(train, val, seed: int, device: str = "auto", init: Optional[Dict] = None,
               epochs: int = EPOCHS, steps_per_epoch: int = STEPS_PER_EPOCH,
               dtype: torch.dtype = torch.float32, dropout_seed: Optional[int] = None,
               **model_kwargs) -> Dict[str, Any]:
    """Train SSG from scratch on ``train``, evaluating on ``val`` after each
    epoch -> {"curve": mIoU per epoch, "losses": the loss of each step,
    "model": the trained model}. The arguments after ``steps_per_epoch``
    are :func:`make_port`'s."""
    model, step = make_port(seed, device, init, dtype, dropout_seed, **model_kwargs)
    curve, losses = [], []
    for e in range(epochs):
        for xyz, rgb, labels in train[e * steps_per_epoch:(e + 1) * steps_per_epoch]:
            losses.append(step(xyz, rgb, labels))
        curve.append(evaluate(model, val, dtype)[0])
    return {"curve": curve, "losses": [float(x) for x in torch.stack(losses).cpu()],
            "model": model}


def run_port(train, val, seed: int, device: str = "auto", init: Optional[Dict] = None,
             epochs: int = EPOCHS, steps_per_epoch: int = STEPS_PER_EPOCH,
             dropout_seed: Optional[int] = None) -> list:
    """The mIoU curve of :func:`train_port` (the JAX module's ``run_ours``)."""
    return train_port(train, val, seed, device, init, epochs, steps_per_epoch,
                      dropout_seed=dropout_seed)["curve"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="auto", help="auto or cuda (the card), or cpu")
    ap.add_argument("--out", default="results_torch", help="directory of the JSON")
    ap.add_argument("--streams", type=int, default=1,
                    help="runs a seed, each from the seed's init with dropout masks "
                         "seeded from seed + 1000 * stream (stream 0: the seed's own); "
                         "more than 1 measures the spread of a single run")
    args = ap.parse_args(argv)
    results = {"config": dict(
        num_classes=NUM_CLASSES, batch=B, points=N, sa_npoints=SA,
        steps_per_epoch=STEPS_PER_EPOCH, epochs=EPOCHS, lr=LR, wd=WD,
        seeds=list(SEEDS), streams=args.streams,
        init_note=(
            "port: the registry's init from torch.Generator().manual_seed(seed), "
            "uniform in +-1/sqrt(fan_in) for weights and biases as torch's "
            "default conv init (flax: lecun-normal Dense, zero biases), so the "
            "comparison with the JAX curves is over seeds. The JAX module's "
            "'torch' half executes a checkout of the reference repository, which "
            "this repository does not hold, so it is absent; the port's steps "
            "from the JAX package's own weights are held to its float64 steps "
            "in tests/test_torch_bench_convergence.py"
        ),
    ), "port": {}}
    if args.streams > 1:
        results["port_streams"] = {}
    for seed in SEEDS:
        train, val = make_data(seed)
        curves = [run_port(train, val, seed, args.device, dropout_seed=seed + 1000 * j)
                  for j in range(args.streams)]
        results["port"][str(seed)] = curves[0]
        if args.streams > 1:
            results["port_streams"][str(seed)] = curves
        for j, curve in enumerate(curves):
            print(f"seed {seed} stream {j}: port mIoU curve {curve}", flush=True)
    final = [c[-1] for c in results["port"].values()]
    results["summary"] = {"port_final_miou_mean": float(np.mean(final)),
                          "port_final_miou_std": float(np.std(final))}
    if args.streams > 1:
        every = [c[-1] for cs in results["port_streams"].values() for c in cs]
        results["summary"] |= {"streams_final_miou_mean": float(np.mean(every)),
                               "streams_final_miou_std": float(np.std(every)),
                               "streams_runs": len(every)}
    print("summary:", json.dumps(results["summary"], indent=2))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "convergence_parity.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
