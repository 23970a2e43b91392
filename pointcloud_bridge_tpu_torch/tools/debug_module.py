"""Model smoke test CLI (counterpart of pointcloud_bridge_tpu/tools/
debug_module.py; the reference's tools/debug_module.py:6-101): a
random-input forward, the parameter count, and a per-batch-size sweep of
points/s and peak device memory.

  python -m pointcloud_bridge_tpu_torch.tools.debug_module pointnet2_ssg \\
      --batch-sizes 1,2,4,8 --device cuda

On the card a batch size's points/s is B * N over the median of ``reps``
timings, each of ``iters`` eager forwards between two CUDA events, and its
peak is ``torch.cuda.max_memory_allocated`` over those forwards (MiB, the
statistics reset first). ``--device cpu`` times with the host clock and
reports no peak. As in the JAX tool, a batch size that fails is reported
(``b{B}_error``) and the sweep goes on.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch


def _seconds_a_call(fn, dev, iters: int = 6, reps: int = 3) -> float:
    fn()  # warm up: a first shape loads the kernels' library
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) / iters)
    return statistics.median(times)


def smoke_test(
    name: str,
    num_classes: int = 5,
    num_points: int = 4096,
    batch_sizes=(1, 2, 4, 8),
    model_kwargs=None,
    device: str = "cuda",
):
    from ..models import get_model
    from ..train.loop import resolve_device

    dev = resolve_device(device)
    model = get_model(name, num_classes=num_classes,
                      generator=torch.Generator().manual_seed(0), **(model_kwargs or {}))
    model.to(dev).eval()
    rng = np.random.default_rng(0)
    results = {"model": name}

    def uniform(b):
        return torch.as_tensor(rng.uniform(size=(b, num_points, 3)), dtype=torch.float32,
                               device=dev)

    xyz1, feats1 = uniform(1), uniform(1)
    n_params = sum(p.numel() for p in model.parameters())
    results["params"] = int(n_params)
    with torch.no_grad():
        out = model(xyz1, feats1)
    results["output_shape"] = tuple(out.shape)
    print(f"{name}: params={n_params:,} out={tuple(out.shape)}", flush=True)

    for b in batch_sizes:
        xyz, feats = uniform(b), uniform(b)
        try:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            with torch.no_grad():
                pps = b * num_points / _seconds_a_call(lambda: model(xyz, feats), dev)
            results[f"b{b}_points_per_sec"] = round(pps, 1)
            if dev.type == "cuda":
                peak = torch.cuda.max_memory_allocated(dev) / 2**20
                results[f"b{b}_peak_mib"] = round(peak, 1)
                print(f"  B={b}: {pps:,.0f} pts/s peak_mem={peak:.0f}MB", flush=True)
            else:
                print(f"  B={b}: {pps:,.0f} pts/s", flush=True)
        except Exception as e:
            print(f"  B={b}: failed ({str(e)[:120]})", flush=True)
            results[f"b{b}_error"] = str(e)[:200]
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="model smoke test")
    ap.add_argument("model")
    ap.add_argument("--num-classes", type=int, default=5)
    ap.add_argument("--num-points", type=int, default=4096)
    ap.add_argument("--batch-sizes", default="1,2,4,8")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    args = ap.parse_args(argv)
    smoke_test(
        args.model,
        args.num_classes,
        args.num_points,
        tuple(int(x) for x in args.batch_sizes.split(",")),
        device=args.device,
    )


if __name__ == "__main__":
    main()
