"""Hyperparameter grid search for the WL pipeline
(Partsize-identical/tool_utils/optimize_parameter.py:286-360 capability:
ParameterGrid sweep, multiprocess pool, chunked evaluation, best-by-mean-error).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .wl_iden import run_wl_identification


def parameter_grid(grid: Dict[str, Sequence]) -> List[Dict]:
    """Expand {name: [values...]} into the cross-product list of dicts
    (sklearn ParameterGrid equivalent)."""
    keys = sorted(grid)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(grid[k] for k in keys))
    ]


def _eval_one(args):
    cases, hp, device = args
    rows = run_wl_identification(cases, out_csv=None, hyperparams=hp, device=device)
    mean_err = float(np.mean([r["relative_error"] for r in rows]))
    return {"params": hp, "mean_error": mean_err, "rows": rows}


def grid_search(
    cases: Sequence[Tuple[str, np.ndarray, np.ndarray]],
    grid: Dict[str, Sequence],
    processes: int = 0,
    csv_path: str | None = None,
    chunk_size: int = 0,
    device: str = "cuda",
) -> List[Dict]:
    """Evaluate every hyperparameter combination; returns results sorted by
    mean relative error (best first).

    Long-sweep workflow (optimize_parameter.py:286-360): pass `csv_path` (+
    optional `chunk_size`) to evaluate the grid in chunks and APPEND each
    chunk's rows to the CSV as it completes — a crash loses at most one
    chunk, and re-running the same sweep resumes by skipping combinations
    already present in the CSV.

    With ``processes`` > 1 the combinations run in a pool of worker
    processes started by "spawn": a forked child cannot use CUDA once the
    parent has initialised it. Each worker runs its stages on ``device``.
    """
    import csv
    import json
    import os

    combos = parameter_grid(grid)

    done: set = set()
    if csv_path and os.path.exists(csv_path):
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f):
                done.add(row["params"])
    todo = [hp for hp in combos if json.dumps(hp, sort_keys=True) not in done]

    def run_chunk(chunk):
        tasks = [(list(cases), hp, device) for hp in chunk]
        if processes and processes > 1:
            import multiprocessing as mp

            with mp.get_context("spawn").Pool(processes) as pool:
                return pool.map(_eval_one, tasks)
        return [_eval_one(t) for t in tasks]

    results: List[Dict] = []
    step = chunk_size if chunk_size > 0 else max(1, len(todo))
    for s in range(0, len(todo), step):
        chunk_results = run_chunk(todo[s : s + step])
        results.extend(chunk_results)
        if csv_path:
            new_file = not os.path.exists(csv_path)
            with open(csv_path, "a", newline="") as f:
                w = csv.writer(f)
                if new_file:
                    w.writerow(["params", "mean_error"])
                for r in chunk_results:
                    w.writerow(
                        [json.dumps(r["params"], sort_keys=True),
                         r["mean_error"]]
                    )
    return sorted(results, key=lambda r: r["mean_error"])
