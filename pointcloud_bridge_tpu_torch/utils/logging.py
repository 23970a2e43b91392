"""Experiment logging: root logger to file+stream (utils/logger_config.py:5-53
contract), CSV scalar writer, and optional TensorBoard (torch's writer when
importable — the reference logs Loss/Acc/LR/Class_Accuracy per epoch,
train_MulSca_PN2.py:278-287)."""

from __future__ import annotations

import csv
import logging
import os
import sys
from typing import Dict, Optional


def initialize_logger(exp_dir: str, name: str = "training") -> logging.Logger:
    os.makedirs(exp_dir, exist_ok=True)
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    fh = logging.FileHandler(os.path.join(exp_dir, f"{name}.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


class ScalarWriter:
    """CSV scalar logger (one row per step/epoch) + optional TensorBoard."""

    def __init__(self, exp_dir: str, use_tensorboard: bool = True):
        os.makedirs(exp_dir, exist_ok=True)
        self.csv_path = os.path.join(exp_dir, "scalars.csv")
        self._rows = []
        self._fields = ["step"]
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(exp_dir, "tensorboard"))
            except Exception:
                self.tb = None

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        row = {"step": step}
        for k, v in scalars.items():
            row[k] = float(v)
            if k not in self._fields:
                self._fields.append(k)
            if self.tb is not None:
                self.tb.add_scalar(k, float(v), step)
        self._rows.append(row)
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields)
            w.writeheader()
            w.writerows(self._rows)

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()


def snapshot_code(exp_dir: str) -> None:
    """Copy the framework package into the experiment dir for reproducibility
    (the reference snapshots models/ + utils/, train_MulSca_PN2.py:116-121,
    and inference re-imports from the snapshot, inference.py:72-78)."""
    import shutil

    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(exp_dir, "code_snapshot", os.path.basename(src))
    if not os.path.exists(dst):
        shutil.copytree(
            src, dst, ignore=shutil.ignore_patterns("__pycache__", "*.pyc")
        )


def load_snapshot_models(exp_dir: str):
    """Import the experiment's code snapshot and return ITS `get_model`.

    Reproducibility device from the reference: inference re-imports model
    code from the experiment snapshot dir (inference.py:72-78) so results
    are reproducible even after the working tree moves on. The snapshot
    package is loaded under an alias (one per exp_dir), leaving the
    installed package untouched.
    """
    import importlib
    import importlib.util
    import sys

    pkg_name = os.path.basename(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    pkg_dir = os.path.join(exp_dir, "code_snapshot", pkg_name)
    if not os.path.isdir(pkg_dir):
        raise FileNotFoundError(f"no code snapshot under {exp_dir}")
    alias = "pcb_snapshot_" + hex(abs(hash(os.path.abspath(exp_dir))))[2:12]
    if alias not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            alias,
            os.path.join(pkg_dir, "__init__.py"),
            submodule_search_locations=[pkg_dir],
        )
        mod = importlib.util.module_from_spec(spec)
        sys.modules[alias] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(alias + ".models").get_model
