"""The port's zoo sweep (``bench/eva_model.py``) against the JAX package's,
on the CPU.

- ``DEFAULT_ZOO`` has the JAX module's rows and kwargs (the ``_note`` text
  apart), and ``REFERENCE_POINTS_PER_SEC`` its figures.
- One case a row: the port's parameter count (``numel`` over
  ``parameters()``) equals the flax count of the same row's init, read by
  ``jax.eval_shape`` (nothing is compiled).
- ``evaluate_model`` on the CPU returns the JAX row's keys but the
  device's peak; ``save_results_csv`` writes the JAX module's bytes;
  ``run_benchmark`` keeps a failing row as {"model", "error"} beside a full
  one and draws its charts only where matplotlib imports; without a card,
  ``device="auto"`` raises; the package imports no JAX.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.bench import eva_model as jeva
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu_torch.bench import eva_model as eva
from pointcloud_bridge_tpu_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of a JAX row (eva_model.py:224-248) for a row with a note and a
# reference figure; host_rss_mb where psutil imports
JAX_ROW_KEYS = ("model", "params", "model_size_mb", "inference_ms", "points_per_sec",
                "train_step_ms", "est_epoch_time_s", "device_peak_mb", "config_note",
                "reference_gpu_points_per_sec", "vs_reference", "host_rss_mb")
TINY = {"sa_npoints": (32, 16, 8), "_note": "tiny"}


def without_note(kwargs: dict) -> dict:
    return {k: v for k, v in kwargs.items() if k != "_note"}


def test_default_zoo_and_reference_figures_equal_jax():
    assert list(eva.DEFAULT_ZOO) == list(jeva.DEFAULT_ZOO)
    assert len(eva.DEFAULT_ZOO) == 14
    for name, kwargs in jeva.DEFAULT_ZOO.items():
        assert without_note(eva.DEFAULT_ZOO[name]) == without_note(kwargs), name
        assert ("_note" in eva.DEFAULT_ZOO[name]) == ("_note" in kwargs), name
    assert eva.REFERENCE_POINTS_PER_SEC == jeva.REFERENCE_POINTS_PER_SEC


@pytest.mark.parametrize("name", list(jeva.DEFAULT_ZOO))
def test_row_parameter_count_equals_flax(name):
    kwargs = dict(jeva.DEFAULT_ZOO[name])
    registry_name = kwargs.pop("_model", name)
    kwargs.pop("_note", None)
    feature_dim = kwargs.pop("_feature_dim", 3)
    jmodel = jax_get_model(registry_name, num_classes=5, **kwargs)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda x, f: jmodel.init({"params": key, "dropout": key, "sampling": key}, x, f,
                                 train=False),
        jax.ShapeDtypeStruct((1, 4096, 3), np.float32),
        jax.ShapeDtypeStruct((1, 4096, feature_dim), np.float32))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    if feature_dim != 3:
        kwargs["in_features"] = feature_dim
    got = sum(p.numel() for p in get_model(registry_name, 5, **kwargs).parameters())
    assert got == want
    if name == "dgcnn_k32":
        assert got == 1_546_245  # the reference CSV's DGCNN row (tests/test_zoo_round2.py)


def test_evaluate_model_row_on_the_cpu():
    row = eva.evaluate_model("pointnet2_ssg", num_points=128, iters=2, train_iters=1,
                             device="cpu", model_kwargs=dict(TINY))
    assert set(row) == set(JAX_ROW_KEYS) - {"device_peak_mb"}
    assert list(row)[:7] == list(JAX_ROW_KEYS[:7])
    want = sum(p.numel() for p in get_model("pointnet2_ssg", 5, sa_npoints=(32, 16, 8))
               .parameters())
    assert row["model"] == "pointnet2_ssg" and row["params"] == want
    assert row["model_size_mb"] == round(want * 4 / 1024 / 1024, 2)
    assert row["config_note"] == "tiny"
    assert row["reference_gpu_points_per_sec"] == 35_557.0 and row["vs_reference"] > 0
    for key in ("inference_ms", "points_per_sec", "train_step_ms", "host_rss_mb"):
        assert np.isfinite(row[key]) and row[key] > 0, key
    assert abs(row["points_per_sec"] * row["inference_ms"] / 1e3 - 4 * 128) <= 1e-3 * 4 * 128
    assert abs(row["est_epoch_time_s"] - row["train_step_ms"] / 10) <= 0.051


def test_build_row_gives_the_row_model_batch_and_step_on_the_cpu():
    """build_row: the row's model in eval mode, seed 0's batch of the row's
    width and labels in [0, num_classes), and a step that trains it."""
    kwargs = {"_model": "pointnet2_ssg", "_feature_dim": 9, "sa_npoints": (32, 16, 8),
              "_note": "tiny"}
    model, batch, step, note = eva.build_row("ssg9", num_points=128, model_kwargs=kwargs,
                                             device="cpu")
    assert note == "tiny" and not model.training
    assert batch["points"].shape == (4, 128, 3) and batch["colors"].shape == (4, 128, 9)
    assert batch["labels"].shape == (4, 128) and 0 <= int(batch["labels"].min())
    assert int(batch["labels"].max()) < 5
    with torch.inference_mode():
        assert model(batch["points"], batch["colors"]).shape == (4, 128, 5)
    before = [p.detach().clone() for p in model.parameters()]
    assert np.isfinite(float(step()["loss"]))
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


ROWS = [
    {"model": "a", "params": 10, "model_size_mb": 0.0, "inference_ms": 1.5,
     "points_per_sec": 10922.7, "train_step_ms": 3.25, "est_epoch_time_s": 0.3,
     "device_peak_mb": 12.5, "config_note": "note, with a comma", "host_rss_mb": 100.1},
    {"model": "b", "error": 'CUDA out of memory "quoted"\nsecond line'},
    {"model": "c", "params": 7, "model_size_mb": 0.0, "inference_ms": 0.25,
     "points_per_sec": 65536.0, "train_step_ms": 1.0, "est_epoch_time_s": 0.1,
     "reference_gpu_points_per_sec": 35557.0, "vs_reference": 1.84},
]


def test_save_results_csv_writes_the_jax_bytes(tmp_path):
    eva.save_results_csv(ROWS, str(tmp_path / "port.csv"))
    jeva.save_results_csv(ROWS, str(tmp_path / "jax.csv"))
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert got.startswith(b"model,params,model_size_mb,inference_ms,points_per_sec,"
                          b"train_step_ms,est_epoch_time_s,")


def test_run_benchmark_keeps_a_failing_row_and_guards_the_charts(tmp_path, monkeypatch):
    zoo = {"pointnet2_ssg": dict(TINY), "no_such_model": {}}
    kw = dict(num_points=64, iters=1, train_iters=1, device="cpu")
    rows = eva.run_benchmark(zoo, out_dir=str(tmp_path / "with"), **kw)
    assert [r["model"] for r in rows] == ["pointnet2_ssg", "no_such_model"]
    assert "error" not in rows[0] and rows[0]["points_per_sec"] > 0
    assert set(rows[1]) == {"model", "error"} and "unknown model" in rows[1]["error"]
    csv_path = tmp_path / "with" / "model_performance_comparison.csv"
    assert csv_path.read_text().splitlines()[0].startswith("model,params,")
    assert len(csv_path.read_text().splitlines()) == 3
    assert (tmp_path / "with" / "radar.png").exists()
    # where matplotlib does not import (the card's machine), no chart
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rows = eva.run_benchmark({"no_such_model": {}}, out_dir=str(tmp_path / "without"), **kw)
    assert set(rows[0]) == {"model", "error"}
    assert sorted(p.name for p in (tmp_path / "without").iterdir()) == [
        "model_performance_comparison.csv"]


def test_the_card_is_the_default_device(tmp_path):
    """With no card, "auto" raises, and in a sweep every row says so."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eva.evaluate_model("pointnet2_ssg", model_kwargs=dict(TINY))
    rows = eva.run_benchmark({"pointnet2_ssg": dict(TINY)}, out_dir=str(tmp_path))
    assert set(rows[0]) == {"model", "error"} and "no CUDA device" in rows[0]["error"]


def test_bench_imports_no_jax():
    """A fresh interpreter imports the port's bench package and both of its
    modules; neither JAX nor any module of the JAX package (nor matplotlib)
    enters sys.modules."""
    code = (
        "import sys\n"
        "import pointcloud_bridge_tpu_torch.bench as b\n"
        "from pointcloud_bridge_tpu_torch.bench import convergence_parity, eva_model\n"
        "assert b.__all__ == ['evaluate_model', 'run_benchmark', 'save_results_csv']\n"
        "bad = [k for k in sys.modules\n"
        "       if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'matplotlib')\n"
        "       or k == 'pointcloud_bridge_tpu' or k.startswith('pointcloud_bridge_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
