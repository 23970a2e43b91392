"""The PyTorch port's block inference and metrics against the JAX package,
on the CPU, and the port's import graph (no JAX)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.data import BlockDataset, make_training_blocks
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu.infer.blocks import (
    run_block_inference as jax_run_block_inference,
)
from pointcloud_bridge_tpu.models.pointnet2 import PointNet2SSG as JaxSSG
from pointcloud_bridge_tpu.utils import metrics as jax_metrics
from pointcloud_bridge_tpu_torch.infer import run_block_inference, save_metrics_csv
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.utils import metrics
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict

from test_torch_ssg import randomize_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SA_NPOINTS = (64, 32, 16)


@pytest.fixture(scope="module")
def served():
    """7 blocks of 256 points from two toy scenes (batch 4: one full batch
    and an overlapping tail), run through both packages' block inference
    with the same weights."""
    blocks, names = [], []
    for seed in (0, 1):
        xyz, rgb, labels = toy_bridge_scene(8000, seed=seed)
        name = f"scene{seed}"
        blocks += make_training_blocks(
            xyz, rgb, labels, num_points=256, block_size=4.0, sample_rate=0.3,
            file_name=name, seed=seed,
        )[:4 if seed == 0 else 3]
        names.append(name)
    ds = BlockDataset.from_blocks(blocks, names)
    jmodel = JaxSSG(num_classes=5, sa_npoints=SA_NPOINTS)
    x0 = jnp.asarray(ds.points[:1])
    c0 = jnp.asarray(ds.colors[:1])
    variables = randomize_bn(
        jax.jit(lambda a, b: jmodel.init(jax.random.PRNGKey(1), a, b, train=False))(x0, c0)
    )
    want = jax_run_block_inference(jmodel, variables, ds, num_classes=5, batch_size=4)
    model = get_model("pointnet2_ssg", num_classes=5, sa_npoints=SA_NPOINTS)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    got = run_block_inference(model, ds, num_classes=5, batch_size=4, device="cpu")
    return ds, want, got


def test_block_inference_predictions_match_jax(served):
    ds, want, got = served
    assert got["predictions"].shape == (len(ds), ds.num_points) == (7, 256)
    assert got["predictions"].dtype == np.int32
    np.testing.assert_array_equal(got["predictions"], want["predictions"])


@pytest.mark.parametrize("key", ["mIoU", "OA", "mAcc", "Precision", "Recall", "F1_score"])
def test_block_inference_metrics_match_jax(served, key):
    _, want, got = served
    assert got["global"][key] == want["global"][key]
    assert set(got["per_file"]) == set(want["per_file"]) == {"scene0", "scene1"}
    for name in want["per_file"]:
        assert got["per_file"][name][key] == want["per_file"][name][key]


def test_save_metrics_csv(served, tmp_path):
    got = served[2]
    path = save_metrics_csv(got, str(tmp_path))
    txt = open(path).read()
    assert "GLOBAL" in txt and "scene0" in txt and "IoU_class_4" in txt
    cm = np.loadtxt(tmp_path / "confusion_matrix.csv", delimiter=",")
    np.testing.assert_array_equal(cm, got["global"]["Confusion_Matrix"])


def test_metrics_match_jax(rng):
    preds = rng.integers(0, 4, size=(3, 50)).astype(np.int32)
    labels = rng.integers(0, 4, size=(3, 50)).astype(np.int32)
    cm = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), 4)
    want_cm = np.asarray(
        jax_metrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), 4)
    )
    np.testing.assert_array_equal(cm.numpy(), want_cm)
    got = metrics.metrics_from_confusion(cm)
    want = jax_metrics.metrics_from_confusion(want_cm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port and runs a small
    forward and a block inference; JAX never enters sys.modules."""
    code = (
        "import sys, numpy as np, torch\n"
        "import pointcloud_bridge_tpu_torch.ops._kernels\n"
        "from pointcloud_bridge_tpu_torch import ops, models, infer\n"
        "from pointcloud_bridge_tpu_torch.utils import weights, metrics\n"
        "from pointcloud_bridge_tpu.data import BlockDataset\n"
        "m = models.get_model('pointnet2_ssg', 5, sa_npoints=(32, 16, 8),\n"
        "                     generator=torch.Generator().manual_seed(0))\n"
        "rng = np.random.default_rng(0)\n"
        "pts = rng.uniform(size=(2, 64, 3)).astype(np.float32)\n"
        "ds = BlockDataset(pts, pts, np.zeros((2, 64), np.int64), pts,\n"
        "                  np.zeros((2, 64), np.int64), np.zeros(2, np.int64), ['a'])\n"
        "res = infer.run_block_inference(m, ds, 5, batch_size=2)\n"
        "assert res['predictions'].shape == (2, 64)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'flax'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
