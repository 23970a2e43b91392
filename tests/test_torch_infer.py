"""The PyTorch port's block inference and metrics against the JAX package,
on the CPU, its inference CLI, and the port's import graph (no JAX, nothing
of the JAX package)."""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import ast
import contextlib
import csv
import io
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.data import BlockDataset, make_training_blocks
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu.data import scene_labelweights
from pointcloud_bridge_tpu.data.dataset import _load_scene
from pointcloud_bridge_tpu.infer import whole_scene_vote_predict as jax_vote
from pointcloud_bridge_tpu.infer.blocks import (
    run_block_inference as jax_run_block_inference,
)
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.models.pointnet2 import PointNet2SSG as JaxSSG
from pointcloud_bridge_tpu.utils import metrics as jax_metrics
from pointcloud_bridge_tpu_torch.infer import run_block_inference, save_metrics_csv
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.utils import metrics
from pointcloud_bridge_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

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
    got = run_block_inference(model, ds, num_classes=5, batch_size=4)
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


# ------------------------------------------------- the port's host layer

HOST_COPIES = [
    "data/lasio.py", "data/h5io.py", "data/blocks.py", "data/dataset.py",
    "data/augment.py", "data/native.py", "data/samplers_extra.py",
    "data/synthetic.py", "config.py", "class_names.py", "infer/figures.py",
    "infer/las_export.py", "measure/evaluation.py", "utils/hostmem.py", "tools/convert.py",
    "tools/relabel.py", "tools/downsample.py", "tools/dataset_stats.py",
    "utils/torch_import.py", "data/completion.py", "ops/avs.py",
]


def _code_without_docstrings(source):
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


# The port's repairs of the copied code, each one statement: (the JAX
# package's statement, the port's). BlockDataset.batches pads a short last
# batch by wrapping its order around; the JAX slice is too short once the
# dataset holds fewer than half a batch of blocks, np.resize takes the same
# rows wherever that slice is full.
HOST_REPAIRS = {
    "data/dataset.py": [("pad = order[: batch_size - len(sel)]",
                         "pad = np.resize(order, batch_size - len(sel))")],
}


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_layer_copy_has_the_jax_packages_code(rel):
    """The port carries its own numpy host layer: a copy of the JAX
    package's, equal statement for statement (comments and docstrings
    apart), so the two packages read and sample data the same way; the
    port's repairs (HOST_REPAIRS) are swapped into the JAX source first,
    each found there exactly once."""
    ours = os.path.join(REPO, "pointcloud_bridge_tpu_torch", rel)
    theirs = os.path.join(REPO, "pointcloud_bridge_tpu", rel)
    src = open(theirs).read()
    for old, new in HOST_REPAIRS.get(rel, []):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert _code_without_docstrings(open(ours).read()) == _code_without_docstrings(src)


# ------------------------------------------------------------ the CLI


def _write_scenes(root, n_points=2500):
    from pointcloud_bridge_tpu_torch.data import write_las

    root.mkdir()
    for seed in (0, 1):
        xyz, rgb, labels = toy_bridge_scene(n_points, seed=seed)
        write_las(str(root / f"scene{seed}.las"), xyz, rgb, labels)
    return root


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Two small LAS scenes, an SSG experiment directory written by the
    port's train_cli (one epoch on the CPU), and a BriStruNet and a
    ptv3_pooled checkpoint file saved with the port's utils/checkpoint.py."""
    from pointcloud_bridge_tpu_torch import train_cli
    from pointcloud_bridge_tpu_torch.utils.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("cli")
    data = _write_scenes(root / "data")
    cwd = os.getcwd()
    os.chdir(root)  # exp_dir_root is relative
    try:
        out = train_cli.main([
            "--train-dir", str(data), "--num-points", "128", "--batch-size", "4",
            "--num-epochs", "1", "--sampler", "random", "--device", "cpu", "--case", "cli",
        ])
    finally:
        os.chdir(cwd)
    files = {}
    for name in ("bristrunet", "ptv3_pooled"):
        model = get_model(name, 5, generator=torch.Generator().manual_seed(0))
        files[name] = str(root / f"{name}_ckpt")
        save_checkpoint(files[name], {"model": model.state_dict(), "epoch": 0})
    exp_dir = os.path.join(root, out["exp_dir"])
    assert os.path.exists(os.path.join(exp_dir, "latest_checkpoint"))
    return {"data": data, "ssg": exp_dir, "root": root, **files}


def _checkpoint_file(path):
    """The file the CLI is to restore from ``path``: an experiment
    directory's best_model, else its latest_checkpoint, else ``path``."""
    for cand in ("best_model", "latest_checkpoint"):
        if os.path.exists(os.path.join(path, cand)):
            return os.path.join(path, cand)
    return path


def _jax_side(name, checkpoint):
    """The JAX package's model at the CLI's (full) width with the weights of
    the port's checkpoint, converted by the port's rule table."""
    sd = restore_checkpoint(_checkpoint_file(checkpoint))["model"]
    return jax_get_model(name, 5), state_dict_to_flax(sd, name)


def _scene_files(cli_run):
    return [str(cli_run["data"] / f"scene{seed}.las") for seed in (0, 1)]


METRIC_TOL = 1e-3  # of a metric in [0, 1], between the CLI's numbers and the JAX package's


def _csv_rows(path):
    with open(path, newline="") as f:
        return {r["file"]: r for r in csv.DictReader(f)}


@pytest.mark.parametrize("name", ["pointnet2_ssg", "bristrunet", "ptv3_pooled"])
def test_infer_cli_blocks_on_cpu(cli_run, capsys, name):
    """``blocks`` mode against the JAX package's block inference on the same
    scenes with the checkpoint's weights: the confusion matrix on >= 99.9%
    of the points, every number of metrics.csv and of the printed GLOBAL
    line within 1e-3."""
    from pointcloud_bridge_tpu_torch import infer_cli

    key = "ssg" if name == "pointnet2_ssg" else name
    out_dir = cli_run["root"] / f"blocks_{name}"
    infer_cli.main([
        "blocks", "--checkpoint", cli_run[key], "--model", name,
        "--data-dir", str(cli_run["data"]), "--out-dir", str(out_dir),
        "--num-points", "128", "--batch-size", "8", "--device", "cpu",
    ])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("GLOBAL")][-1]
    m = re.fullmatch(r"GLOBAL mIoU=([\d.]+) OA=([\d.]+) mAcc=([\d.]+) F1=([\d.]+)", line)
    assert m, line
    assert all(0.0 <= float(v) <= 1.0 for v in m.groups())
    txt = (out_dir / "metrics.csv").read_text()
    assert "GLOBAL" in txt and "scene0" in txt and "scene1" in txt
    cm = np.loadtxt(out_dir / "confusion_matrix.csv", delimiter=",")
    assert cm.shape == (5, 5) and cm.sum() > 0 and cm.sum() % 128 == 0

    jmodel, variables = _jax_side(name, cli_run[key])
    ds = BlockDataset.from_files(_scene_files(cli_run), num_points=128, num_classes=5)
    want = jax_run_block_inference(jmodel, variables, ds, num_classes=5, batch_size=8)
    want_cm = np.asarray(want["global"]["Confusion_Matrix"])
    assert cm.sum() == want_cm.sum() == len(ds) * 128
    assert np.abs(cm - want_cm).sum() / 2 <= 1e-3 * cm.sum()
    for got, key in zip(m.groups(), ("mIoU", "OA", "mAcc", "F1_score")):
        assert abs(float(got) - want["global"][key]) <= METRIC_TOL + 5e-5, key  # 4 decimals
    rows = _csv_rows(out_dir / "metrics.csv")
    assert set(rows) == {"GLOBAL"} | set(want["per_file"])
    for fname, row in rows.items():
        ref = want["global"] if fname == "GLOBAL" else want["per_file"][fname]
        for key in ("mIoU", "OA", "mAcc", "Precision", "Recall", "F1_score"):
            assert abs(float(row[key]) - ref[key]) <= METRIC_TOL, (fname, key)
        for c, iou in enumerate(ref["IoU_per_class"]):
            got_iou = float(row[f"IoU_class_{c}"])
            assert (np.isnan(got_iou) and np.isnan(iou)) or abs(got_iou - iou) <= 5 * METRIC_TOL


_SCENE_RUNS = {}


def _cli_scene(cli_run, name):
    """One ``scene`` run of the CLI a model, shared by the tests below ->
    (the lines it printed, its output directory)."""
    from pointcloud_bridge_tpu_torch import infer_cli

    if name not in _SCENE_RUNS:
        key = "ssg" if name == "pointnet2_ssg" else name
        out_dir = cli_run["root"] / f"scene_{name}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            infer_cli.main([
                "scene", "--checkpoint", cli_run[key], "--model", name,
                "--data-dir", str(cli_run["data"]), "--out-dir", str(out_dir),
                "--num-points", "128", "--batch-size", "8", "--num-votes", "1",
                "--block-size", "8.0", "--stride", "8.0", "--export-las", "--device", "cpu",
            ])
        _SCENE_RUNS[name] = (buf.getvalue().splitlines(), out_dir)
    return _SCENE_RUNS[name]


SCENE_LINE = r"(scene\d\.las): mIoU=([\d.]+) OA=([\d.]+)"
OVERALL_LINE = r"OVERALL mIoU=([\d.]+) OA=([\d.]+)"


@pytest.mark.parametrize("name", ["pointnet2_ssg", "bristrunet", "ptv3_pooled"])
def test_infer_cli_scene_on_cpu(cli_run, name):
    from pointcloud_bridge_tpu_torch.data import read_las

    lines, out_dir = _cli_scene(cli_run, name)
    per_scene = [ln for ln in lines if re.fullmatch(SCENE_LINE, ln)]
    assert len(per_scene) == 2, lines
    overall = [ln for ln in lines if ln.startswith("OVERALL")][-1]
    m = re.fullmatch(OVERALL_LINE, overall)
    assert m and all(0.0 <= float(v) <= 1.0 for v in m.groups()), overall
    for seed in (0, 1):
        src = read_las(str(cli_run["data"] / f"scene{seed}.las"))
        las = read_las(str(out_dir / f"scene{seed}_pred.las"))
        assert len(las.xyz) == len(src.xyz)
        np.testing.assert_allclose(las.xyz, src.xyz, atol=2e-3)
        assert las.classification.min() >= 0 and las.classification.max() < 5


@pytest.mark.parametrize("name", ["pointnet2_ssg", "bristrunet", "ptv3_pooled"])
def test_infer_cli_scene_matches_jax(cli_run, name):
    """``scene`` mode against the JAX package's vote inference on the same
    scenes with the checkpoint's weights and the vote weights of all scenes
    together: the exported labels agree on >= 99.9% of the points, the
    printed per-scene and OVERALL numbers within 1e-3."""
    from pointcloud_bridge_tpu_torch.data import read_las

    lines, out_dir = _cli_scene(cli_run, name)
    per_scene = [re.fullmatch(SCENE_LINE, ln) for ln in lines if re.fullmatch(SCENE_LINE, ln)]
    overall = re.fullmatch(OVERALL_LINE, [ln for ln in lines if ln.startswith("OVERALL")][-1])
    jmodel, variables = _jax_side(name, cli_run["ssg" if name == "pointnet2_ssg" else name])
    loaded = [_load_scene(f) for f in _scene_files(cli_run)]
    lw = scene_labelweights([labels for _, _, labels in loaded], 5)
    total_cm = np.zeros((5, 5))
    for seed, (pts, cols, labels) in enumerate(loaded):
        want = jax_vote(jmodel, variables, np.concatenate([pts, cols], axis=1), labels, lw, 5,
                        block_points=128, block_size=8.0, stride=8.0, num_votes=1,
                        batch_size=8)
        total_cm += want["metrics"]["Confusion_Matrix"]
        got_pred = read_las(str(out_dir / f"scene{seed}_pred.las")).classification
        assert (got_pred == want["pred"]).mean() >= 0.999
        fname, miou, oa = per_scene[seed].groups()
        assert fname == f"scene{seed}.las"
        assert abs(float(miou) - want["metrics"]["mIoU"]) <= METRIC_TOL + 5e-5  # 4 decimals
        assert abs(float(oa) - want["metrics"]["OA"]) <= METRIC_TOL + 5e-5
    ref = jax_metrics.metrics_from_confusion(total_cm)
    assert abs(float(overall.group(1)) - ref["mIoU"]) <= METRIC_TOL + 5e-5
    assert abs(float(overall.group(2)) - ref["OA"]) <= METRIC_TOL + 5e-5


@pytest.mark.parametrize("present, taken", [
    (("best_model", "latest_checkpoint"), "best_model"),
    (("latest_checkpoint",), "latest_checkpoint"),
])
def test_infer_cli_restore_order(cli_run, capsys, present, taken):
    """From an experiment directory the CLI takes best_model, and
    latest_checkpoint only where there is no best_model: its confusion
    matrix is that of a run from the taken file alone, and not that of the
    other file's weights."""
    from pointcloud_bridge_tpu_torch import infer_cli

    root = cli_run["root"] / ("order_" + "_".join(present))
    exp = root / "exp"
    exp.mkdir(parents=True)
    files = {}
    for seed, fname in enumerate(("best_model", "latest_checkpoint")):
        model = get_model("pointnet2_ssg", 5, generator=torch.Generator().manual_seed(seed))
        files[fname] = root / f"{fname}_alone"
        save_checkpoint(str(files[fname]), {"model": model.state_dict(), "epoch": seed})
        if fname in present:
            save_checkpoint(str(exp / fname), {"model": model.state_dict(), "epoch": seed})

    def confusion(checkpoint, label):
        out_dir = root / label
        infer_cli.main(["blocks", "--checkpoint", str(checkpoint), "--data-dir",
                        str(cli_run["data"]), "--out-dir", str(out_dir), "--num-points", "128",
                        "--batch-size", "8", "--device", "cpu"])
        capsys.readouterr()
        return np.loadtxt(out_dir / "confusion_matrix.csv", delimiter=",")

    got = confusion(exp, "from_dir")
    np.testing.assert_array_equal(got, confusion(files[taken], "from_taken"))
    other = next(f for f in files if f != taken)
    assert not np.array_equal(got, confusion(files[other], "from_other"))


def test_infer_cli_from_snapshot_matches_the_working_tree(cli_run, capsys):
    """--from-snapshot builds the model from the experiment's code_snapshot
    (written by train); with an unchanged tree the metrics are the same."""
    from pointcloud_bridge_tpu_torch import infer_cli

    args = ["blocks", "--checkpoint", cli_run["ssg"], "--data-dir", str(cli_run["data"]),
            "--num-points", "128", "--batch-size", "8", "--device", "cpu"]
    infer_cli.main(args + ["--out-dir", str(cli_run["root"] / "snap_a")])
    a = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("GLOBAL")]
    infer_cli.main(args + ["--out-dir", str(cli_run["root"] / "snap_b"), "--from-snapshot"])
    b = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("GLOBAL")]
    assert a and a == b
    assert any(k.startswith("pcb_snapshot_") for k in sys.modules)


def test_infer_cli_refuses_a_model_not_ported(cli_run):
    """Every registry name is ported; a name outside the registry is
    refused before any checkpoint is read."""
    from pointcloud_bridge_tpu_torch import infer_cli

    with pytest.raises(ValueError, match="unknown model"):
        infer_cli.main(["blocks", "--checkpoint", cli_run["ptv3_pooled"], "--model",
                        "randlanet_v2", "--data-dir", str(cli_run["data"]), "--device", "cpu"])


def test_infer_cli_refuses_a_missing_card(tmp_path):
    from pointcloud_bridge_tpu_torch import infer_cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_cli.main(["blocks", "--checkpoint", str(tmp_path), "--data-dir", str(tmp_path)])


def test_port_imports_no_scikit_learn_and_measures_on_the_cpu():
    """A fresh interpreter with scikit-learn blocked (``sys.modules['sklearn']
    = None``, so any import of it raises) imports every module of the port,
    the measurement layer, the host tools and the examples among them, and
    runs ``run_wl_identification`` on a small deck with ``device="cpu"``:
    no module of scikit-learn, JAX or the JAX package enters."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['sklearn'] = None\n"
        "import numpy as np\n"
        "import pointcloud_bridge_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for want in ('measure.wl_iden', 'measure.wl_vision', 'measure.optimize',\n"
        "             'measure.evaluation', 'tools.convert', 'tools.relabel',\n"
        "             'tools.downsample', 'tools.dataset_stats', 'utils.hostmem',\n"
        "             'examples.full_pipeline', 'examples.large_scene_stream'):\n"
        "    assert pkg.__name__ + '.' + want in names, want\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from pointcloud_bridge_tpu_torch.measure import run_wl_identification\n"
        "def deck(n, seed):\n"
        "    r = np.random.default_rng(seed)\n"
        "    return np.stack([r.uniform(0, 20, n), r.uniform(0, 6, n),\n"
        "                     2.7 + r.normal(0, 0.01, n)], 1)\n"
        "rows = run_wl_identification([('d', deck(3000, 1), deck(2000, 2))],\n"
        "                             hyperparams={'voxel_size': 0.05, 'lof_n_neighbors': 20,\n"
        "                                          'isolation_forest_contamination': 0.1,\n"
        "                                          'lof_contamination': 0.05}, device='cpu')\n"
        "assert rows[0]['length_pred'] > rows[0]['width_pred'] > 0, rows\n"
        "assert rows[0]['relative_error'] < 0.2, rows\n"
        "bad = [k for k in sys.modules if sys.modules[k] is not None and (\n"
        "       k.split('.')[0] in ('sklearn', 'jax', 'jaxlib', 'flax', 'optax', 'orbax')\n"
        "       or k == 'pointcloud_bridge_tpu' or k.startswith('pointcloud_bridge_tpu.'))]\n"
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


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port and the smoke
    script, and runs a small forward and a block inference; neither JAX (or
    flax, optax, orbax) nor any module of the JAX package enters
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys, numpy as np, torch\n"
        "import pointcloud_bridge_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 30, names\n"
        "for want in ('utils.torch_import', 'utils.export', 'tools.import_ckpt',\n"
        "             'tools.debug_module', 'data.superpoints', 'data.completion', 'ops.avs',\n"
        "             'parallel.mesh', 'parallel.train_step', 'parallel.sharding',\n"
        "             'parallel.fsdp', 'parallel.engine', 'utils.collectives'):\n"
        "    assert pkg.__name__ + '.' + want in names, want\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from pointcloud_bridge_tpu_torch import models, infer\n"
        "from pointcloud_bridge_tpu_torch.data import BlockDataset\n"
        "m = models.get_model('pointnet2_ssg', 5, sa_npoints=(32, 16, 8),\n"
        "                     generator=torch.Generator().manual_seed(0))\n"
        "rng = np.random.default_rng(0)\n"
        "pts = rng.uniform(size=(2, 64, 3)).astype(np.float32)\n"
        "ds = BlockDataset(pts, pts, np.zeros((2, 64), np.int64), pts,\n"
        "                  np.zeros((2, 64), np.int64), np.zeros(2, np.int64), ['a'])\n"
        "res = infer.run_block_inference(m, ds, 5, batch_size=2)\n"
        "assert res['predictions'].shape == (2, 64)\n"
        "bad = [k for k in sys.modules\n"
        "       if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax')\n"
        "       or k == 'pointcloud_bridge_tpu' or k.startswith('pointcloud_bridge_tpu.')]\n"
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
