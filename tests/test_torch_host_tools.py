"""The port's host tools on the CPU, against the JAX package and
scikit-learn: ``classification_report`` (numpy) string for string against
scikit-learn's, the superpoint pipeline's DBSCAN label for label against
``sklearn.cluster.DBSCAN`` and ``generate_superpoints`` against the JAX
module, the host copies of data/completion.py and ops/avs.py run beside the
JAX package's, ``tools/debug_module.py``'s parameter count against the JAX
model's, and no module of the port importing scikit-learn."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN

from pointcloud_bridge_tpu.data import completion as jax_completion
from pointcloud_bridge_tpu.data import superpoints as jax_superpoints
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.ops import avs as jax_avs
from pointcloud_bridge_tpu.utils import metrics as jax_metrics
from pointcloud_bridge_tpu_torch.data import completion, superpoints
from pointcloud_bridge_tpu_torch.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.ops import avs_adapt_voxel_size, avs_net_sample_indices
from pointcloud_bridge_tpu_torch.tools import debug_module
from pointcloud_bridge_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["noise", "abutment", "girder", "deck", "parapet"]


def _report_case(name):
    """(preds, labels, class names) of one case."""
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 5, 400)
    preds = np.where(rng.uniform(size=400) < 0.7, labels, rng.integers(0, 5, 400))
    if name == "five_classes":
        return preds.reshape(4, 100), labels.reshape(4, 100), NAMES
    if name == "missing_class_named":  # 4 classes present, 5 names: both raise
        return np.minimum(preds, 3), np.minimum(labels, 3), NAMES
    if name == "missing_classes_unnamed":  # rows named by the labels 0, 2, 3
        return np.where(preds == 1, 2, np.minimum(preds, 3)), \
            np.where(labels == 1, 0, np.minimum(labels, 3)), None
    if name == "zero_divisions":  # 4 never predicted, 0 never true
        return np.where(preds == 4, 0, preds), np.where(labels == 0, 1, labels), NAMES
    if name == "nothing_right":  # no true positive: supports in float64
        return (labels + 1) % 5, labels, NAMES
    if name == "one_class":
        return np.zeros(30, np.int64), np.zeros(30, np.int64), ["only_one_long_class_name"]
    raise KeyError(name)


@pytest.mark.parametrize("case", ["five_classes", "missing_class_named",
                                  "missing_classes_unnamed", "zero_divisions",
                                  "nothing_right", "one_class"])
def test_classification_report_is_scikit_learns(case):
    """The string is the JAX package's (scikit-learn's ``classification_
    report`` with ``target_names`` and ``zero_division=0``) character for
    character, or both raise the same ValueError."""
    preds, labels, names = _report_case(case)
    try:
        want = jax_metrics.classification_report(preds, labels, names)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            metrics.classification_report(preds, labels, names)
        assert str(got.value) == str(exc)
        return
    assert metrics.classification_report(preds, labels, names) == want


# ---------------------------------------------------------------- DBSCAN


def superpoint_features(n, seed):
    """[N, 12] features as generate_superpoints builds them, on a toy
    scene."""
    xyz, rgb, _ = toy_bridge_scene(n, seed=seed)
    xyz, rgb = xyz.astype(np.float64), rgb.astype(np.float64)
    normals = superpoints.compute_normals_host(xyz)
    geometric = superpoints.compute_geometric_features(xyz, normals)
    return np.concatenate([xyz, normals * 0.5, geometric * 2.0, rgb * 0.3], axis=1)


def _border_ties(b_first):
    """Two clusters on a line with a point at exactly eps = 1 from a core
    point of each and too few neighbours to be core itself: it belongs to
    the cluster numbered first, the one whose lowest core index is lower."""
    a = [0.0, 0.25, 0.5, 0.75, 1.0]
    b = [3.0, 3.25, 3.5, 3.75, 4.0]
    x = (b + [2.0] + a) if b_first else (a + [2.0] + b)
    out = np.zeros((len(x), 12))
    out[:, 0] = x
    return out


@pytest.mark.parametrize("case,eps,min_samples", [
    ("scene", 0.3, 10), ("scene", 0.5, 20), ("scene", 0.2, 3),
    ("grid", 2.0, 6), ("grid", 1.0, 2), ("ties_a_first", 1.0, 4), ("ties_b_first", 1.0, 4),
])
def test_dbscan_labels_are_scikit_learns(case, eps, min_samples):
    """Labels equal to ``sklearn.cluster.DBSCAN``'s: core points, cluster
    numbers in the order of the lowest core index, a border point the lowest
    label among its core neighbours' clusters, noise -1; on a toy scene's
    superpoint features, on an integer grid (distances at exactly eps), and
    at a border point tied between two clusters."""
    if case == "scene":
        x = superpoint_features(1500, seed=2)
    elif case == "grid":
        x = np.random.default_rng(3).integers(0, 3, (400, 12)).astype(np.float64)
    else:
        x = _border_ties(case.endswith("b_first"))
    want = DBSCAN(eps=eps, min_samples=min_samples).fit(x).labels_
    got = superpoints.dbscan_labels(x, eps, min_samples)
    np.testing.assert_array_equal(got, want)
    if case.startswith("ties"):
        assert got[5] == 0 and set(got.tolist()) == {0, 1}


def test_generate_superpoints_matches_the_jax_module():
    """Labels and superpoint features equal to the JAX module's (its DBSCAN
    is scikit-learn's) on the same scene."""
    xyz, rgb, _ = toy_bridge_scene(2500, seed=5)
    xyz, rgb = xyz.astype(np.float64), rgb.astype(np.float64)
    normals = jax_superpoints.compute_normals_host(xyz)
    want = jax_superpoints.generate_superpoints(xyz, rgb, normals, min_points=8, eps=0.6)
    got = superpoints.generate_superpoints(xyz, rgb, normals, min_points=8, eps=0.6)
    assert want[1].shape[0] > 30 and (want[0] < 0).any()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _functions(path, edit=None):
    """Each top-level function's AST without its docstring, by name, after
    ``edit`` (a function of the FunctionDef)."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.FunctionDef):
            body = node.body
            if isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                node.body = body[1:]
            if edit:
                edit(node)
            out[node.name] = ast.dump(node)
    return out


def _without_scikit_learn(fn):
    """The JAX generate_superpoints with its DBSCAN swapped for the port's:
    the import of sklearn.cluster gone, the labels from dbscan_labels."""
    if fn.name != "generate_superpoints":
        return
    fn.body = [s for s in fn.body
               if not (isinstance(s, ast.ImportFrom) and s.module == "sklearn.cluster")]
    for node in fn.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "labels":
            node.value = ast.parse("dbscan_labels(features, eps=eps, "
                                   "min_samples=min_points)").body[0].value


def test_superpoints_is_the_jax_module_but_for_its_dbscan():
    """Every function of the JAX module is the port's statement for
    statement, generate_superpoints too once its scikit-learn DBSCAN is
    swapped for ``dbscan_labels``."""
    ours = _functions(os.path.join(REPO, "pointcloud_bridge_tpu_torch", "data", "superpoints.py"))
    theirs = _functions(os.path.join(REPO, "pointcloud_bridge_tpu", "data", "superpoints.py"),
                        _without_scikit_learn)
    assert set(ours) == set(theirs) | {"dbscan_labels"}
    for name in theirs:
        assert ours[name] == theirs[name], name


def test_completion_and_avs_copies_run_as_the_jax_package():
    """data/completion.py and ops/avs.py (host copies, held statement for
    statement by test_torch_infer.py) give the JAX package's outputs."""
    xyz, rgb, labels = toy_bridge_scene(6000, seed=1)
    got = completion.complete_scene(xyz, rgb, labels, voxel_size=0.2)
    want = jax_completion.complete_scene(xyz, rgb, labels, voxel_size=0.2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pts = xyz[None, :1024].astype(np.float64)
    idx, v = avs_net_sample_indices(pts, 256, rng=np.random.default_rng(0))
    jidx, jv = jax_avs.avs_net_sample_indices(pts, 256, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(idx, jidx)
    assert v == jv == avs_adapt_voxel_size(pts, 256)


# ---------------------------------------------------------------- debug_module


@pytest.mark.parametrize("name", ["pointnet2_ssg", "pointnet2_msg", "dgcnn", "ptv3_pooled"])
def test_debug_module_counts_the_jax_models_parameters(name):
    """The parameter count ``smoke_test`` reports (the port model's
    parameters) equals the JAX tool's (the leaves of the flax params), the
    JAX tree traced by jax.eval_shape, nothing compiled."""
    xyz = jnp.zeros((1, 256, 3), jnp.float32)
    tree = jax.eval_shape(lambda: jax_get_model(name, num_classes=5).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0),
         "sampling": jax.random.PRNGKey(0)}, xyz, xyz, train=False))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree["params"]))
    assert sum(p.numel() for p in get_model(name, 5).parameters()) == want


def test_debug_module_smoke_test_on_the_cpu(capsys):
    """``smoke_test`` on the CPU at a small size: the forward's shape, a
    points/s for each batch size and no peak (no card); the CLI refuses a
    missing card."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # ~40 tiny forwards: threads only add barriers
    try:
        res = debug_module.smoke_test("pointnet2_ssg", 5, 64, (1, 2),
                                      model_kwargs={"sa_npoints": (16, 8, 4)}, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert res["output_shape"] == (1, 64, 5)
    assert res["params"] == sum(p.numel() for p in get_model("pointnet2_ssg", 5).parameters())
    assert res["b1_points_per_sec"] > 0 and res["b2_points_per_sec"] > 0
    assert not any(k.endswith(("_error", "_peak_mib")) for k in res)
    assert "B=2:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            debug_module.main(["pointnet2_ssg"])


# ---------------------------------------------------------------- guards


def test_no_module_of_the_port_imports_scikit_learn():
    """No source of the port, nor chip_smoke.py, imports scikit-learn (the
    card's machine has none); test_torch_infer.py imports every module with
    it blocked."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "pointcloud_bridge_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    found = []
    for path in paths:
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            found += [(path, n) for n in names if n.split(".")[0] == "sklearn"]
    assert len(paths) > 60 and not found, found
