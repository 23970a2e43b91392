"""The port's import of reference torch checkpoints (utils/torch_import.py,
utils/weights.py::reference_state_dict, tools/import_ckpt.py) against the
JAX package's import, on the CPU.

A reference-layout state_dict is built from seeded flax-layout variables by
inverting the JAX package's own rule table here; the JAX
``convert_state_dict`` must give those variables back (which checks the
inversion), and the port's import must give exactly ``flax_to_state_dict``
of them and load with ``strict=True``. The tests that hold that state_dict's
forward against the JAX model are the models' own parity tests. Numpy only:
nothing here compiles a JAX function."""

import os

import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.utils import torch_import as jax_import
from pointcloud_bridge_tpu_torch import infer_cli
from pointcloud_bridge_tpu_torch.data import write_las
from pointcloud_bridge_tpu_torch.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu_torch.models import MultiScaleSetAbstraction, get_model
from pointcloud_bridge_tpu_torch.tools import import_ckpt
from pointcloud_bridge_tpu_torch.utils.checkpoint import restore_checkpoint
from pointcloud_bridge_tpu_torch.utils.weights import (
    flax_to_state_dict,
    multiscale_sa_rules,
    ptv3_rules,
    reference_rules,
    reference_state_dict,
    rules_for,
    state_dict_to_flax,
)

PTV3_DEPTH = 2
# the JAX import's aliases (utils/torch_import.py:405-409)
ALIASES = {"pointnet2": "pointnet2_ssg", "pointnet_seg": "pointnet", "dgcnn_cls": "dgcnn_global"}


def port_module(name):
    """The port's module for a rule set, small where the width allows."""
    gen = torch.Generator().manual_seed(0)
    if name == "multiscale_sa":
        return MultiScaleSetAbstraction(32, (0.1, 0.2), (8, 16), 3 + 6, (16, 16, 32), gen)
    if name == "ptv3":
        return get_model("ptv3", 5, depth=PTV3_DEPTH, generator=gen)
    return get_model(ALIASES.get(name, name), 5, generator=gen)


def jax_rules(name, variables):
    """The JAX package's rule table for ``name`` (utils/torch_import.py)."""
    name = ALIASES.get(name, name)
    if name == "ptv3":
        return jax_import._rules_ptv3(PTV3_DEPTH)
    if name == "multiscale_sa":
        params = variables["params"]
        return jax_import._rules_multiscale_sa(
            {f"conv_blocks.{i}.{j}.weight": None
             for i in range(len(params)) for j in range(len(params["mlp_0"]) // 2)})
    return getattr(jax_import, f"_rules_{name}")()


def port_rules(name):
    """The port's rule table for a rule set at this file's sizes."""
    name = ALIASES.get(name, name)
    if name == "multiscale_sa":
        return multiscale_sa_rules()
    return ptv3_rules(PTV3_DEPTH) if name == "ptv3" else rules_for(name)


def seeded_variables(name, seed=0):
    """Flax-layout variables of the port module's shapes, drawn from a seed:
    the template is ``state_dict_to_flax`` of a fresh port module."""
    module = port_module(name)
    template = state_dict_to_flax(module.state_dict(), port_rules(name))
    rng = np.random.default_rng(seed)

    def draw(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = draw(v)
            elif k == "var":
                out[k] = (0.5 + rng.uniform(size=v.shape)).astype(np.float32)
            else:
                out[k] = rng.normal(scale=0.3, size=v.shape).astype(np.float32)
        return out

    return draw(template), module


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def reference_layout(name, variables):
    """Invert the JAX rule table: flax-layout variables -> the reference
    torch state_dict that ``convert_state_dict`` reads (Conv kernels
    [I, O] -> weight [O, I, 1]; the Partsize MSG branch's first conv with
    its rel-xyz rows moved behind the features; DGCNN's BatchNorms also under
    their Sequential aliases ``conv{i}.1``, as the reference registers
    them)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for tp, fp, kind in jax_rules(name, variables):
        node = _leaf(params, fp)
        if kind in ("conv", "linear", "conv_featfirst"):
            w = np.asarray(node["kernel"]).T  # [O, I]
            if kind == "conv_featfirst":
                w = np.concatenate([w[:, 3:], w[:, :3]], axis=1)
            sd[tp + ".weight"] = w[..., None] if kind != "linear" else w
            if "bias" in node:
                sd[tp + ".bias"] = np.asarray(node["bias"])
        elif kind in ("bn", "ln"):
            sd[tp + ".weight"], sd[tp + ".bias"] = node["scale"], node["bias"]
            if kind == "bn":
                s = _leaf(stats, fp)
                sd[tp + ".running_mean"], sd[tp + ".running_var"] = s["mean"], s["var"]
                sd[tp + ".num_batches_tracked"] = np.array(3, np.int64)
    if ALIASES.get(name, name) in ("dgcnn", "dgcnn_global"):
        for i in range(1, 6):
            bn = f"bn{i}"
            for leaf in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
                sd[f"conv{i}.1.{leaf}"] = sd[f"{bn}.{leaf}"]
    return sd


RULE_SETS = ["pointnet2_ssg", "pointnet2", "pointnet", "pointnet_seg", "dgcnn", "dgcnn_global",
             "dgcnn_cls", "randlanet", "ptv3", "pointnet2_sem_seg", "pointnet2_msg",
             "pointnet_sem_seg", "multiscale_sa"]


def _assert_same_tree(got, want, path=()):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_tree(got[k], want[k], path + (k,))
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(path + (k,)))


@pytest.mark.parametrize("name", RULE_SETS)
def test_reference_import_equals_flax_to_state_dict_of_the_jax_conversion(name):
    """For every rule set of the JAX import (aliases included) and
    module-level multiscale_sa: the JAX ``convert_state_dict`` of the
    reference layout gives the seeded variables back exactly; the port's
    import gives exactly ``flax_to_state_dict`` of them, leaf for leaf, and
    the port's module loads it with ``strict=True``."""
    variables, module = seeded_variables(name)
    sd = reference_layout(name, variables)
    back = jax_import.convert_state_dict(name, sd, strict=True)
    _assert_same_tree(back, variables)
    got = reference_state_dict(name, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    want = flax_to_state_dict(variables, reference_rules(name, variables))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    module.load_state_dict(got, strict=True)


def test_unmappable_models_keep_the_jax_error():
    sd = {"sa1.mlp_0.dense_0.weight": np.zeros((2, 2), np.float32)}
    for name in ("bristrunet", "enhanced_pointnet2"):
        with pytest.raises(ValueError) as want:
            jax_import.convert_state_dict(name, sd)
        with pytest.raises(ValueError) as got:
            reference_state_dict(name, sd)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- the CLI


def _save_pth(path, sd, **scalars):
    torch.save({"model_state_dict": {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                **scalars}, path)
    return str(path)


def test_import_ckpt_keeps_the_scalars_and_serves(tmp_path, capsys, monkeypatch):
    """A wrapped save of a seeded pointnet2_ssg (the port's names are the
    reference's) -> import_ckpt -> a port checkpoint with the weights, the
    wrapper's scalars and ``source_torch``; ``infer_cli blocks`` serves it
    as it stands, with the seeded model's predictions (its figures, which
    test_torch_infer.py checks, are not drawn here)."""
    from pointcloud_bridge_tpu_torch.infer import figures

    monkeypatch.setattr(figures, "save_inference_figures", lambda *a, **k: None)
    monkeypatch.setattr(figures, "file_comparison_charts", lambda *a, **k: None)
    model = get_model("pointnet2_ssg", 5, generator=torch.Generator().manual_seed(4)).eval()
    pth = _save_pth(tmp_path / "best.pth", model.state_dict(), epoch=7, class_avg_iou=0.91,
                    note="run a")
    out = tmp_path / "exp"
    import_ckpt.main(["--model", "pointnet2_ssg", "--torch-ckpt", pth, "--out", str(out)])
    printed = capsys.readouterr().out
    assert "validated" in printed and "epoch=7" in printed
    ckpt = restore_checkpoint(str(out / "best_model"))
    assert (ckpt["epoch"], ckpt["class_avg_iou"], ckpt["note"]) == (7, 0.91, "run a")
    assert ckpt["source_torch"] == os.path.abspath(pth)
    for k, v in model.state_dict().items():
        assert torch.equal(ckpt["model"][k].to(v.dtype), v), k

    data = tmp_path / "data"
    data.mkdir()
    xyz, rgb, labels = toy_bridge_scene(3000, seed=3)
    write_las(str(data / "s.las"), xyz, rgb, labels)
    infer_cli.main(["blocks", "--checkpoint", str(out), "--model", "pointnet2_ssg",
                    "--data-dir", str(data), "--out-dir", str(tmp_path / "served"),
                    "--num-points", "1024", "--batch-size", "4", "--device", "cpu"])
    assert "GLOBAL mIoU=" in capsys.readouterr().out
    from pointcloud_bridge_tpu_torch.data import BlockDataset
    from pointcloud_bridge_tpu_torch.infer import run_block_inference

    ds = BlockDataset.from_files([str(data / "s.las")], num_points=1024, num_classes=5)
    want = run_block_inference(model, ds, 5, batch_size=4)["global"]["Confusion_Matrix"]
    got = np.loadtxt(tmp_path / "served" / "confusion_matrix.csv", delimiter=",")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("argv,match", [
    (["--num-classes", "6"], r"shape mismatch at \('head', 'dense1', 'kernel'\)"),
    (["--feature-dim", "9"], r"shape mismatch at \('sa1', 'mlp', 'dense_0', 'kernel'\)"),
])
def test_import_ckpt_refuses_a_wrong_template(tmp_path, argv, match):
    """A wrong --num-classes or --feature-dim fails at import, not at serve
    time, and writes nothing."""
    model = get_model("pointnet2_ssg", 5, generator=torch.Generator().manual_seed(0))
    pth = _save_pth(tmp_path / "m.pth", model.state_dict())
    with pytest.raises(ValueError, match=match):
        import_ckpt.main(["--model", "pointnet2_ssg", "--torch-ckpt", pth,
                          "--out", str(tmp_path / "exp"), *argv])
    assert not (tmp_path / "exp").exists()


def test_import_ckpt_ignores_dgcnn_aliases_and_refuses_an_extra_key(tmp_path):
    """DGCNN's duplicate ``conv{i}.1.`` BatchNorm aliases are ignored under
    ``strict``; any other key the rules do not use raises, unless
    --no-strict; --feature-dim 9 validates a 9-channel MSG checkpoint."""
    variables, _ = seeded_variables("dgcnn", seed=2)
    sd = reference_layout("dgcnn", variables)
    assert "conv3.1.running_var" in sd
    import_ckpt.main(["--model", "dgcnn", "--torch-ckpt", _save_pth(tmp_path / "d.pth", sd),
                      "--out", str(tmp_path / "d")])
    got = restore_checkpoint(str(tmp_path / "d" / "best_model"))["model"]
    for k, v in flax_to_state_dict(variables, "dgcnn").items():
        assert torch.equal(got[k], v), k

    extra = _save_pth(tmp_path / "e.pth", {**sd, "cls_head.0.weight": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="unconsumed reference keys for 'dgcnn'"):
        import_ckpt.main(["--model", "dgcnn", "--torch-ckpt", extra, "--out", str(tmp_path / "e")])
    import_ckpt.main(["--model", "dgcnn", "--torch-ckpt", extra, "--out", str(tmp_path / "e"),
                      "--no-strict"])
    assert os.path.exists(tmp_path / "e" / "best_model")

    msg = get_model("pointnet2_msg", 5, in_features=9, generator=torch.Generator().manual_seed(1))
    pth = _save_pth(tmp_path / "msg.pth", msg.state_dict())
    import_ckpt.main(["--model", "pointnet2_msg", "--torch-ckpt", pth, "--out",
                      str(tmp_path / "msg"), "--feature-dim", "9"])
    got = restore_checkpoint(str(tmp_path / "msg" / "best_model"))["model"]
    for k, v in msg.state_dict().items():
        assert torch.equal(got[k].to(v.dtype), v), k
