"""The port's trainer on a mesh: ``train()`` over two gloo ranks, on the
CPU (tests/torch_ranks.py's ``engine`` job, spawned once).

In dp for one epoch at the registry's SSG, rank 0 writes checkpoints in the
single-device layout that load into a single-process model and that
``infer_cli blocks --device cpu`` serves; tp (a 1 x 2 mesh) and fsdp train
an epoch too, with the EMA, and gather their state back to that layout;
dp at two steps a dispatch gives the bits of one, and resumes from rank
0's checkpoint. The JAX
trainer's refusals raise before any collective: a batch the mesh does not
divide, a ``tp_axis_size`` that does not divide the devices, accumulation
or multi-step dispatch with tp or fsdp (and accumulation with dp, which the
JAX dp step leaves unread), accumulation with sp, multi-step dispatch with
pp and ep on a model without experts. sp (the registry's SSG), pp (its
ptv3 over two stages) and ep (its ptv3_moe on a 1 x 2 mesh) train an epoch
too, and ``infer_cli`` serves their checkpoints."""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import os
import re

import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu_torch.data import write_las
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.utils.checkpoint import restore_checkpoint

from torch_ranks import SA_NPOINTS, Ranks


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine")
    (root / "scenes").mkdir()
    for seed in (0, 1):
        xyz, rgb, labels = toy_bridge_scene(2000, seed=seed)
        write_las(str(root / "scenes" / f"scene{seed}.las"), xyz, rgb, labels)
    r0, r1 = Ranks("engine", 2, root / "ranks", timeout=150).start().join()
    return root, r0, r1


@pytest.mark.parametrize("case,kind,pattern", [
    ("batch", "ValueError", "batch_size 3 must divide the mesh size 2"),
    ("tp_axis", "ValueError", "tp_axis_size 3 must divide 2 devices"),
    ("fsdp_accum", "ValueError", "accum_steps is not supported with parallel.mode=fsdp"),
    ("dp_accum", "ValueError", "accum_steps is not supported with parallel.mode=dp"),
    ("tp_dispatch", "ValueError", "steps_per_dispatch is not supported with parallel.mode=tp"),
    ("fsdp_dispatch", "ValueError",
     "steps_per_dispatch is not supported with parallel.mode=fsdp"),
    ("sp", "ValueError", "accum_steps is not supported with parallel.mode=sp"),
    ("pp", "ValueError", "steps_per_dispatch is not supported with parallel.mode=pp"),
    ("ep", "ValueError", "parallel.mode=ep requires a mixture-of-experts model"),
])
def test_mesh_refusals(engine, case, kind, pattern):
    for r in engine[1:]:
        msg = r["refusals"][case]
        assert msg is not None and msg.startswith(kind) and pattern in msg, msg


MODELS = {"sp": "pointnet2_ssg", "pp": "ptv3", "ep": "ptv3_moe"}


@pytest.mark.parametrize("mode", ["dp", "tp", "fsdp", "sp", "pp", "ep"])
def test_rank_0_writes_a_single_device_checkpoint(engine, mode):
    root, r0, r1 = engine
    exp = r0[mode]["exp_dir"]
    assert os.path.exists(os.path.join(exp, "latest_checkpoint"))
    assert os.path.exists(os.path.join(exp, "training.log"))
    for r in (r0, r1):
        (row,) = r[mode]["history"]
        assert np.isfinite(row["train_loss"]) and 0.0 <= row["val_acc"] <= 1.0
    # the ranks agree on every number of the epoch but its wall time
    assert _rows(r0[mode]["history"]) == _rows(r1[mode]["history"])
    extra = {} if mode in ("dp", "sp", "pp", "ep") else {"sa_npoints": SA_NPOINTS}
    model = get_model(MODELS.get(mode, "pointnet2_ssg"), 5, **extra)
    ckpt = restore_checkpoint(os.path.join(exp, "latest_checkpoint"), map_location="cpu")
    model.load_state_dict(ckpt["model"], strict=True)
    opt = torch.optim.Adam(model.parameters())
    opt.load_state_dict(ckpt["optimizer"])  # the moments in the model's layout
    for k, v in ckpt["model"].items():
        assert torch.equal(v, r1[mode]["state"][k]), k
    if mode not in ("dp", "sp"):  # the EMA weights, gathered, beside them
        ema = restore_checkpoint(os.path.join(exp, "latest_ema"), map_location="cpu")["model"]
        assert {k: v.shape for k, v in ema.items()} == {
            k: p.shape for k, p in model.named_parameters()}


def test_infer_cli_serves_the_dp_checkpoint(engine, capsys):
    from pointcloud_bridge_tpu_torch import infer_cli

    root, r0, _ = engine
    infer_cli.main([
        "blocks", "--checkpoint", r0["dp"]["exp_dir"], "--data-dir", str(root / "scenes"),
        "--out-dir", str(root / "served"), "--num-points", "128", "--batch-size", "8",
        "--device", "cpu",
    ])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("GLOBAL")][-1]
    m = re.fullmatch(r"GLOBAL mIoU=([\d.]+) OA=([\d.]+) mAcc=([\d.]+) F1=([\d.]+)", line)
    assert m and all(0.0 <= float(v) <= 1.0 for v in m.groups()), line


@pytest.mark.parametrize("mode", ["sp", "pp", "ep"])
def test_infer_cli_serves_the_sp_pp_and_ep_checkpoints(engine, capsys, mode):
    from pointcloud_bridge_tpu_torch import infer_cli

    root, r0, _ = engine
    infer_cli.main([
        "blocks", "--checkpoint", r0[mode]["exp_dir"], "--model", MODELS[mode],
        "--data-dir", str(root / "scenes"), "--out-dir", str(root / f"served_{mode}"),
        "--num-points", "128", "--batch-size", "8", "--device", "cpu",
    ])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("GLOBAL")][-1]
    m = re.fullmatch(r"GLOBAL mIoU=([\d.]+) OA=([\d.]+) mAcc=([\d.]+) F1=([\d.]+)", line)
    assert m and all(0.0 <= float(v) <= 1.0 for v in m.groups()), line


def _rows(history):
    return [{k: v for k, v in row.items() if k != "epoch_time_s"} for row in history]


def test_dp_at_two_steps_a_dispatch_is_one_step_a_dispatch(engine):
    """train() in dp at steps_per_dispatch 2 (the dp multi-step, eager on
    the CPU) gives the history and weights of steps_per_dispatch 1, bit for
    bit, as the single-device trainer does."""
    for r in engine[1:]:
        assert _rows(r["spd2"]["history"]) == _rows(r["spd1"]["history"])
        for k, v in r["spd1"]["state"].items():
            assert torch.equal(v, r["spd2"]["state"][k]), k


def test_dp_resumes_from_rank_0s_checkpoint(engine):
    """A second run resumed from the dp run's latest_checkpoint trains
    epoch 2 alone, on every rank from the same state."""
    r0, r1 = engine[1:]
    assert [row["epoch"] for row in r0["resumed"]["history"]] == [2]
    assert _rows(r0["resumed"]["history"]) == _rows(r1["resumed"]["history"])
    for k, v in r0["resumed"]["state"].items():
        assert torch.equal(v, r1["resumed"]["state"][k]), k
    assert any(not torch.equal(v, r0["spd1"]["state"][k])
               for k, v in r0["resumed"]["state"].items())
