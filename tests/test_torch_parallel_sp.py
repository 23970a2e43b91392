"""The port's sequence parallelism (parallel/sp.py) against the JAX
package's ``make_sp_train_step``, on the CPU: four gloo ranks
(tests/torch_ranks.py's ``sp`` job, spawned once) against the JAX step on
four of the conftest's virtual devices under ``shard_map``.

Cases: global ``ptv3`` (the N axis sharded, attention as ring attention),
and in the whole-input contract windowed ``ptv3`` and ``ptv3_pooled`` (its
levels sharded or whole); then global ``ptv3`` on a 2 x 2 ("data", "sp")
mesh. tests/test_torch_parallel_sp_pointnet.py (SSG, MSG) and
test_torch_parallel_sp_bristrunet.py run these tests over the
neighbourhood models (queries sliced, FPS whole on every rank), each with
a rank job and a JAX side of its own, so that each file stays near half
a minute alone. Each starts from the same seeded weights (carried to flax
by ``state_dict_to_flax``), dropout 0, the default ``weighted_ce`` with class
weights, on a batch whose first half of points and second half draw from
different classes, so that the shards' label mixes differ and the mean of
per-shard weighted losses is not the global one: the loss must be the
global weighted loss, the sums taken over the axes before the division.

Bands, as tests/test_torch_parallel.py's with the port's single-process
float32 step in place of the JAX float64 one (the port's float32
attention has no float64 form): each gradient leaf within 2e-4 of its max
plus 1e-6, each BatchNorm statistic within 1e-5 of its max, plus twice the
distance of the port's single-process step from the JAX sp step on that
leaf; the loss within 1e-5 relative of the JAX step's and of the
single-process weighted loss.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.config import Config
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.parallel import make_mesh, make_named_mesh, make_sp_train_step
from pointcloud_bridge_tpu_torch import losses
from pointcloud_bridge_tpu_torch.utils import metrics as M
from pointcloud_bridge_tpu_torch.utils.weights import ptv3_pooled_rules, ptv3_rules

from test_torch_parallel import GRAD_BAND, RECORD, STAT_BAND, check_tree, jax_state, to64
from torch_ranks import (CLASS_WEIGHTS, SGD_LR, SP_CASES, SP_PTV3, Ranks, n_skewed_batch,
                         sp_model)
from pointcloud_bridge_tpu_torch.utils.weights import state_dict_to_flax

MODELS = list(SP_PTV3)  # the cases of the forward and eval test
CASES = MODELS + ["dp_x_sp"]
JOB = "sp"
RULES = {"ptv3": ptv3_rules(2), "windowed_ptv3": ptv3_rules(2),
         "ptv3_pooled": ptv3_pooled_rules((1, 1, 1), (1, 1)), "pointnet2_ssg": "pointnet2_ssg",
         "pointnet2_msg": "pointnet2_msg", "bristrunet": "bristrunet"}
NO_DROP = {"ptv3": dict(drop_rate=0.0, attn_drop_rate=0.0, head_drop_rate=0.0),
           "ptv3_pooled": dict(drop_rate=0.0, attn_drop_rate=0.0, head_drop_rate=0.0),
           "pointnet2_ssg": dict(dropout_rate=0.0), "pointnet2_msg": dict(dropout_rate=0.0),
           "bristrunet": dict(dropout_rate=0.0)}


def base_case(case):
    return "ptv3" if case == "dp_x_sp" else case


def jax_sp_step(case, variables):
    name, kw, shard, b, n = SP_CASES[base_case(case)]
    if case == "dp_x_sp":
        mesh, axis_name, dp_axis = make_named_mesh((2, 2), ("data", "sp")), ("data", "sp"), "data"
    else:
        mesh, axis_name, dp_axis = make_mesh(4, "sp"), "sp", None
    model = jax_get_model(name, num_classes=5, sp_axis="sp", axis_name=axis_name,
                          **kw, **NO_DROP[name])
    step = make_sp_train_step(model, Config().loss, RECORD, mesh, axis="sp", donate=False,
                              dp_axis=dp_axis, shard_inputs=shard)
    batch = n_skewed_batch(b, n)
    state, m = step(jax_state(variables, np.float32),
                    {k: jnp.asarray(batch[k]) for k in ("points", "colors", "labels")},
                    jnp.float32(SGD_LR), jnp.asarray(CLASS_WEIGHTS), jax.random.PRNGKey(0))
    return to64({"loss": m["loss"], "acc": m["acc"], "grads": state.opt_state,
                 "batch_stats": state.batch_stats})


def single(case):
    """The port's single-process float32 train-mode step on the whole batch:
    its weighted loss, gradients, BatchNorm statistics and logits."""
    _, _, _, b, n = SP_CASES[base_case(case)]
    batch = n_skewed_batch(b, n)
    with torch.no_grad():
        eval_logits = sp_model(base_case(case)).eval()(torch.from_numpy(batch["points"]),
                                                       torch.from_numpy(batch["colors"]))
    model = sp_model(base_case(case))
    logits = model(torch.from_numpy(batch["points"]), torch.from_numpy(batch["colors"]))
    labels = torch.from_numpy(batch["labels"]).long()
    loss = losses.weighted_cross_entropy(logits, labels, torch.from_numpy(CLASS_WEIGHTS))
    loss.backward()
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    return {"loss": loss.item(), "grads": {k: p.grad for k, p in model.named_parameters()},
            "state": sd, "logits": eval_logits, "train_logits": logits.detach(),
            "labels": labels}


def pytest_generate_tests(metafunc):
    """``case`` runs over the calling file's CASES, ``model`` over its
    MODELS."""
    for name, cases in (("case", metafunc.module.CASES), ("model", metafunc.module.MODELS)):
        if name in metafunc.fixturenames:
            metafunc.parametrize(name, cases)


def run_cases(module, tmp_path_factory):
    """The rank job of ``module`` (its JOB) beside the JAX steps of its
    CASES -> (the ranks' results, the JAX steps', the single-process
    steps')."""
    ranks = Ranks(module.JOB, 4, tmp_path_factory.mktemp(module.JOB), timeout=240).start()
    jax_out = {}
    for case in module.CASES:
        weights = sp_model(base_case(case)).state_dict()
        jax_out[case] = jax_sp_step(case, state_dict_to_flax(weights, RULES[base_case(case)]))
    singles = {case: single(base_case(case)) for case in module.CASES}
    return ranks.join(), jax_out, singles


@pytest.fixture(scope="module")
def sp(request, tmp_path_factory):
    return run_cases(request.module, tmp_path_factory)


def flax_tree(case, tensors):
    return to64(state_dict_to_flax(tensors, RULES[base_case(case)]))


def test_sp_ranks_hold_the_same_step(sp, case):
    r0 = sp[0][0][case]
    for r in sp[0][1:]:
        assert r[case]["loss"] == r0["loss"] and r[case]["acc"] == r0["acc"]
        for k, g in r0["grads"].items():
            assert torch.equal(g, r[case]["grads"][k]), k


def test_sp_loss_is_the_global_weighted_loss(sp, case):
    """Within 1e-5 of the JAX sp step's loss and of the single-process
    weighted loss of the whole batch; the mean of the shards' weighted
    losses, which a pmean of per-shard means would give, is not it."""
    ranks, jax_out, singles = sp
    got, whole = ranks[0][case]["loss"], singles[case]["loss"]
    np.testing.assert_allclose(got, jax_out[case]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got, whole, rtol=1e-5)
    if case == "ptv3":  # the skewed shards of the N axis
        s = singles[case]
        cw = torch.from_numpy(CLASS_WEIGHTS)
        shards = [losses.weighted_cross_entropy(lg, lb, cw).item() for lg, lb in zip(
            s["train_logits"].chunk(4, dim=1), s["labels"].chunk(4, dim=1))]
        assert abs(np.mean(shards) - whole) > 100 * 1e-5 * whole  # a hundred bands off


@pytest.mark.parametrize("key", ["grads", "batch_stats"])
def test_sp_step_matches_jax(sp, case, key):
    ranks, jax_out, singles = sp
    r0 = ranks[0][case]
    if key == "grads":
        got = flax_tree(case, r0["grads"])["params"]
        near = flax_tree(case, singles[case]["grads"])["params"]
        base = GRAD_BAND
    else:
        got = flax_tree(case, r0["stats"])["batch_stats"]
        moved = sp_model(base_case(case))
        moved(*(torch.from_numpy(n_skewed_batch(*SP_CASES[base_case(case)][3:])[k])
                for k in ("points", "colors")))
        near = flax_tree(case, moved.state_dict())["batch_stats"]
        base = STAT_BAND
    check_tree(got, near, jax_out[case][key], base, f"{case} {key}")
    assert abs(r0["acc"] - jax_out[case]["acc"]) <= 1.0 / 64


def test_sp_forward_and_eval_match_the_single_process_model(sp, model):
    """make_sp_forward's logits (this rank's slice of N, or the whole N)
    and make_sp_eval_step's confusion matrix and loss against the
    single-process eval of the whole batch."""
    ranks, _, singles = sp
    case = model
    shard = SP_CASES[case][2]
    want = singles[case]["logits"]
    got = (torch.cat([r[case]["forward"] for r in ranks], dim=1) if shard
           else ranks[0][case]["forward"])
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    labels = singles[case]["labels"]
    cw = torch.from_numpy(CLASS_WEIGHTS)
    want_loss = losses.weighted_cross_entropy(want, labels, cw).item()
    mask = torch.ones(labels.shape, dtype=torch.bool)
    want_cm = M.masked_confusion_matrix(want.argmax(-1), labels, mask, 5)
    for r in ranks:
        cm, loss = r[case]["eval"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert int(cm.sum()) == labels.numel()
        assert int((cm - want_cm).abs().sum()) <= 2  # argmax ties alone


def test_sp_multi_step_is_two_single_steps(sp):
    """make_sp_multi_train_step at K = 2 with the EMA (eager on the CPU)
    gives the bits of two sp steps and their EMA updates."""
    for r in sp[0]:
        got, want = r["multi"], r["multi"]["single"]
        assert torch.equal(got["loss"], want["loss"])
        for key in ("state", "ema"):
            for k, v in want[key].items():
                assert torch.equal(got[key][k], v), (key, k)
