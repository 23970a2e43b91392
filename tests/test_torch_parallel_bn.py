"""Sync-BN across the registry at two gloo ranks, on the CPU.

Every registry name built with ``axis_name="data"`` runs a train-mode
forward on its rank's half of a batch (dropout 0, RandLA-Net's stride
subsets, ``ptv3_moe`` at a capacity that drops no token, so that nothing
but the BatchNorms ties the rows together); the concatenated logits and
the running statistics are held to the port's single-process forward of
the whole batch through the same synced BatchNorm in a world of one (one
rank's own group: the same arithmetic, all rows at once). No float64
forward exists for most of the registry (the kernels' wrappers take
float32), so the band's float32 part is the spread between the two
single-process arithmetics the port has: ``|port - alone| <= base +
2 |alone - single|``, with ``single`` the model built without axis_name
(torch's BatchNorm), base 2e-4 * max|logits| and 1e-5 * max|stat|.

SSG and BriStruNet, at small sizes, are also held to the JAX models with
``axis_name="data"`` under ``shard_map`` over two devices, in the bands of
tests/test_torch_train.py (float64 reference plus twice JAX's own float32
error).
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.parallel import make_mesh
from pointcloud_bridge_tpu_torch.models.registry import MODEL_REGISTRY
from pointcloud_bridge_tpu_torch.utils.weights import state_dict_to_flax

from test_torch_parallel import cast, check_tree, in_dtype, to64
from torch_ranks import BN_POINTS, SA_NPOINTS, Ranks, registry_models, skewed_batch, small

RULES = {"pointnet2_ssg": None, "bristrunet": "bristrunet"}


def jax_forward(name, variables, b, dtype):
    """The JAX model's train-mode forward under shard_map over two devices:
    the logits and the updated batch statistics."""
    kw = {"compute_dtype": np.dtype(dtype).name} if name == "pointnet2_ssg" else {}
    model = jax_get_model(name, num_classes=5, axis_name="data", sa_npoints=SA_NPOINTS,
                          dropout_rate=0.0, **kw)

    def run():
        v, x = cast(variables, dtype), cast(b, dtype)

        def body(v, xyz, colors):
            logits, mut = model.apply(v, xyz, colors, train=True, mutable=["batch_stats"])
            return logits, mut["batch_stats"]

        f = jax.jit(shard_map(body, mesh=make_mesh(2), in_specs=(P(), P("data"), P("data")),
                              out_specs=(P("data"), P()), check_vma=False))
        logits, stats = f(v, x["points"], x["colors"])
        return to64({"logits": logits, "batch_stats": stats})
    return in_dtype(run, dtype)


@pytest.fixture(scope="module")
def bn(tmp_path_factory):
    """(rank 0's results, rank 1's, the JAX forwards {name: (float32,
    float64)})."""
    ranks = Ranks("bn", 2, tmp_path_factory.mktemp("bn"), timeout=150).start()
    b = skewed_batch(4, BN_POINTS, seed=9)
    want = {}
    for name, rules in RULES.items():
        sd = small(name).state_dict()
        variables = state_dict_to_flax(sd) if rules is None else state_dict_to_flax(sd, rules)
        want[name] = tuple(jax_forward(name, variables, b, dt) for dt in (np.float32, np.float64))
    r0, r1 = ranks.join()
    return r0, r1, want


def test_registry_names_share_distinct_models():
    names = registry_models()
    assert set(names) == set(MODEL_REGISTRY)
    assert len(set(names.values())) < len(names)


def _band(got, alone, single, base):
    err = (got - alone).abs().max().item()
    tol = base * alone.abs().max().item() + 2 * (alone - single).abs().max().item()
    return err, tol


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_sync_bn_gives_the_global_batchs_statistics(bn, name):
    r0, r1 = bn[0], bn[1]
    key = registry_models()[name]
    got = torch.cat([r0[key]["logits"], r1[key]["logits"]])
    alone, single = r0[key]["alone"], r1[key]["single"]
    assert got.shape == alone["logits"].shape and torch.isfinite(got).all()
    err, tol = _band(got, alone["logits"], single["logits"], 2e-4)
    assert err <= tol, f"logits |port - alone| {err:.3g} > {tol:.3g}"
    assert r0[key]["stats"].keys() == alone["stats"].keys() and alone["stats"]
    for k, v in alone["stats"].items():
        for r in (r0, r1):  # both ranks hold the same statistics
            err, tol = _band(r[key]["stats"][k], v, single["stats"][k], 1e-5)
            assert err <= tol, f"{k}: |port - alone| {err:.3g} > {tol:.3g}"


def test_sync_bn_of_the_restructured_edgeconv(bn):
    """The restructured EdgeConv (its BatchNorm from moments,
    ``affine_from_moments``) with axis_name on two ranks: the outputs of
    the two halves and both ranks' running statistics against the whole
    batch through the same module in a world of one, in the file's bands."""
    r0, r1 = bn[0]["fast_edgeconv"], bn[1]["fast_edgeconv"]
    assert r0["fast"] and r1["fast"]
    got = torch.cat([r0["logits"], r1["logits"]])
    alone, single = r0["alone"], r1["single"]
    assert got.shape == alone["logits"].shape == (4, 64, 24) and torch.isfinite(got).all()
    err, tol = _band(got, alone["logits"], single["logits"], 2e-4)
    assert err <= tol, f"outputs |port - alone| {err:.3g} > {tol:.3g}"
    assert alone["stats"].keys() == {"bn.running_mean", "bn.running_var"}
    for k, v in alone["stats"].items():
        for r in (r0, r1):
            err, tol = _band(r["stats"][k], v, single["stats"][k], 1e-5)
            assert err <= tol, f"{k}: |port - alone| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("name", sorted(RULES))
def test_sync_bn_matches_the_jax_model_under_shard_map(bn, name):
    """Logits within 2e-4 and running statistics within 1e-5 * max|stat|
    of the JAX float64 forward, plus twice JAX's own float32 error."""
    r0, r1, want = bn
    res = (r0[f"small:{name}"], r1[f"small:{name}"])
    want32, want64 = want[name]
    got = torch.cat([r["logits"] for r in res]).double().numpy()
    check_tree({"logits": got}, {"logits": want32["logits"]}, {"logits": want64["logits"]},
               lambda r: 2e-4, "logits")
    rules = RULES[name]
    for r in res:
        sd = {k: v for k, v in small(name).state_dict().items()}
        sd.update(r["stats"])
        stats = state_dict_to_flax(sd) if rules is None else state_dict_to_flax(sd, rules)
        check_tree(to64(stats["batch_stats"]), want32["batch_stats"], want64["batch_stats"],
                   lambda x: 1e-5 * np.abs(x).max(), "batch_stats")
