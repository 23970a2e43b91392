"""The PyTorch port's exact k-NN and local structure ops against the JAX
package, on the CPU (where the port runs its plain versions and JAX its
exact ``lax.top_k`` path).

The JAX package measures distances in the expanded form
(|a|^2 + |b|^2 - 2ab), the port in the direct form ((dx^2 + dy^2) + dz^2),
so two near-equal distances can order differently. Indices are therefore
held identical wherever the JAX distances of the two picks differ by more
than 1e-6, and distances within 1e-5. On an integer grid both forms are
exact and the lower index must win every tie in both packages.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu import ops as jops
from pointcloud_bridge_tpu.ops import grouping as jgrouping
from pointcloud_bridge_tpu.ops import structure as jstructure
from pointcloud_bridge_tpu_torch import ops
from pointcloud_bridge_tpu_torch.ops import _kernels, grouping, structure

SHAPES = [(128, 128, 16), (256, 64, 32), (40, 40, 40)]
STRUCT_TOL = 2e-4  # PARITY.md §7's band for torch-vs-JAX parity


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, n, s):
    xyz = rng.uniform(size=(2, n, 3)).astype(np.float32)
    query = xyz if s == n else rng.uniform(size=(2, s, 3)).astype(np.float32)
    return xyz, query


def _assert_same_neighbours(got_idx, want_idx, jax_d2_full):
    """Identical indices, or picks whose JAX distances are within 1e-6."""
    differ = got_idx != want_idx
    if differ.any():
        d_got = np.take_along_axis(jax_d2_full, got_idx.astype(np.int64), -1)
        d_want = np.take_along_axis(jax_d2_full, want_idx.astype(np.int64), -1)
        assert np.abs(d_got - d_want)[differ].max() <= 1e-6
        # and both rows hold k distinct points
        assert (np.diff(np.sort(got_idx, -1), axis=-1) > 0).all()


@pytest.mark.parametrize("n,s,k", SHAPES)
def test_knn_with_distance_matches_jax(rng, n, s, k):
    xyz, query = _cloud(rng, n, s)
    want_d, want_idx = jgrouping.knn_with_distance(
        jnp.asarray(xyz), jnp.asarray(query), k, approx=False)
    got_d, got_idx = ops.knn_with_distance(_t(xyz), _t(query), k)
    assert got_idx.dtype == torch.int32 and got_idx.shape == (2, s, k)
    assert got_d.dtype == torch.float32 and got_d.shape == (2, s, k)
    full = np.asarray(jops.square_distance(jnp.asarray(query), jnp.asarray(xyz)))
    _assert_same_neighbours(got_idx.numpy(), np.asarray(want_idx), full)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-5)
    assert (np.diff(got_d.numpy(), axis=-1) >= 0).all()  # nearest first


@pytest.mark.parametrize("n,s,k", SHAPES)
def test_knn_and_knn_set_match_jax(rng, n, s, k):
    xyz, query = _cloud(rng, n, s)
    full = np.asarray(jops.square_distance(jnp.asarray(query), jnp.asarray(xyz)))
    want = np.asarray(jgrouping.knn(jnp.asarray(xyz), jnp.asarray(query), k, approx=False))
    _assert_same_neighbours(ops.knn(_t(xyz), _t(query), k).numpy(), want, full)
    want_set = np.asarray(jgrouping.knn_set(jnp.asarray(xyz), jnp.asarray(query), k))
    _assert_same_neighbours(ops.knn_set(_t(xyz), _t(query), k).numpy(), want_set, full)


def test_knn_defaults_to_self_query(rng):
    xyz = _t(rng.uniform(size=(2, 64, 3)).astype(np.float32))
    d2, idx = ops.knn_with_distance(xyz, k=5)
    assert torch.equal(idx, ops.knn(xyz, xyz, 5))
    assert torch.equal(idx[..., 0], torch.arange(64, dtype=torch.int32).expand(2, 64))
    assert (d2[..., 0] == 0).all()


def test_knn_ties_go_to_the_lower_index_in_both(rng):
    """Integer coordinates: every distance is exact in both forms and ties
    abound; both packages must give the same indices, lower index first."""
    grid = rng.integers(0, 4, size=(2, 96, 3)).astype(np.float32)
    want_d, want_idx = jgrouping.knn_with_distance(jnp.asarray(grid), None, 24, approx=False)
    got_d, got_idx = ops.knn_with_distance(_t(grid), None, 24)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    tied = got_d[..., 1:] == got_d[..., :-1]
    assert tied.any()
    assert (got_idx[..., 1:] > got_idx[..., :-1])[tied].all()


@pytest.mark.parametrize("n,s,k", SHAPES[:2])
def test_pallas_knnset_selects_the_plain_set(rng, n, s, k):
    """The Pallas selection kernel that K5 replaces, in interpret mode and
    fed the full distance matrix as its candidate buffer, selects the set
    that ``knn_plain`` returns."""
    from pointcloud_bridge_tpu.ops.pallas_kernels.knnset import topk_set_from_buffer

    xyz, query = _cloud(rng, n, s)
    d2 = ops.pairwise_sq_dist(_t(query), _t(xyz)).numpy()
    buf_idx = np.broadcast_to(np.arange(n, dtype=np.int32), d2.shape)
    got = np.asarray(topk_set_from_buffer(jnp.asarray(-d2), jnp.asarray(buf_idx), k, True))
    _, want = grouping.knn_plain(_t(xyz), _t(query), k)
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want.numpy(), -1))


def test_knn_refuses_bad_arguments(rng):
    xyz = _t(rng.uniform(size=(1, 16, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="k"):
        ops.knn(xyz, k=17)
    with pytest.raises(ValueError, match="k"):
        ops.knn(xyz, k=0)
    with pytest.raises(TypeError):
        ops.knn(xyz.double(), k=4)


def test_knn_cuda_refuses_cpu_tensors(rng):
    """The kernel wrapper takes CUDA tensors only; a CPU tensor that reaches
    it is refused before any build or launch."""
    xyz = _t(rng.uniform(size=(1, 32, 3)).astype(np.float32))
    before = _kernels.KNN.launches
    with pytest.raises(ValueError, match="CUDA"):
        grouping.knn_cuda(xyz, xyz, 4)
    assert _kernels.KNN.launches == before
    assert "knn" in _kernels.launch_counts()


# ------------------------------------------------------------- structure ops


def _neighbourhoods(rng, kind, k=16):
    """rel_pos [2, 40, k, 3]: random, planar (z = 0), collinear (along one
    direction), or all-equal (a multiple-of-identity covariance of zero)."""
    rel = rng.normal(scale=0.1, size=(2, 40, k, 3)).astype(np.float32)
    if kind == "planar":
        rel[..., 2] = 0.0
    elif kind == "collinear":
        t = rng.normal(scale=0.1, size=(2, 40, k, 1)).astype(np.float32)
        rel = t * np.array([1.0, 2.0, -0.5], np.float32)
    elif kind == "point":
        rel[:] = 0.0
    return rel


@pytest.mark.parametrize("kind", ["random", "planar", "collinear", "point"])
def test_local_structure_features_match_jax(rng, kind):
    rel = _neighbourhoods(rng, kind)
    want = np.asarray(jops.local_structure_features(jnp.asarray(rel)))
    got = ops.local_structure_features(_t(rel))
    assert got.shape == (2, 40, 13) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got[..., 3:], want[..., 3:], rtol=STRUCT_TOL, atol=STRUCT_TOL)
    # A collinear neighbourhood has r = det/2 = 1 in the closed form, where
    # arccos has no derivative: one float32 ulp of r (6e-8) moves phi by
    # 1.2e-4 and with it e2/e1 and e3/e1 by 1e-4. The two packages sum the
    # covariance in another order, so r differs by a few ulps and the three
    # eigenvalue features are held to 1e-3 there (and both to the exact
    # answer 1, 0, 0); everywhere else to 2e-4.
    tol = 1e-3 if kind == "collinear" else STRUCT_TOL
    np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=tol, atol=tol)
    if kind == "collinear":
        np.testing.assert_allclose(got[..., :3], np.broadcast_to([1.0, 0, 0], got[..., :3].shape),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["random", "planar", "collinear", "point"])
def test_eigh3x3_matches_jax(rng, kind):
    rel = _neighbourhoods(rng, kind)
    cov_want = np.asarray(jstructure.local_covariance(jnp.asarray(rel)))
    cov = structure.local_covariance(_t(rel))
    np.testing.assert_allclose(cov.numpy(), cov_want, rtol=1e-5, atol=1e-7)
    want = np.asarray(jstructure.eigh3x3(jnp.asarray(cov_want)))
    got = ops.eigh3x3(_t(cov_want)).numpy()
    np.testing.assert_allclose(got, want, rtol=STRUCT_TOL, atol=STRUCT_TOL)
    assert (got[..., 0] >= got[..., 1] - 1e-6).all() and (got[..., 1] >= got[..., 2] - 1e-6).all()
    if kind == "random":  # against LAPACK, descending
        ref = np.linalg.eigvalsh(cov_want.astype(np.float64))[..., ::-1]
        np.testing.assert_allclose(got, ref, rtol=STRUCT_TOL, atol=STRUCT_TOL)


@pytest.mark.parametrize("ordered", [True, False])
def test_knn_relative_positions_match_jax(rng, ordered):
    xyz = rng.uniform(size=(2, 96, 3)).astype(np.float32)
    query = xyz[:, :24]
    want_rel, want_idx = jstructure.knn_relative_positions(
        jnp.asarray(xyz), 12, ordered=ordered, query=jnp.asarray(query))
    rel, idx = ops.knn_relative_positions(_t(xyz), 12, ordered=ordered, query=_t(query))
    full = np.asarray(jops.square_distance(jnp.asarray(query), jnp.asarray(xyz)))
    _assert_same_neighbours(idx.numpy(), np.asarray(want_idx), full)
    same = (idx.numpy() == np.asarray(want_idx))[..., None]
    np.testing.assert_allclose(
        np.where(same, rel.numpy(), 0), np.where(same, np.asarray(want_rel), 0),
        rtol=STRUCT_TOL, atol=STRUCT_TOL)
    rel_self, idx_self = ops.knn_relative_positions(_t(xyz), 12)
    assert torch.equal(idx_self[:, :24], idx) and torch.equal(rel_self[:, :24], rel)
