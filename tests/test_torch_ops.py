"""The PyTorch port's ops against the JAX package, on the CPU.

On the CPU every op of the port runs its plain PyTorch version (the CUDA
kernels run only on the card, where chip_smoke.py holds each one against
its plain version). Inputs come from seeded numpy and go through both
packages. The JAX side is the exact path: ``_fps_jnp``, the Pallas kernels
in interpret mode (as tests/test_pallas_kernels.py runs them) and the
``approx=False`` ops. Index and gather outputs must be bit-identical;
interpolation agrees with the interpret-mode kernel to 1e-5 (both compute
the direct-form distances; the blend sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.ops import grouping as jgrouping
from pointcloud_bridge_tpu.ops.core import index_points as j_index_points
from pointcloud_bridge_tpu.ops.core import square_distance as j_square_distance
from pointcloud_bridge_tpu.ops.interpolate import (
    three_nn_interpolate as j_three_nn_interpolate,
)
from pointcloud_bridge_tpu.ops.pallas_kernels.ballq import ball_query_pallas
from pointcloud_bridge_tpu.ops.pallas_kernels.interp3 import interpolate_pallas
from pointcloud_bridge_tpu.ops.sampling import _fps_jnp
from pointcloud_bridge_tpu_torch import ops
from pointcloud_bridge_tpu_torch.ops import grouping, interpolate, sampling


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------- FPS


@pytest.mark.parametrize("b,n,npoint", [(2, 512, 128), (2, 256, 64), (1, 100, 37)])
def test_fps_matches_fps_jnp(rng, b, n, npoint):
    xyz = rng.uniform(size=(b, n, 3)).astype(np.float32)
    want = np.asarray(_fps_jnp(jnp.asarray(xyz), npoint))
    got = ops.farthest_point_sample(_t(xyz), npoint)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_start_idx_tensor_matches_fps_jnp(rng):
    xyz = rng.uniform(size=(3, 200, 3)).astype(np.float32)
    starts = np.array([5, 0, 199], np.int32)
    want = np.asarray(_fps_jnp(jnp.asarray(xyz), 48, jnp.asarray(starts)))
    got = ops.farthest_point_sample(_t(xyz), 48, _t(starts))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, 0].numpy(), starts)


def test_fps_ties_match_fps_jnp(rng):
    """Points on a coarse integer grid: many exact duplicates and equal
    distances, so every step exercises the lowest-index tie rule."""
    xyz = rng.integers(0, 4, size=(2, 256, 3)).astype(np.float32)
    want = np.asarray(_fps_jnp(jnp.asarray(xyz), 96, 7))
    got = ops.farthest_point_sample(_t(xyz), 96, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_rejects_out_of_range_start(rng):
    xyz = _t(rng.uniform(size=(2, 16, 3)).astype(np.float32))
    with pytest.raises(ValueError):
        ops.farthest_point_sample(xyz, 4, 16)
    with pytest.raises(ValueError):
        ops.farthest_point_sample(xyz, 4, torch.tensor([0, -1]))


# -------------------------------------------------------------- ball query


@pytest.mark.parametrize(
    "n,s,k,r",
    [
        (512, 128, 32, 0.2),
        (256, 64, 32, 0.4),   # the sa3 radius
        (300, 100, 8, 0.15),  # ragged sizes
        (64, 16, 128, 0.3),   # nsample > N: pad with the first hit
        (128, 8, 4, 1e-4),    # mostly empty balls: every slot N
    ],
)
def test_ball_query_matches_pallas_and_exact_path(rng, n, s, k, r):
    xyz = rng.uniform(size=(2, n, 3)).astype(np.float32)
    q = rng.uniform(size=(2, s, 3)).astype(np.float32)
    want = np.asarray(
        ball_query_pallas(r, k, jnp.asarray(xyz), jnp.asarray(q), interpret=True)
    )
    exact = np.asarray(
        jgrouping.query_ball_point(r, k, jnp.asarray(xyz), jnp.asarray(q), approx=False)
    )
    got = ops.query_ball_point(r, k, _t(xyz), _t(q))
    assert got.dtype == torch.int32 and got.shape == (2, s, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), exact)


def test_ball_query_empty_ball_gives_n(rng):
    xyz = rng.uniform(size=(1, 40, 3)).astype(np.float32)
    q = np.full((1, 3, 3), 10.0, np.float32)  # far from every point
    got = ops.query_ball_point(0.5, 6, _t(xyz), _t(q))
    np.testing.assert_array_equal(got.numpy(), np.full((1, 3, 6), 40))


def test_ball_query_radius_rounds_like_jax():
    """A point exactly at float32(radius**2) is inside, as in the JAX
    package, which compares against radius*radius rounded to float32."""
    r = 0.1
    d = float(np.sqrt(np.float32(r * r)))
    xyz = np.array([[[d, 0, 0], [0.5, 0, 0]]], np.float32)
    q = np.zeros((1, 1, 3), np.float32)
    want = np.asarray(
        ball_query_pallas(r, 2, jnp.asarray(xyz), jnp.asarray(q), interpret=True)
    )
    got = ops.query_ball_point(r, 2, _t(xyz), _t(q))
    np.testing.assert_array_equal(got.numpy(), want)
    assert grouping.radius_sq(r) == float(np.float32(r * r))


# ---------------------------------------------------------------- grouping


@pytest.mark.parametrize("c", [0, 3, 16])
def test_group_points_matches_jax(rng, c):
    b, n, s, k = 2, 96, 24, 8
    xyz = rng.uniform(size=(b, n, 3)).astype(np.float32)
    new_xyz = rng.uniform(size=(b, s, 3)).astype(np.float32)
    idx = rng.integers(0, n + 1, size=(b, s, k)).astype(np.int32)  # N = miss
    feats = rng.normal(size=(b, n, c)).astype(np.float32) if c else None
    want = np.asarray(
        jgrouping.group_points(
            jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(idx),
            None if feats is None else jnp.asarray(feats),
        )
    )
    got = ops.group_points(
        _t(xyz), _t(new_xyz), _t(idx), None if feats is None else _t(feats)
    )
    assert got.shape == (b, s, k, 3 + c)
    np.testing.assert_array_equal(got.numpy(), want)


def test_index_points_clamps_like_jax(rng):
    pts = rng.normal(size=(2, 10, 5)).astype(np.float32)
    idx = np.array([[0, 9, 10, -1], [3, 3, 12, 1]], np.int32)
    want = np.asarray(j_index_points(jnp.asarray(pts), jnp.asarray(idx)))
    got = ops.index_points(_t(pts), _t(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_and_group_matches_jax(rng):
    xyz = rng.uniform(size=(2, 256, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 256, 4)).astype(np.float32)
    want = jgrouping.sample_and_group(
        64, 0.2, 16, jnp.asarray(xyz), jnp.asarray(feats)
    )
    got = ops.sample_and_group(64, 0.2, 16, _t(xyz), _t(feats))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_square_distance_matches_jax(rng):
    a = rng.uniform(size=(2, 30, 3)).astype(np.float32)
    b = rng.uniform(size=(2, 20, 3)).astype(np.float32)
    want = np.asarray(j_square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = ops.square_distance(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    direct = ops.pairwise_sq_dist(_t(a), _t(b))
    np.testing.assert_allclose(direct.numpy(), want, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- interpolation


@pytest.mark.parametrize(
    "n,s,d,k",
    [
        (256, 64, 32, 3),  # an fp3-like shape, narrow
        (512, 128, 16, 3),
        (300, 100, 37, 4),  # ragged, EnhancedFP's k=4
        (64, 16, 8, 3),
    ],
)
def test_interpolate_matches_pallas_interpret(rng, n, s, d, k):
    dst = rng.uniform(size=(2, n, 3)).astype(np.float32)
    src = rng.uniform(size=(2, s, 3)).astype(np.float32)
    f = rng.normal(size=(2, s, d)).astype(np.float32)
    want = np.asarray(
        interpolate_pallas(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(f), k, True)
    )
    got = ops.three_nn_interpolate(_t(dst), _t(src), _t(f), k=k)
    assert got.shape == (2, n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_interpolate_picks_lowest_index_on_ties():
    """Two sources at the same distance: the first-min picks the lower
    index first, so with k=1 the output is that source's row."""
    src = np.array([[[1, 0, 0], [-1, 0, 0], [0, 5, 0]]], np.float32)
    dst = np.zeros((1, 1, 3), np.float32)
    f = np.array([[[1.0], [2.0], [3.0]]], np.float32)
    got = ops.three_nn_interpolate(_t(dst), _t(src), _t(f), k=1)
    assert got.item() == 1.0


@pytest.mark.parametrize("s,k", [(1, 3), (2, 3)])
def test_interpolate_few_sources_matches_jax(rng, s, k):
    """S == 1 broadcasts; S < k blends over all S sources."""
    dst = rng.uniform(size=(2, 20, 3)).astype(np.float32)
    src = rng.uniform(size=(2, s, 3)).astype(np.float32)
    f = rng.normal(size=(2, s, 6)).astype(np.float32)
    want = np.asarray(
        j_three_nn_interpolate(
            jnp.asarray(dst), jnp.asarray(src), jnp.asarray(f), k=k, approx=False
        )
    )
    got = ops.three_nn_interpolate(_t(dst), _t(src), _t(f), k=k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ the kernel wrappers


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """The kernel wrappers take CUDA tensors only: the dispatch sends CPU
    tensors to the plain versions, and a CPU tensor that reaches a wrapper
    is refused before any build or launch."""
    xyz = _t(rng.uniform(size=(1, 32, 3)).astype(np.float32))
    idx = torch.zeros((1, 4, 2), dtype=torch.int32)
    f = _t(rng.normal(size=(1, 32, 5)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        sampling.fps_cuda(xyz, 4, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        grouping.ball_query_cuda(0.2, 4, xyz, xyz[:, :4].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        grouping.group_cuda(xyz, xyz[:, :4].contiguous(), idx, f)
    with pytest.raises(ValueError, match="CUDA"):
        interpolate.interpolate_cuda(xyz, xyz[:, :8].contiguous(), f[:, :8].contiguous(), 3)


def test_ops_refuse_other_dtypes(rng):
    xyz = torch.from_numpy(rng.uniform(size=(1, 16, 3)))  # float64
    with pytest.raises(TypeError):
        ops.farthest_point_sample(xyz, 4)
    with pytest.raises(TypeError):
        ops.query_ball_point(0.2, 4, xyz, xyz)
