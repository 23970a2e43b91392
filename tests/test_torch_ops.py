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

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import flax.linen as nn
import jax
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
from pointcloud_bridge_tpu_torch.models import BatchNorm
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


# ------------------------------------------------------------- backwards


@pytest.mark.parametrize(
    "n,s,d,k",
    [
        (128, 32, 64, 3),
        (96, 40, 24, 4),
        (50, 1, 8, 3),  # one source: the features broadcast
        (60, 2, 8, 3),  # k > S: blend over both sources
    ],
)
def test_interpolate_backward_matches_pallas_vjp(rng, n, s, d, k):
    """d(sum(sin(out)))/dfeats: the port's Interpolate Function and
    interpolate_backward_plain against jax.grad through the Pallas kernel's
    custom VJP (interpret mode) within 1e-5, and through the JAX exact CPU
    path."""
    dst = rng.uniform(size=(2, n, 3)).astype(np.float32)
    src = rng.uniform(size=(2, s, 3)).astype(np.float32)
    f = rng.normal(size=(2, s, d)).astype(np.float32)
    jd, js, jf = jnp.asarray(dst), jnp.asarray(src), jnp.asarray(f)
    want = np.asarray(jax.grad(
        lambda f: jnp.sum(jnp.sin(interpolate_pallas(jd, js, f, k, True)))
    )(jf))
    exact = np.asarray(jax.grad(
        lambda f: jnp.sum(jnp.sin(j_three_nn_interpolate(jd, js, f, k=k, approx=False)))
    )(jf))
    tf = _t(f).requires_grad_(True)
    out = ops.three_nn_interpolate(_t(dst), _t(src), tf, k=k)
    g = torch.cos(out.detach())
    out.backward(g)
    np.testing.assert_allclose(tf.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    # the exact path weighs by expanded-form distances (-2ab + a^2 + b^2):
    # tests/test_pallas_kernels.py holds the Pallas VJP to it at this band
    np.testing.assert_allclose(tf.grad.numpy(), exact, rtol=1e-3, atol=5e-5)
    if s > 1:  # the plain backward on the saved selection
        _, idx, w = interpolate.interpolate_plain(_t(dst), _t(src), _t(f), min(k, s), True)
        plain = interpolate.interpolate_backward_plain(g, idx, w, s)
        np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_group_grads(xyz, new_xyz, idx, feats, g):
    def f(x, c, fe):
        return jnp.sum(jgrouping.group_points(x, c, jnp.asarray(idx), fe) * g)

    return [np.asarray(a) for a in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(feats))]


def test_group_backward_matches_jax_with_empty_balls_and_repeats(rng):
    """Gradients to xyz, new_xyz and features against jax.grad of the JAX
    group_points: empty-ball slots (index N) send theirs to N-1, and a
    repeated first hit adds once per slot."""
    b, n, s, k, c = 2, 64, 16, 8, 5
    xyz = rng.uniform(size=(b, n, 3)).astype(np.float32)
    new_xyz = rng.uniform(size=(b, s, 3)).astype(np.float32)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, s, k)).astype(np.int32)
    idx[:, 0] = n  # empty balls
    idx[:, 1, 2:] = idx[:, 1, :1]  # a sparse ball: its first hit repeated
    g = rng.normal(size=(b, s, k, 3 + c)).astype(np.float32)
    want = _jax_group_grads(xyz, new_xyz, idx, feats, g)
    tx, tc, tf = (_t(a).requires_grad_(True) for a in (xyz, new_xyz, feats))
    out = ops.group_points(tx, tc, _t(idx), tf)
    assert type(out.grad_fn).__name__ == "GroupPointsBackward"
    out.backward(_t(g))
    for got, w in zip((tx.grad, tc.grad, tf.grad), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-6)
    assert np.abs(want[2][:, n - 1]).sum() > 0  # the empty balls' share
    plain = grouping.group_backward_plain(_t(g), _t(idx), n, 0, 3 + c)
    np.testing.assert_allclose(plain[..., :3].numpy(), want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(plain[..., 3:].numpy(), want[2], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("need", ["features", "xyz", "none"])
def test_group_backward_scatters_only_what_is_needed(rng, need):
    """The feature-only case (every SA level past the first) scatters the
    feature channels alone; xyz alone scatters 3 channels; nothing needed,
    nothing scattered."""
    b, n, s, k, c = 1, 20, 6, 4, 3
    xyz = _t(rng.uniform(size=(b, n, 3)).astype(np.float32))
    feats = _t(rng.normal(size=(b, n, c)).astype(np.float32))
    idx = _t(rng.integers(0, n + 1, size=(b, s, k)).astype(np.int32))
    xyz.requires_grad_(need == "xyz")
    feats.requires_grad_(need == "features")
    calls = []
    real = grouping.group_backward_plain

    def spy(g, idx, n, c0, c1):
        calls.append((c0, c1))
        return real(g, idx, n, c0, c1)

    grouping.group_backward_plain = spy
    try:
        out = ops.group_points(xyz, xyz[:, :s].detach(), idx, feats)
        if need == "none":
            assert out.grad_fn is None
            return
        out.sum().backward()
    finally:
        grouping.group_backward_plain = real
    assert calls == [(3, 3 + c)] if need == "features" else calls == [(0, 3)]


def test_interpolate_keeps_its_selection_only_for_a_backward(rng):
    dst = _t(rng.uniform(size=(1, 30, 3)).astype(np.float32))
    src = _t(rng.uniform(size=(1, 10, 3)).astype(np.float32))
    f = _t(rng.normal(size=(1, 10, 4)).astype(np.float32)).requires_grad_(True)
    kept = []
    real = interpolate.interpolate_plain

    def spy(*args):
        kept.append(args[-1])
        return real(*args)

    interpolate.interpolate_plain = spy
    try:
        out = ops.three_nn_interpolate(dst, src, f)
        assert type(out.grad_fn).__name__ == "InterpolateBackward"
        with torch.inference_mode():
            assert ops.three_nn_interpolate(dst, src, f).grad_fn is None
        with torch.no_grad():
            ops.three_nn_interpolate(dst, src, f)
    finally:
        interpolate.interpolate_plain = real
    assert kept == [True, False, False]


def test_batch_norm_matches_flax_with_biased_running_variance(rng):
    """n=4 rows: the unbiased variance would be 4/3 of the biased one, so
    the running variance tells the two apart."""
    x = rng.normal(size=(4, 6)).astype(np.float32) * 3 + 1
    g = rng.normal(size=(4, 6)).astype(np.float32)
    mean0 = (0.1 * rng.normal(size=6)).astype(np.float32)
    var0 = (0.5 + rng.uniform(size=6)).astype(np.float32)
    scale = (0.5 + rng.uniform(size=6)).astype(np.float32)
    bias = (0.1 * rng.normal(size=6)).astype(np.float32)
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(params, x):
        y, mut = fbn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           x, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (y, stats)), (dparams, dx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    tx = _t(x).requires_grad_(True)
    out = bn(tx)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(dparams["scale"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(dparams["bias"]), rtol=1e-5, atol=1e-5)
    unbiased = 0.9 * var0 + 0.1 * x.var(0, ddof=1)
    assert not np.allclose(bn.running_var.numpy(), unbiased, rtol=1e-3)
    bn.eval()
    with torch.no_grad():  # eval mode normalises with the running statistics
        want = (x - bn.running_mean.numpy()) / np.sqrt(bn.running_var.numpy() + 1e-5) * scale + bias
        np.testing.assert_allclose(bn(_t(x)).numpy(), want, rtol=1e-5, atol=1e-5)


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
    g = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        grouping.group_backward_cuda(g, idx, 32, 3, 8)
    w = torch.zeros((1, 32, 3))
    with pytest.raises(ValueError, match="CUDA"):
        interpolate.interpolate_backward_cuda(f, w.int(), w, 8)


def test_ops_refuse_other_dtypes(rng):
    xyz = torch.from_numpy(rng.uniform(size=(1, 16, 3)))  # float64
    with pytest.raises(TypeError):
        ops.farthest_point_sample(xyz, 4)
    with pytest.raises(TypeError):
        ops.query_ball_point(0.2, 4, xyz, xyz)
