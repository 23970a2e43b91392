"""DGCNN's restructured EdgeConv in the PyTorch port against the JAX
package's, on the CPU, both packages set to it by ``PCB_EDGECONV_FAST=1``
(the JAX package runs it on its accelerator, the port on the card; on the
CPU both default to the literal form, tests/test_torch_dgcnn.py).

- ``ops.edge``: the plain ``edge_reduce`` against ``index_points`` and the
  reductions (the max and min exactly, the means within 1e-6 of max|y|
  and max y^2: K7's fold adds in slot order), on normal values and on an
  integer grid full of ties, against the JAX gather and reductions too;
  its gradient against ``jax.vjp`` of those and against torch's autograd
  of them, a tie splitting the cotangent evenly; the ties K7 counts
  against the counts the plain gradient divides by and a numpy emulation
  of K7's online count; the kernels' plans, lanes, routes, refusals and
  K7b's scratch; the custom op's fake shapes.
- One EdgeConv (B = 2, N = 64, C = 16, F = 24, k = 8; the BatchNorm's
  scales of both signs and one exactly 0, which takes the min as
  ``where(a > 0, mx, mn)`` does) against the JAX module on the JAX graph,
  in the bands of tests/test_models.py:99-145: eval within rtol 1e-4 and
  atol 1e-5; train mode with the running statistics, and the gradients on
  x and the weights, held to the JAX float64 module (the float32 moments
  cancel in mean2 - mu^2 on both sides) within those bands plus twice the
  JAX float32 module's own error.
- ``dgcnn`` and ``dgcnn_global`` (B = 2, N = 128): eval logits within 2e-4
  of the JAX fast path on its graphs; the two forms' state_dicts are one
  and the same, and a state trained in one form serves in the other.
The train steps are in tests/test_torch_edgeconv_fast_train.py.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import functools
import inspect
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pointcloud_bridge_tpu.models import dgcnn as jdgcnn
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.ops import index_points as jax_index_points
from pointcloud_bridge_tpu_torch.models import BatchNorm, EdgeConv, get_model
from pointcloud_bridge_tpu_torch.models import dgcnn as tdgcnn
from pointcloud_bridge_tpu_torch.ops import _kernels, edge, index_points
from pointcloud_bridge_tpu_torch.ops.grouping import group_backward_order
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict

from test_torch_bristrunet import randomize
from test_torch_dgcnn import JaxGraphs, jax_variables

TOL = 2e-4
B, N = 2, 128
MODELS = ("dgcnn", "dgcnn_global")


@pytest.fixture
def fast(monkeypatch):
    monkeypatch.setenv("PCB_EDGECONV_FAST", "1")


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------- the reduction


def reduction_case(seed: int, grid: bool):
    """y [2, 50, 6] (normal, or integers 0-2: ties in most rows) and idx
    [2, 40, 7] with repeated slots and one index past N (clamped)."""
    rng = np.random.default_rng(seed)
    y = (rng.integers(0, 3, (2, 50, 6)) if grid else rng.normal(size=(2, 50, 6)))
    idx = rng.integers(0, 50, (2, 40, 7)).astype(np.int32)
    idx[0, 3, 2] = 50
    return y.astype(np.float32), idx


def jax_reductions(y, idx):
    yg = jax_index_points(y, idx)
    return (jnp.max(yg, axis=2), jnp.min(yg, axis=2), jnp.mean(yg, axis=2),
            jnp.mean(yg * yg, axis=2))


@pytest.mark.parametrize("grid", [False, True], ids=["normal", "grid"])
@pytest.mark.parametrize("moments", [False, True])
def test_plain_reduction_matches_the_gather_and_reductions(grid, moments):
    y, idx = reduction_case(1, grid)
    got = edge.edge_reduce_plain(_t(y), _t(idx), moments)
    yg = index_points(_t(y), _t(idx))
    want = (yg.amax(2), yg.amin(2), yg.mean(2), (yg * yg).mean(2))
    jwant = jax_reductions(jnp.asarray(y), jnp.asarray(idx))
    assert len(got) == (4 if moments else 2)
    for i, g in enumerate(got):
        assert g.shape == (2, 40, 6) and g.dtype == torch.float32
        if i < 2:
            assert torch.equal(g, want[i])
            np.testing.assert_array_equal(g.numpy(), np.asarray(jwant[i]))
        else:
            scale = 1e-6 * float(np.abs(y).max()) ** (i - 1)
            np.testing.assert_allclose(g.numpy(), want[i].numpy(), rtol=0, atol=scale)
            np.testing.assert_allclose(g.numpy(), np.asarray(jwant[i]), rtol=0, atol=scale)


@pytest.mark.parametrize("grid", [False, True], ids=["normal", "grid"])
@pytest.mark.parametrize("moments", [False, True])
def test_gradient_splits_ties_as_jax_does(grid, moments):
    """EdgeReduce's backward (the plain one, K7b's arithmetic) against
    ``jax.vjp`` of the JAX gather and reductions and against torch's
    autograd of amax, amin and the means, within 1e-6 of max|g|; on the
    grid a row's max is held by up to 7 slots."""
    y, idx = reduction_case(2, grid)
    rng = np.random.default_rng(3)
    cots = [rng.normal(size=(2, 40, 6)).astype(np.float32) for _ in range(4 if moments else 2)]
    yt = _t(y).requires_grad_(True)
    outs = edge.edge_reduce(yt, _t(idx), moments)
    sum(o.mul(_t(c)).sum() for o, c in zip(outs, cots)).backward()
    _, vjp = jax.vjp(lambda a: jax_reductions(a, jnp.asarray(idx))[:len(cots)], jnp.asarray(y))
    (jgrad,) = vjp(tuple(jnp.asarray(c) for c in cots))
    ya = _t(y).requires_grad_(True)
    yg = index_points(ya, _t(idx))
    ref = (yg.amax(2), yg.amin(2), yg.mean(2), (yg * yg).mean(2))[:len(cots)]
    sum(o.mul(_t(c)).sum() for o, c in zip(ref, cots)).backward()
    band = 1e-6 * float(np.abs(np.asarray(jgrad)).max())
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jgrad), rtol=0, atol=band)
    np.testing.assert_allclose(yt.grad.numpy(), ya.grad.numpy(), rtol=0, atol=band)
    if grid:
        hits = (index_points(_t(y), _t(idx)) == outs[0].detach().unsqueeze(2)).sum(2)
        assert hits.max() > 2  # ties were there to split
    # the kernel's order of adds (K3b's) against scatter_add_'s
    d = [o.detach() for o in outs]
    ordered = group_backward_order(edge.edge_grads_plain(_t(y), _t(idx), *d[:2], *map(_t, cots)),
                                   _t(idx), 50, 0, 6)
    np.testing.assert_allclose(ordered.numpy(), yt.grad.numpy(), rtol=0, atol=band)


def test_per_edge_gradients_follow_the_formula():
    """edge_grads_plain, slot by slot: the max's cotangent over its ties,
    the min's likewise, g_s1 / k and 2 y g_s2 / k."""
    y, idx = reduction_case(4, True)
    g = [np.random.default_rng(5).normal(size=(2, 40, 6)).astype(np.float32) for _ in range(4)]
    mx, mn = edge.edge_reduce_plain(_t(y), _t(idx))
    e = edge.edge_grads_plain(_t(y), _t(idx), mx, mn, *map(_t, g)).double().numpy()
    yg = index_points(_t(y), _t(idx)).double().numpy()
    k = idx.shape[-1]
    hx, hn = yg == mx.double().numpy()[:, :, None], yg == mn.double().numpy()[:, :, None]
    want = (hx * (g[0] / hx.sum(2))[:, :, None] + hn * (g[1] / hn.sum(2))[:, :, None]
            + g[2][:, :, None] / k + 2 * yg * g[3][:, :, None] / k)
    np.testing.assert_allclose(e, want, rtol=1e-6, atol=1e-6)


def online_ties(yg: np.ndarray):
    """K7's fold of [B, S, k, F] slot by slot in numpy: the max and the min
    (NaN sticks), and their ties counted as the slots go by (a new max
    restarts at 1, an equal value adds 1) -> (mx, mn, ties packed)."""
    shape = yg.shape[:2] + yg.shape[3:]
    hi, lo = np.full(shape, -np.inf, np.float32), np.full(shape, np.inf, np.float32)
    nx, nn = np.zeros(shape, np.int64), np.zeros(shape, np.int64)
    for j in range(yg.shape[2]):
        a = yg[:, :, j]
        with np.errstate(invalid="ignore"):
            up, down = (a > hi) | np.isnan(a), (a < lo) | np.isnan(a)
            nx = np.where(up, 1, nx + (a == hi))
            nn = np.where(down, 1, nn + (a == lo))
        hi, lo = np.where(up, a, hi), np.where(down, a, lo)
    return hi, lo, (nx | nn << 16).astype(np.int32)


def special_case():
    """y [2, 50, 6] of -0.0, +0.0, -inf, 1 and a few NaN, idx as
    reduction_case's: rows whose max or min is a signed zero, -inf or NaN."""
    y, idx = reduction_case(9, True)
    rng = np.random.default_rng(10)
    y = np.array([-0.0, 0.0, -np.inf, 1.0], np.float32)[rng.integers(0, 4, y.shape)]
    y[1, 7, 2] = y[0, 11, 4] = np.nan
    return y, idx


@pytest.mark.parametrize("case", ["normal", "grid", "special"])
def test_tie_counts_match_what_the_plain_gradient_divides_by(case):
    """tie_counts_plain (the ties K7 writes and K7b divides by) against the
    counts edge_grads_plain takes (its hits' sums) and against K7's online
    count emulated in numpy, wherever the max (the min) is not NaN; the
    emulation's max and min against edge_reduce_plain's, NaN included; and
    the ties edge_reduce_plain appends are the same."""
    y, idx = special_case() if case == "special" else reduction_case(11, case == "grid")
    yt, it = _t(y), _t(idx)
    mx, mn, s1, s2, ties = edge.edge_reduce_plain(yt, it, True, True)
    assert ties.dtype == torch.int32 and ties.shape == mx.shape
    assert torch.equal(ties, edge.tie_counts_plain(yt, it, mx, mn))
    yg = index_points(yt, it)
    implied = ((yg == mx.unsqueeze(2)).sum(2), (yg == mn.unsqueeze(2)).sum(2))
    got = (ties & 0xFFFF, (ties >> 16) & 0xFFFF)
    hi, lo, online = online_ties(yg.numpy())
    np.testing.assert_array_equal(hi, mx.numpy())
    np.testing.assert_array_equal(lo, mn.numpy())
    for half, (g, want, ref) in enumerate(zip(got, implied, (mx, mn))):
        valid = ~torch.isnan(ref)
        assert torch.equal(g[valid].long(), want[valid])
        own = torch.from_numpy((online >> 16 * half) & 0xFFFF)
        assert torch.equal(own[valid], g[valid])
    if case == "grid":
        assert int(got[0].max()) > 2  # ties were there to count
    if case == "special":
        assert torch.isnan(mx).any() and (mx == 0).any() and torch.isinf(mn).any()


# ------------------------------------------------------- the launch path


@pytest.mark.parametrize("source,symbol,fields", [
    ("edge_reduce.cu", "pcb_edge_reduce", edge.EDGE_PLAN),
    ("edge_reduce_bwd.cu", "pcb_edge_reduce_backward", edge.EDGE_BWD_PLAN),
])
def test_plan_fields_in_the_order_c_reads_them(source, symbol, fields):
    """K7 reads EDGE_PLAN's slots and K7b EDGE_BWD_PLAN's into the variables
    they name; inv_k as the float32 bits of the last slot."""
    text = (_kernels.CSRC / source).read_text()
    body = text[text.index(f"PCB_API int {symbol}("):]
    read = {int(m.group(2)): m.group(1)
            for m in re.finditer(r"const int (\w+) = plan\[(\d+)\];", body)}
    m = re.search(r"memcpy\(&inv_k, plan \+ (\d+), sizeof\(float\)\)", body)
    read[int(m.group(1))] = "inv_k_bits"
    assert read == dict(enumerate(fields))


def test_row_pass_probe_reads_k7s_plan():
    """probes/k7b_rows.cu (the row pass measured against K7's online ties)
    takes K7's plan: it reads EDGE_PLAN's first six slots into the variables
    they name, and its wrapper builds it with edge._edge_plan."""
    from pointcloud_bridge_tpu_torch.probes import k7_probe

    text = (k7_probe.HERE / "k7b_rows.cu").read_text()
    body = text[text.index("PCB_API int pcb_edge_tie_rows("):]
    read = {int(m.group(2)): m.group(1)
            for m in re.finditer(r"const int (\w+) = plan\[(\d+)\];", body)}
    assert read == dict(enumerate(edge.EDGE_PLAN[:6]))
    assert "k7b_rows.cu" in inspect.getsource(k7_probe.start_build)
    assert "edge._edge_plan(" in inspect.getsource(k7_probe.edge_tie_rows)


def test_plans_hold_the_launch():
    plan = edge._edge_plan(16, 4096, 4096, 20, 64, 2, True)
    assert list(plan)[:7] == [16, 4096, 4096, 20, 64, 2, 1]
    assert np.int32(plan[7]).view(np.float32) == np.float32(1) / np.float32(20)
    assert edge.inv_k(3) == float(np.float32(1 / 3)) and edge.inv_k(64) == 1 / 64
    for bad in ((4, 4096, 4096, 0, 64, 2, False), (4, 4096, 4096, 20, 6, 4, False),
                (4, 4096, 4096, 20, 64, 3, False), (4, 0, 4096, 20, 64, 1, False)):
        with pytest.raises(ValueError, match="edge reduce kernel"):
            edge._edge_plan(*bad)
    bwd = edge._edge_bwd_plan(16, 4096, 4096, 20, 64, True, 9)
    want = dict(b=16, n=4096, s=4096, k=20, f=64, moments=1, split=9, staged=1)
    assert dict(zip(edge.EDGE_BWD_PLAN, bwd)) | want == dict(zip(edge.EDGE_BWD_PLAN, bwd))
    mul, shift = bwd[8] % 2**32, bwd[9]  # k's FastDiv, read as unsigned
    assert (mul, shift) == edge.fast_divisor(20)
    assert all((i * mul >> 32) >> shift == i // 20 for i in (0, 19, 20, 81919, 2**31 - 1))
    assert np.int32(bwd[10]).view(np.float32) == np.float32(1) / np.float32(20)
    assert edge._edge_bwd_plan(1, 8192, 8192, 20, 64, False, 1)[7] == 0
    with pytest.raises(ValueError, match="split"):
        edge._edge_bwd_plan(16, 4096, 4096, 20, 64, True, 0)


@pytest.mark.parametrize("s,staged", [(4096, True), (4842, True), (4843, False), (1, True)])
def test_k7b_fold_route_by_rows(s, staged):
    """K7b's fold stages a 48-byte record a row of its channel pair: staged
    up to S = 4,842, then it reads device memory at each slot."""
    assert edge.edge_fold_staged(s) is staged


@pytest.mark.parametrize("b,s,k,split", [(4, 4096, 20, 16), (16, 4096, 20, 16), (4, 4096, 64, 52),
                                         (16, 4096, 64, 17), (2, 1000, 8, 2), (1, 4096, 64, 52)])
def test_k7b_sort_split_by_slots_and_sms(b, s, k, split):
    assert edge.edge_sort_split(b, s, k, 132) == split


def test_k7b_scratch_holds_no_per_edge_tensor(monkeypatch):
    """At dgcnn_global's conv4 in the batch-16 step ([16, 4096, 64, 128]),
    what K7b's wrapper allocates (seen through torch.empty on the meta
    device) is its output and the sort's ints, under a quarter of the
    B * S * k * F float32 elements the first design's per-edge scratch held, and no
    tensor of B * S * k * F elements at all."""
    b, n, k, f = 16, 4096, 64, 128
    per_edge = b * n * k * f * 4
    scratch = 4 * edge.edge_bwd_work(b, n, n, k, edge.edge_sort_split(b, n, k, 132))
    assert scratch < per_edge / 4
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(_kernels, "stream_args", lambda t: (0, None))
    launched = []
    monkeypatch.setattr(_kernels.EDGE_REDUCE_BWD, "launch", lambda *a: launched.append(a))
    made = []
    empty = torch.empty

    def recording(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", recording)
    y = empty(b, n, f, device="meta")
    idx = empty(b, n, k, dtype=torch.int32, device="meta")
    rows = [empty(b, n, f, device="meta") for _ in range(6)]
    ties = empty(b, n, f, dtype=torch.int32, device="meta")
    out = edge.edge_reduce_backward_cuda(y, idx, *rows, ties=ties)
    assert out.shape == (b, n, f) and len(launched) == 1
    sizes = [t.numel() * t.element_size() for t in made]
    assert max(t.numel() for t in made) < b * n * k * f
    assert sum(sizes) - out.numel() * 4 == scratch
    assert sum(sizes) < per_edge / 4


@pytest.mark.parametrize("f,vec", [(64, 2), (128, 4), (256, 4), (24, 1), (3, 1), (66, 2),
                                   (33, 1), (96, 4)])
def test_lanes_cover_the_channels(f, vec):
    """The fewest floats a lane whose warp covers F (F = 64: 2, one row of
    256 bytes a slot), 4 past 128 channels, F a multiple of it."""
    assert edge.edge_vec(f, torch.empty(2, f)) == vec


def test_lanes_follow_alignment():
    """A view 4 bytes off 16-byte alignment takes one float a lane."""
    base = torch.empty(2 * 128 + 1)
    assert edge.edge_vec(128, base[:256]) == 4
    assert edge.edge_vec(128, base[1:]) == 1
    assert edge.edge_vec(64, base[2:130]) == 2


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """CPU tensors; then, with ``is_cuda`` patched (meta tensors): K7's ties
    past 16 bits (k > 65535), K7b past N = GROUP_BWD_MAX_N (the sort's
    shared counts), without K7's ties or with ties of another shape or type. (K7b's fold past a
    block's shared memory takes its other route: test_k7b_fold_route_by_rows.)"""
    y, idx = reduction_case(6, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        edge.edge_reduce_cuda(_t(y), _t(idx))
    mx = torch.zeros(2, 40, 6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        edge.edge_reduce_backward_cuda(_t(y), _t(idx), mx, mx, mx, mx)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    meta = functools.partial(torch.zeros, device="meta")
    with pytest.raises(ValueError, match="16 bits"):
        edge.edge_reduce_cuda(meta(1, 8, 4), meta(1, 2, 65536, dtype=torch.int32), True, True)
    big = edge.GROUP_BWD_MAX_N + 1
    rows = meta(1, 8, 4)
    with pytest.raises(ValueError, match="edge reduce backward kernel"):
        edge.edge_reduce_backward_cuda(meta(1, big, 4), meta(1, 8, 20, dtype=torch.int32),
                                       rows, rows, rows, rows, ties=meta(1, 8, 4,
                                                                         dtype=torch.int32))
    monkeypatch.setattr(_kernels, "sm_count", lambda device: 132)
    for ties in (None, meta(1, 8, 5, dtype=torch.int32), meta(1, 8, 4)):
        with pytest.raises((TypeError, ValueError), match="ties"):
            edge.edge_reduce_backward_cuda(meta(1, 64, 4), meta(1, 8, 20, dtype=torch.int32),
                                           rows, rows, rows, rows, ties=ties)


def test_wrappers_check_types_and_shapes(monkeypatch):
    """With ``is_cuda`` patched (meta tensors): a float64 y, an int64 idx, a
    strided y, idx of another batch and a cotangent of another shape."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    y = torch.zeros(2, 50, 6, device="meta")
    idx = torch.zeros(2, 40, 7, dtype=torch.int32, device="meta")
    assert edge._check_edge_args(y, idx) == (2, 50, 40, 7, 6)
    with pytest.raises(TypeError):
        edge._check_edge_args(y.double(), idx)
    with pytest.raises(TypeError):
        edge._check_edge_args(y, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        edge._check_edge_args(y.transpose(1, 2), idx)
    with pytest.raises(ValueError, match="edge reduce"):
        edge._check_edge_args(y, idx[:1])
    rows = torch.zeros(2, 40, 6, device="meta")
    with pytest.raises(ValueError, match="g_mn"):
        edge.edge_reduce_backward_cuda(y, idx, rows, rows, rows, rows[:, :3])


def test_probe_edits_find_their_text():
    """probes/k7_probe.py times textual variants of csrc/edge_reduce_bwd.cu,
    csrc/group_bwd.cu and probes/k7_staged.cu on the card: every text it
    edits is in the source as it stands."""
    from pointcloud_bridge_tpu_torch.probes import k7_probe

    k7b = (_kernels.CSRC / "edge_reduce_bwd.cu").read_text()
    staged = (k7_probe.HERE / "k7_staged.cu").read_text()
    for table, text in ((k7_probe.K7B_VARIANTS, k7b), (k7_probe.K7_VARIANTS, staged)):
        for name, edits in table:
            assert all(old in text for old, _ in edits), name
    assert all(line in k7b for _, line, _ in k7_probe.K7B_PARTS)
    assert k7_probe.SORT_ONLY[0] in (_kernels.CSRC / "group_bwd.cu").read_text()


@pytest.mark.parametrize("moments", [False, True])
def test_fake_implementation_matches_the_plain_version(moments):
    y, idx = map(_t, reduction_case(7, False))
    real = edge.EDGE_REDUCE_OP(y, idx, moments)
    with FakeTensorMode() as mode:
        fake = edge.EDGE_REDUCE_OP(mode.from_tensor(y), mode.from_tensor(idx), moments)
    assert [(tuple(t.shape), t.dtype) for t in fake] == [(tuple(t.shape), t.dtype) for t in real]
    assert len(real) == (4 if moments else 2)


def test_eager_path_does_not_reach_the_op(monkeypatch, fast):
    def refuse(*args, **kwargs):
        raise AssertionError("an op was called on the eager path")

    monkeypatch.setattr(edge, "EDGE_REDUCE_OP", refuse)
    with torch.no_grad():
        out = get_model("dgcnn", 5).eval()(torch.rand(1, 64, 3), None)
    assert out.shape == (1, 64, 5)


@pytest.mark.parametrize("flag,want", [(None, False), ("1", True), ("0", False),
                                       ("false", False), ("", False), ("yes", True)])
def test_the_form_follows_the_flag_and_the_device(monkeypatch, flag, want):
    """PCB_EDGECONV_FAST as the JAX package reads it; unset, the card takes
    the restructured form and the CPU the literal one."""
    if flag is None:
        monkeypatch.delenv("PCB_EDGECONV_FAST", raising=False)
        assert tdgcnn._edgeconv_fast_default(types.SimpleNamespace(is_cuda=True))
    else:
        monkeypatch.setenv("PCB_EDGECONV_FAST", flag)
    assert tdgcnn._edgeconv_fast_default(torch.zeros(1)) is want
    assert jdgcnn._edgeconv_fast_default() is want


def test_literal_form_stays_the_cpu_default(monkeypatch):
    """Unset, a CPU forward builds the [B, N, k, 2C] graph feature and never
    reaches edge_reduce."""
    monkeypatch.delenv("PCB_EDGECONV_FAST", raising=False)
    monkeypatch.setattr(tdgcnn, "edge_reduce", None)
    with torch.no_grad():
        assert get_model("dgcnn_global", 5).eval()(torch.rand(1, 32, 3), None).shape == (1, 32, 5)


# -------------------------------------------------------------- one EdgeConv

C, F, K, EN = 16, 24, 8, 64


@pytest.fixture(scope="module")
def edgeconv():
    """JAX variables of one EdgeConv (scales of both signs, one exactly 0),
    its input and cotangent, its graph, and the JAX fast module's eval
    output, train output, statistics and gradients in float32 and float64."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PCB_EDGECONV_FAST", "1")
    try:
        rng = np.random.default_rng(11)
        x = rng.normal(size=(2, EN, C)).astype(np.float32)
        cot = rng.normal(size=(2, EN, F)).astype(np.float32)
        module = jdgcnn.EdgeConv(F, K)
        v = randomize(jax.jit(lambda a: module.init(jax.random.PRNGKey(1), a, False))(x), 12)
        scale = v["params"]["bn"]["scale"]
        scale[::2] *= -1.0
        scale[5] = 0.0
        graphs = JaxGraphs(mp)
        graphs.record()
        out = {"eval": np.asarray(jax.jit(lambda p: module.apply(p, x, False))(v))}
        graph = graphs.stages[0][1]
        mp.setattr(jdgcnn, "knn_set", lambda a, query=None, k=16, recall_target=0.9:
                   jnp.asarray(graph))

        def train(params, stats, xa):
            y, mut = module.apply({"params": params, "batch_stats": stats}, xa, True,
                                  mutable=["batch_stats"])
            return jnp.sum(y * cot.astype(y.dtype)), (y, mut["batch_stats"])

        step = jax.jit(jax.value_and_grad(train, argnums=(0, 2), has_aux=True))
        x64 = jax.config.jax_enable_x64
        for dt in (np.float32, np.float64):
            jax.config.update("jax_enable_x64", dt == np.float64)
            try:
                vd = jax.tree_util.tree_map(lambda a: np.asarray(a, dt), v)
                (_, (y, stats)), (gp, gx) = step(vd["params"], vd["batch_stats"], x.astype(dt))
                assert y.dtype == dt
                out[dt] = jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float64),
                    {"train": y, "stats": stats["bn"], "gx": gx, "gw": gp["conv"]["kernel"],
                     "gscale": gp["bn"]["scale"], "gbias": gp["bn"]["bias"]})
            finally:
                jax.config.update("jax_enable_x64", x64)
        return v, x, cot, graph, out
    finally:
        mp.undo()


def port_edgeconv(v, train: bool):
    holder = torch.nn.Module()
    holder.edge, holder.bn = EdgeConv(C, F, K), BatchNorm(F)
    holder.load_state_dict(flax_to_state_dict(
        v, [("edge.0", ("conv",), "conv2d"), ("bn", ("bn",), "bn")]), strict=True)
    return holder.train(train)


def test_edgeconv_eval_matches_jax(edgeconv, monkeypatch, fast):
    v, x, _, graph, out = edgeconv
    holder = port_edgeconv(v, False)
    monkeypatch.setattr(tdgcnn, "knn_set", lambda a, k: _t(graph))
    monkeypatch.setattr(tdgcnn, "knn", None)  # the restructured form only
    with torch.no_grad():
        got = holder.edge(_t(x), holder.bn).numpy()
    assert got.shape == (2, EN, F)
    np.testing.assert_allclose(got, out["eval"], rtol=1e-4, atol=1e-5)
    assert holder.bn.num_batches_tracked.item() == 0


def _held(got, want32, want64, rtol, atol):
    """|port - f64| within rtol |f64| + atol plus twice |jax f32 - f64|."""
    tol = rtol * np.abs(want64) + atol + 2 * np.abs(want32 - want64)
    assert np.all(np.abs(got - want64) <= tol), np.abs(got - want64).max()


def test_edgeconv_train_mode_and_gradients_match_jax(edgeconv, monkeypatch, fast):
    """Train-mode output, running statistics, num_batches_tracked, and the
    gradients on x, the conv's weight and the BatchNorm's scale and bias,
    held to the JAX float64 module."""
    v, x, cot, graph, out = edgeconv
    holder = port_edgeconv(v, True)
    monkeypatch.setattr(tdgcnn, "knn_set", lambda a, k: _t(graph))
    xt = _t(x).requires_grad_(True)
    y = holder.edge(xt, holder.bn)
    (y * _t(cot)).sum().backward()
    w32, w64 = out[np.float32], out[np.float64]
    _held(y.detach().double().numpy(), w32["train"], w64["train"], 1e-4, 1e-5)
    bn = holder.bn
    assert bn.num_batches_tracked.item() == 1
    _held(bn.running_mean.double().numpy(), w32["stats"]["mean"], w64["stats"]["mean"], 1e-4, 1e-6)
    _held(bn.running_var.double().numpy(), w32["stats"]["var"], w64["stats"]["var"], 1e-4, 1e-6)
    gw = getattr(holder.edge, "0").weight.grad.flatten(1).t().double().numpy()
    for got, key in ((xt.grad, "gx"), (gw, "gw"), (bn.weight.grad, "gscale"),
                     (bn.bias.grad, "gbias")):
        got = got.double().numpy() if torch.is_tensor(got) else got
        _held(got, w32[key], w64[key], 1e-4, 1e-5 * np.abs(w64[key]).max())
    # the zero scale took the min: its gradient is sum over the rows of
    # leaky'(c) * (min_j y_j + z_i) * cot, not the literal form's mean over ties
    assert np.isfinite(bn.weight.grad[5].item())


# ---------------------------------------------------------------- the models


@pytest.fixture(scope="module", params=MODELS)
def model_case(request):
    """(name, variables, xyz, JAX fast eval logits, JAX graphs)."""
    name = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("PCB_EDGECONV_FAST", "1")
    try:
        xyz = np.random.default_rng(21).uniform(-1.0, 1.0, size=(B, N, 3)).astype(np.float32)
        variables = jax_variables(name, xyz, seed=22)
        graphs = JaxGraphs(mp)
        graphs.record()
        jmodel = jax_get_model(name, 5)
        want = np.asarray(jax.jit(lambda a: jmodel.apply(variables, a, None, train=False))(xyz))
        return name, variables, xyz, want, graphs.graphs()
    finally:
        mp.undo()


def replay(monkeypatch, graphs, names=("knn_set",)):
    calls = []

    def replaying(x, query=None, k=20):
        idx = graphs[len(calls) % 4]
        calls.append(None)
        assert idx.shape == tuple(x.shape[:2]) + (k,)
        return torch.from_numpy(idx.copy())

    for name in names:
        monkeypatch.setattr(tdgcnn, name, replaying)
    return calls


def test_eval_logits_match_jax_fast_path(model_case, monkeypatch, fast):
    name, variables, xyz, want, graphs = model_case
    model = get_model(name, 5)
    model.load_state_dict(flax_to_state_dict(variables, name), strict=True)
    calls = replay(monkeypatch, graphs)
    with torch.no_grad():
        got = model.eval()(_t(xyz), None).numpy()
    assert len(calls) == 4 and got.shape == want.shape == (B, N, 5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_the_forms_share_one_state_dict(model_case, monkeypatch):
    """A train-mode forward in the restructured form moves the running
    statistics; its state_dict (the same names and shapes as a literal
    model's) loads into another model, whose literal eval forward on the
    same graphs gives the restructured one's logits within 2e-4."""
    name, variables, xyz, _, graphs = model_case
    model = get_model(name, 5, **({"dropout_rate": 0.0} if name == "dgcnn_global" else {}))
    model.load_state_dict(flax_to_state_dict(variables, name), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    monkeypatch.setenv("PCB_EDGECONV_FAST", "1")
    replay(monkeypatch, graphs)
    with torch.no_grad():
        model.train()(_t(xyz), None)
        trained = model.state_dict()
        assert trained.keys() == before.keys()
        assert not torch.equal(trained["bn2.running_var"], before["bn2.running_var"])
        assert trained["bn1.num_batches_tracked"].item() == 1
        fast_logits = model.eval()(_t(xyz), None)
    other = get_model(name, 5)
    assert {k: v.shape for k, v in other.state_dict().items()} == {
        k: v.shape for k, v in trained.items()}
    other.load_state_dict(trained, strict=True)
    monkeypatch.setenv("PCB_EDGECONV_FAST", "0")
    replay(monkeypatch, graphs, ("knn",))
    with torch.no_grad():
        literal = other.eval()(_t(xyz), None)
    torch.testing.assert_close(literal, fast_logits, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", MODELS)
def test_export_records_the_edge_reduce_op(name, tmp_path, fast):
    """Exported in the restructured form (here on the CPU, by the flag; on
    the card by default), the graph calls pcb::edge_reduce once an EdgeConv
    and pcb::knn / pcb::knn_c for the graphs, and the loaded program gives
    the eager logits exactly."""
    from pointcloud_bridge_tpu_torch.utils.export import (
        dump_program_text,
        export_program,
        load_program,
    )

    model = get_model(name, 5, generator=torch.Generator().manual_seed(4)).eval()
    x = torch.rand(1, 64, 3, generator=torch.Generator().manual_seed(5))
    program = load_program(export_program(model, None, str(tmp_path / "m.pt2"), 1, 64, 3))
    with torch.no_grad():
        assert torch.equal(program(x, x), model(x, x))
    text = open(dump_program_text(model, None, str(tmp_path / "m.txt"), 1, 64, 3)).read()
    for op, count in (("edge_reduce", 4), ("knn", 1), ("knn_c", 3)):
        assert text.count(f"torch.ops.pcb.{op}.default(") == count, op
