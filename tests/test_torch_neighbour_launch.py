"""The launch path and the selection arithmetic of K2 (ball query,
csrc/ballq.cu) and K5 (exact k-NN, csrc/knn.cu), on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions. Here, without a card: their C entry points against
the argument types the wrappers bind; the plans the wrappers lay out and
the constants the C sources share with them; the launch choices (warps a
block by the number of queries, the row staged whole or as a ring of tiles,
over every N); the wrappers' refusals; that ``query_ball_point`` hands the
kernel contiguous tensors; and numpy emulations of what the kernels compute
in their own order, held bit for bit against the port's plain versions and
the JAX package: K5's candidate buffer filled by ballot compaction and
merged 32 at a time into the sorted list by a bitonic network, K2's scan of
32-point steps in groups with its slot order and early stop.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.ops import grouping as jgrouping
from pointcloud_bridge_tpu.ops import square_distance
from pointcloud_bridge_tpu.ops.pallas_kernels.ballq import ball_query_pallas
from pointcloud_bridge_tpu.ops.pallas_kernels.knnset import topk_set_from_buffer
from pointcloud_bridge_tpu_torch import ops
from pointcloud_bridge_tpu_torch.ops import _kernels, grouping

F32 = np.float32
LANES = np.arange(32)
# the C sources' constants, read once
KNN_SRC = (_kernels.CSRC / "knn.cu").read_text()
BALL_SRC = (_kernels.CSRC / "ballq.cu").read_text()


def constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


UNROLL = constant(KNN_SRC, "kUnroll")  # 32-point steps between two votes
GROUP = 32 * UNROLL
BUF = constant(KNN_SRC, "kBuf")  # candidate slots a warp
NO_BOUND = np.uint64(0x7F800001)  # csrc/knn.cu kNoBound
EMPTY = (NO_BOUND << np.uint64(32)) | np.uint64(0xFFFFFFFF)
MAX_SMEM = 232_448


def c_parameters(symbol: str) -> list:
    for path in sorted(_kernels.CSRC.glob("*.cu")):
        m = re.search(r"PCB_API\s+int\s+" + symbol + r"\s*\(([^)]*)\)", path.read_text())
        if m:
            return [" ".join(p.split()) for p in m.group(1).split(",")]
    raise AssertionError(f"{symbol}: no PCB_API definition in csrc/")


@pytest.mark.parametrize("kernel", [_kernels.BALL_QUERY, _kernels.KNN], ids=lambda k: k.name)
def test_argtypes_match_the_c_entry_point(kernel):
    params = c_parameters(kernel.symbol)
    assert list(kernel.argtypes) == [_kernels._P if "*" in p else _kernels._I for p in params]
    assert params[-3:] == ["const int* plan", "int device", "void* stream"]


@pytest.mark.parametrize("text,symbol,fields", [
    (BALL_SRC, "pcb_ball_query", grouping.BALL_PLAN),
    (KNN_SRC, "pcb_knn", grouping.KNN_PLAN),
])
def test_plan_fields_in_the_order_c_reads_them(text, symbol, fields):
    body = text[text.index(f"PCB_API int {symbol}("):]
    read = {int(m.group(2)): m.group(1)
            for m in re.finditer(r"const int (\w+) = plan\[(\d+)\];", body)}
    assert read == dict(enumerate(fields))


@pytest.mark.parametrize("text", [KNN_SRC, BALL_SRC], ids=["knn", "ballq"])
def test_the_c_constants_are_the_wrappers(text):
    """Both kernels stage a row whole up to STAGE_ROW_MAX points and pad a
    tile to the group of UNROLL steps; the largest block of each fits the
    card's 227 KB: the whole row or a ring of two tiles, beside K5's
    candidate slots (8 bytes a key) for 32 warps."""
    assert constant(text, "kRowMax") == grouping.STAGE_ROW_MAX
    assert constant(text, "kUnroll") == UNROLL
    assert constant(text, "kMaxSmem") == MAX_SMEM
    slots = 32 * BUF * 8
    assert grouping.STAGE_ROW_MAX * 16 + slots <= MAX_SMEM
    assert 2 * grouping.STAGE_TILE * 16 + slots <= MAX_SMEM
    assert grouping.STAGE_TILE % GROUP == 0 and grouping.STAGE_ROW_MAX % GROUP == 0


# --------------------------------------------------------- launch choices


def test_stage_tile_covers_every_n():
    for n in range(1, 3 * grouping.STAGE_ROW_MAX):
        tile = grouping.stage_tile(n)
        ring = 1 if tile >= n else 2
        padded = -(-tile // GROUP) * GROUP
        assert ring * padded * 16 + 32 * BUF * 8 <= MAX_SMEM
        assert (tile == n) == (n <= grouping.STAGE_ROW_MAX)
        assert ring == 1 or tile <= grouping.STAGE_ROW_MAX


@pytest.mark.parametrize("b,s,queries,warps", [
    (4, 4096, 1, 32), (16, 4096, 1, 32), (4, 1024, 1, 32), (4, 512, 1, 16), (4, 256, 1, 8),
    (4, 128, 1, 4), (16, 256, 1, 32), (16, 64, 1, 8), (1, 1, 1, 4), (16, 1024, 4, 32),
    (4, 1024, 4, 8), (1, 528, 1, 4), (1, 529, 1, 8)])
def test_neighbour_launch_by_the_number_of_queries(b, s, queries, warps):
    assert grouping.neighbour_launch(b, s, 132, queries) == warps


def test_neighbour_launch_keeps_about_a_block_an_sm():
    """The fewest warps (4-32, a power of two) whose blocks number no more
    than the SMs, else 32; over every query count up to 64 blocks of 32."""
    for queries in (1, 4):
        for total in range(1, 64 * 32 * 132, 97):
            warps = grouping.neighbour_launch(1, total, 132, queries)
            assert warps in (4, 8, 16, 32)
            assert warps == 32 or -(-total // (warps * queries)) <= 132
            assert warps == 4 or -(-total // (warps // 2 * queries)) > 132


@pytest.mark.parametrize("b,s,queries", [(16, 1024, 4), (4, 4096, 4), (4, 3960, 4),
                                         (4, 3959, 1), (4, 1024, 1), (1, 1, 1)])
def test_ball_queries_a_warp(b, s, queries):
    assert grouping.ball_queries_a_warp(b, s, 132) == queries


def r2_bits(radius):
    return int(np.array(grouping.radius_sq(radius), F32).view(np.int32))


def test_plans_hold_the_launch():
    assert list(grouping._knn_plan(4, 4096, 4096, 32, 132)) == [4, 4096, 4096, 32, 32, 4096]
    assert list(grouping._knn_plan(4, 16384, 1000, 64, 132)) == [
        4, 16384, 1000, 64, 32, grouping.STAGE_TILE]
    assert list(grouping._knn_plan(4, 512, 512, 16, 132, 16, 256)) == [4, 512, 512, 16, 16, 256]
    assert list(grouping._ball_plan(16, 4096, 1024, ((0.1, 32),), 132)) == [
        16, 4096, 1024, 32, 4, 4096, 1, 32, r2_bits(0.1), 0, 0, 0, 0]
    assert list(grouping._ball_plan(4, 4096, 1024, ((0.1, 16), (0.2, 32)), 132)) == [
        4, 4096, 1024, 32, 1, 4096, 2, 16, r2_bits(0.1), 32, r2_bits(0.2), 0, 0]
    assert list(grouping._ball_plan(4, 512, 128, ((0.4, 16),), 132, 32, 4))[3:6] == [32, 4, 512]
    assert list(grouping._ball_plan(4, 512, 128, ((0.0, 16),), 132))[6:9] == [1, 16, 0]
    assert len(grouping.BALL_PLAN) == 7 + 2 * grouping.BALL_MAX_RADII
    assert constant(BALL_SRC, "kMaxRadii") == grouping.BALL_MAX_RADII


@pytest.mark.parametrize("args", [
    (4, 4096, 4096, 0, 132), (4, 4096, 4096, 65, 132), (4, 16, 16, 17, 132),
    (65536, 64, 64, 4, 132), (4, 64, 64, 4, 132, 12), (4, 20000, 64, 4, 132, None, 9000),
    (4, 0, 4, 1, 132)])
def test_knn_plan_refuses(args):
    with pytest.raises(ValueError):
        grouping._knn_plan(*args)


@pytest.mark.parametrize("args", [
    (65536, 64, 64, ((0.1, 4),), 132), (4, 0, 64, ((0.1, 4),), 132),
    (4, 64, 64, ((0.1, 4),), 132, 64), (4, 64, 64, ((0.1, 4),), 132, 8, 2),
    (4, 64, 64, ((float("nan"), 4),), 132), (4, 64, 64, (), 132),
    (4, 64, 64, ((0.1, 4),) * 4, 132), (4, 64, 64, ((0.1, 0),), 132)])
def test_ball_plan_refuses(args):
    with pytest.raises(ValueError):
        grouping._ball_plan(*args)


# --------------------------------------------- what the wrappers hand over


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """CPU tensors that pass the device check; every launch is recorded
    instead of made (there is no nvcc here)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_kernels, "stream_args", lambda t: (0, None))
    monkeypatch.setattr(_kernels, "sm_count", lambda device: 132)
    launched = []
    for kernel in (_kernels.BALL_QUERY, _kernels.KNN):
        monkeypatch.setattr(kernel, "launch", lambda *args, k=kernel: launched.append((k, args)))
    return launched


def test_knn_cuda_hands_over_its_plan(as_if_on_the_card):
    xyz = torch.zeros(2, 600, 3)
    d2, idx = grouping.knn_cuda(xyz, xyz[:, :100].contiguous(), 33)
    assert idx.shape == d2.shape == (2, 100, 33) and idx.dtype == torch.int32
    (kernel, args), = as_if_on_the_card
    assert kernel is _kernels.KNN and len(args) == len(kernel.argtypes)
    assert args[2:4] == (idx.data_ptr(), d2.data_ptr())
    assert list(args[4]) == [2, 600, 100, 33, 4, 600]  # 200 queries: 4 warps


def test_ball_query_cuda_hands_over_its_plan(as_if_on_the_card):
    xyz = torch.zeros(3, 9000, 3)
    out = grouping.ball_query_cuda(0.2, 40, xyz, xyz[:, :700].contiguous())
    assert out.shape == (3, 700, 40) and out.dtype == torch.int32
    (kernel, args), = as_if_on_the_card
    assert kernel is _kernels.BALL_QUERY and len(args) == len(kernel.argtypes)
    assert args[2:5] == (out.data_ptr(), None, None)
    plan = dict(zip(grouping.BALL_PLAN, args[5]))
    assert (plan["b"], plan["n"], plan["s"], plan["warps"], plan["queries"], plan["tile"],
            plan["radii"], plan["k0"]) == (3, 9000, 700, 16, 1, grouping.STAGE_TILE, 1, 40)


def test_one_launch_answers_up_to_three_radii(as_if_on_the_card):
    """Two radii: one launch writing both outputs; four: two launches (3 +
    1); a radius of K = 0 gets its empty output and no slot in a launch."""
    xyz = torch.zeros(2, 512, 3)
    centers = xyz[:, :128].contiguous()
    outs = grouping.ball_query_radii_cuda(((0.1, 16), (0.2, 32)), xyz, centers)
    assert [o.shape for o in outs] == [(2, 128, 16), (2, 128, 32)]
    (kernel, args), = as_if_on_the_card
    assert args[2:5] == (outs[0].data_ptr(), outs[1].data_ptr(), None)
    plan = dict(zip(grouping.BALL_PLAN, args[5]))
    assert (plan["radii"], plan["k0"], plan["k1"]) == (2, 16, 32)
    as_if_on_the_card.clear()
    balls = ((0.1, 8), (0.2, 0), (0.3, 16), (0.4, 4), (0.5, 2))
    outs = grouping.ball_query_radii_cuda(balls, xyz, centers)
    assert [o.shape[2] for o in outs] == [8, 0, 16, 4, 2]
    assert [dict(zip(grouping.BALL_PLAN, a[5]))["radii"] for _, a in as_if_on_the_card] == [3, 1]
    assert as_if_on_the_card[0][1][2:5] == (outs[0].data_ptr(), outs[2].data_ptr(),
                                            outs[3].data_ptr())
    assert as_if_on_the_card[1][1][2:5] == (outs[4].data_ptr(), None, None)


def test_msg_levels_query_every_radius_in_one_call(monkeypatch):
    """MultiScaleSetAbstraction asks for all its radii at once; on the CPU
    each output is the one-radius query's."""
    from pointcloud_bridge_tpu_torch.models import common

    calls = []
    real = grouping._query_ball_radii

    def spy(balls, xyz, new_xyz):
        calls.append(balls)
        outs = real(balls, xyz, new_xyz)
        for (r, k), out in zip(balls, outs):
            assert torch.equal(out, grouping.query_ball_point(r, k, xyz, new_xyz))
        return outs

    monkeypatch.setattr(common, "_query_ball_radii", spy)
    gen = torch.Generator().manual_seed(0)
    layer = common.MultiScaleSetAbstraction(32, (0.2, 0.4), (8, 16), 3 + 4, (8, 16),
                                            generator=gen)
    xyz = torch.rand(2, 128, 3, generator=gen)
    new_xyz, feats = layer(xyz, torch.rand(2, 128, 4, generator=gen))
    assert new_xyz.shape == (2, 32, 3) and feats.shape == (2, 32, 32)
    assert calls == [((0.2, 8), (0.4, 16))]


def test_ball_query_hands_the_kernel_contiguous_tensors(monkeypatch):
    """A non-contiguous CUDA input takes the kernel as a contiguous copy, as
    the JAX package and the CPU path take any layout (the wrapper refuses
    strides). The meta device stands in for the card: it is not the CPU, so
    the op dispatches to the kernel wrapper, which records here."""
    seen = []

    def fake_ball(balls, xyz, new_xyz):
        seen.append((xyz.is_contiguous(), new_xyz.is_contiguous()))
        return [torch.empty(xyz.shape[0], new_xyz.shape[1], k, dtype=torch.int32,
                            device=xyz.device) for _, k in balls]

    monkeypatch.setattr(grouping, "ball_query_radii_cuda", fake_ball)
    xyz = torch.empty(4, 3, 256, device="meta").transpose(1, 2)  # [4, 256, 3], strided
    assert not xyz.is_contiguous()
    assert ops.query_ball_point(0.2, 16, xyz, xyz[:, ::4]).shape == (4, 64, 16)
    assert [o.shape for o in grouping._query_ball_radii(((0.1, 8), (0.2, 4)), xyz,
                                                         xyz[:, ::4])] == [(4, 64, 8), (4, 64, 4)]
    assert seen == [(True, True)] * 2


def test_wrappers_refuse_cpu_tensors():
    xyz = torch.rand(2, 64, 3)
    before = (_kernels.BALL_QUERY.launches, _kernels.KNN.launches)
    with pytest.raises(ValueError, match="CUDA"):
        grouping.ball_query_cuda(0.2, 8, xyz, xyz[:, :8].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        grouping.knn_cuda(xyz, xyz, 8)
    assert (_kernels.BALL_QUERY.launches, _kernels.KNN.launches) == before


def bad_inputs(case: str):
    xyz, query = torch.rand(2, 64, 3), torch.rand(2, 8, 3)
    if case == "xyz float64":
        xyz = xyz.double()
    elif case == "xyz not contiguous":
        xyz = torch.rand(2, 3, 64).transpose(1, 2)
    elif case == "query not contiguous":
        query = torch.rand(2, 3, 8).transpose(1, 2)
    elif case == "xyz of 4 channels":
        xyz = torch.rand(2, 64, 4)
    elif case == "query of another B":
        query = torch.rand(3, 8, 3)
    elif case == "query rank 2":
        query = query[0]
    elif case == "N = 0":
        xyz = torch.zeros(2, 0, 3)
    elif case == "B over 65535":
        xyz, query = torch.zeros(65536, 4, 3), torch.zeros(65536, 1, 3)
    return xyz, query


CASES = ["xyz float64", "xyz not contiguous", "query not contiguous", "xyz of 4 channels",
         "query of another B", "query rank 2", "N = 0", "B over 65535"]


@pytest.mark.parametrize("case", CASES)
def test_ball_query_cuda_refuses(as_if_on_the_card, case):
    xyz, query = bad_inputs(case)
    with pytest.raises((TypeError, ValueError)):
        grouping.ball_query_cuda(0.2, 4, xyz, query)
    assert not as_if_on_the_card


@pytest.mark.parametrize("case", CASES + ["k = 0", "k = 65", "k over N"])
def test_knn_cuda_refuses(as_if_on_the_card, case):
    xyz, query = bad_inputs(case)
    k = {"k = 0": 0, "k = 65": 65, "k over N": 17}.get(case, 4)
    if case == "k = 65":
        xyz = torch.rand(2, 100, 3)
    elif case == "k over N":
        xyz = torch.rand(2, 16, 3)
    with pytest.raises((TypeError, ValueError)):
        grouping.knn_cuda(xyz, query, k)
    assert not as_if_on_the_card


# ---------------------------------------------- K5's selection, as the card runs it


def sq_dist(query: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """sq_dist3 (common.cuh) of every query [Q, 3] to every point [P, 3]."""
    dx, dy, dz = (query[:, None, c] - pts[None, :, c] for c in range(3))
    return (dx * dx + dy * dy) + dz * dz


def staged(pts: np.ndarray, tile: int):
    """csrc/common.cuh stage_points over a row: (base, lim, points padded to
    a whole group with NaN coordinates) a tile."""
    n = len(pts)
    for base in range(0, n, tile):
        lim = min(tile, n - base)
        pad = np.full((-(-lim // GROUP) * GROUP, 3), np.nan, F32)
        pad[:lim] = pts[base:base + lim]
        yield base, lim, pad


def exchange(v, stride, keep_min):
    o = v[:, LANES ^ stride]
    return np.where((o < v) == keep_min, o, v)


def warp_sort(v):
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            v = exchange(v, stride, ((LANES & stride) == 0) == ((LANES & size) == 0))
            stride //= 2
        size *= 2
    return v


def warp_merge(v):
    for stride in (16, 8, 4, 2, 1):
        v = exchange(v, stride, (LANES & stride) == 0)
    return v


def merge(lst, c):
    """csrc/knn.cu merge: lst [Q, R, 32] ascending by position r * 32 +
    lane, c [Q, 32] the candidates -> the R * 32 least of both."""
    lst = lst.copy()
    c = warp_sort(c)
    lst[:, -1] = np.minimum(lst[:, -1], c[:, 31 - LANES])
    if lst.shape[1] == 2:
        lst[:, 0], lst[:, 1] = np.minimum(lst[:, 0], lst[:, 1]), np.maximum(lst[:, 0], lst[:, 1])
    for r in range(lst.shape[1]):
        lst[:, r] = warp_merge(lst[:, r])
    return lst


def knn_emulated(xyz: np.ndarray, query: np.ndarray, k: int, tile=None):
    """csrc/knn.cu in numpy, a warp a query: tiles staged with NaN pads;
    groups of UNROLL 32-point steps with one vote against the k-th key's
    distance bits; each step's candidates appended in lane order to the
    warp's buffer, the last 32 merged whenever it holds 32 (the bound read
    after each merge); the rest merged at the end. -> (d2, idx)."""
    b, n, _ = xyz.shape
    s = query.shape[1]
    tile = grouping.stage_tile(n) if tile is None else tile
    r_regs = 1 if k <= 32 else 2
    d2_out = np.empty((b, s, k), F32)
    idx_out = np.empty((b, s, k), np.int32)
    rows = np.arange(s)
    for bi in range(b):
        lst = np.full((s, r_regs, 32), EMPTY, np.uint64)
        bound = np.full(s, NO_BOUND, np.uint64)
        buf = np.zeros((s, BUF), np.uint64)
        count = np.zeros(s, np.int64)
        for base, lim, pts in staged(xyz[bi], tile):
            bits = sq_dist(query[bi], pts).view(np.uint32).astype(np.uint64)  # [S, padded]
            for t0 in range(0, lim, GROUP):
                group = bits[:, t0:t0 + GROUP]
                if not (group < bound[:, None]).any():
                    continue
                for u in range(UNROLL):
                    v = group[:, u * 32:(u + 1) * 32]
                    hit = v < bound[:, None]
                    slot = count[:, None] + np.cumsum(hit, 1) - hit
                    key = (v << np.uint64(32)) | (base + t0 + u * 32 + LANES).astype(np.uint64)
                    qs, ls = np.nonzero(hit)
                    buf[qs, slot[qs, ls]] = key[qs, ls]
                    count += hit.sum(1)
                    full = count >= 32
                    if full.any():
                        count[full] -= 32
                        at = count[full][:, None] + LANES
                        lst[full] = merge(lst[full], buf[full][np.arange(full.sum())[:, None], at])
                        bound[full] = lst[full, (k - 1) // 32, (k - 1) % 32] >> np.uint64(32)
        left = count > 0
        if left.any():
            cand = np.where(LANES < count[left][:, None], buf[left][:, :32], EMPTY)
            lst[left] = merge(lst[left], cand)
        flat = lst.reshape(s, -1)[rows][:, :k]
        idx_out[bi] = (flat & np.uint64(0xFFFFFFFF)).astype(np.int64)
        d2_out[bi] = (flat >> np.uint64(32)).astype(np.uint32).view(F32)
    return d2_out, idx_out


def knn_clouds(kind: str, n: int, s: int, rng):
    if kind == "uniform":
        xyz = rng.uniform(size=(2, n, 3)).astype(F32)
        query = xyz[:, :s] if s <= n else rng.uniform(size=(2, s, 3)).astype(F32)
    else:  # an integer grid: many exact ties
        xyz = rng.integers(0, 4, (2, n, 3)).astype(F32)
        query = rng.integers(0, 4, (2, s, 3)).astype(F32)
    return xyz, np.ascontiguousarray(query)


KNN_SHAPES = [("uniform", 300, 300, 16), ("uniform", 300, 100, 32), ("uniform", 200, 70, 33),
              ("uniform", 500, 64, 64), ("uniform", 100, 100, 1), ("uniform", 40, 40, 40),
              ("uniform", 100, 30, 64), ("grid", 300, 100, 1), ("grid", 300, 100, 16),
              ("grid", 300, 100, 32), ("grid", 300, 100, 33), ("grid", 300, 100, 64),
              ("grid", 90, 50, 64)]


@pytest.mark.parametrize("tile", [None, 100])
@pytest.mark.parametrize("kind,n,s,k", KNN_SHAPES)
def test_knn_selection_matches_plain(kind, n, s, k, tile):
    """Bit for bit, indices and distances, with the row staged whole and as
    tiles of 100 points (each padded to a group); N no multiple of 32 and
    N < 32 * UNROLL among them."""
    rng = np.random.default_rng(n * s + k)
    xyz, query = knn_clouds(kind, n, s, rng)
    d2, idx = knn_emulated(xyz, query, k, tile)
    pd2, pidx = grouping.knn_plain(torch.from_numpy(xyz), torch.from_numpy(query), k)
    np.testing.assert_array_equal(idx, pidx.numpy())
    np.testing.assert_array_equal(d2.view(np.uint32), pd2.numpy().view(np.uint32))


@pytest.mark.parametrize("kind,n,s,k", [("uniform", 256, 128, 16), ("uniform", 200, 64, 33),
                                        ("grid", 160, 64, 32), ("grid", 100, 40, 64)])
def test_knn_selection_matches_jax(kind, n, s, k):
    """Against the JAX package's exact k-NN, whose distances are in the
    expanded form: on an integer grid both forms are exact and the indices
    and distances agree bit for bit; on random clouds indices agree wherever
    the JAX distances of the two picks differ by more than 1e-6, distances
    within 1e-5."""
    rng = np.random.default_rng(n + s + k)
    xyz, query = knn_clouds(kind, n, s, rng)
    d2, idx = knn_emulated(xyz, query, k)
    want_d, want_idx = (np.asarray(a) for a in jgrouping.knn_with_distance(
        jnp.asarray(xyz), jnp.asarray(query), k, approx=False))
    if kind == "grid":
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(d2, want_d)
        return
    full = np.asarray(square_distance(jnp.asarray(query), jnp.asarray(xyz)))
    differ = idx != want_idx
    if differ.any():
        d_got = np.take_along_axis(full, idx.astype(np.int64), -1)
        d_want = np.take_along_axis(full, want_idx.astype(np.int64), -1)
        assert np.abs(d_got - d_want)[differ].max() <= 1e-6
    np.testing.assert_allclose(d2, want_d, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,n,s,k", [("uniform", 128, 64, 16), ("uniform", 200, 64, 32),
                                        ("grid", 128, 64, 1), ("grid", 160, 64, 16)])
def test_knn_selection_is_the_pallas_set(kind, n, s, k):
    """The Pallas selection kernel that K5 replaces, in interpret mode, fed
    the whole distance row as its buffer in index order, selects the set
    the emulation returns."""
    rng = np.random.default_rng(3 * n + k)
    xyz, query = knn_clouds(kind, n, s, rng)
    _, idx = knn_emulated(xyz, query, k)
    d2 = np.stack([sq_dist(query[i], xyz[i]) for i in range(2)])
    buf_idx = np.broadcast_to(np.arange(n, dtype=np.int32), d2.shape)
    got = np.asarray(topk_set_from_buffer(jnp.asarray(-d2), jnp.asarray(buf_idx), k, True))
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(idx, -1))


def test_the_merge_network_keeps_the_least():
    """One merge of random keys: the R * 32 least of the list and the 32
    candidates, ascending, at R = 1 and 2."""
    rng = np.random.default_rng(11)
    for r in (1, 2):
        lst = np.sort(rng.integers(0, 2**40, (50, r * 32), dtype=np.uint64), -1)
        cand = rng.integers(0, 2**40, (50, 32), dtype=np.uint64)
        got = merge(lst.reshape(50, r, 32), cand).reshape(50, -1)
        np.testing.assert_array_equal(got, np.sort(np.concatenate([lst, cand], 1), -1)[:, :32 * r])


# ---------------------------------------------- K2's scan, as the card runs it


def ball_emulated(balls, xyz: np.ndarray, centers: np.ndarray, tile=None) -> list:
    """csrc/ballq.cu's scan of a query in numpy, for each (radius, K) of
    ``balls`` at once: tiles staged with NaN pads; a distance computed once
    and its uint32 bits compared with each r2's; groups of UNROLL 32-point
    steps, entered while any radius has fewer than its K hits; for each
    radius still short of K, in each step the hits in lane order take slots
    count + (hits in lower lanes), written while below K; the first hit
    kept; the slots past the last hit padded with it (N for an empty ball).
    -> one [B, S, K] array a radius."""
    b, n, _ = xyz.shape
    s = centers.shape[1]
    tile = grouping.stage_tile(n) if tile is None else tile
    r2 = [np.array(grouping.radius_sq(r), F32).view(np.uint32) for r, _ in balls]
    outs = [np.zeros((b, s, k), np.int32) for _, k in balls]
    for bi in range(b):
        count = np.zeros((len(balls), s), np.int64)
        first = np.full((len(balls), s), n, np.int64)
        ks = np.array([k for _, k in balls])[:, None]
        for base, lim, pts in staged(xyz[bi], tile):
            bits = sq_dist(centers[bi], pts).view(np.uint32)  # NaN pads never hit
            for t0 in range(0, lim, GROUP):
                live = count < ks  # [radii, S] at the group's start
                for r, (_, k) in enumerate(balls):
                    for u in range(UNROLL):
                        hit = (bits[:, t0 + u * 32:t0 + (u + 1) * 32] <= r2[r]) & live[r, :, None]
                        j = base + t0 + u * 32 + LANES
                        starts = (count[r] == 0) & hit.any(1)
                        first[r, starts] = j[hit[starts].argmax(1)]
                        slot = count[r, :, None] + np.cumsum(hit, 1) - hit
                        qs, ls = np.nonzero(hit & (slot < k))
                        outs[r][bi, qs, slot[qs, ls]] = j[ls]
                        count[r] += hit.sum(1)
        for r, (_, k) in enumerate(balls):
            for q in range(s):
                outs[r][bi, q, min(count[r, q], k):] = first[r, q]
    return outs


def ball_clouds(kind: str, n: int, s: int, rng):
    if kind == "uniform":
        xyz = rng.uniform(size=(2, n, 3)).astype(F32)
        return xyz, np.ascontiguousarray(xyz[:, :s])
    if kind == "duplicates":  # points on a few sites, each many times
        xyz = rng.integers(0, 3, (2, n, 3)).astype(F32)
        return xyz, np.ascontiguousarray(xyz[:, :s])
    xyz = rng.uniform(size=(2, n, 3)).astype(F32)  # "empty": centres far away
    return xyz, np.full((2, s, 3), 10.0, F32)


BALL_CASES = [("uniform", 300, 64, 16, 0.2), ("uniform", 300, 64, 32, 0.4),
              ("uniform", 500, 100, 32, 0.1), ("uniform", 40, 20, 64, 0.5),
              ("uniform", 16, 8, 32, 0.8), ("empty", 200, 16, 32, 0.1),
              ("duplicates", 150, 40, 16, 0.0), ("duplicates", 150, 40, 64, 1.0),
              ("duplicates", 30, 10, 64, 0.0)]


@pytest.mark.parametrize("tile", [None, 100])
@pytest.mark.parametrize("kind,n,s,k,r", BALL_CASES)
def test_ball_scan_matches_plain(kind, n, s, k, r, tile):
    """Bit for bit, with the row staged whole and as tiles of 100 points:
    empty balls, K > N, radius 0 over duplicate points, N no multiple of 32
    and N < 32 * UNROLL among the cases."""
    rng = np.random.default_rng(n + s + k)
    xyz, centers = ball_clouds(kind, n, s, rng)
    got, = ball_emulated(((r, k),), xyz, centers, tile)
    want = grouping.ball_query_plain(r, k, torch.from_numpy(xyz), torch.from_numpy(centers))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("kind,n,s,k,r", BALL_CASES)
def test_ball_scan_matches_the_pallas_kernel(kind, n, s, k, r):
    """Against the Pallas kernel in interpret mode, bit for bit."""
    rng = np.random.default_rng(n * s + k)
    xyz, centers = ball_clouds(kind, n, s, rng)
    got, = ball_emulated(((r, k),), xyz, centers)
    want = np.asarray(ball_query_pallas(r, k, jnp.asarray(xyz), jnp.asarray(centers),
                                        interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", [None, 100])
@pytest.mark.parametrize("kind,n,s,balls", [
    ("uniform", 512, 128, ((0.1, 16), (0.2, 32))), ("uniform", 300, 64, ((0.4, 32), (0.2, 16))),
    ("uniform", 200, 50, ((0.1, 8), (0.2, 16), (0.4, 64))), ("duplicates", 150, 40, ((0.0, 16), (1.0, 8))),
    ("empty", 100, 16, ((0.1, 4), (0.3, 40)))])
def test_one_scan_of_several_radii_matches_each_radius(kind, n, s, balls, tile):
    """Each output of the multi-radius scan is bit for bit the one-radius
    query at its radius and K: the plain version and the scan alone."""
    rng = np.random.default_rng(n + s + len(balls))
    xyz, centers = ball_clouds(kind, n, s, rng)
    got = ball_emulated(balls, xyz, centers, tile)
    for (r, k), out in zip(balls, got):
        want = grouping.ball_query_plain(r, k, torch.from_numpy(xyz), torch.from_numpy(centers))
        np.testing.assert_array_equal(out, want.numpy())
        np.testing.assert_array_equal(out, ball_emulated(((r, k),), xyz, centers, tile)[0])
