"""k-NN over C channels, on the CPU: the port's ``knn`` / ``knn_with_distance``
against the JAX package's exact k-NN at C = 1, 5, 8 and 64, and the launch
path and selection of K5c (csrc/knn.cu ``pcb_knn_c``), the kernel that DGCNN's
feature-space graphs run on the card.

Until this file, ``pairwise_sq_dist`` summed the first three channels
whatever C was, so ``ops.knn`` of 8-channel features returned the neighbours
by channels 0-2. The JAX package measures distances in the expanded form
(|a|^2 + |b|^2 - 2ab) over all channels, the port in the direct form, a
left fold d0*d0 + d1*d1 + ... over all channels; so indices are held
identical wherever the JAX distances of the two picks differ by more than
1e-6 of the row's largest distance, and distances within 1e-5 of it: the
bands of tests/test_torch_knn.py at C = 3, where the largest distance is
about 1, taken relative to the row, since the expanded form's cancellation
grows with |q|^2 + |p|^2 (about 20 for 64 uniform channels). The port's
distances are also held within 1e-5 relative to float64. On an integer
grid both forms are exact, and the indices and distances must agree bit
for bit, ties to the lower index.

The kernel runs only on the card, where chip_smoke.py holds it against
``knn_plain`` bit for bit. Here: its C entry point against the argument
types the wrapper binds, the plan in the order C reads it, the shared
memory the wrapper lays out against the C source's, the launch the plan
picks by shape, the wrappers' routing and
refusals with ``is_cuda`` patched, and a numpy emulation of the kernel's
warps of Q queries (fold, tile ring, one selection and buffer a query, the
group vote, a last warp partly active) held bit for bit against
``knn_plain``.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.ops import grouping as jgrouping
from pointcloud_bridge_tpu.ops import square_distance
from pointcloud_bridge_tpu_torch import ops
from pointcloud_bridge_tpu_torch.ops import _kernels, grouping
from pointcloud_bridge_tpu_torch.probes import k2_k5_probe

from test_torch_neighbour_launch import (
    BUF,
    EMPTY,
    GROUP,
    LANES,
    NO_BOUND,
    UNROLL,
    c_parameters,
    constant,
    merge,
)

F32 = np.float32
KNN_SRC = (_kernels.CSRC / "knn.cu").read_text()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def features(rng, kind: str, b: int, n: int, c: int) -> np.ndarray:
    if kind == "grid":  # small integers: every distance exact, ties abound
        return rng.integers(0, 3, (b, n, c)).astype(F32)
    return rng.uniform(size=(b, n, c)).astype(F32)


def assert_same_neighbours(got_idx, want_idx, jax_d2_full):
    """Identical indices, or picks whose JAX distances differ by at most
    1e-6 of the row's largest; each row k distinct points."""
    differ = got_idx != want_idx
    if differ.any():
        d_got = np.take_along_axis(jax_d2_full, got_idx.astype(np.int64), -1)
        d_want = np.take_along_axis(jax_d2_full, want_idx.astype(np.int64), -1)
        scale = np.abs(jax_d2_full).max(-1, keepdims=True)
        assert (np.abs(d_got - d_want) <= 1e-6 * scale)[differ].all()
    assert (np.diff(np.sort(got_idx, -1), axis=-1) > 0).all()


# ------------------------------------------------- the op against the JAX k-NN

CHANNEL_CASES = [(1, 64, 64, 8), (5, 96, 40, 16), (8, 64, 64, 4), (8, 128, 128, 20),
                 (64, 128, 128, 20), (64, 200, 50, 64), (6, 40, 40, 39)]


@pytest.mark.parametrize("c,n,s,k", CHANNEL_CASES)
def test_knn_with_distance_uses_every_channel(c, n, s, k):
    rng = np.random.default_rng(c * 1000 + n + k)
    xyz = features(rng, "uniform", 2, n, c)
    query = xyz[:, :s]
    want_d, want_idx = (np.asarray(a) for a in jgrouping.knn_with_distance(
        jnp.asarray(xyz), jnp.asarray(query), k, approx=False))
    got_d, got_idx = ops.knn_with_distance(_t(xyz), _t(query), k)
    assert got_idx.dtype == torch.int32 and got_idx.shape == (2, s, k)
    assert got_d.dtype == torch.float32 and got_d.shape == (2, s, k)
    full = np.asarray(square_distance(jnp.asarray(query), jnp.asarray(xyz)))
    assert_same_neighbours(got_idx.numpy(), want_idx, full)
    # the expanded form cancels: its error grows with |q|^2 + |p|^2, ~20 at C = 64
    scale = np.abs(full).max(-1, keepdims=True)
    assert (np.abs(got_d.numpy() - want_d) <= 1e-5 * scale).all()
    assert (np.diff(got_d.numpy(), axis=-1) >= 0).all()  # nearest first
    # and the distances are over all C channels, not the first three
    ref = ((query[:, :, None, :].astype(np.float64) - xyz[:, None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got_d.numpy(), np.take_along_axis(
        ref, got_idx.numpy().astype(np.int64), -1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("c,k", [(1, 8), (5, 16), (8, 20), (64, 33)])
def test_knn_on_an_integer_grid_is_the_jax_knn_bit_for_bit(c, k):
    rng = np.random.default_rng(c + k)
    grid = features(rng, "grid", 2, 96, c)
    want_d, want_idx = jgrouping.knn_with_distance(jnp.asarray(grid), None, k, approx=False)
    got_d, got_idx = ops.knn_with_distance(_t(grid), None, k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    tied = got_d[..., 1:] == got_d[..., :-1]
    assert tied.any()
    assert (got_idx[..., 1:] > got_idx[..., :-1])[tied].all()
    assert torch.equal(ops.knn(_t(grid), k=k), got_idx)
    assert torch.equal(ops.knn_set(_t(grid), k=k), got_idx)


@pytest.mark.parametrize("n,s", [(64, 64), (200, 37)])
def test_three_channels_are_the_direct_form_bit_for_bit(rng, n, s):
    """C = 3 is (dx*dx + dy*dy) + dz*dz as before, so K5, K4 and the ball
    query see the same bits."""
    a = _t(rng.uniform(size=(2, s, 3)).astype(F32))
    b = _t(rng.uniform(size=(2, n, 3)).astype(F32))
    d = [a[..., i].unsqueeze(2) - b[..., i].unsqueeze(1) for i in range(3)]
    assert torch.equal(ops.pairwise_sq_dist(a, b), (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])


@pytest.mark.parametrize("c", [1, 2, 6, 64, 67])
def test_the_fold_is_left_to_right_over_the_channels(rng, c):
    """pairwise_sq_dist against a float32 left fold in numpy, bit for bit:
    d0*d0, then + dc*dc channel by channel, each operation rounded."""
    a = rng.normal(size=(1, 9, c)).astype(F32)
    b = rng.normal(size=(1, 11, c)).astype(F32)
    want = None
    for ch in range(c):
        d = a[0, :, None, ch] - b[0, None, :, ch]
        want = d * d if want is None else want + d * d
    got = ops.pairwise_sq_dist(_t(a), _t(b))[0].numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_knn_of_features_carries_no_gradient():
    x = torch.rand(2, 32, 8, requires_grad=True)
    d2, idx = ops.knn_with_distance(x, k=4)
    assert not d2.requires_grad and not idx.requires_grad


@pytest.mark.parametrize("xyz_shape,query_shape", [((2, 16, 5), (2, 8, 4)), ((2, 16, 0), None),
                                                   ((2, 16, 5), (3, 8, 5)), ((16, 5), None)])
def test_knn_refuses_mismatched_channels(xyz_shape, query_shape):
    xyz = torch.rand(xyz_shape)
    query = None if query_shape is None else torch.rand(query_shape)
    with pytest.raises(ValueError):
        ops.knn(xyz, query, k=2)


# ----------------------------------------------------- K5c's launch path


def test_argtypes_match_the_c_entry_point():
    params = c_parameters("pcb_knn_c")
    kernel = _kernels.KNN_C
    assert list(kernel.argtypes) == [_kernels._P if "*" in p else _kernels._I for p in params]
    assert params[-3:] == ["const int* plan", "int device", "void* stream"]
    assert kernel.source.endswith("csrc/knn.cu") and kernel.symbol == "pcb_knn_c"
    assert kernel.replaces == _kernels.KNN.replaces
    assert kernel in _kernels.KERNELS and "knn_c" in _kernels.launch_counts()


def test_plan_fields_in_the_order_c_reads_them():
    body = KNN_SRC[KNN_SRC.index("PCB_API int pcb_knn_c("):KNN_SRC.index("PCB_API int pcb_knn(")]
    read = {int(m.group(2)): m.group(1)
            for m in re.finditer(r"const int (\w+) = plan\[(\d+)\];", body)}
    assert read == dict(enumerate(grouping.KNN_C_PLAN))


def test_the_c_constants_are_the_wrappers():
    assert grouping.KNN_GROUP == GROUP == 32 * UNROLL
    assert grouping.KNN_BUF == BUF == constant(KNN_SRC, "kBuf")
    assert grouping.MAX_SMEM == constant(KNN_SRC, "kMaxSmem")
    # the C source lays out the same three regions in the same order
    text = KNN_SRC[KNN_SRC.index("constexpr size_t knn_c_smem("):]
    text = text[:text.index("}")]
    assert "ring * c * round_up(tile, kGroup) * 4" in text
    assert "round_up(warps * queries * c * 4, 16)" in text
    assert "warps * queries * kBuf * sizeof(Key)" in text
    # K5c is instantiated at the models' width and for any other, at each
    # number of queries a warp the plan may ask for
    assert "launch_knn_c_queries<R, 64, true>" in KNN_SRC
    assert "launch_knn_c_queries<R, 0, false>" in KNN_SRC
    body = KNN_SRC[KNN_SRC.index("cudaError_t launch_knn_c_queries("):]
    body = body[:body.index("\n}\n")]
    cases = [int(q) for q in re.findall(r"case (\d+):", body)]
    assert cases + [int(re.search(r"default:\s*return launch_knn_c<R, CC, VEC, (\d+)>",
                                  body).group(1))] == list(grouping.KNN_C_QUERIES)
    entry = KNN_SRC[KNN_SRC.index("PCB_API int pcb_knn_c("):]
    assert "(queries != 1 && queries != 2)" in entry and grouping.KNN_C_QUERIES == (1, 2)
    assert 'static_assert(Q == 1 || Q == 2, "1 or 2 queries a warp");' in KNN_SRC


@pytest.mark.parametrize("c", [1, 3, 5, 6, 8, 64, 67, 128, 187])
@pytest.mark.parametrize("warps", [4, 8, 16, 32])
def test_knn_c_tile_fits_shared_memory(c, warps):
    """At every number of queries a warp the kernel is compiled for; 0 (no
    tile) only where not even a ring of two 128-point groups fits beside the
    queries and buffers, which never happens at a query a warp up to
    C = 187."""
    for queries in grouping.KNN_C_QUERIES:
        for n in (1, 31, 127, 128, 129, 400, 700, 1000, 4096, 4097, 16384):
            tile = grouping.knn_c_tile(n, c, warps, queries)
            ring = 1 if tile >= n else 2
            if tile == 0:
                assert queries > 1
                assert grouping.knn_c_smem(c, n, 1, warps, queries) > grouping.MAX_SMEM
                assert grouping.knn_c_smem(c, GROUP, 2, warps, queries) > grouping.MAX_SMEM
                continue
            assert tile >= 1
            assert grouping.knn_c_smem(c, tile, ring, warps, queries) <= grouping.MAX_SMEM
            if ring == 2:  # the most whole groups that fit
                assert tile % GROUP == 0
                assert grouping.knn_c_smem(c, tile + GROUP, 2, warps, queries) > grouping.MAX_SMEM
            else:
                assert tile == n


@pytest.mark.parametrize("c,tile,ring,warps,queries", [
    (64, 384, 2, 32, 1), (64, 256, 2, 32, 2), (64, 128, 2, 16, 2), (67, 1000, 1, 8, 2),
    (5, 129, 1, 4, 1), (1, 7, 1, 16, 2)])
def test_knn_c_smem_mirrors_the_c_layout_byte_for_byte(c, tile, ring, warps, queries):
    """The three regions csrc/knn.cu lays out, each summed by hand: the ring
    of channel-major tiles padded to whole groups, the warps' Q query slices
    rounded to 16 bytes, Q candidate buffers of kBuf 8-byte keys a warp."""
    ring_bytes = ring * c * (-(-tile // GROUP) * GROUP) * 4
    query_bytes = -(-(warps * queries * c * 4) // 16) * 16
    buf_bytes = warps * queries * BUF * 8
    assert grouping.knn_c_smem(c, tile, ring, warps, queries) == ring_bytes + query_bytes + buf_bytes


def test_the_dgcnn_shapes_stage_a_ring_of_384_point_tiles():
    """C = 64 at 32 warps of one query (the first design's launch, which
    probes/k2_k5_probe.py compare_k5c times): two tiles of 384 points (196,608
    bytes), the warps' queries (8 KB) and candidate slots (16 KB) fit 227 KB.
    At 32 warps of two queries, the plan at every DGCNN shape (measured
    fastest of the (warps, queries, tile) grid, PERF.md §6), the queries
    (16 KB) and slots (32 KB) leave room for two tiles of 256."""
    assert grouping.knn_c_tile(4096, 64, 32, 1) == 384
    assert grouping.knn_c_smem(64, 384, 2, 32, 1) == 196_608 + 8192 + 16_384
    assert grouping.knn_c_tile(4096, 64, 32, 2) == 256
    assert grouping.knn_c_smem(64, 256, 2, 32, 2) == 131_072 + 16_384 + 32_768
    assert list(grouping._knn_c_plan(4, 4096, 4096, 20, 64, 132, True)) == [
        4, 4096, 4096, 20, 64, 32, 2, 256, 1]
    for b, k in ((4, 64), (16, 20), (16, 64)):
        assert list(grouping._knn_c_plan(b, 4096, 4096, k, 64, 132, True))[5:] == [32, 2, 256, 1]
    # a row that fits is staged whole: N = 256 at C = 64, a query a warp
    assert list(grouping._knn_c_plan(2, 256, 256, 20, 64, 132, True))[5:] == [4, 1, 256, 1]


@pytest.mark.parametrize("b,s,sms,launch", [
    (4, 4096, 132, (32, 2)), (16, 4096, 132, (32, 2)), (3, 4096, 132, (32, 2)),
    (2, 4096, 132, (32, 2)), (1, 4096, 132, (16, 2)), (2, 600, 132, (8, 2)),
    (1, 1056, 132, (4, 2)), (1, 1055, 132, (8, 1)), (1, 1024, 132, (8, 1)), (1, 256, 132, (4, 1)),
    (2, 64, 132, (4, 1)), (2, 100, 132, (4, 1)), (1, 1, 132, (4, 1)), (4, 4096, 78, (32, 2)),
    (4, 4096, 300, (32, 2))])
def test_knn_c_launch_by_the_number_of_queries(b, s, sms, launch):
    """Two queries a warp at the warps neighbour_launch gives pairs of
    queries wherever every SM still gets a block of 4 warps (B * S >= 8 per
    SM); else a warp a query at the warps neighbour_launch gives single
    queries. Each launch the plan picks here was the fastest of the grid
    chip_smoke.py --neighbours times at N = 4096 (B = 1, 2, 4, 16 at
    S = 4096; S = 1024, 256, 64), and B = 3 the one it times behind 16 x 2 at
    128-point tiles. Every launch it picks is one the kernel is compiled for
    and fits at C = 64."""
    assert grouping.knn_c_launch(b, s, sms) == launch
    warps, queries = launch
    assert queries in grouping.KNN_C_QUERIES
    assert grouping.knn_c_tile(4096, 64, warps, queries) >= grouping.KNN_GROUP


@pytest.mark.parametrize("args", [
    (4, 4096, 4096, 0, 64, 132, True), (4, 4096, 4096, 65, 64, 132, True),
    (4, 16, 16, 17, 64, 132, True), (65536, 64, 64, 4, 64, 132, True),
    (4, 64, 64, 4, 6, 132, True), (4, 64, 64, 4, 0, 132, False),
    (4, 2**25, 64, 4, 64, 132, True), (4, 4096, 4096, 20, 188, 132, False),
    (4, 4096, 4096, 20, 64, 132, True, 12), (4, 4096, 4096, 20, 64, 132, True, 32, 1024),
    (4, 4096, 4096, 20, 64, 132, True, 32, None, 3), (4, 4096, 4096, 20, 64, 132, True, 32, None, 4),
    (4, 4096, 4096, 20, 64, 132, True, 16, None, 8), (4, 4096, 4096, 20, 64, 132, True, 32, 384, 2),
    (4, 4096, 4096, 20, 187, 132, False, 32, None, 2)])
def test_knn_c_plan_refuses(args):
    with pytest.raises(ValueError):
        grouping._knn_c_plan(*args)


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """CPU tensors that pass the device check; every launch is recorded
    instead of made (there is no nvcc here)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_kernels, "stream_args", lambda t: (0, None))
    monkeypatch.setattr(_kernels, "sm_count", lambda device: 132)
    launched = []
    for kernel in (_kernels.KNN, _kernels.KNN_C):
        monkeypatch.setattr(kernel, "launch", lambda *args, k=kernel: launched.append((k, args)))
    return launched


def test_knn_c_cuda_hands_over_its_plan(as_if_on_the_card):
    x = torch.zeros(2, 600, 64)
    d2, idx = grouping.knn_c_cuda(x, x[:, :100].contiguous(), 33)
    assert idx.shape == d2.shape == (2, 100, 33) and idx.dtype == torch.int32
    (kernel, args), = as_if_on_the_card
    assert kernel is _kernels.KNN_C and len(args) == len(kernel.argtypes)
    assert args[2:4] == (idx.data_ptr(), d2.data_ptr())
    assert list(args[4]) == [2, 600, 100, 33, 64, 4, 1, 600, 1]  # 200 queries: 4 warps of 1


@pytest.mark.parametrize("c,offset,vec", [(64, 0, 1), (64, 1, 0), (6, 0, 0), (5, 0, 0),
                                          (128, 0, 1), (3, 0, 0)])
def test_knn_c_cuda_stages_four_channels_where_it_can(as_if_on_the_card, c, offset, vec):
    """Four channels a copy where 4 divides C and the rows start on 16
    bytes; a view one float off takes 4-byte copies."""
    flat = torch.zeros(2 * 300 * c + offset)
    x = flat[offset:].view(2, 300, c)
    grouping.knn_c_cuda(x, x, 8)
    (kernel, args), = as_if_on_the_card
    assert dict(zip(grouping.KNN_C_PLAN, args[4]))["vec"] == vec


@pytest.mark.parametrize("c,wrapper", [(3, "knn_cuda"), (64, "knn_c_cuda"), (5, "knn_c_cuda"),
                                       (1, "knn_c_cuda")])
def test_knn_sends_three_channels_to_k5_and_any_other_to_k5c(monkeypatch, c, wrapper):
    """The meta device stands in for the card: it is not the CPU, so the op
    dispatches to a kernel wrapper, contiguous and detached."""
    seen = []

    def record(name):
        def fake(xyz, query, k):
            seen.append((name, xyz.is_contiguous(), query.is_contiguous(), xyz.requires_grad))
            out = torch.empty(xyz.shape[0], query.shape[1], k, device=xyz.device)
            return out, out.int()
        return fake

    for name in ("knn_cuda", "knn_c_cuda"):
        monkeypatch.setattr(grouping, name, record(name))
    x = torch.empty(2, c, 128, device="meta", requires_grad=True).transpose(1, 2)
    assert ops.knn(x, k=20).shape == (2, 128, 20)
    assert seen == [(wrapper, True, True, False)]


def bad_inputs(case: str):
    xyz, query = torch.rand(2, 64, 8), torch.rand(2, 8, 8)
    if case == "xyz float64":
        xyz = xyz.double()
    elif case == "xyz not contiguous":
        xyz = torch.rand(2, 8, 64).transpose(1, 2)
    elif case == "query not contiguous":
        query = torch.rand(2, 8, 8).transpose(1, 2)
    elif case == "query of 4 channels":
        query = torch.rand(2, 8, 4)
    elif case == "query of another B":
        query = torch.rand(3, 8, 8)
    elif case == "query rank 2":
        query = query[0]
    elif case == "N = 0":
        xyz = torch.zeros(2, 0, 8)
    elif case == "B over 65535":
        xyz, query = torch.zeros(65536, 4, 8), torch.zeros(65536, 1, 8)
    elif case == "C = 300":  # no tile of a group fits shared memory
        xyz, query = torch.rand(2, 4096, 300), torch.rand(2, 8, 300)
    return xyz, query


@pytest.mark.parametrize("case", ["xyz float64", "xyz not contiguous", "query not contiguous",
                                  "query of 4 channels", "query of another B", "query rank 2",
                                  "N = 0", "B over 65535", "C = 300", "k = 0", "k = 65",
                                  "k over N"])
def test_knn_c_cuda_refuses(as_if_on_the_card, case):
    xyz, query = bad_inputs(case)
    k = {"k = 0": 0, "k = 65": 65, "k over N": 65}.get(case, 4)
    if case == "k = 65":
        xyz = torch.rand(2, 100, 8)
    with pytest.raises((TypeError, ValueError)):
        grouping.knn_c_cuda(xyz, query, k)
    assert not as_if_on_the_card


def test_knn_c_cuda_refuses_cpu_tensors():
    x = torch.rand(1, 32, 8)
    before = _kernels.KNN_C.launches
    with pytest.raises(ValueError, match="CUDA"):
        grouping.knn_c_cuda(x, x, 4)
    assert _kernels.KNN_C.launches == before


# ------------------------------------------ K5c's fold and ring, as the card runs it


def knn_c_emulated(xyz: np.ndarray, query: np.ndarray, k: int, tile: int, queries: int = 1):
    """csrc/knn.cu knn_c_kernel in numpy, ``queries`` consecutive queries a
    warp: a warp with fewer left scans zeros for the rest and writes nothing
    for them; tiles of ``tile`` points padded with NaN to a whole group;
    each distance the left fold over the channels in float32; groups of
    UNROLL 32-point steps, one vote for the group over the warp's queries,
    then each query's own vote against its k-th key's bits; each query's
    candidates appended by ballot order to its own buffer and merged 32 at a
    time (csrc/knn.cu Selection). -> (d2, idx)."""
    b, n, c = xyz.shape
    s = query.shape[1]
    warps = -(-s // queries)
    slots = warps * queries  # the warps' query slots; those past S scan zeros
    r_regs = 1 if k <= 32 else 2
    d2_out = np.empty((b, s, k), F32)
    idx_out = np.empty((b, s, k), np.int32)
    for bi in range(b):
        q = np.zeros((slots, c), F32)
        q[:s] = query[bi]
        lst = np.full((slots, r_regs, 32), EMPTY, np.uint64)
        bound = np.full(slots, NO_BOUND, np.uint64)
        buf = np.zeros((slots, BUF), np.uint64)
        count = np.zeros(slots, np.int64)
        for base in range(0, n, tile):
            lim = min(tile, n - base)
            pts = np.full((-(-lim // GROUP) * GROUP, c), np.nan, F32)
            pts[:lim] = xyz[bi, base:base + lim]
            acc = None
            with np.errstate(invalid="ignore"):
                for ch in range(c):
                    d = q[:, None, ch] - pts[None, :, ch]
                    acc = d * d if acc is None else acc + d * d
            bits = acc.view(np.uint32).astype(np.uint64)
            for t0 in range(0, lim, GROUP):
                group = bits[:, t0:t0 + GROUP]
                own = (group < bound[:, None]).any(1)  # each query's vote
                warp_vote = own.reshape(warps, queries).any(1)  # one for the warp's group
                offered = np.repeat(warp_vote, queries) & own
                if not offered.any():
                    continue
                for u in range(UNROLL):
                    v = group[:, u * 32:(u + 1) * 32]
                    hit = (v < bound[:, None]) & offered[:, None]
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
        flat = lst[:s].reshape(s, -1)[:, :k]  # the slots past S write nothing
        idx_out[bi] = (flat & np.uint64(0xFFFFFFFF)).astype(np.int64)
        d2_out[bi] = (flat >> np.uint64(32)).astype(np.uint32).view(F32)
    return d2_out, idx_out


def plan_launch(b, n, s, k, c, vec=True):
    """(warps, queries, tile) of the wrapper's plan at this shape, 132 SMs."""
    fields = dict(zip(grouping.KNN_C_PLAN, grouping._knn_c_plan(b, n, s, k, c, 132, vec)))
    return fields["warps"], fields["queries"], fields["tile"]


@pytest.mark.parametrize("kind,c,n,s,k", [
    ("uniform", 64, 1000, 40, 20), ("uniform", 64, 1000, 30, 64), ("uniform", 6, 300, 50, 16),
    ("uniform", 128, 400, 20, 33), ("uniform", 5, 129, 129, 1), ("grid", 64, 900, 40, 20),
    ("grid", 8, 300, 60, 64), ("grid", 67, 256, 30, 32)])
def test_knn_c_selection_matches_plain(kind, c, n, s, k):
    """Bit for bit, indices and distances, at the launch the wrapper plans
    for this shape (its queries a warp and its tile) and with the row whole;
    and at 32 warps of 2 queries with the tile that leaves them (256 points
    at C = 64: N = 1000 takes four tiles, the last 232 points)."""
    rng = np.random.default_rng(c * n + k)
    xyz = features(rng, kind, 2, n, c)
    query = np.ascontiguousarray(xyz[:, :s] if kind == "uniform" else features(rng, kind, 2, s, c))
    pd2, pidx = grouping.knn_plain(_t(xyz), _t(query), k)
    _, queries, tile = plan_launch(2, n, s, k, c, c % 4 == 0)
    for q, tl in {(queries, tile), (queries, n), (2, grouping.knn_c_tile(n, c, 32, 2))}:
        d2, idx = knn_c_emulated(xyz, query, k, tl, q)
        np.testing.assert_array_equal(idx, pidx.numpy())
        np.testing.assert_array_equal(d2.view(np.uint32), pd2.numpy().view(np.uint32))


def warp_edge_cases():
    """(queries, kind, c, n, s, k): S = 1, S = Q - 1 and odd S (a last warp
    of one query at Q = 2, as 4095 leaves), k = 1, 20, 33 and 64, on uniform
    and integer-grid features."""
    cases = []
    for q in grouping.KNN_C_QUERIES:
        for kind, c, n, s, k in (("uniform", 64, 600, 1, 20), ("uniform", 64, 600, q - 1, 64),
                                 ("uniform", 64, 700, 37, 33), ("uniform", 5, 300, 45, 1),
                                 ("uniform", 64, 900, 255, 20), ("uniform", 128, 400, 33, 64),
                                 ("grid", 64, 500, 23, 20), ("grid", 8, 300, 19, 64),
                                 ("grid", 67, 256, 37, 1), ("grid", 64, 400, 63, 33)):
            if s >= 1:
                cases.append((q, kind, c, n, s, k))
    return cases


@pytest.mark.parametrize("queries,kind,c,n,s,k", warp_edge_cases())
def test_knn_c_warps_of_q_queries_match_plain(queries, kind, c, n, s, k):
    """Every Q the kernel is compiled for, with the tile the plan gives at
    32 warps, cut to 256 points (a ring wherever the row does not fit),
    bit for bit against knn_plain: the last warp partly active, B = 1 and
    B = 2."""
    rng = np.random.default_rng(queries * 1000 + c * n + s + k)
    for b in (1, 2):
        xyz = features(rng, kind, b, n, c)
        query = features(rng, kind, b, s, c)
        pd2, pidx = grouping.knn_plain(_t(xyz), _t(query), k)
        tile = min(grouping.knn_c_tile(n, c, 32, queries), 2 * GROUP)
        d2, idx = knn_c_emulated(xyz, query, k, tile, queries)
        np.testing.assert_array_equal(idx, pidx.numpy())
        np.testing.assert_array_equal(d2.view(np.uint32), pd2.numpy().view(np.uint32))


# ------------------------------- the probe's designs, held to the kernel's source

@pytest.mark.parametrize("table", ["KNN_C_VARIANTS", "KNN_C_LAUNCH_VARIANTS", "EXIT_VARIANT"])
def test_the_probes_edits_still_apply_to_the_kernel(table):
    """Every text the probe's K5c variants replace occurs in csrc/knn.cu
    exactly once, so that a variant is the kernel with one part changed."""
    rows = getattr(k2_k5_probe, table)
    rows = [rows] if table == "EXIT_VARIANT" else rows
    assert rows
    for row in rows:
        for old, new in row[2]:
            assert KNN_SRC.count(old) == 1, (row[0], old)
            assert old != new


@pytest.mark.parametrize("b,n,s,k,c,vec,want", [
    (4, 4096, 4096, 20, 64, True, [4, 4096, 4096, 20, 64, 32, 1, 384, 1]),
    (16, 4096, 4096, 64, 64, True, [16, 4096, 4096, 64, 64, 32, 1, 384, 1]),
    (2, 600, 100, 33, 64, False, [2, 600, 100, 33, 64, 4, 1, 600, 0])])
def test_the_first_designs_plan_is_the_one_it_ran_with(b, n, s, k, c, vec, want):
    """A warp a query at the warps of neighbour_launch and the most tile
    that leaves: 32 warps and 384-point tiles at DGCNN's shapes."""
    assert list(k2_k5_probe.first_design_plan(b, n, s, k, c, 132, vec)) == want
