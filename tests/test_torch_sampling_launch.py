"""The launch path and the selection arithmetic of K1 (FPS, csrc/fps.cu) and
K4 (interpolation, csrc/interp.cu), on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions. Here, without a card: their C entry points against
the argument types the wrappers bind; the plans the wrappers lay out; the
launch choices they make (threads and points a thread by N; lanes a query
by the number of queries; channel chunks; 16-byte accesses by D and pointer alignment); their
refusals; and numpy emulations of what the kernels compute in their own
order (the FPS argmax as a maximum of uint32 keys with the lowest index on
equal keys, a thread, a warp, a block; the k nearest sources as lane
groups that scan a stride each and merge sorted lists), held bit for bit
against the port's plain versions and the JAX package (``_fps_jnp``; the
Pallas interpolation kernel in interpret mode).
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.ops.pallas_kernels.interp3 import interpolate_pallas
from pointcloud_bridge_tpu.ops.sampling import _fps_jnp
from pointcloud_bridge_tpu_torch import ops
from pointcloud_bridge_tpu_torch.ops import _kernels, interpolate, sampling

F32 = np.float32
NO_INDEX = np.iinfo(np.int32).max
# sources a lane scans between two updates of the group's bound (interp.cu kScan)
SCAN = 8


def c_parameters(symbol: str) -> list:
    """The parameter list of the PCB_API function ``symbol`` in csrc/*.cu."""
    for path in sorted(_kernels.CSRC.glob("*.cu")):
        m = re.search(r"PCB_API\s+int\s+" + symbol + r"\s*\(([^)]*)\)", path.read_text())
        if m:
            return [" ".join(p.split()) for p in m.group(1).split(",")]
    raise AssertionError(f"{symbol}: no PCB_API definition in csrc/")


def ctypes_of(param: str):
    if "*" in param:
        return _kernels._P
    kind = param.rsplit(" ", 1)[0].replace("const ", "").strip()
    return {"int": _kernels._I, "float": _kernels._F, "long long": _kernels._L}[kind]


@pytest.mark.parametrize("kernel", [_kernels.FPS, _kernels.INTERPOLATE], ids=lambda k: k.name)
def test_argtypes_match_the_c_entry_point(kernel):
    params = c_parameters(kernel.symbol)
    assert list(kernel.argtypes) == [ctypes_of(p) for p in params], params
    assert params[-3:] == ["const int* plan", "int device", "void* stream"]


@pytest.mark.parametrize("source,symbol,fields", [
    ("fps.cu", "pcb_fps", sampling.FPS_PLAN),
    ("interp.cu", "pcb_interpolate", interpolate.INTERP_PLAN),
])
def test_plan_fields_in_the_order_c_reads_them(source, symbol, fields):
    text = (_kernels.CSRC / source).read_text()
    body = text[text.index(f"PCB_API int {symbol}("):]
    read = {int(m.group(2)): m.group(1)
            for m in re.finditer(r"const int (\w+) = plan\[(\d+)\];", body)}
    assert read == dict(enumerate(fields))


def test_the_scan_between_bounds_is_the_kernels():
    text = (_kernels.CSRC / "interp.cu").read_text()
    assert int(re.search(r"constexpr int kScan = (\d+);", text).group(1)) == SCAN


def test_the_c_cap_is_the_wrappers():
    """fps.cu sizes its shared-memory opt-in for FPS_MAX_POINTS: the row's
    copy (12 bytes a point) and the ring of indices fit a block's 227 KB
    beside the static slots."""
    text = (_kernels.CSRC / "fps.cu").read_text()
    cap = int(re.search(r"constexpr int kMaxPoints = (\d+);", text).group(1))
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", text).group(1))
    assert cap == sampling.FPS_MAX_POINTS
    assert 12 * cap + 2 * chunk * 4 + 2 * 2 * 32 * 4 <= 232_448


# --------------------------------------------------------- launch choices


@pytest.mark.parametrize("n,launch", [
    (1, (32, 1)), (32, (32, 1)), (33, (32, 2)), (200, (32, 8)), (256, (32, 8)),
    (257, (128, 4)), (512, (128, 4)), (600, (128, 8)), (1000, (128, 8)), (1024, (128, 8)), (4096, (512, 8)),
    (8192, (1024, 8)), (8193, (1024, 16)), (16384, (1024, 16)),
])
def test_fps_launch_by_n(n, launch):
    assert sampling.fps_launch(n) == launch


def test_fps_launch_covers_every_n():
    for n in range(1, sampling.FPS_MAX_POINTS + 1):
        threads, ppt = sampling.fps_launch(n)
        assert threads % 32 == 0 and 32 <= threads <= 1024 and ppt in (1, 2, 4, 8, 16)
        assert threads * ppt >= n and (ppt == 1 or threads * (ppt // 2) < n)
        assert (threads == 32) == (n <= 256)
    for n in (0, sampling.FPS_MAX_POINTS + 1):
        with pytest.raises(ValueError):
            sampling.fps_launch(n)


@pytest.mark.parametrize("queries,lanes", [
    (1, 32), (4 * 256, 32), (4 * 1024, 32), (8191, 32), (8192, 16), (16383, 16), (16384, 8),
    (4 * 4096, 8), (16 * 1024, 8), (32767, 8), (32768, 4), (16 * 4096, 4)])
def test_interp_lanes_by_queries(queries, lanes):
    assert interpolate.interp_lanes(queries) == lanes


# (B, N, S, D) of every interpolation of SSG and BriStruNet at B=4 and 16
MODEL_INTERPS = [(b, n, s, d) for b in (4, 16) for n, s, d in (
    (256, 64, 512), (1024, 256, 256), (4096, 1024, 128),
    (512, 128, 1024), (1024, 512, 256), (4096, 1024, 256))]


@pytest.mark.parametrize("b,n,s,d", MODEL_INTERPS)
def test_interp_grid_fills_the_card_at_the_model_shapes(b, n, s, d):
    """The query tiles alone where they give 132 SMs two blocks each; else
    the narrowest chunk of whole warp widths (128 channels of 16-byte
    accesses) that cuts D into no more chunks than it takes to get there."""
    plan = dict(zip(interpolate.INTERP_PLAN, interpolate._interp_plan(b, n, s, d, 3, True, 132)))
    assert plan["lanes"] == interpolate.interp_lanes(b * n)
    chunk = plan["chunk"]
    tiles = -(-n // (256 // plan["lanes"])) * b
    want = -(-2 * 132 // tiles)
    assert chunk == d or chunk % 128 == 0
    assert -(-d // chunk) <= want
    assert chunk == d if tiles >= 2 * 132 else chunk == 128 or -(-d // (chunk - 128)) > want


@pytest.mark.parametrize("blocks,d,chunk", [
    (64, 1024, 256), (32, 512, 128), (256, 256, 128), (512, 256, 256), (2048, 128, 128),
    (128, 512, 256), (8, 131, 128), (8, 300, 128), (1, 0, 1), (300, 64, 64)])
def test_interp_chunk(blocks, d, chunk):
    assert interpolate.interp_chunk(blocks, d, 132) == chunk


def test_interp_plan_refuses():
    with pytest.raises(ValueError):
        interpolate._interp_plan(65536, 4, 4, 4, 3, True, 132)
    with pytest.raises(ValueError):
        interpolate._interp_plan(4, 4, 4, 4, 3, True, 132, lanes=2)
    with pytest.raises(ValueError):
        sampling._fps_plan(4, 4096, 64, 256, 8)  # 2048 slots for 4096 points


# --------------------------------------------- what the wrappers hand over


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """CPU tensors that pass the device check; every launch is recorded
    instead of made (there is no nvcc here)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_kernels, "stream_args", lambda t: (0, None))
    monkeypatch.setattr(interpolate, "_sm_count", lambda device: 132)
    launched = []
    for kernel in (_kernels.FPS, _kernels.INTERPOLATE):
        monkeypatch.setattr(kernel, "launch", lambda *args, k=kernel: launched.append((k, args)))
    return launched


def test_fps_cuda_hands_over_its_plan(as_if_on_the_card):
    xyz = torch.zeros(3, 1000, 3)
    out = sampling.fps_cuda(xyz, 300, torch.zeros(3, dtype=torch.int32))
    assert out.shape == (3, 300) and out.dtype == torch.int32
    (kernel, args), = as_if_on_the_card
    assert kernel is _kernels.FPS and len(args) == len(kernel.argtypes)
    assert list(args[3]) == [3, 1000, 300, 128, 8]


def aligned_normal(shape, offset=0):
    """A float32 tensor whose first element is `offset` floats past a
    16-byte boundary."""
    size = int(np.prod(shape))
    flat = torch.empty(size + 8)
    skip = (-(flat.data_ptr() // 4)) % 4 + offset
    return flat[skip:skip + size].view(*shape).normal_()


@pytest.mark.parametrize("d,offset,vec", [(256, 0, 1), (4, 0, 1), (131, 0, 0), (256, 1, 0),
                                          (256, 2, 0), (128, 3, 0)])
def test_interpolate_cuda_vector_access_by_d_and_alignment(as_if_on_the_card, d, offset, vec):
    dst = torch.rand(2, 64, 3)
    feats = aligned_normal((2, 16, d), offset)
    assert feats.is_contiguous() and feats.data_ptr() % 16 == 4 * offset
    out, idx, w = interpolate.interpolate_cuda(dst, dst[:, :16].contiguous(), feats, 3)
    assert out.shape == (2, 64, d) and idx is None and w is None
    (kernel, args), = as_if_on_the_card
    plan = dict(zip(interpolate.INTERP_PLAN, args[6]))
    assert plan["vec"] == vec and (plan["b"], plan["n"], plan["s"], plan["d"], plan["k"]) == (
        2, 64, 16, d, 3)
    assert args[4] is None and args[5] is None  # no backward: nothing kept


def test_interpolate_cuda_keeps_the_selection_for_a_backward(as_if_on_the_card):
    dst = torch.rand(2, 64, 3)
    _, idx, w = interpolate.interpolate_cuda(dst, dst[:, :16].contiguous(), torch.rand(2, 16, 8),
                                             4, keep=True)
    assert idx.shape == w.shape == (2, 64, 4) and idx.dtype == torch.int32
    (_, args), = as_if_on_the_card
    assert args[4] == idx.data_ptr() and args[5] == w.data_ptr()


def test_ops_hand_the_kernels_contiguous_tensors(monkeypatch):
    """A non-contiguous CUDA input takes the kernel as a contiguous copy,
    as the JAX package and the CPU path take any layout (the wrappers
    refuse strides). The meta device stands in for the card: it is not the
    CPU, so the ops dispatch to the kernel wrappers, which record here."""
    seen = []

    def fake_fps(xyz, npoint, start):
        seen.append(("fps", xyz.is_contiguous(), start.is_contiguous()))
        return torch.empty(xyz.shape[0], npoint, dtype=torch.int32, device=xyz.device)

    def fake_interp(dst, src, feats, k, keep):
        seen.append(("interp", dst.is_contiguous(), src.is_contiguous(), feats.is_contiguous()))
        return torch.empty(dst.shape[0], dst.shape[1], feats.shape[2], device=dst.device), None, None

    monkeypatch.setattr(sampling, "fps_cuda", fake_fps)
    monkeypatch.setattr(interpolate, "interpolate_cuda", fake_interp)
    xyz = torch.empty(4, 3, 256, device="meta").transpose(1, 2)  # [4, 256, 3], strided
    assert ops.farthest_point_sample(xyz, 64).shape == (4, 64)
    feats = torch.empty(4, 32, 64, device="meta").transpose(1, 2)  # [4, 64, 32], strided
    out = ops.three_nn_interpolate(xyz, xyz[:, ::4], feats)
    assert out.shape == (4, 256, 32)
    assert seen == [("fps", True, True), ("interp", True, True, True)]


# ------------------------------------------------------------- refusals


def test_wrappers_refuse_cpu_tensors():
    xyz = torch.rand(2, 64, 3)
    with pytest.raises(ValueError, match="CUDA"):
        sampling.fps_cuda(xyz, 16, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        interpolate.interpolate_cuda(xyz, xyz[:, :8].contiguous(), torch.rand(2, 8, 4), 3)


@pytest.mark.parametrize("case", ["xyz float64", "xyz not contiguous", "xyz of 4 channels",
                                  "start int64", "start of another B", "start rank 2",
                                  "N over the cap", "N = 0"])
def test_fps_cuda_refuses(as_if_on_the_card, case):
    xyz = torch.rand(2, 64, 3)
    start = torch.zeros(2, dtype=torch.int32)
    if case == "xyz float64":
        xyz = xyz.double()
    elif case == "xyz not contiguous":
        xyz = torch.rand(2, 3, 64).transpose(1, 2)
    elif case == "xyz of 4 channels":
        xyz = torch.rand(2, 64, 4)
    elif case == "start int64":
        start = start.long()
    elif case == "start of another B":
        start = torch.zeros(3, dtype=torch.int32)
    elif case == "start rank 2":
        start = start.view(2, 1)
    elif case == "N over the cap":
        xyz = torch.zeros(1, sampling.FPS_MAX_POINTS + 1, 3)
        start = start[:1]
    elif case == "N = 0":
        xyz = torch.zeros(2, 0, 3)
    with pytest.raises((TypeError, ValueError)):
        sampling.fps_cuda(xyz, 16, start)
    assert not as_if_on_the_card


@pytest.mark.parametrize("case", ["k = 5", "k over S", "k = 0", "feats of another S",
                                  "src of another B", "dst of 2 channels", "feats float16",
                                  "feats not contiguous", "B over 65535"])
def test_interpolate_cuda_refuses(as_if_on_the_card, case):
    dst, src, feats, k = torch.rand(2, 64, 3), torch.rand(2, 8, 3), torch.rand(2, 8, 5), 3
    if case == "k = 5":
        k = 5
    elif case == "k over S":
        src, feats = src[:, :2].contiguous(), feats[:, :2].contiguous()
    elif case == "k = 0":
        k = 0
    elif case == "feats of another S":
        feats = torch.rand(2, 9, 5)
    elif case == "src of another B":
        src = torch.rand(3, 8, 3)
    elif case == "dst of 2 channels":
        dst = torch.rand(2, 64, 2)
    elif case == "feats float16":
        feats = feats.half()
    elif case == "feats not contiguous":
        feats = torch.rand(2, 5, 8).transpose(1, 2)
    elif case == "B over 65535":
        dst, src, feats = torch.zeros(65536, 1, 3), torch.zeros(65536, 4, 3), torch.zeros(65536, 4, 1)
    with pytest.raises((TypeError, ValueError)):
        interpolate.interpolate_cuda(dst, src, feats, k)
    assert not as_if_on_the_card


# ------------------------------------------ K1's selection, as the card runs it


def fps_emulated(xyz: np.ndarray, npoint: int, start: np.ndarray) -> np.ndarray:
    """csrc/fps.cu step by step in numpy at the wrapper's launch: each
    thread's points t + j * threads (slots past N at distance 0), the first
    maximum over j; then a warp's and the block's maximum of the distances'
    uint32 bits with the lowest index among the lanes that hold it."""
    b, n, _ = xyz.shape
    threads, ppt = sampling.fps_launch(n)
    slot = np.arange(threads)[:, None] + threads * np.arange(ppt)[None, :]  # [threads, ppt]
    valid = slot < n
    rows = np.arange(threads)
    out = np.empty((b, npoint), np.int32)
    for r in range(b):
        p = xyz[r][np.minimum(slot, n - 1)]  # [threads, ppt, 3]
        dist = np.where(valid, F32(1e10), F32(0))
        far = int(start[r])
        for it in range(npoint):
            out[r, it] = far
            dx, dy, dz = (p[..., c] - xyz[r, far, c] for c in range(3))
            dist = np.fmin(dist, (dx * dx + dy * dy) + dz * dz)
            j = dist.argmax(1)  # the first maximum: a strict > over j
            key = dist[rows, j].view(np.uint32).reshape(-1, 32)
            idx = (rows + threads * j).astype(np.uint32).reshape(-1, 32)
            wkey = key.max(1)
            widx = np.where(key == wkey[:, None], idx, np.uint32(0xFFFFFFFF)).min(1)
            far = int(np.where(wkey == wkey.max(), widx, np.uint32(0xFFFFFFFF)).min())
    return out


def fps_clouds(kind: str, b: int, n: int, rng) -> np.ndarray:
    if kind == "uniform":
        return rng.uniform(size=(b, n, 3)).astype(F32)
    if kind == "grid":  # many equal distances
        return rng.integers(0, 4, (b, n, 3)).astype(F32)
    xyz = rng.uniform(size=(b, n, 3)).astype(F32)
    xyz[0] = 0.25  # a row of one point n times
    return xyz


@pytest.mark.parametrize("kind", ["uniform", "grid", "equal"])
@pytest.mark.parametrize("n,npoint", [(33, 33), (200, 48), (300, 64), (1000, 48), (1024, 96)])
def test_fps_key_reduction_matches_plain_and_jax(kind, n, npoint):
    rng = np.random.default_rng(n + len(kind))
    xyz = fps_clouds(kind, 2, n, rng)
    start = rng.integers(0, n, 2).astype(np.int32)
    got = fps_emulated(xyz, npoint, start)
    plain = sampling.fps_plain(torch.from_numpy(xyz), npoint, torch.from_numpy(start))
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, np.asarray(_fps_jnp(jnp.asarray(xyz), npoint,
                                                           jnp.asarray(start))))


def test_uint32_keys_order_like_nonnegative_floats():
    """The kernel compares distances by their bits: for float32 >= 0
    (+0, subnormals, 1e10 included) the uint32 order is the float order."""
    rng = np.random.default_rng(7)
    v = np.concatenate([np.array([0.0, 1e-45, 1e-38, 1.0, 1e10], F32),
                        rng.uniform(0, 4, 2000).astype(F32),
                        (rng.uniform(size=2000) ** 20).astype(F32)])
    order = np.argsort(v, kind="stable")
    np.testing.assert_array_equal(np.argsort(v.view(np.uint32), kind="stable"), order)


# ------------------------------------------ K4's selection, as the card runs it


def ahead(a, ai, b, bi):
    return (a < b) | ((a == b) & (ai < bi))


def lane_group_select(dst: np.ndarray, src: np.ndarray, k: int, lanes: int):
    """csrc/interp.cu's selection in numpy: lane l of a query's group scans
    sources l, l + lanes, ... in order into a sorted list of kp pairs (kp =
    4 at k = 3) by strict (distance, index) insertion, skipping a source
    farther than the group's bound (the least k-th kept distance of its
    lanes, renewed every SCAN sources a lane); then log2(lanes)
    rounds merge each lane's list with its xor partner's (the min of one
    list and the other reversed, sorted by a bitonic pass); then the weights
    in selection order. -> (idx [B, N, k], w [B, N, k])."""
    dx, dy, dz = (dst[:, :, None, c] - src[:, None, :, c] for c in range(3))
    d2 = (dx * dx + dy * dy) + dz * dz
    b, n, s = d2.shape
    kp = 4 if k == 3 else k
    bd = np.full((b, n, lanes, kp), np.inf, F32)
    bi = np.full((b, n, lanes, kp), NO_INDEX, np.int64)
    bound = np.full((b, n, 1), np.inf, F32)
    steps = -(-s // lanes)
    for step in range(steps):
        t = step * lanes + np.arange(lanes)
        v = np.broadcast_to(d2[..., np.minimum(t, s - 1)], (b, n, lanes)).copy()
        vi = np.broadcast_to(t, (b, n, lanes)).copy()
        live = (t < s) & (v <= bound)
        for p in range(kp):
            swap = live & ahead(v, vi, bd[..., p], bi[..., p])
            bd[..., p], v = np.where(swap, v, bd[..., p]), np.where(swap, bd[..., p], v)
            bi[..., p], vi = np.where(swap, vi, bi[..., p]), np.where(swap, bi[..., p], vi)
        if step % SCAN == SCAN - 1 or step == steps - 1:
            bound = bd[..., k - 1].min(-1, keepdims=True)
    off = 1
    while off < lanes:
        partner = np.arange(lanes) ^ off
        od, oi = bd[..., partner, ::-1], bi[..., partner, ::-1]
        take = ahead(od, oi, bd, bi)
        bd, bi = np.where(take, od, bd), np.where(take, oi, bi)
        h = kp // 2
        while h:
            for t in range(kp):
                if not t & h:
                    u = t + h
                    swap = ahead(bd[..., u], bi[..., u], bd[..., t], bi[..., t])
                    bd[..., t], bd[..., u] = (np.where(swap, bd[..., u], bd[..., t]),
                                              np.where(swap, bd[..., t], bd[..., u]))
                    bi[..., t], bi[..., u] = (np.where(swap, bi[..., u], bi[..., t]),
                                              np.where(swap, bi[..., t], bi[..., u]))
            h //= 2
        off *= 2
    assert (bi == bi[..., :1, :]).all()  # every lane of a group holds the result
    dist, idx = bd[..., 0, :k], bi[..., 0, :k]
    w = [F32(1) / (dist[..., t] + F32(1e-8)) for t in range(k)]
    wsum = w[0]
    for x in w[1:]:
        wsum = wsum + x
    return idx, np.stack([x / wsum for x in w], -1)


def interp_clouds(kind: str, n: int, s: int, rng):
    if kind == "uniform":
        dst = rng.uniform(size=(2, n, 3)).astype(F32)
        return dst, np.ascontiguousarray(dst[:, :s])  # sources among the queries, as FPS makes them
    return (rng.integers(0, 3, (2, n, 3)).astype(F32),  # an integer grid: many ties
            rng.integers(0, 3, (2, s, 3)).astype(F32))


@pytest.mark.parametrize("lanes", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("kind,n,s,k", [
    ("uniform", 96, 64, 3), ("uniform", 64, 130, 4), ("grid", 96, 40, 3), ("grid", 64, 100, 4),
    ("grid", 48, 5, 3), ("uniform", 40, 2, 2), ("grid", 40, 7, 1)])
def test_lane_group_selection_matches_plain(lanes, kind, n, s, k):
    rng = np.random.default_rng(n * s + k)
    dst, src = interp_clouds(kind, n, s, rng)
    idx, w = lane_group_select(dst, src, k, lanes)
    pidx, pw = interpolate.interpolate_select_plain(torch.from_numpy(dst), torch.from_numpy(src), k)
    np.testing.assert_array_equal(idx, pidx.numpy())
    np.testing.assert_array_equal(w, pw.numpy())


@pytest.mark.parametrize("lanes", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("kind,n,s,k", [("uniform", 64, 48, 3), ("grid", 64, 20, 4)])
def test_lane_group_selection_matches_the_pallas_kernel(lanes, kind, n, s, k):
    """The Pallas kernel in interpret mode with identity features returns
    its blend rows [B, N, S]: the selected sources' normalised weights and
    zeros elsewhere. The selection is held bit for bit; the weights within
    1e-6, since XLA may divide by wsum as a multiplication by 1 / wsum."""
    rng = np.random.default_rng(s + k)
    dst, src = interp_clouds(kind, n, s, rng)
    eye = np.broadcast_to(np.eye(s, dtype=F32), (2, s, s))
    blend = np.asarray(interpolate_pallas(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(eye),
                                          k, True))
    idx, w = lane_group_select(dst, src, k, lanes)
    picked = np.zeros(blend.shape, bool)
    np.put_along_axis(picked, idx, True, axis=-1)
    np.testing.assert_array_equal(blend != 0, picked)
    np.testing.assert_allclose(np.take_along_axis(blend, idx, -1), w, rtol=1e-6, atol=1e-7)
