"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The ``.cu`` files in the repository are the only source of truth. On first
use, ``nvcc`` compiles all of them into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), named by a hash of
the sources and the flags, under ``build/pointcloud_bridge_tpu_torch/`` at
the repository root; a later call with unchanged sources loads the same
file. The library is loaded with ``ctypes``.

Each kernel is a :class:`Kernel`: its C entry point, its argument types, and
a launch counter that goes up by one for every successful launch, so that a
run can show which kernels the main path went through. The wrappers in the
``ops`` modules check their tensors and call :meth:`Kernel.launch` with
raw pointers and PyTorch's current stream. The launch path is kept thin,
because at the models' smaller shapes a call's host time exceeds its device
time: each entry point is bound once (``Kernel.fn``), the stream is read as
a raw handle, the C side sets the device only when it changes, and the FPS,
ball-query, group, interpolation (both ways), both k-NN and both edge-reduce
kernels take their integers as one array laid out once a shape
(ops/sampling.py, grouping.py, interpolate.py, edge.py),
since ctypes converts every argument on every call.

Each forward kernel is also a ``torch.library`` custom op in the namespace
``pcb`` (``custom_op``), so that ``torch.export`` records the kernel and not
its plain version: an exported program calls ``pcb::fps`` and friends, whose
CUDA implementation is the wrapper's launch and whose CPU implementation is
the plain version. The models reach an op only while they are exported or
compiled (``torch.compiler.is_compiling()``); the eager path calls the
wrapper directly, which keeps the dispatcher's cost off it.

Nothing here runs at import time but the ops' registration: the CPU tests
import every module on a machine without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_REPO = _PKG.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _REPO / "build" / "pointcloud_bridge_tpu_torch"

# -fmad=false: no FMA contraction anywhere, so distances round exactly as in
# the reference's separate multiply and add (common.cuh spells it out too).
# flash_attn.cu and flash_attn_bwd.cu, which need no bit-identity, write their
# FMAs as fmaf().
# --threads 0: the sources compile side by side, one job a core.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v", "--threads", "0",
)

# a copy of the package loaded under another name (a training run's code
# snapshot, utils/logging.py) registers its ops under that name
_ROOT_PACKAGE = __name__.split(".")[0]
OP_NAMESPACE = "pcb" if _ROOT_PACKAGE == "pointcloud_bridge_tpu_torch" else _ROOT_PACKAGE

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


@dataclasses.dataclass
class Kernel:
    """One C entry point of the library, with its launch counter."""

    name: str
    symbol: str
    argtypes: tuple
    source: str  # path in the repository
    replaces: str  # file:line of the Pallas kernel it ports
    launches: int = 0
    fn: object = dataclasses.field(default=None, repr=False)  # bound by library()

    def launch(self, *args) -> None:
        """Call the entry point; raise if it returns a CUDA error."""
        err = (self.fn or _bound(self))(*args)
        if err != 0:
            msg = library().pcb_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel: CUDA error {err}: {msg}")
        self.launches += 1


FPS = Kernel(
    "fps", "pcb_fps",
    # xyz, start, out, plan (ops/sampling.py FPS_PLAN), device, stream
    (_P, _P, _P, _P, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/fps.cu",
    "pointcloud_bridge_tpu/ops/pallas_kernels/fps.py:137",
)
BALL_QUERY = Kernel(
    "ball_query", "pcb_ball_query",
    # xyz, centers, out0, out1, out2 (one a radius), plan (ops/grouping.py
    # BALL_PLAN), device, stream
    (_P, _P, _P, _P, _P, _P, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/ballq.cu",
    "pointcloud_bridge_tpu/ops/pallas_kernels/ballq.py:85",
)
GROUP = Kernel(
    "group", "pcb_group",
    # xyz, centers, idx, feats, out, plan (ops/grouping.py GROUP_PLAN),
    # device, stream
    (_P, _P, _P, _P, _P, _P, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/group.cu",
    "pointcloud_bridge_tpu/ops/pallas_kernels/gather3.py:57",
)
INTERPOLATE = Kernel(
    "interpolate", "pcb_interpolate",
    # dst, src, feats, out, idx_out, w_out, plan (ops/interpolate.py
    # INTERP_PLAN), device, stream
    (_P, _P, _P, _P, _P, _P, _P, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/interp.cu",
    "pointcloud_bridge_tpu/ops/pallas_kernels/interp3.py:53",
)
GROUP_BWD = Kernel(
    "group_bwd", "pcb_group_backward",
    # g, idx, out, work (ops/grouping.py group_backward_work), plan
    # (GROUP_BWD_PLAN), device, stream
    (_P, _P, _P, _P, _P, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/group_bwd.cu",
    "pointcloud_bridge_tpu/ops/core.py:44",
)
INTERP_BWD = Kernel(
    "interp_bwd", "pcb_interpolate_backward",
    # g, idx, w, df, plan (ops/interpolate.py INTERP_BWD_PLAN), device, stream
    (_P, _P, _P, _P, _P, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/interp_bwd.cu",
    "pointcloud_bridge_tpu/ops/pallas_kernels/interp3.py:115",
)
KNN = Kernel(
    "knn", "pcb_knn",
    # xyz, query, idx_out, d2_out, plan (ops/grouping.py KNN_PLAN), device,
    # stream
    (_P, _P, _P, _P, _P, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/knn.cu",
    "pointcloud_bridge_tpu/ops/pallas_kernels/knnset.py:77",
)
KNN_C = Kernel(
    "knn_c", "pcb_knn_c",
    # xyz, query, idx_out, d2_out, plan (ops/grouping.py KNN_C_PLAN), device,
    # stream
    (_P, _P, _P, _P, _P, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/knn.cu",
    "pointcloud_bridge_tpu/ops/pallas_kernels/knnset.py:77",
)
FLASH_ATTN = Kernel(
    "flash_attn", "pcb_flash_attn",
    # q, k, v, out, lse (or null), B, N, H, D, ldq, ldk, ldv, device, stream
    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/flash_attn.cu",
    "pointcloud_bridge_tpu/models/ptv3.py:74",
)
# the library kernel's VJP, which the block_*_dq and block_*_dkv sizes of
# ptv3.py:154-156 configure: two kernels there, two here
FLASH_ATTN_BWD_DQ = Kernel(
    "flash_attn_bwd_dq", "pcb_flash_attn_bwd_dq",
    # q, k, v, o, do, lse, dq, delta, B, N, H, D, ldq, ldk, ldv, device, stream
    (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/flash_attn_bwd.cu",
    "pointcloud_bridge_tpu/models/ptv3.py:156",
)
FLASH_ATTN_BWD_DKV = Kernel(
    "flash_attn_bwd_dkv", "pcb_flash_attn_bwd_dkv",
    # q, k, v, do, lse, delta, dk, dv, B, N, H, D, ldq, ldk, ldv, device, stream
    (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/flash_attn_bwd.cu",
    "pointcloud_bridge_tpu/models/ptv3.py:154",
)
# the same three in bfloat16 (the blocks of a model that computes or streams
# in bfloat16): their own entry points, sources and counters
FLASH_ATTN_BF16 = Kernel(
    "flash_attn_bf16", "pcb_flash_attn_bf16",
    # q, k, v, out, lse (or null), B, N, H, D, ldq, ldk, ldv, device, stream
    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/flash_attn_bf16.cu",
    "pointcloud_bridge_tpu/models/ptv3.py:74",
)
FLASH_ATTN_BWD_DQ_BF16 = Kernel(
    "flash_attn_bwd_dq_bf16", "pcb_flash_attn_bwd_dq_bf16",
    # q, k, v, o, do, lse, dq, delta, B, N, H, D, ldq, ldk, ldv, device, stream
    (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/flash_attn_bwd_bf16.cu",
    "pointcloud_bridge_tpu/models/ptv3.py:156",
)
FLASH_ATTN_BWD_DKV_BF16 = Kernel(
    "flash_attn_bwd_dkv_bf16", "pcb_flash_attn_bwd_dkv_bf16",
    # q, k, v, do, lse, delta, dk, dv, B, N, H, D, ldq, ldk, ldv, device, stream
    (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/flash_attn_bwd_bf16.cu",
    "pointcloud_bridge_tpu/models/ptv3.py:154",
)
# DGCNN's restructured EdgeConv: no Pallas kernel, the XLA fusion of its
# gather and reductions (models/dgcnn.py:127-137 of the JAX package) and its VJP
EDGE_REDUCE = Kernel(
    "edge_reduce", "pcb_edge_reduce",
    # y, idx, mx, mn, s1 (or null), s2 (or null), ties (or null), plan
    # (ops/edge.py EDGE_PLAN), device, stream
    (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/edge_reduce.cu",
    "pointcloud_bridge_tpu/models/dgcnn.py:127",
)
EDGE_REDUCE_BWD = Kernel(
    "edge_reduce_bwd", "pcb_edge_reduce_backward",
    # y, idx, mx, mn, ties, g_mx, g_mn, g_s1 (or null), g_s2 (or null), out,
    # work (ops/edge.py edge_bwd_work), plan (EDGE_BWD_PLAN), device, stream
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    "pointcloud_bridge_tpu_torch/csrc/edge_reduce_bwd.cu",
    "pointcloud_bridge_tpu/models/dgcnn.py:127",
)
KERNELS = (FPS, BALL_QUERY, GROUP, INTERPOLATE, GROUP_BWD, INTERP_BWD, KNN, KNN_C, FLASH_ATTN,
           FLASH_ATTN_BWD_DQ, FLASH_ATTN_BWD_DKV, FLASH_ATTN_BF16, FLASH_ATTN_BWD_DQ_BF16,
           FLASH_ATTN_BWD_DKV_BF16, EDGE_REDUCE, EDGE_REDUCE_BWD)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def custom_op(name: str, cpu, cuda, fake):
    """Register ``OP_NAMESPACE::name``: ``cpu`` (the plain version, whose
    annotations give the schema) on CPU tensors, ``cuda`` (the kernel's
    wrapper, which raises where it cannot launch) on CUDA tensors and
    ``fake`` (the outputs' shapes and types, no data) while tracing."""
    op = torch.library.custom_op(f"{OP_NAMESPACE}::{name}", cpu, mutates_args=(),
                                 device_types="cpu")
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless a library for these sources exists.

    The ptxas report (registers, shared memory, spills of every kernel) is
    kept beside the library as ``<name>.log``. A failed build raises with
    nvcc's output.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(f) for f in sorted(CSRC.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)  # atomic: a concurrent build leaves one whole file
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    for k in KERNELS:
        fn = getattr(lib, k.symbol)
        fn.argtypes = list(k.argtypes)
        fn.restype = ctypes.c_int
        k.fn = fn
    lib.pcb_error_string.argtypes = [ctypes.c_int]
    lib.pcb_error_string.restype = ctypes.c_char_p
    return lib


def _bound(kernel: Kernel):
    """The kernel's entry point, after a first build and load."""
    library()
    return kernel.fn


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype and rank ndim."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """Streaming multiprocessors of a CUDA device, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_args(t: torch.Tensor) -> tuple:
    """(device index, raw handle of the current stream) for a launch on t's
    device, read without building a torch.cuda.Stream."""
    dev = t.get_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev)
