"""Local geometric structure ops (counterpart of
pointcloud_bridge_tpu/ops/structure.py): closed-form eigenvalues of
symmetric 3x3 matrices and the 13-dim PCA shape descriptor of a k-NN
neighbourhood.

As in the JAX package, eigenvalues come in DESCENDING order and the shape
features follow Weinmann et al. (linearity = (l1 - l2) / l1 with l1 the
largest), a deliberate difference from the reference torch code, which
indexes ascending eigenvalues with the descending formula. The arithmetic
keeps the JAX package's coordinate-plane form, so that the two agree to
float32 rounding. ``min_eigvec3x3`` takes the eigenvector of the smallest
eigenvalue by the cross-product method, and ``estimate_normals`` the
normals of k-NN neighbourhoods (K5 on the card).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .core import index_points
from .grouping import knn, knn_set


def eigvals3_from_entries(a00, a01, a02, a11, a12, a22):
    """Cardano eigenvalues (descending) from the 6 unique entries of a
    symmetric 3x3, elementwise over any batch shape -> (e1, e2, e3), largest
    first (ops/structure.py:33-71). A matrix that is a multiple of the
    identity (p <= 1e-12) gives its diagonal value three times."""
    q = (a00 + a11 + a22) / 3.0
    p1 = a01**2 + a02**2 + a12**2
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00**2 + b11**2 + b22**2 + 2.0 * p1
    p = torch.sqrt(p2.clamp_min(0.0) / 6.0)
    safe_p = torch.where(p > 1e-12, p, torch.ones_like(p))

    # det((A - qI) / p) / 2
    c00, c11, c22 = b00 / safe_p, b11 / safe_p, b22 / safe_p
    c01, c02, c12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detb = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = (detb / 2.0).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3

    degenerate = p <= 1e-12
    e1 = torch.where(degenerate, q, e1)
    e2 = torch.where(degenerate, q, e2)
    e3 = torch.where(degenerate, q, e3)
    return e1, e2, e3


def eigh3x3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric 3x3 matrices [..., 3, 3] -> [..., 3] float32,
    largest first (ops/structure.py:74-88)."""
    a = a.float()
    e1, e2, e3 = eigvals3_from_entries(
        a[..., 0, 0], a[..., 0, 1], a[..., 0, 2],
        a[..., 1, 1], a[..., 1, 2], a[..., 2, 2],
    )
    return torch.stack([e1, e2, e3], dim=-1)


def min_eigvec3x3(a: torch.Tensor, eigvals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric 3x3 matrices
    [..., 3, 3] -> [..., 3] (ops/structure.py:88-114): the rows of A - l_min
    I are orthogonal to it, so it is the longest of their three pairwise
    cross products, normalised (the first of equal lengths); +z where all
    three vanish (a degenerate neighbourhood). The sign is not normalised."""
    if eigvals is None:
        eigvals = eigh3x3(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = a - eigvals[..., 2, None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)  # [..., 3, 3]
    best = torch.sqrt((cands * cands).sum(-1)).argmax(dim=-1)
    vec = cands.gather(-2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    nrm = torch.sqrt((vec * vec).sum(-1, keepdim=True))
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device).expand_as(vec)
    return torch.where(nrm > 1e-10, vec / nrm.clamp_min(1e-10), fallback)


def estimate_normals(xyz: torch.Tensor, k: int = 20) -> torch.Tensor:
    """Per-point normals, the min-eigenvector of the k-NN covariance
    (ops/structure.py:199-212): xyz [B, N, 3] -> [B, N, 3] unit vectors,
    their sign not normalised, as the reference's."""
    idx = knn(xyz, k=k)
    rel = index_points(xyz, idx) - xyz.unsqueeze(2)
    return min_eigvec3x3(torch.einsum("bnki,bnkj->bnij", rel, rel))


def local_covariance(rel_pos: torch.Tensor, unbiased: bool = True) -> torch.Tensor:
    """Covariance of k-NN relative positions [B, N, k, 3] -> [B, N, 3, 3]
    (ops/structure.py:117-123; the positions are taken as centred)."""
    k = rel_pos.shape[-2]
    denom = (k - 1) if unbiased else k
    return torch.einsum("bnki,bnkj->bnij", rel_pos, rel_pos) / denom


def local_structure_features(rel_pos: torch.Tensor) -> torch.Tensor:
    """13-dim per-point structure descriptor from k-NN relative positions
    (ops/structure.py:126-196): [linearity, planarity, sphericity,
    local_radius, mean_dist, std_dist, direction_consistency, z_std,
    z_range, mean_rel_pos(3), |std(rel_pos)|].

    rel_pos [B, N, k, 3] -> [B, N, 13] float32. Standard deviations are the
    unbiased ones (``ddof=1`` in the JAX package).
    """
    k = rel_pos.shape[-2]
    rel_pos = rel_pos.float()
    rx, ry, rz = rel_pos[..., 0], rel_pos[..., 1], rel_pos[..., 2]
    inv_km1 = 1.0 / (k - 1)

    cxx = (rx * rx).sum(-1) * inv_km1
    cyy = (ry * ry).sum(-1) * inv_km1
    czz = (rz * rz).sum(-1) * inv_km1
    cxy = (rx * ry).sum(-1) * inv_km1
    cxz = (rx * rz).sum(-1) * inv_km1
    cyz = (ry * rz).sum(-1) * inv_km1
    e1, e2, e3 = eigvals3_from_entries(cxx, cxy, cxz, cyy, cyz, czz)
    l1 = e1 + 1e-8
    linearity = (e1 - e2) / l1
    planarity = (e2 - e3) / l1
    sphericity = e3 / l1

    mx, my, mz = rx.mean(-1), ry.mean(-1), rz.mean(-1)
    dx = rx - mx.unsqueeze(-1)
    dy = ry - my.unsqueeze(-1)
    dz = rz - mz.unsqueeze(-1)
    dists = torch.sqrt(dx * dx + dy * dy + dz * dz)  # [B, N, k]
    local_radius = dists.amax(-1)
    mean_dist = dists.mean(-1)
    std_dist = dists.std(-1, unbiased=True)

    # mean pairwise cosine of the neighbour directions:
    # mean_ij (u_i . u_j) == |sum_i u_i|^2 / k^2
    inv_norm = 1.0 / (torch.sqrt(rx * rx + ry * ry + rz * rz) + 1e-8)
    sx = (rx * inv_norm).sum(-1)
    sy = (ry * inv_norm).sum(-1)
    sz = (rz * inv_norm).sum(-1)
    direction_consistency = (sx * sx + sy * sy + sz * sz) / (k * k)

    z_std = rz.std(-1, unbiased=True)
    z_range = rz.amax(-1) - rz.amin(-1)

    vx = rx.std(-1, unbiased=True)
    vy = ry.std(-1, unbiased=True)
    std_norm = torch.sqrt(vx * vx + vy * vy + z_std * z_std)

    return torch.stack(
        [
            linearity, planarity, sphericity,
            local_radius, mean_dist, std_dist,
            direction_consistency,
            z_std, z_range,
            mx, my, mz,
            std_norm,
        ],
        dim=-1,
    )


def knn_relative_positions(
    xyz: torch.Tensor,
    k: int,
    ordered: bool = True,
    query: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN, then centre-relative positions -> (rel_pos [B, S, k, 3], idx
    [B, S, k] int32) (ops/structure.py:215-240). ``ordered=False`` is for
    consumers that treat the neighbours as a set (``knn_set``). ``query``
    [B, S, 3] defaults to xyz. The gather is plain autograd, so rel_pos is
    differentiable in xyz and query."""
    q = xyz if query is None else query
    idx = (knn if ordered else knn_set)(xyz, q, k)
    return index_points(xyz, idx) - q.unsqueeze(2), idx
