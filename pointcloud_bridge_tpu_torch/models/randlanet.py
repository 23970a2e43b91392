"""RandLA-Net and its RandLANet_ss variant in PyTorch (counterpart of
pointcloud_bridge_tpu/models/randlanet.py).

:class:`RandLANet` (``randlanet``): fc_start (-> 8) -> four levels of
[sampling (ratios .35/.25/.25/.25) + LocalFeatureAggregation (2x
LocalSpatialEncoding + 2x AttentivePooling + DilatedResidualBlock, k = 16
neighbours on the k-NN kernel)] of widths 16/64/128/256 -> four decoder
levels, each a 1-D linear upsampling over the point axis
(``linear_upsample``, half-pixel centres as ``jax.image.resize``) joined to
the skip features and two 1x1 convolutions -> a head of 64 with dropout.
:class:`RandLANetSS` (``randlanet_ss``): ratios .25, k = 16/8/5/4 by
level, the statistically re-weighted k-NN (``ops.grouping.knn_stat_weighted``)
and one shared MLP a level (LocalFeatureAggregationSS), decoder 128/64/32/32.

Sampling. Without a generator, and always in eval mode, a level takes the
stride subset arange(s) * (n // s) % n, as the JAX model does wherever no
"sampling" rng is given (its trainer gives none, train/loop.py:169,290).
With ``sampling_generator`` set (a ``torch.Generator`` on the model's
device) and in train mode, a level draws a random subset
(``ops.sampling.random_sample_indices``) or, for ``sampling="density"`` and
always for RandLANetSS, a density-weighted one.

Neighbourhoods. Both LFAs take their neighbours' relative xyz and features
from ``ops.grouping.group_points`` (the group kernel on the card, the
port of the JAX package's 3-channel gather kernel), and RandLANetSS's
re-weighted k-NN gathers its 2k candidates there too.

Gradients. Every gather of a tensor that needs a gradient has the
group-backward kernel (a fixed order of adds) as its backward on the card:
the neighbours' features through ``group_points``, the features kept at
each level and the two sources of each upsampled point through
``ops.core.index_points``.

Parameter names: ``randlanet`` carries the reference torch names of the
JAX package's ``_rules_randlanet`` (utils/torch_import.py:293-336):
``fc_start`` (Linear), ``bn_start``, ``down_modules.{i}.localAgg.lse1.mlp.0``
(Conv2d over [B, C, N, k]) and ``.mlp.1``, ``ap1.score_fn.{0,1,3}`` (Conv2d),
``ap1.mlp.{0,1}``, ``drb.mlp1.{0,1}``, ``drb.mlp2.{0,1}``,
``up_modules.{i}.mlp.{0,1,3,4}`` and ``seg_head.{0,1,4}`` (Conv1d). The
reference file is not in this repository, so the Conv1d/Conv2d split follows
the tensors each layer sees there; the JAX import reads either shape.
``randlanet_ss`` has no torch rules in the JAX package and carries the flax
module names (``lfa0.mlp0``, ``up0_d1``, ``head_bn``; a Dense [out, in]).
``axis_name`` is accepted and raises unless None.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import index_points, knn
from ..ops.grouping import group_points, knn_stat_weighted
from ..ops.sampling import density_weighted_sample_indices, random_sample_indices
from .common import BatchNorm, Dense, Dropout, PointConv
from .ptv3 import only_defaults


def spatial_encoding(xyz: torch.Tensor, features: Optional[torch.Tensor],
                     idx: torch.Tensor) -> torch.Tensor:
    """The input of a LocalSpatialEncoding (models/randlanet.py:37-44):
    [relative xyz (3) | distance (1) | neighbour features (C)] a neighbour,
    [B, N, k, 4 + C], the neighbourhoods grouped by ``group_points`` (the
    group kernel on the card). Both encodings of a level take the same
    input, so the level builds it once."""
    grouped = group_points(xyz, xyz, idx, features)  # [B, N, k, 3 + C]
    rel = grouped[..., :3]
    return torch.cat([rel, torch.linalg.norm(rel, dim=-1, keepdim=True), grouped[..., 3:]],
                     dim=-1)


class LocalSpatialEncoding(nn.Module):
    """Conv2d (no bias) ``mlp.0`` + BatchNorm ``mlp.1`` + ReLU over the
    spatial encoding (models/randlanet.py:29-50): [B, N, k, 4 + C] ->
    [B, N, k, out]."""

    def __init__(self, in_ch: int, out_ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = nn.Sequential(PointConv(in_ch, out_ch, 2, generator, bias=False),
                                 BatchNorm(out_ch), nn.ReLU())

    def forward(self, enc: torch.Tensor) -> torch.Tensor:
        return self.mlp(enc)


class AttentivePooling(nn.Module):
    """Softmax attention over the neighbours, the weighted sum, then a
    Conv1d + BatchNorm + ReLU (models/randlanet.py:53-76): [B, N, k, C] ->
    [B, N, out]. ``score_fn`` is Conv2d C -> C (no bias), BatchNorm, ReLU,
    Conv2d C -> 1."""

    def __init__(self, channels: int, out_ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.score_fn = nn.Sequential(
            PointConv(channels, channels, 2, g, bias=False), BatchNorm(channels), nn.ReLU(),
            PointConv(channels, 1, 2, g))
        self.mlp = nn.Sequential(PointConv(channels, out_ch, 1, g, bias=False),
                                 BatchNorm(out_ch), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scores = torch.softmax(self.score_fn(x), dim=2)
        return self.mlp((x * scores).sum(dim=2))


class DilatedResidualBlock(nn.Module):
    """Two 1x1 convolutions and the identity shortcut
    (models/randlanet.py:79-100): relu(bn2(mlp2(relu(bn1(mlp1(x))))) + x).
    The JAX block adds a conv + BatchNorm shortcut where its input is
    narrower than its output; a level's never is (its two pooled halves
    make out_channels)."""

    def __init__(self, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.mlp1 = nn.Sequential(PointConv(channels, channels, 1, g, bias=False),
                                  BatchNorm(channels), nn.ReLU())
        self.mlp2 = nn.Sequential(PointConv(channels, channels, 1, g, bias=False),
                                  BatchNorm(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.mlp2(self.mlp1(x)) + x)


class LocalFeatureAggregation(nn.Module):
    """2x (LocalSpatialEncoding + AttentivePooling) + DilatedResidualBlock
    over the k = min(k, N) nearest points (K5 on the card), as
    models/randlanet.py:103-125: xyz [B, N, 3], features [B, N, C] ->
    [B, N, out_channels]."""

    def __init__(self, in_ch: int, out_channels: int, k: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if out_channels % 2:
            raise ValueError(f"LocalFeatureAggregation: out_channels {out_channels} is odd")
        g, half = generator, out_channels // 2
        self.k = k
        self.lse1 = LocalSpatialEncoding(4 + in_ch, half, g)
        self.ap1 = AttentivePooling(half, half, g)
        self.lse2 = LocalSpatialEncoding(4 + in_ch, half, g)
        self.ap2 = AttentivePooling(half, half, g)
        self.drb = DilatedResidualBlock(out_channels, g)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]) -> torch.Tensor:
        idx = knn(xyz, k=min(self.k, xyz.shape[1]))
        enc = spatial_encoding(xyz, features, idx)
        agg = torch.cat([self.ap1(self.lse1(enc)), self.ap2(self.lse2(enc))], dim=-1)
        return self.drb(agg)


class LocalFeatureAggregationSS(nn.Module):
    """RandLANet_ss's one shared MLP a level (models/randlanet.py:212-250):
    the statistically re-weighted k-NN, [centre features | feature
    differences | centred xyz] (2C + 3), three Dense (no bias) + BatchNorm +
    ReLU of widths out/2, out/2, out (``mlp0``-``mlp2``, ``bn0``-``bn2``),
    the max over the k neighbours."""

    def __init__(self, in_ch: int, out_channels: int, k: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, half = generator, out_channels // 2
        self.k = k
        widths = (half, half, out_channels)
        c = 2 * in_ch + 3
        for i, w in enumerate(widths):
            setattr(self, f"mlp{i}", Dense(c, w, bias=False, generator=g))
            setattr(self, f"bn{i}", BatchNorm(w))
            c = w

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]) -> torch.Tensor:
        idx = knn_stat_weighted(xyz, k=min(self.k, xyz.shape[1]))
        grouped = group_points(xyz, xyz, idx, features)  # [B, N, k, 3 + C]
        h = grouped[..., :3]
        if features is not None:
            nf = grouped[..., 3:]
            center = features.unsqueeze(2).expand_as(nf)
            h = torch.cat([center, nf - center, h], dim=-1)
        for i in range(3):
            h = F.relu(getattr(self, f"bn{i}")(getattr(self, f"mlp{i}")(h)))
        return torch.amax(h, dim=2)


def _upsample_plan(n_in: int, n_out: int, dtype: torch.dtype, device) -> tuple:
    """The two sources and weights of each output of ``jax.image.resize``'s
    linear method from n_in to n_out >= n_in points, computed as
    jax/_src/image/scale.py computes its weight matrix: sample at (i + 0.5)
    * (n_in / n_out) - 0.5 (rounded once, as the compiled function does),
    a triangle kernel, the weights over the points in range renormalised to
    sum 1 -> (sources [n_out, 2] int64, weights [n_out, 2] of ``dtype``),
    made on ``device`` (no copy from the host, which a CUDA graph cannot
    capture)."""
    inv_scale = float(np.dtype(str(dtype).removeprefix("torch.")).type(1.0 / (n_out / n_in)))
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one FMA, a single rounding:
    # exact in float64 for float32 operands, then rounded once
    pos = torch.arange(n_out, dtype=torch.float64, device=device)
    sample = ((pos + 0.5) * inv_scale - 0.5).to(dtype)
    lo = torch.floor(sample).long()
    src = torch.stack([lo, lo + 1], dim=1)
    w = (1 - (sample[:, None] - src.to(dtype)).abs()).clamp_min(0)
    w = torch.where((src >= 0) & (src < n_in), w, 0)
    return src.clamp(0, n_in - 1), w / (w[:, :1] + w[:, 1:])


def linear_upsample(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """1-D linear interpolation over the point axis of x [B, N, C] to n_out
    >= N points (models/randlanet.py:128-134, ``jax.image.resize(method=
    "linear")``: half-pixel centres, the edge weights renormalised): each
    output point w0 * x[j0] + w1 * x[j1], its two sources gathered by
    ``index_points`` (the group-backward kernel as the gradient on the
    card, a fixed order of adds; ``F.interpolate``'s CUDA backward adds with
    atomics)."""
    b, n, _ = x.shape
    if n == n_out:
        return x
    if n_out < n:
        raise ValueError(f"linear_upsample: {n} -> {n_out} points is not an upsampling")
    src, w = _upsample_plan(n, n_out, torch.float64 if x.dtype == torch.float64 else
                            torch.float32, x.device)
    idx = src.expand(b, -1, -1)
    w = w.to(x.dtype)
    pair = index_points(x, idx)  # [B, n_out, 2, C]
    return pair[:, :, 0] * w[:, :1] + pair[:, :, 1] * w[:, 1:]


class _Down(nn.Module):
    """One encoder level, named as the reference's ``down_modules.{i}``."""

    def __init__(self, agg: LocalFeatureAggregation):
        super().__init__()
        self.localAgg = agg


class _Up(nn.Module):
    """One decoder level's ``mlp``: two bias-free Conv1d + BatchNorm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, generator: Optional[torch.Generator]):
        super().__init__()
        g = generator
        self.mlp = nn.Sequential(
            PointConv(in_ch, out_ch, 1, g, bias=False), BatchNorm(out_ch), nn.ReLU(),
            PointConv(out_ch, out_ch, 1, g, bias=False), BatchNorm(out_ch), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class _RandLABase(nn.Module):
    """The sampling and the encoder/decoder loop both models share; a
    subclass names its layers."""

    sampling = "random"
    sampling_ratios: Sequence[float] = ()

    def sample(self, xyz: torch.Tensor, s: int) -> torch.Tensor:
        """[B, s] indices of a level's kept points: the stride subset, or a
        random draw in train mode with ``sampling_generator`` set."""
        b, n, _ = xyz.shape
        gen = self.sampling_generator
        if self.training and gen is not None:
            if self.sampling == "density":
                return density_weighted_sample_indices(xyz, s, gen)
            return random_sample_indices(n, s, b, gen)
        stride = max(1, n // s)
        return (torch.arange(s, device=xyz.device) * stride % n).expand(b, -1)

    def encode_decode(self, xyz: torch.Tensor, x: torch.Tensor, aggregate,
                      upsample) -> torch.Tensor:
        """The levels: sample, gather the kept points and features,
        ``aggregate(i, xyz, features)``; then per decoder level the upsampled
        features joined to the skip features through ``upsample(i, h)``."""
        enc_xyz, enc_feats = [xyz], [x]
        for i, ratio in enumerate(self.sampling_ratios):
            n = enc_xyz[-1].shape[1]
            idx = self.sample(enc_xyz[-1], max(1, int(n * ratio)))
            xyz_d = index_points(enc_xyz[-1], idx)
            enc_feats.append(aggregate(i, xyz_d, index_points(enc_feats[-1], idx)))
            enc_xyz.append(xyz_d)
        dec = enc_feats[-1]
        for i in range(len(self.sampling_ratios)):
            skip = enc_feats[-(i + 2)]
            dec = upsample(i, torch.cat([linear_upsample(dec, skip.shape[1]), skip], dim=-1))
        return dec

    @staticmethod
    def inputs(xyz: torch.Tensor, features: Optional[torch.Tensor], d_in: int) -> torch.Tensor:
        inp = xyz if features is None else torch.cat([xyz, features], dim=-1)
        return inp[..., :d_in]


class RandLANet(_RandLABase):
    """RandLA-Net (models/randlanet.py:137-209): forward(xyz [B, N, 3],
    features [B, N, C] or None) -> logits [B, N, num_classes]. The input is
    the first ``d_in`` channels of [xyz | features] (xyz alone at the
    default 3)."""

    def __init__(self, num_classes: int = 5, d_in: int = 3, k: int = 16,
                 encoder_dims: Sequence[int] = (16, 64, 128, 256),
                 decoder_dims: Sequence[int] = (256, 128, 64, 32),
                 sampling_ratios: Sequence[float] = (0.35, 0.25, 0.25, 0.25),
                 sampling: str = "random", axis_name: Optional[str] = None,
                 dropout_rate: float = 0.5, generator: Optional[torch.Generator] = None):
        only_defaults("RandLANet", axis_name=(axis_name, None))
        if sampling not in ("random", "density"):
            raise ValueError(f"RandLANet: sampling {sampling!r} is not 'random' or 'density'")
        if not len(encoder_dims) == len(decoder_dims) == len(sampling_ratios):
            raise ValueError("RandLANet: encoder_dims, decoder_dims and sampling_ratios differ "
                             "in length")
        super().__init__()
        g = generator
        self.d_in, self.sampling, self.sampling_ratios = d_in, sampling, tuple(sampling_ratios)
        self.sampling_generator: Optional[torch.Generator] = None
        self.fc_start = Dense(d_in, 8, generator=g)
        self.bn_start = BatchNorm(8)
        widths = [8] + list(encoder_dims)
        self.down_modules = nn.ModuleList(
            _Down(LocalFeatureAggregation(c, d, k, g)) for c, d in zip(widths, encoder_dims))
        dec = encoder_dims[-1]
        self.up_modules = nn.ModuleList()
        for i, d in enumerate(decoder_dims):
            self.up_modules.append(_Up(dec + widths[-(i + 2)], d, g))
            dec = d
        self.seg_head = nn.Sequential(
            PointConv(dec, 64, 1, g, bias=False), BatchNorm(64), nn.ReLU(),
            Dropout(dropout_rate), PointConv(64, num_classes, 1, g))

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.relu(self.bn_start(self.fc_start(self.inputs(xyz, features, self.d_in))))
        dec = self.encode_decode(
            xyz, x, lambda i, p, f: self.down_modules[i].localAgg(p, f),
            lambda i, h: self.up_modules[i](h))
        return self.seg_head(dec)


class RandLANetSS(_RandLABase):
    """The RandLANet_ss variant (models/randlanet.py:253-325): ratios .25,
    k_i = max(min(16, 16 // (i + 1)), 4), LocalFeatureAggregationSS,
    decoder 128/64/32/32; with a sampling generator always density-weighted
    sampling. Layers under the flax names: ``fc_start``, ``bn_start``,
    ``lfa{i}``, ``up{i}_d1``, ``up{i}_bn1``, ``up{i}_d2``, ``up{i}_bn2``,
    ``head_d0``, ``head_bn``, ``head_d1``."""

    sampling = "density"

    def __init__(self, num_classes: int = 5, d_in: int = 3,
                 encoder_dims: Sequence[int] = (16, 64, 128, 256),
                 decoder_dims: Sequence[int] = (128, 64, 32, 32),
                 sampling_ratios: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
                 axis_name: Optional[str] = None, dropout_rate: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        only_defaults("RandLANetSS", axis_name=(axis_name, None))
        if not len(encoder_dims) == len(decoder_dims) == len(sampling_ratios):
            raise ValueError("RandLANetSS: encoder_dims, decoder_dims and sampling_ratios "
                             "differ in length")
        super().__init__()
        g = generator
        self.d_in, self.sampling_ratios = d_in, tuple(sampling_ratios)
        self.sampling_generator: Optional[torch.Generator] = None
        self.fc_start = Dense(d_in, 8, generator=g)
        self.bn_start = BatchNorm(8)
        widths = [8] + list(encoder_dims)
        for i, (c, d) in enumerate(zip(widths, encoder_dims)):
            k_i = max(min(16, 16 // (i + 1)), 4)  # RandLANet_ss.py:227
            setattr(self, f"lfa{i}", LocalFeatureAggregationSS(c, d, k_i, g))
        dec = encoder_dims[-1]
        for i, d in enumerate(decoder_dims):
            setattr(self, f"up{i}_d1", Dense(dec + widths[-(i + 2)], d, bias=False, generator=g))
            setattr(self, f"up{i}_bn1", BatchNorm(d))
            setattr(self, f"up{i}_d2", Dense(d, d, bias=False, generator=g))
            setattr(self, f"up{i}_bn2", BatchNorm(d))
            dec = d
        self.head_d0 = Dense(dec, 64, bias=False, generator=g)
        self.head_bn = BatchNorm(64)
        self.dropout = Dropout(dropout_rate)
        self.head_d1 = Dense(64, num_classes, generator=g)

    def _up(self, i: int, h: torch.Tensor) -> torch.Tensor:
        h = F.relu(getattr(self, f"up{i}_bn1")(getattr(self, f"up{i}_d1")(h)))
        return F.relu(getattr(self, f"up{i}_bn2")(getattr(self, f"up{i}_d2")(h)))

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.relu(self.bn_start(self.fc_start(self.inputs(xyz, features, self.d_in))))
        dec = self.encode_decode(xyz, x, lambda i, p, f: getattr(self, f"lfa{i}")(p, f),
                                 self._up)
        h = self.dropout(F.relu(self.head_bn(self.head_d0(dec))))
        return self.head_d1(h)
