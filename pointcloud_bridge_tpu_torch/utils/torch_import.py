"""Reference torch checkpoint import, first step: state_dict -> flax-layout
variables (a host copy of pointcloud_bridge_tpu/utils/torch_import.py, equal
statement for statement; tests/test_torch_infer.py holds it so).

``convert_state_dict`` turns a reference model's ``state_dict`` (numpy
arrays or torch tensors) into ``{"params": ..., "batch_stats": ...}`` nested
dicts of numpy arrays laid out as the JAX package's flax trees. The port's
import composes it with ``utils/weights.py::flax_to_state_dict``
(``weights.reference_state_dict``), which gives the port's state_dict, and
``tools/import_ckpt.py`` is the command.

Layout rules (the whole conversion is these four):
  - Conv1d/Conv2d(kernel_size=1) weight [O, I, 1(,1)] -> Dense kernel [I, O].
  - Linear weight [O, I] -> Dense kernel [I, O] (transpose).
  - BatchNorm{1,2}d: weight/bias -> params scale/bias; running_mean/var ->
    batch_stats mean/var (the state transfers 1:1).
  - LayerNorm: weight/bias -> scale/bias.

Supported models (reference anchors):
  - pointnet2_ssg  Highway_bridge/models/model.py:12-56
  - pointnet       Highway_bridge/models/pointnet.py:59-173 (+TNet :10-57)
  - dgcnn          Highway_bridge/models/DGCNN.py:6-172 (k=20 trained seg)
  - dgcnn_global   Highway_bridge/models/model.py:372-482
  - randlanet      Highway_bridge/models/RandLANet.py:302-443
  - ptv3           Highway_bridge/models/PointTransformerV3.py:173-304
  - pointnet2_sem_seg   Partsize-identical/models/pointnet2_sem_seg.py:7-47
  - pointnet2_msg  Partsize-identical/models/pointnet2_sem_seg_msg.py:7-42
  - pointnet_sem_seg    Partsize-identical/models/pointnet_sem_seg.py:10-41
  - multiscale_sa  Highway_bridge/models/pointnet2_utils.py:302-360
    (module-level: the Highway MSG set-abstraction block)

bristrunet and enhanced_pointnet2 are not mappable: their structure
encodings fix the reference's scrambled eigenvalue indexing (see the JAX
module's docstring), so identical weights cannot give identical logits.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence, Tuple

import numpy as np

Rule = Tuple[str, Tuple[str, ...], str]  # (torch prefix, flax path, kind)


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _assign(tree: Dict[str, Any], path: Sequence[str], leaf: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = leaf


def _apply_rules(
    rules: Iterable[Rule], sd: Dict[str, Any]
) -> Tuple[Dict, Dict, set]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    used = set()

    def take(key):
        used.add(key)
        return _np(sd[key])

    for tp, fp, kind in rules:
        if kind == "conv":  # kernel-size-1 conv == Dense over channels
            w = take(tp + ".weight")
            _assign(params, fp + ("kernel",), w.reshape(w.shape[0], w.shape[1]).T)
            if tp + ".bias" in sd:
                _assign(params, fp + ("bias",), take(tp + ".bias"))
        elif kind == "linear":
            _assign(params, fp + ("kernel",), take(tp + ".weight").T)
            if tp + ".bias" in sd:
                _assign(params, fp + ("bias",), take(tp + ".bias"))
        elif kind == "bn":
            _assign(params, fp + ("scale",), take(tp + ".weight"))
            _assign(params, fp + ("bias",), take(tp + ".bias"))
            _assign(stats, fp + ("mean",), take(tp + ".running_mean"))
            _assign(stats, fp + ("var",), take(tp + ".running_var"))
            used.add(tp + ".num_batches_tracked")
        elif kind == "conv_featfirst":
            # First conv of a Partsize MSG branch: the reference concats
            # [grouped_points, grouped_xyz] (pointnet_util.py:265-267 —
            # features FIRST, opposite of its own sample_and_group and of
            # our group_points), so the torch kernel's last 3 input rows
            # (rel-xyz) move to the front.
            w = take(tp + ".weight")
            w = w.reshape(w.shape[0], w.shape[1])
            w = np.concatenate([w[:, -3:], w[:, :-3]], axis=1)
            _assign(params, fp + ("kernel",), w.T)
            if tp + ".bias" in sd:
                _assign(params, fp + ("bias",), take(tp + ".bias"))
        elif kind == "ln":
            _assign(params, fp + ("scale",), take(tp + ".weight"))
            _assign(params, fp + ("bias",), take(tp + ".bias"))
        else:  # pragma: no cover
            raise ValueError(f"unknown rule kind {kind}")
    return params, stats, used


# ---------------------------------------------------------------- rule tables


def _rules_pointnet2_ssg() -> List[Rule]:
    r: List[Rule] = []
    for i in (1, 2, 3):
        for j in range(3):
            r.append((f"sa{i}.mlp_convs.{j}", (f"sa{i}", "mlp", f"dense_{j}"), "conv"))
            r.append((f"sa{i}.mlp_bns.{j}", (f"sa{i}", "mlp", f"bn_{j}"), "bn"))
    for fp, nl in (("fp3", 2), ("fp2", 2), ("fp1", 3)):
        for j in range(nl):
            r.append((f"{fp}.mlp_convs.{j}", (fp, "mlp", f"dense_{j}"), "conv"))
            r.append((f"{fp}.mlp_bns.{j}", (fp, "mlp", f"bn_{j}"), "bn"))
    r += [
        ("conv1", ("head", "dense0"), "conv"),
        ("bn1", ("head", "bn0"), "bn"),
        ("conv2", ("head", "dense1"), "conv"),
    ]
    return r


def _rules_tnet(tprefix: str, fprefix: str) -> List[Rule]:
    r: List[Rule] = []
    for nm in ("conv1", "conv2", "conv3"):
        r.append((f"{tprefix}.{nm}", (fprefix, nm), "conv"))
    for nm in ("fc1", "fc2", "fc3"):
        r.append((f"{tprefix}.{nm}", (fprefix, nm), "linear"))
    for nm in ("bn1", "bn2", "bn3", "bn4", "bn5"):
        r.append((f"{tprefix}.{nm}", (fprefix, nm), "bn"))
    return r


def _rules_pointnet() -> List[Rule]:
    r = _rules_tnet("input_transform", "input_transform")
    r += _rules_tnet("feature_transform_net", "feature_transform")
    for i in range(1, 6):
        r.append((f"conv{i}", (f"conv{i}",), "conv"))
        r.append((f"bn{i}", (f"bn{i}",), "bn"))
    for i in range(1, 5):
        r.append((f"seg_conv{i}", (f"seg_conv{i}",), "conv"))
    for i in range(1, 4):
        r.append((f"bn_seg{i}", (f"bn_seg{i}",), "bn"))
    return r


def _rules_dgcnn_global() -> List[Rule]:
    r: List[Rule] = []
    for i in range(1, 5):  # EdgeConv stages: Sequential(conv, bn, leaky)
        r.append((f"conv{i}.0", (f"conv{i}", "conv"), "conv"))
        r.append((f"bn{i}", (f"conv{i}", "bn"), "bn"))
    r += [
        ("conv5.0", ("conv5",), "conv"),
        ("bn5", ("bn5",), "bn"),
        ("linear1", ("linear1",), "linear"),
        ("bn6", ("bn6",), "bn"),
        ("linear2", ("linear2",), "linear"),
        ("bn7", ("bn7",), "bn"),
        ("linear3", ("linear3",), "linear"),
    ]
    return r


def _rules_ptv3(depth: int = 12) -> List[Rule]:
    r: List[Rule] = [
        ("patch_embed.proj", ("patch_embed",), "linear"),
        ("patch_embed.norm", ("patch_norm",), "ln"),
        ("pos_embed.linear", ("pos_embed",), "linear"),
        ("norm", ("norm",), "ln"),
        ("head.0", ("head_fc1",), "linear"),
        ("head.1", ("head_bn",), "bn"),
        ("head.4", ("head_fc2",), "linear"),
    ]
    for i in range(depth):
        b = f"blocks.{i}"
        f = f"block{i}"
        r += [
            (f"{b}.norm1", (f, "norm1"), "ln"),
            (f"{b}.attn.qkv", (f, "attn", "qkv"), "linear"),
            (f"{b}.attn.proj", (f, "attn", "proj"), "linear"),
            (f"{b}.norm2", (f, "norm2"), "ln"),
            (f"{b}.mlp.net.0.proj", (f, "mlp", "geglu", "proj"), "linear"),
            (f"{b}.mlp.net.2", (f, "mlp", "out"), "linear"),
        ]
    return r


def _rules_pointnet2_sem_seg() -> List[Rule]:
    """Partsize pointnet2_sem_seg (Partsize-identical/models/
    pointnet2_sem_seg.py:7-47): 4x SSG SA + 4x FP + head."""
    r: List[Rule] = []
    for i in (1, 2, 3, 4):
        for j in range(3):
            r.append((f"sa{i}.mlp_convs.{j}", (f"sa{i}", "mlp", f"dense_{j}"), "conv"))
            r.append((f"sa{i}.mlp_bns.{j}", (f"sa{i}", "mlp", f"bn_{j}"), "bn"))
    for fp, nl in (("fp4", 2), ("fp3", 2), ("fp2", 2), ("fp1", 3)):
        for j in range(nl):
            r.append((f"{fp}.mlp_convs.{j}", (fp, "mlp", f"dense_{j}"), "conv"))
            r.append((f"{fp}.mlp_bns.{j}", (fp, "mlp", f"bn_{j}"), "bn"))
    r += [
        ("conv1", ("head", "dense0"), "conv"),
        ("bn1", ("head", "bn0"), "bn"),
        ("conv2", ("head", "dense1"), "conv"),
    ]
    return r


def _rules_pointnet2_msg() -> List[Rule]:
    """Partsize pointnet2_sem_seg_msg (the BASELINE north-star model,
    Partsize-identical/models/pointnet2_sem_seg_msg.py:7-42): 4x MSG SA
    (two radius branches each, PointNetSetAbstractionMsg
    pointnet_util.py:222-284) + 4x FP + head. Each branch's first conv uses
    conv_featfirst (the MSG module's [feats, rel-xyz] concat order)."""
    branch_mlps = (
        ((16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 96, 128)),
        ((128, 196, 256), (128, 196, 256)),
        ((256, 256, 512), (256, 384, 512)),
    )
    r: List[Rule] = []
    for i, mlps in zip((1, 2, 3, 4), branch_mlps):
        for b, mlp in enumerate(mlps):
            for j in range(len(mlp)):
                kind = "conv_featfirst" if j == 0 else "conv"
                r.append(
                    (
                        f"sa{i}.conv_blocks.{b}.{j}",
                        (f"sa{i}", f"mlp_{b}", f"dense_{j}"),
                        kind,
                    )
                )
                r.append(
                    (
                        f"sa{i}.bn_blocks.{b}.{j}",
                        (f"sa{i}", f"mlp_{b}", f"bn_{j}"),
                        "bn",
                    )
                )
    for fp, nl in (("fp4", 2), ("fp3", 2), ("fp2", 2), ("fp1", 3)):
        for j in range(nl):
            r.append((f"{fp}.mlp_convs.{j}", (fp, "mlp", f"dense_{j}"), "conv"))
            r.append((f"{fp}.mlp_bns.{j}", (fp, "mlp", f"bn_{j}"), "bn"))
    r += [
        ("conv1", ("head", "dense0"), "conv"),
        ("bn1", ("head", "bn0"), "bn"),
        ("conv2", ("head", "dense1"), "conv"),
    ]
    return r


def _rules_dgcnn() -> List[Rule]:
    """The k=20 trained DGCNN seg variant (Highway_bridge/models/
    DGCNN.py:6-172): 4 EdgeConvs + conv5 + local_bn + 3-conv point head.
    Like dgcnn_global, each EdgeConv BN is registered both standalone
    ("bn{i}") and inside the Sequential ("conv{i}.1") — aliases ignored."""
    r: List[Rule] = []
    for i in range(1, 5):
        r.append((f"conv{i}.0", (f"conv{i}", "conv"), "conv"))
        r.append((f"bn{i}", (f"conv{i}", "bn"), "bn"))
    r += [
        ("conv5.0", ("conv5",), "conv"),
        ("bn5", ("bn5",), "bn"),
        ("local_bn", ("local_bn",), "bn"),
        ("point_conv.0", ("point_conv1",), "conv"),
        ("point_conv.1", ("bn_p1",), "bn"),
        ("point_conv.3", ("point_conv2",), "conv"),
        ("point_conv.4", ("bn_p2",), "bn"),
        ("point_conv.6", ("point_conv3",), "conv"),
    ]
    return r


def _rules_randlanet() -> List[Rule]:
    """RandLANet (Highway_bridge/models/RandLANet.py:302-443): fc_start ->
    4x [RandomSampling + LocalFeatureAggregation(2x LSE + 2x AttnPool +
    DRB)] -> 4x FP-upsample -> seg head. RandomSampling/KNN carry no params;
    each LFA's DRB has in == out channels, so its shortcut Sequential is
    empty (no params) on both sides."""
    r: List[Rule] = [
        ("fc_start", ("fc_start",), "linear"),
        ("bn_start", ("bn_start",), "bn"),
    ]
    for i in range(4):
        la = f"down_modules.{i}.localAgg"
        fl = f"lfa{i}"
        for lse in ("lse1", "lse2"):
            r.append((f"{la}.{lse}.mlp.0", (fl, lse, "mlp"), "conv"))
            r.append((f"{la}.{lse}.mlp.1", (fl, lse, "bn"), "bn"))
        for ap in ("ap1", "ap2"):
            r += [
                (f"{la}.{ap}.score_fn.0", (fl, ap, "score0"), "conv"),
                (f"{la}.{ap}.score_fn.1", (fl, ap, "score_bn"), "bn"),
                (f"{la}.{ap}.score_fn.3", (fl, ap, "score1"), "conv"),
                (f"{la}.{ap}.mlp.0", (fl, ap, "mlp"), "conv"),
                (f"{la}.{ap}.mlp.1", (fl, ap, "mlp_bn"), "bn"),
            ]
        r += [
            (f"{la}.drb.mlp1.0", (fl, "drb", "mlp1"), "conv"),
            (f"{la}.drb.mlp1.1", (fl, "drb", "bn1"), "bn"),
            (f"{la}.drb.mlp2.0", (fl, "drb", "mlp2"), "conv"),
            (f"{la}.drb.mlp2.1", (fl, "drb", "bn2"), "bn"),
        ]
    for i in range(4):
        up = f"up_modules.{i}.mlp"
        r += [
            (f"{up}.0", (f"up{i}_d1",), "conv"),
            (f"{up}.1", (f"up{i}_bn1",), "bn"),
            (f"{up}.3", (f"up{i}_d2",), "conv"),
            (f"{up}.4", (f"up{i}_bn2",), "bn"),
        ]
    r += [
        ("seg_head.0", ("head_d0",), "conv"),
        ("seg_head.1", ("head_bn",), "bn"),
        ("seg_head.4", ("head_d1",), "conv"),
    ]
    return r


def _rules_multiscale_sa(sd: Dict[str, Any]) -> List[Rule]:
    """MODULE-level rules for the Highway MultiScaleSetAbstraction
    (Highway_bridge/models/pointnet2_utils.py:302-360) -> our
    models/common.py::MultiScaleSetAbstraction. The module concats
    [grouped_xyz_norm, grouped_points] — xyz FIRST, same as our
    group_points, so no input-channel permutation (unlike the Partsize MSG
    module's conv_featfirst). Scale/layer counts are inferred from the
    state_dict. The enclosing EnhancedPointNet2 model stays non-mappable
    (see module docstring); this rule set carries the per-module parity."""
    r: List[Rule] = []
    i = 0
    while f"conv_blocks.{i}.0.weight" in sd:
        j = 0
        while f"conv_blocks.{i}.{j}.weight" in sd:
            r.append(
                (f"conv_blocks.{i}.{j}", (f"mlp_{i}", f"dense_{j}"), "conv")
            )
            r.append((f"bn_blocks.{i}.{j}", (f"mlp_{i}", f"bn_{j}"), "bn"))
            j += 1
        i += 1
    return r


def _rules_pointnet_sem_seg() -> List[Rule]:
    """Partsize pointnet_sem_seg (pointnet_sem_seg.py:10-41 + PointNetEncoder
    pointnet.py:99-145): STN3d(9ch) + encoder + STNkd(64) + 4-conv head."""
    r = _rules_tnet("feat.stn", "stn")
    r += _rules_tnet("feat.fstn", "fstn")
    for i in (1, 2, 3):
        r.append((f"feat.conv{i}", (f"conv{i}",), "conv"))
        r.append((f"feat.bn{i}", (f"bn{i}",), "bn"))
    for i in (1, 2, 3, 4):
        r.append((f"conv{i}", (f"head{i}",), "conv"))
    for i in (1, 2, 3):
        r.append((f"bn{i}", (f"bn_h{i}",), "bn"))
    return r


def _ptv3_depth(sd: Dict[str, Any]) -> int:
    d = 0
    while f"blocks.{d}.norm1.weight" in sd:
        d += 1
    return d


# DGCNN registers each BN both standalone ("bn1") and inside the Sequential
# ("conv1.1"): the duplicate Sequential aliases are consumed implicitly.
_DGCNN_ALIASES = tuple(f"conv{i}.1." for i in range(1, 6))

# Dead-code heads the reference constructs but never calls in forward
# (model.py EnhancedPointNet2 cls_head; PARITY.md documents the delta).
_IGNORE: Dict[str, Tuple[str, ...]] = {
    "pointnet2_ssg": (),
    "pointnet": (),
    "dgcnn_global": _DGCNN_ALIASES,
    "dgcnn": _DGCNN_ALIASES,
    "ptv3": (),
}


def convert_state_dict(
    model_name: str, sd: Dict[str, Any], strict: bool = True
) -> Dict[str, Any]:
    """torch state_dict -> {'params': ..., 'batch_stats': ...} for
    `get_model(model_name)`. `strict` raises on any unconsumed torch key
    (catches silent architecture gaps); known dead-code keys are exempt."""
    name = {
        "pointnet2": "pointnet2_ssg",
        "pointnet_seg": "pointnet",
        "dgcnn_cls": "dgcnn_global",
    }.get(model_name, model_name)
    if name == "pointnet2_ssg":
        rules = _rules_pointnet2_ssg()
    elif name == "pointnet":
        rules = _rules_pointnet()
    elif name == "dgcnn_global":
        rules = _rules_dgcnn_global()
    elif name == "dgcnn":
        rules = _rules_dgcnn()
    elif name == "randlanet":
        rules = _rules_randlanet()
    elif name == "multiscale_sa":
        rules = _rules_multiscale_sa(sd)
    elif name == "ptv3":
        rules = _rules_ptv3(_ptv3_depth(sd))
    elif name == "pointnet2_sem_seg":
        rules = _rules_pointnet2_sem_seg()
    elif name == "pointnet2_msg":
        rules = _rules_pointnet2_msg()
    elif name == "pointnet_sem_seg":
        rules = _rules_pointnet_sem_seg()
    else:
        raise ValueError(
            f"no torch-import rules for model '{model_name}' "
            f"(supported: pointnet2_ssg, pointnet, dgcnn, dgcnn_global, "
            f"randlanet, ptv3, pointnet2_sem_seg, pointnet2_msg, "
            f"pointnet_sem_seg, multiscale_sa [module-level])"
        )
    params, stats, used = _apply_rules(rules, sd)
    if strict:
        ignore = _IGNORE.get(name, ())
        leftover = [
            k
            for k in sd
            if k not in used
            and not k.endswith("num_batches_tracked")
            and not any(k.startswith(p) for p in ignore)
        ]
        if leftover:
            raise ValueError(
                f"unconsumed reference keys for '{name}': {sorted(leftover)[:8]}"
                f"{' ...' if len(leftover) > 8 else ''}"
            )
    return {"params": params, "batch_stats": stats}


def _flat_paths(tree, prefix=()) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    out = {}
    items = tree.items() if hasattr(tree, "items") else ()
    for k, v in items:
        if hasattr(v, "items"):
            out.update(_flat_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def validate_variables(converted: Dict[str, Any], reference_vars: Dict[str, Any]):
    """Assert the converted tree has exactly the leaf paths + shapes of a
    freshly-initialized model's variables (params + batch_stats)."""
    for col in ("params", "batch_stats"):
        got = _flat_paths(converted.get(col, {}))
        want = _flat_paths(reference_vars.get(col, {}))
        missing = set(want) - set(got)
        extra = set(got) - set(want)
        if missing or extra:
            raise ValueError(
                f"{col} tree mismatch: missing={sorted(missing)[:5]} "
                f"extra={sorted(extra)[:5]}"
            )
        for p, shp in want.items():
            if got[p] != shp:
                raise ValueError(f"{col} shape mismatch at {p}: {got[p]} vs {shp}")


def load_raw_state_dict(path: str):
    """Load a torch .pth from the reference training pipeline, returning
    (state_dict-as-numpy, scalar metadata). Accepts raw state_dicts and the
    reference's wrapped saves ({'model_state_dict': ..., 'epoch': ...,
    'class_avg_iou': ...} — train_MulSca_PN2.py:290-313); the wrapper's
    int/float/str entries (epoch, best metric) come back as metadata so an
    import can preserve the checkpoint's provenance."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    meta: Dict[str, Any] = {}
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict", "model"):
            if key in obj and isinstance(obj[key], dict):
                meta = {
                    k: v for k, v in obj.items()
                    if isinstance(v, (int, float, str))
                }
                obj = obj[key]
                break
    sd = {k: _np(v) for k, v in obj.items() if hasattr(v, "shape")}
    return sd, meta


def load_torch_checkpoint(
    model_name: str, path: str, strict: bool = True
) -> Dict[str, Any]:
    """Load a torch .pth checkpoint from the reference training pipeline and
    convert it. Accepts raw state_dicts and the reference's wrapped formats
    ({'model_state_dict': ...} — train_MulSca_PN2.py checkpoint saves)."""
    sd, _ = load_raw_state_dict(path)
    return convert_state_dict(model_name, sd, strict=strict)
