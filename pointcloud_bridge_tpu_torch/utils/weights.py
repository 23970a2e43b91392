"""JAX package variables -> the port's state_dict (``flax_to_state_dict``),
and back (``state_dict_to_flax``, which maps gradients and trained weights
onto the JAX trees leaf by leaf), for every model the port has.

The variables are ``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays (``jax.device_get`` of the flax variables). A rule table a
model says which flax module becomes which prefix of the state_dict:

  - PointNet2SSG (``pointnet2_ssg_rules``) carries the reference torch
    model's names. The table is the inverse of the JAX package's
    ``_rules_pointnet2_ssg`` (utils/torch_import.py:125-140), written out
    here so that the port needs neither JAX nor that module. Dense kernel
    [I, O] -> conv weight [O, I, 1, 1] (SA, the reference's Conv2d) or
    [O, I, 1] (FP and head, Conv1d); bias as is.
  - BriStruNet (``bristrunet_rules``) has no mappable reference torch model,
    so the port names its layers after the flax modules and a prefix is the
    flax path joined with dots. Dense kernel [I, O] -> weight [O, I]; a
    Dense without a bias has none on either side.
  - The PTv3 family (``ptv3_rules``, ``ptv3_pooled_rules``,
    ``ptv3_moe_rules``) is named after the flax modules too; one block table
    (``_ptv3_block``) serves all three models. The tables depend on the
    depths: the registry names stand for the registry's default models,
    another depth passes its own table. A MoE block's ``moe_mlp`` keeps its
    stacked ``experts_*`` leaves as stored (kind "experts") and its
    ``router`` is a Dense without a bias. ``remat`` and the dtype options
    change no name: the flax tree is the same under ``nn.remat``, and the
    parameters stay float32.
  - DGCNN and DGCNNGlobal (``dgcnn_rules``, ``dgcnn_global_rules``) carry
    the reference torch names of the JAX package's ``_rules_dgcnn``
    (utils/torch_import.py:271-290) and ``_rules_dgcnn_global`` (:167-181):
    an EdgeConv's Dense kernel [2C, F] -> Conv2d weight [F, 2C, 1, 1],
    conv5 and the point head -> Conv1d [O, I, 1], linear1-3 -> Linear
    [O, I] (kind "linear").
  - The PointNet++ MSG family carries the reference torch names too:
    ``pointnet2_msg_rules`` is the inverse of the JAX package's
    ``_rules_pointnet2_msg`` (utils/torch_import.py:228-268),
    ``pointnet2_sem_seg_rules`` of ``_rules_pointnet2_sem_seg`` (:208-225).
    The JAX package has no torch rules for the two classifiers
    (``pointnet2_cls_ssg_rules``, ``pointnet2_cls_msg_rules``): they take
    the names of the reference's modules, which the port's layers carry,
    and ``fc1``-``fc3`` as Linear. The first conv of an MSG branch is kind
    "conv2d_featfirst": the reference's input order is [features, rel-xyz]
    and the flax kernel's [rel-xyz, features], so the kernel's first 3
    input rows go to the end of the torch weight's columns (and back).
  - The PointNet family: ``pointnet`` (``pointnet_seg``) and
    ``pointnet_sem_seg`` carry the reference torch names of the JAX
    package's ``_rules_pointnet`` (utils/torch_import.py:154-164) and
    ``_rules_pointnet_sem_seg`` (:362-374), with ``_rules_tnet``'s T-Net
    (:143-151): per-point convs Conv1d [O, I, 1], a T-Net's fc1-fc3 Linear.
    ``pointnet_global`` and ``pointnet_cls`` have no torch rules in the JAX
    package and take the flax names (a Dense [O, I]).
  - ``enhanced_pointnet2_ssg`` (``enhanced_pointnet2_ssg_rules``) has no
    torch rules in the JAX package: its SSG levels, decoder and head carry
    PointNet2SSG's names (the same rules), its positional encoding and
    attention blocks the flax paths (a Dense [O, I]).
  - BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
    running_mean/running_var, num_batches_tracked 0.
  - ``randlanet`` (``randlanet_rules``) carries the reference torch names
    of the JAX package's ``_rules_randlanet`` (utils/torch_import.py:293-336):
    the convolutions over neighbourhoods Conv2d, the others Conv1d,
    ``fc_start`` Linear. ``randlanet_ss``, ``spg`` (``superpoint_graph``)
    and ``spt`` (``superpoint_transformer``) have no torch rules in the JAX
    package and take the flax names.
  - LayerNorm (kind "ln") scale/bias -> weight/bias; it has no statistics.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

# (torch prefix, flax path, kind); kind is "conv2d", "conv2d_featfirst" (a
# Conv2d whose input columns are [features, rel-xyz]), "conv1d", "dense",
# "linear" (the reference's nn.Linear: a Dense under a reference name), "bn",
# "ln" or "experts" (a MoE feed-forward's stacked expert leaves, as stored)
Rule = Tuple[str, Tuple[str, ...], str]
EXPERT_LEAVES = ("experts_proj_kernel", "experts_proj_bias", "experts_out_kernel",
                 "experts_out_bias")


def _shared_mlp(tprefix: str, fprefix: Tuple[str, ...], depth: int, conv: str) -> List[Rule]:
    """A shared MLP's ``mlp_convs.{j}``/``mlp_bns.{j}`` <-> flax
    ``dense_{j}``/``bn_{j}`` under ``fprefix``."""
    r: List[Rule] = []
    for j in range(depth):
        r.append((f"{tprefix}.mlp_convs.{j}", fprefix + (f"dense_{j}",), conv))
        r.append((f"{tprefix}.mlp_bns.{j}", fprefix + (f"bn_{j}",), "bn"))
    return r


def _msg_level(i: int, branches: int) -> List[Rule]:
    """MSG level ``sa{i}`` of three-layer branches: branch b's
    ``conv_blocks.{b}.{j}`` and ``bn_blocks.{b}.{j}`` <-> flax ``mlp_{b}``'s
    ``dense_{j}``/``bn_{j}``; the first conv of a branch is
    "conv2d_featfirst"."""
    r: List[Rule] = []
    for b in range(branches):
        for j in range(3):
            path = (f"sa{i}", f"mlp_{b}")
            r.append((f"sa{i}.conv_blocks.{b}.{j}", path + (f"dense_{j}",),
                      "conv2d_featfirst" if j == 0 else "conv2d"))
            r.append((f"sa{i}.bn_blocks.{b}.{j}", path + (f"bn_{j}",), "bn"))
    return r


def _ssg_levels(count: int) -> List[Rule]:
    """Set-abstraction levels sa1 to sa{count}, a three-layer shared MLP of
    Conv2d each."""
    return [x for i in range(1, count + 1)
            for x in _shared_mlp(f"sa{i}", (f"sa{i}", "mlp"), 3, "conv2d")]


def _decoder(*depths: int) -> List[Rule]:
    """Feature-propagation levels from the coarsest down to fp1, ``depths``
    Conv1d each in that order."""
    return [x for k, depth in zip(range(len(depths), 0, -1), depths)
            for x in _shared_mlp(f"fp{k}", (f"fp{k}", "mlp"), depth, "conv1d")]


_SEG_HEAD: List[Rule] = [
    ("conv1", ("head", "dense0"), "conv1d"),
    ("bn1", ("head", "bn0"), "bn"),
    ("conv2", ("head", "dense1"), "conv1d"),
]
# the classifiers' group-all level and FC head
_CLS_HEAD: List[Rule] = _shared_mlp("sa3", ("sa3", "mlp"), 3, "conv2d") + [
    ("fc1", ("fc1",), "linear"), ("bn1", ("bn1",), "bn"),
    ("fc2", ("fc2",), "linear"), ("bn2", ("bn2",), "bn"),
    ("fc3", ("fc3",), "linear"),
]


def pointnet2_ssg_rules() -> List[Rule]:
    return _ssg_levels(3) + _decoder(2, 2, 3) + _SEG_HEAD


def pointnet2_msg_rules() -> List[Rule]:
    return [x for i in (1, 2, 3, 4) for x in _msg_level(i, 2)] + _decoder(2, 2, 2, 3) + _SEG_HEAD


def pointnet2_sem_seg_rules() -> List[Rule]:
    return _ssg_levels(4) + _decoder(2, 2, 2, 3) + _SEG_HEAD


def pointnet2_cls_ssg_rules() -> List[Rule]:
    return _ssg_levels(2) + _CLS_HEAD


def pointnet2_cls_msg_rules() -> List[Rule]:
    return [x for i in (1, 2) for x in _msg_level(i, 3)] + _CLS_HEAD


_Layers = List[Tuple[Tuple[str, ...], str]]  # (flax path, kind)


def _by_flax_path(layers: _Layers) -> List[Rule]:
    """Rules of layers that the port names after their flax path."""
    return [(".".join(path), path, kind) for path, kind in layers]


def _bse(prefix: Tuple[str, ...]) -> _Layers:
    """A BridgeStructureEncoding's layers under ``prefix``."""
    return [(prefix + (n,), kind) for n, kind in (("mlp0_shared", "dense"), ("mlp0_rel", "dense"),
                                                  ("bn0", "bn"), ("mlp1", "dense"))]


def bristrunet_rules() -> List[Rule]:
    layers: _Layers = _bse(("bri_enc",))
    layers += [(("color_encoder", n), "bn" if "bn" in n else "dense")
               for n in ("mlp0", "bn0", "mlp1", "bn1", "attn0", "attn_bn", "attn1", "ctx0", "ctx1")]
    layers += [(("feature_fusion", "fusion"), "dense"), (("feature_fusion", "bn"), "bn")]
    for sa in ("sa1", "sa2", "sa3"):
        for scale in (0, 1):
            for j in range(3):
                layers.append(((sa, f"mlp_{scale}", f"dense_{j}"), "dense"))
                layers.append(((sa, f"mlp_{scale}", f"bn_{j}"), "bn"))
    for geo in ("geometric2", "geometric3"):
        layers += _bse((geo, "br_pos"))
        layers += [((geo, "mlp0"), "dense"), ((geo, "bn0"), "bn"), ((geo, "mlp1"), "dense")]
    for fp in ("fp3", "fp2", "fp1"):
        layers += [((fp, "attn_dense0"), "dense"), ((fp, "attn_bn"), "bn"),
                   ((fp, "attn_dense1"), "dense")]
        for j in range(2):
            layers += [((fp, "mlp", f"dense_{j}"), "dense"), ((fp, "mlp", f"bn_{j}"), "bn")]
        layers += [((fp, "boundary_mlp0", "dense_0"), "dense"),
                   ((fp, "boundary_mlp0", "bn_0"), "bn"),
                   ((fp, "boundary_dense1"), "dense")]
    for i in range(3):
        layers += [(("fusion", f"conv{i}"), "dense"), (("fusion", f"bn{i}"), "bn")]
    layers += [(("final0",), "dense"), (("final_bn",), "bn"), (("final1",), "dense")]
    return _by_flax_path(layers)


def _dense_bn(prefix: Tuple[str, ...], names: Sequence[str]) -> _Layers:
    """Layers named ``names`` under ``prefix``: a BatchNorm where the name
    has "bn" in it, else a Dense."""
    return [(prefix + (n,), "bn" if "bn" in n else "dense") for n in names]


def enhanced_pointnet2_ssg_rules(use_attention: bool = False) -> List[Rule]:
    layers = _dense_bn(("pos_encoding",), ("rel_mlp0", "rel_bn", "rel_mlp1", "struct_mlp0",
                                           "struct_bn", "struct_mlp1"))
    if use_attention:
        attention = ("ca0", "ca1", "sa0", "sa_bn", "sa1")
        for i in (1, 2, 3):
            layers += _dense_bn((f"attention{i}",), attention)
        layers += _bse(("geometric1", "br_pos")) + _dense_bn(("geometric1",),
                                                             ("mlp0", "bn0", "mlp1"))
        layers += _dense_bn(("boundary1",), (
            "spatial0", "spatial_bn", "spatial1", "boundary0", "boundary_bn0", "boundary1",
            "boundary_bn1", "attn0", "attn_bn", "attn1"))
    return pointnet2_ssg_rules() + _by_flax_path(layers)


def _ptv3_block(name: str, moe: bool = False) -> _Layers:
    """The layers of one PointTransformerBlock called ``name``, its
    feed-forward a Mixture of Experts where ``moe``."""
    mlp = ([((name, "moe_mlp"), "experts"), ((name, "moe_mlp", "router"), "dense")] if moe
           else [((name, "mlp", "geglu", "proj"), "dense"), ((name, "mlp", "out"), "dense")])
    return [((name, "norm1"), "ln"), ((name, "attn", "qkv"), "dense"),
            ((name, "attn", "proj"), "dense"), ((name, "norm2"), "ln")] + mlp


_PTV3_HEAD: _Layers = [(("norm",), "ln"), (("head_fc1",), "dense"), (("head_bn",), "bn"),
                       (("head_fc2",), "dense")]


def ptv3_rules(depth: int = 8, moe_every: int = 0) -> List[Rule]:
    """The flat model; with ``moe_every`` > 0 block i is MoE where
    i % moe_every == moe_every - 1 (models/ptv3.py)."""
    layers: _Layers = [(("patch_embed",), "dense"), (("patch_norm",), "ln"),
                       (("pos_embed",), "dense")]
    for i in range(depth):
        layers += _ptv3_block(f"block{i}", moe_every > 0 and i % moe_every == moe_every - 1)
    return _by_flax_path(layers + _PTV3_HEAD)


def ptv3_moe_rules(depth: int = 8, moe_every: int = 2) -> List[Rule]:
    return ptv3_rules(depth, moe_every)


def ptv3_pooled_rules(enc_depths: Sequence[int] = (2, 2, 2),
                      dec_depths: Sequence[int] = (1, 1)) -> List[Rule]:
    layers: _Layers = [(("patch_embed",), "dense"), (("patch_norm",), "ln")]
    for tag, depths in (("enc", enc_depths), ("dec", dec_depths)):
        for lv, count in enumerate(depths):
            layers.append(((f"{tag}{lv}_pos",), "dense"))
            for i in range(count):
                layers += _ptv3_block(f"{tag}{lv}_block{i}")
    for lv in range(len(dec_depths)):
        layers += [((f"pool{lv}", "proj"), "dense"), ((f"pool{lv}", "norm"), "ln"),
                   ((f"unpool{lv}", "proj_up"), "dense"),
                   ((f"unpool{lv}", "proj_skip"), "dense"), ((f"unpool{lv}", "norm"), "ln")]
    return _by_flax_path(layers + _PTV3_HEAD)


def _edgeconv_rules() -> List[Rule]:
    """The trunk both DGCNNs share: each EdgeConv's bias-free Conv2d
    ``conv{i}.0`` and standalone BatchNorm ``bn{i}`` (the reference's
    duplicate ``conv{i}.1`` alias is not kept, as the JAX import ignores
    it), then ``conv5.0`` and ``bn5``."""
    r: List[Rule] = []
    for i in range(1, 5):
        r += [(f"conv{i}.0", (f"conv{i}", "conv"), "conv2d"), (f"bn{i}", (f"conv{i}", "bn"), "bn")]
    return r + [("conv5.0", ("conv5",), "conv1d"), ("bn5", ("bn5",), "bn")]


def dgcnn_rules() -> List[Rule]:
    return _edgeconv_rules() + [
        ("local_bn", ("local_bn",), "bn"),
        ("point_conv.0", ("point_conv1",), "conv1d"),
        ("point_conv.1", ("bn_p1",), "bn"),
        ("point_conv.3", ("point_conv2",), "conv1d"),
        ("point_conv.4", ("bn_p2",), "bn"),
        ("point_conv.6", ("point_conv3",), "conv1d"),
    ]


def dgcnn_global_rules() -> List[Rule]:
    return _edgeconv_rules() + [
        ("linear1", ("linear1",), "linear"),
        ("bn6", ("bn6",), "bn"),
        ("linear2", ("linear2",), "linear"),
        ("bn7", ("bn7",), "bn"),
        ("linear3", ("linear3",), "linear"),
    ]


def _tnet(tprefix: str, fpath: Tuple[str, ...], conv: str) -> List[Rule]:
    """A T-Net's ``conv1``-``conv3`` (``conv``), ``fc1``-``fc3`` and
    ``bn1``-``bn5`` under ``tprefix`` <-> the flax TNet at ``fpath``."""
    fc = "dense" if conv == "dense" else "linear"
    return ([(f"{tprefix}.conv{i}", fpath + (f"conv{i}",), conv) for i in (1, 2, 3)]
            + [(f"{tprefix}.fc{i}", fpath + (f"fc{i}",), fc) for i in (1, 2, 3)]
            + [(f"{tprefix}.bn{i}", fpath + (f"bn{i}",), "bn") for i in range(1, 6)])


def _flat(names: Sequence[str], kind: str) -> List[Rule]:
    return [(n, (n,), kind) for n in names]


def pointnet_rules() -> List[Rule]:
    return (_tnet("input_transform", ("input_transform",), "conv1d")
            + _tnet("feature_transform_net", ("feature_transform",), "conv1d")
            + _flat([f"conv{i}" for i in range(1, 6)], "conv1d")
            + _flat([f"bn{i}" for i in range(1, 6)], "bn")
            + _flat([f"seg_conv{i}" for i in range(1, 5)], "conv1d")
            + _flat([f"bn_seg{i}" for i in range(1, 4)], "bn"))


def pointnet_sem_seg_rules() -> List[Rule]:
    return (_tnet("feat.stn", ("stn",), "conv1d") + _tnet("feat.fstn", ("fstn",), "conv1d")
            + [(f"feat.conv{i}", (f"conv{i}",), "conv1d") for i in (1, 2, 3)]
            + [(f"feat.bn{i}", (f"bn{i}",), "bn") for i in (1, 2, 3)]
            + [(f"conv{i}", (f"head{i}",), "conv1d") for i in (1, 2, 3, 4)]
            + [(f"bn{i}", (f"bn_h{i}",), "bn") for i in (1, 2, 3)])


def pointnet_global_rules() -> List[Rule]:
    return (_tnet("stn", ("stn",), "dense")
            + _flat(["conv1", "mlp64_dense0", "mlp64_dense1"]
                    + [f"conv{i}" for i in range(2, 6)] + ["fc1", "fc2", "fc3"], "dense")
            + _flat(["mlp64_bn"] + [f"bn{i}" for i in range(1, 8)], "bn"))


def pointnet_cls_rules() -> List[Rule]:
    return (_tnet("stn", ("stn",), "dense") + _tnet("fstn", ("fstn",), "dense")
            + _flat(["conv1", "conv2", "conv3", "fc1", "fc2", "fc3"], "dense")
            + _flat([f"bn{i}" for i in range(1, 6)], "bn"))


def randlanet_rules() -> List[Rule]:
    """The inverse of the JAX package's ``_rules_randlanet``
    (utils/torch_import.py:293-336): the LocalSpatialEncodings' and the
    attention scores' convolutions Conv2d [O, I, 1, 1], the other
    convolutions Conv1d [O, I, 1], ``fc_start`` Linear."""
    r: List[Rule] = [("fc_start", ("fc_start",), "linear"), ("bn_start", ("bn_start",), "bn")]
    for i in range(4):
        la, fl = f"down_modules.{i}.localAgg", f"lfa{i}"
        for lse in ("lse1", "lse2"):
            r += [(f"{la}.{lse}.mlp.0", (fl, lse, "mlp"), "conv2d"),
                  (f"{la}.{lse}.mlp.1", (fl, lse, "bn"), "bn")]
        for ap in ("ap1", "ap2"):
            r += [(f"{la}.{ap}.score_fn.0", (fl, ap, "score0"), "conv2d"),
                  (f"{la}.{ap}.score_fn.1", (fl, ap, "score_bn"), "bn"),
                  (f"{la}.{ap}.score_fn.3", (fl, ap, "score1"), "conv2d"),
                  (f"{la}.{ap}.mlp.0", (fl, ap, "mlp"), "conv1d"),
                  (f"{la}.{ap}.mlp.1", (fl, ap, "mlp_bn"), "bn")]
        r += [(f"{la}.drb.mlp{j}.{t}", (fl, "drb", f"{kind}{j}"), "conv1d" if t == 0 else "bn")
              for j in (1, 2) for t, kind in ((0, "mlp"), (1, "bn"))]
    for i in range(4):
        up = f"up_modules.{i}.mlp"
        r += [(f"{up}.0", (f"up{i}_d1",), "conv1d"), (f"{up}.1", (f"up{i}_bn1",), "bn"),
              (f"{up}.3", (f"up{i}_d2",), "conv1d"), (f"{up}.4", (f"up{i}_bn2",), "bn")]
    return r + [("seg_head.0", ("head_d0",), "conv1d"), ("seg_head.1", ("head_bn",), "bn"),
                ("seg_head.4", ("head_d1",), "conv1d")]


def randlanet_ss_rules() -> List[Rule]:
    layers = _dense_bn((), ("fc_start", "bn_start"))
    for i in range(4):
        layers += _dense_bn((f"lfa{i}",), ("mlp0", "bn0", "mlp1", "bn1", "mlp2", "bn2"))
        layers += _dense_bn((), (f"up{i}_d1", f"up{i}_bn1", f"up{i}_d2", f"up{i}_bn2"))
    return _by_flax_path(layers + _dense_bn((), ("head_d0", "head_bn", "head_d1")))


def _dense_mlp(prefix: Tuple[str, ...], depth: int) -> _Layers:
    """A DenseMLP's ``dense_{i}`` and ``bn_{i}`` under ``prefix``."""
    return [x for i in range(depth) for x in _dense_bn(prefix, (f"dense_{i}", f"bn_{i}"))]


def spg_rules() -> List[Rule]:
    layers = _dense_mlp(("point_encoder",), 4) + _dense_mlp(("sp_encoder",), 3)
    for i in (1, 2, 3):
        layers += _dense_bn((f"gconv{i}",), (
            "self_transform", "neighbor_transform", "edge_mlp0", "edge_mlp1", "attn0", "attn1",
            "gate0", "gate1", "combine0", "combine1"))
        layers += _dense_bn((), (f"gbn{i}",))
    for i in (1, 2):
        layers += _dense_bn((f"gpool{i}",), ("score0", "score1", "score2"))
    layers += _dense_bn(("gpooling",), ("attn0", "attn1", "global0", "global1"))
    layers += _dense_bn((), ("cls_fc1", "cls_bn1", "cls_fc2", "cls_bn2", "cls_fc3", "pfp_mlp0",
                             "pfp_mlp1", "pfp_comb0", "pfp_comb1", "pfp_comb2"))
    return _by_flax_path(layers)


def spt_rules(num_layers: int = 4) -> List[Rule]:
    """SPTSegmenter's SuperPointTransformer ``spt``, ``num_layers`` encoders
    with edge attributes."""
    def graph_mlp(prefix: Tuple[str, ...]) -> _Layers:
        return _dense_bn(prefix, ("lin0", "bn0", "lin1"))

    layers = graph_mlp(("spt", "input_proj"))
    for i in range(num_layers):
        block = ("spt", f"layer{i}")
        layers += [(block + ("norm1",), "ln")]
        layers += _dense_bn(block + ("attn",), ("q", "k", "v", "edge_proj", "o"))
        layers += [(block + ("norm2",), "ln")] + graph_mlp(block + ("ffn",))
    return _by_flax_path(layers + graph_mlp(("spt", "output_proj")))


MODEL_RULES = {
    "pointnet": pointnet_rules,
    "pointnet_seg": pointnet_rules,
    "pointnet_global": pointnet_global_rules,
    "pointnet_cls": pointnet_cls_rules,
    "pointnet_sem_seg": pointnet_sem_seg_rules,
    "enhanced_pointnet2_ssg": enhanced_pointnet2_ssg_rules,
    "pointnet2": pointnet2_ssg_rules,
    "pointnet2_ssg": pointnet2_ssg_rules,
    "bristrunet": bristrunet_rules,
    "enhanced_pointnet2": bristrunet_rules,
    "bridgeseg": bristrunet_rules,
    "ptv3": ptv3_rules,
    "ptv3_pooled": ptv3_pooled_rules,
    "ptv3_moe": ptv3_moe_rules,
    "dgcnn": dgcnn_rules,
    "dgcnn_global": dgcnn_global_rules,
    "pointnet2_msg": pointnet2_msg_rules,
    "pointnet2_sem_seg": pointnet2_sem_seg_rules,
    "pointnet2_cls_ssg": pointnet2_cls_ssg_rules,
    "pointnet2_cls_msg": pointnet2_cls_msg_rules,
    "randlanet": randlanet_rules,
    "randlanet_ss": randlanet_ss_rules,
    "spg": spg_rules,
    "superpoint_graph": spg_rules,
    "spt": spt_rules,
    "superpoint_transformer": spt_rules,
}


def rules_for(model: Union[str, Sequence[Rule]]) -> Sequence[Rule]:
    """A model's rule table by its registry name; a table passes through."""
    if not isinstance(model, str):
        return model
    if model not in MODEL_RULES:
        raise KeyError(f"no weight rules for model '{model}'; known: {sorted(MODEL_RULES)}")
    return MODEL_RULES[model]()


def _leaf(tree: Dict[str, Any], path: Tuple[str, ...]) -> np.ndarray:
    for p in path:
        tree = tree[p]
    return np.asarray(tree, dtype=np.float32)


_TRAILING = {"conv2d": (1, 1), "conv2d_featfirst": (1, 1), "conv1d": (1,), "dense": (),
             "linear": ()}


def flax_to_state_dict(
    variables: Dict[str, Any], model: Union[str, Sequence[Rule]] = "pointnet2_ssg"
) -> Dict[str, torch.Tensor]:
    """JAX variables of ``model`` (a registry name or a rule table) ->
    state_dict for ``load_state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for tp, fp, kind in rules_for(model):
        if kind == "experts":
            for leaf in EXPERT_LEAVES:
                sd[f"{tp}.{leaf}"] = _leaf(params, fp + (leaf,))
        elif kind in ("bn", "ln"):
            sd[f"{tp}.weight"] = _leaf(params, fp + ("scale",))
            sd[f"{tp}.bias"] = _leaf(params, fp + ("bias",))
            if kind == "bn":
                sd[f"{tp}.running_mean"] = _leaf(stats, fp + ("mean",))
                sd[f"{tp}.running_var"] = _leaf(stats, fp + ("var",))
                sd[f"{tp}.num_batches_tracked"] = np.zeros((), np.int64)
        else:
            kernel = _leaf(params, fp + ("kernel",))  # [I, O]
            if kind == "conv2d_featfirst":  # [rel-xyz, features] -> [features, rel-xyz]
                kernel = np.concatenate([kernel[3:], kernel[:3]], axis=0)
            sd[f"{tp}.weight"] = kernel.T.reshape(kernel.shape[::-1] + _TRAILING[kind])
            try:
                sd[f"{tp}.bias"] = _leaf(params, fp + ("bias",))
            except KeyError:  # a Dense without a bias
                pass
    return {k: torch.tensor(v) for k, v in sd.items()}  # copies


def state_dict_to_flax(
    sd: Dict[str, torch.Tensor], model: Union[str, Sequence[Rule]] = "pointnet2_ssg"
) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict``: a state_dict of ``model``, or
    any part of one (a dict of gradients holds only weights and biases) ->
    ``{"params": ..., "batch_stats": ...}`` nested dicts of float32 numpy
    arrays (float64 where the tensor is float64), with the leaves that
    ``sd`` has."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}

    def put(tree: Dict[str, Any], path: Tuple[str, ...], v: torch.Tensor) -> None:
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        a = v.detach().cpu().numpy()
        tree[path[-1]] = a if a.dtype == np.float64 else a.astype(np.float32)

    names = {"weight": "scale", "bias": "bias"}
    for tp, fp, kind in rules_for(model):
        if kind == "experts":
            for leaf in EXPERT_LEAVES:
                if f"{tp}.{leaf}" in sd:
                    put(out["params"], fp + (leaf,), sd[f"{tp}.{leaf}"])
        elif kind in ("bn", "ln"):
            for key, leaf in names.items():
                if f"{tp}.{key}" in sd:
                    put(out["params"], fp + (leaf,), sd[f"{tp}.{key}"])
            for key, leaf in (("running_mean", "mean"), ("running_var", "var")):
                if f"{tp}.{key}" in sd:  # a LayerNorm has none
                    put(out["batch_stats"], fp + (leaf,), sd[f"{tp}.{key}"])
        else:
            if f"{tp}.weight" in sd:
                w = sd[f"{tp}.weight"]
                w = w.reshape(w.shape[0], w.shape[1])
                if kind == "conv2d_featfirst":  # [features, rel-xyz] -> [rel-xyz, features]
                    w = torch.cat([w[:, -3:], w[:, :-3]], dim=1)
                put(out["params"], fp + ("kernel",), w.T)
            if f"{tp}.bias" in sd:
                put(out["params"], fp + ("bias",), sd[f"{tp}.bias"])
    return out
