"""Pipeline parallelism (GPipe) over PointTransformerV3's block stack
(counterpart of pointcloud_bridge_tpu/parallel/pp.py).

Stage s of the P ranks of the pipeline axis holds blocks [s L/P, (s + 1)
L/P) of the L blocks, with their Adam moments; the other stages' blocks
leave its model and optimizer (:meth:`Stages.place`), so a rank's trunk
memory drops by P. The patch embedding and the head are small and run
replicated on every rank (pp.py:97-145); the head's BatchNorm syncs over
``dp_axis`` alone (the model built with ``axis_name=dp_axis``).

Schedule (pp.py:166-200): the batch splits into M microbatches and the
pipeline runs M + P - 1 ticks. At tick t stage s applies its blocks to
microbatch t - s where that is one (stage 0 takes it from the embedding,
the others from the activation handed over at the last tick), then every
rank hands its activation one stage to the right with
:func:`~..utils.collectives.ppermute`; the last stage keeps each finished
microbatch, and the outputs reach every rank by a
:func:`~..utils.collectives.psum` of the last stage's outputs and the
others' zeros. Every rank issues the same collectives on every tick: a
stage with no microbatch skips its blocks, never the rotation.

The backward is autograd's, through the ``ppermute`` Function (torch has
no differentiable send and receive). The ranks must run the rotations'
backwards in the same order, so every tick's activation is kept in one
chain: a stage's input always depends on the activation it received (on
stage 0 plus a zero multiple of it, where it takes the embedding's), the
first received activation is a leaf that needs a gradient, and the zeros a
stage adds to the final sum depend on its last activation. Each rotation's
backward then waits for the next one's, on every rank.

Gradient scale, from those collectives: every rank computes the global
loss L, so autograd gives each rank its share of the gradient of R L over
the R ranks of the mesh (utils/collectives.py). A replicated parameter's
gradient is the sum over all ranks over R; a block's, which the ranks of
its stage hold, the sum over ``dp_axis`` over R. That is the JAX step's
rule (pp.py:19-30, 278-285), reached from the port's own collectives.

Checkpoints stay in the single-device layout: :meth:`Stages.full_state`
and :meth:`Stages.full_optimizer_state` stack a stage's blocks and their
Adam moments (``pp_stack_state``), gather the stacked leaves from the
stages and unstack them whole (``pp_unstack_state``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import losses as L
from ..models.common import Dropout
from ..models.ptv3 import input_channels, run_block, serialize, take_rows, widen
from ..train.loop import loss_fn_for, set_lr
from ..utils import metrics as M
from ..utils.collectives import axis_group, gather_list, ppermute, psum
from .sharding import gather_plain
from .sp import check_decomposable
from .train_step import all_reduce_bucket_

BLOCKS = "blocks."


# ---------------------------------------------------------------- layouts


def _block_key(key: str, blocks: range):
    """(block index, the key's rest) of ``block<i>.<rest>`` with i in
    ``blocks``, else None."""
    head, _, rest = key.partition(".")
    if head.startswith("block") and head[5:].isdigit() and int(head[5:]) in blocks and rest:
        return int(head[5:]), rest
    return None


def check_homogeneous(keys) -> None:
    """The MoE model is refused (pp.py:64-69): its blocks alternate dense
    and MoE feed-forwards, so the stack is not homogeneous."""
    if any(".moe_mlp." in k for k in keys):
        raise ValueError(
            "pipeline parallelism requires a homogeneous block stack; the MoE model "
            "(num_experts>0) alternates dense/MoE blocks - use expert parallelism "
            "(parallel/ep.py) for it instead")


def stack_ptv3_params(state: Dict[str, Any], depth: int, first: int = 0) -> Dict[str, Any]:
    """{block<first>.x .. block<first+depth-1>.x, rest} -> {"blocks.x":
    [depth, ...] stacked, rest} (pp.py:61-75); ``first`` > 0 stacks a
    stage's blocks. Refuses the MoE model (:func:`check_homogeneous`)."""
    check_homogeneous(state)
    blocks = range(first, first + depth)
    out, by_rest = {}, {}
    for key, value in state.items():
        hit = _block_key(key, blocks)
        if hit is None:
            out[key] = value
        else:
            by_rest.setdefault(hit[1], {})[hit[0]] = value
    for rest, by_block in by_rest.items():
        if sorted(by_block) != list(blocks):
            raise ValueError(f"block leaf '{rest}' is not in every one of blocks {blocks}")
        out[BLOCKS + rest] = torch.stack([by_block[i] for i in blocks])
    return out


def unstack_ptv3_params(state: Dict[str, Any], depth: int, first: int = 0) -> Dict[str, Any]:
    """Inverse of :func:`stack_ptv3_params`."""
    out = {}
    for key, value in state.items():
        if key.startswith(BLOCKS):
            for i in range(depth):
                out[f"block{first + i}.{key[len(BLOCKS):]}"] = value[i]
        else:
            out[key] = value
    return out


def named_moments(model: torch.nn.Module, optimizer) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer's state by parameter name: {name: {"step", "exp_avg",
    "exp_avg_sq"}} for every parameter it holds state for."""
    names = {id(p): k for k, p in model.named_parameters()}
    return {names[id(p)]: dict(st) for p, st in optimizer.state.items() if id(p) in names}


def pp_stack_state(state: Dict[str, Any], depth: int, first: int = 0) -> Dict[str, Any]:
    """{"model": state_dict, "moments": named_moments} in the single-device
    layout -> the stacked layout, Adam's moments stacked with their
    parameters (pp.py:424-438)."""
    moments = state.get("moments", {})
    keys = {k for st in moments.values() for k in st}
    return {"model": stack_ptv3_params(state["model"], depth, first),
            "moments": {key: stack_ptv3_params({n: st[key] for n, st in moments.items()
                                                if key in st}, depth, first)
                        for key in sorted(keys)}}


def pp_unstack_state(state: Dict[str, Any], depth: int, first: int = 0) -> Dict[str, Any]:
    """Inverse of :func:`pp_stack_state`."""
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, tree in state.get("moments", {}).items():
        for name, value in unstack_ptv3_params(tree, depth, first).items():
            moments.setdefault(name, {})[key] = value
    return {"model": unstack_ptv3_params(state["model"], depth, first), "moments": moments}


def make_pp_state(model: torch.nn.Module, optimizer=None) -> Dict[str, Any]:
    """The model's state_dict and the optimizer's moments in the stacked
    layout (pp.py:405-418)."""
    moments = named_moments(model, optimizer) if optimizer is not None else {}
    return pp_stack_state({"model": model.state_dict(), "moments": moments}, model.depth)


def pp_state_specs(state: Dict[str, Any], axis: str = "pp") -> Dict[str, Any]:
    """The layout of a stacked state, leaf by leaf: ``axis`` for a stacked
    block leaf (split over the stages along its depth dim), None for a
    replicated one (pp.py:372-379)."""
    def spec(tree):
        return {k: axis if k.startswith(BLOCKS) else None for k in tree}
    return {"model": spec(state["model"]),
            "moments": {key: spec(tree) for key, tree in state.get("moments", {}).items()}}


def pp_place_state(state: Dict[str, Any], mesh: DeviceMesh, axis: str = "pp") -> Dict[str, Any]:
    """This rank's part of a stacked state: its stage's rows of every
    stacked block leaf, the rest whole (pp.py:382-392)."""
    p, s = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)

    def place(tree):
        return {k: v[s * v.shape[0] // p:(s + 1) * v.shape[0] // p] if k.startswith(BLOCKS)
                else v for k, v in tree.items()}
    return {"model": place(state["model"]),
            "moments": {key: place(tree) for key, tree in state.get("moments", {}).items()}}


# ---------------------------------------------------------------- stages


class Stages:
    """One rank's stage of a PTv3 model: ``local`` its block indices.
    :meth:`of` gives the one a model has on a mesh axis.

    The model keeps its own layout (``block<i>`` modules, the other stages'
    dropped by :meth:`place`). The stacked layout is how a stage's state
    travels: :meth:`stacked_state` is this rank's part of it, which
    :func:`pp_place_state` cuts from the single-device model's
    :func:`make_pp_state`; :meth:`gather` is that cut's inverse, and
    :func:`pp_unstack_state` of it the single-device layout of a
    checkpoint."""

    @classmethod
    def of(cls, model: torch.nn.Module, mesh: DeviceMesh, axis: str = "pp") -> "Stages":
        found = model.__dict__.get("_pp_stages")
        if found is None or found.mesh is not mesh or found.axis != axis:
            found = model.__dict__["_pp_stages"] = cls(model, mesh, axis)
        return found

    def __init__(self, model: torch.nn.Module, mesh: DeviceMesh, axis: str = "pp"):
        if getattr(model, "sp_axis", None):
            raise ValueError("PP and SP are separate modes (sp_axis must be None)")
        depth = getattr(model, "depth", 0)
        self.n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
        if not depth:
            raise ValueError("pipeline parallelism requires a homogeneous block-stack model "
                             "(the ptv3 family); this model has no depth")
        if depth % self.n_stages:
            raise ValueError(f"depth {depth} not divisible by {self.n_stages} stages")
        self.keys = list(model.state_dict().keys())
        check_homogeneous(self.keys)
        self.model, self.mesh, self.axis, self.depth = model, mesh, axis, depth
        self.group = mesh.get_group(axis)
        self.stage = mesh.get_local_rank(axis)
        per = depth // self.n_stages
        self.local = list(range(self.stage * per, (self.stage + 1) * per))
        self.names = [k for k, _ in model.named_parameters()]
        self.placed = False

    @property
    def blocks(self) -> List[torch.nn.Module]:
        return [getattr(self.model, f"block{i}") for i in self.local]

    def place(self, optimizer=None, tensors: Optional[Dict[str, torch.Tensor]] = None):
        """Drop the other stages' blocks from the model and the optimizer
        (the first call), give the head's Dropout a generator of its own
        (the ranks of a pipeline draw the same head masks) and return
        ``tensors`` (the EMA weights) without the other stages' leaves."""
        every = range(self.depth)
        if not self.placed:
            drop = self.model.head_drop
            if isinstance(drop, Dropout) and drop.generator is not None:
                gen = torch.Generator(device=drop.generator.device)
                gen.set_state(drop.generator.get_state())
                drop.generator = gen
            gone = [i for i in every if i not in self.local]
            dropped = {id(p) for i in gone for p in getattr(self.model, f"block{i}").parameters()}
            if optimizer is not None:
                for group in optimizer.param_groups:
                    group["params"] = [p for p in group["params"] if id(p) not in dropped]
                for p in list(optimizer.state):
                    if id(p) in dropped:
                        del optimizer.state[p]
            for i in gone:
                delattr(self.model, f"block{i}")
            self.placed = True
        if tensors is None:
            return None
        return {k: v for k, v in tensors.items()
                if _block_key(k, every) is None or _block_key(k, every)[0] in self.local}

    def stacked_state(self, tensors: Optional[Dict[str, torch.Tensor]] = None,
                      optimizer=None) -> Dict[str, Any]:
        """This rank's part of the stacked state: its stage's blocks of
        ``tensors`` (the model's state_dict by default) stacked, with the
        optimizer's moments when it is given."""
        tensors = self.model.state_dict() if tensors is None else tensors
        moments = named_moments(self.model, optimizer) if optimizer is not None else {}
        return pp_stack_state({"model": tensors, "moments": moments}, len(self.local),
                              self.local[0])

    def gather(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The inverse of :func:`pp_place_state`: every leaf that
        :func:`pp_state_specs` splits over the stages gathered from them
        (a collective over the pipeline axis: every rank calls it)."""
        specs = pp_state_specs(state, self.axis)

        def whole(tree, spec):
            return {k: torch.cat(gather_list(v, self.group)) if spec[k] else v.detach()
                    for k, v in tree.items()}
        return {"model": whole(state["model"], specs["model"]),
                "moments": {key: whole(tree, specs["moments"][key])
                            for key, tree in state["moments"].items()}}

    def full_tensors(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``tensors`` (parameter or state names of this rank) in the
        single-device layout; every rank must call it."""
        return pp_unstack_state(self.gather(self.stacked_state(tensors)), self.depth)["model"]

    def full_state(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict in the single-device layout, its keys in
        the single-device order."""
        full = self.full_tensors(self.model.state_dict())
        return {k: full[k] for k in self.keys}

    def full_optimizer_state(self, optimizer) -> dict:
        """The optimizer's state_dict in the single-device layout (every
        parameter of the single-device model in one group)."""
        moments = pp_unstack_state(self.gather(self.stacked_state({}, optimizer)),
                                   self.depth)["moments"]
        group = {k: v for k, v in optimizer.state_dict()["param_groups"][0].items()
                 if k != "params"}
        state = {i: moments[name] for i, name in enumerate(self.names) if name in moments}
        return {"state": state, "param_groups": [dict(group, params=list(range(len(self.names))))]}


# ---------------------------------------------------------------- the model's parts


def _embed(model, xyz: torch.Tensor, feats: Optional[torch.Tensor]):
    """PointTransformerV3.forward up to its blocks -> (x, pos, inv_order)."""
    x = input_channels(xyz, feats, model.d_in)
    inv_order = None
    if model.window_size:
        order, inv_order = serialize(xyz)
        x = take_rows(x, order)
        xyz = x[..., :3] if model.d_in >= 3 else take_rows(xyz, order)
    x = model.patch_norm(widen(model.patch_embed(x)))
    pos = model.pos_embed(xyz)
    if model.stream_dtype is not None:
        x, pos = x.to(model.stream_dtype), pos.to(model.stream_dtype)
    return x, pos, inv_order


def _head(model, x: torch.Tensor, inv_order) -> torch.Tensor:
    logits = model.head(x)
    return logits if inv_order is None else take_rows(logits, inv_order)


def _split_mb(x: torch.Tensor, m: int) -> torch.Tensor:
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by num_microbatches {m}")
    return x.reshape(m, b // m, *x.shape[1:])


def pipeline(stages: Stages, x_mb: torch.Tensor, pos_mb: torch.Tensor) -> torch.Tensor:
    """The GPipe tick loop: [M, mb, N, C] microbatches (the same on every
    rank; stage 0's are used) -> the [M, mb, N, C] outputs of the whole
    stack on every rank."""
    m_total, p, s = x_mb.shape[0], stages.n_stages, stages.stage
    axis, blocks, remat = stages.axis, stages.blocks, stages.model.remat
    chain = torch.is_grad_enabled()
    acts = torch.zeros_like(x_mb[0]).requires_grad_(chain)
    outs, y = [], acts
    for t in range(m_total + p - 1):
        m = t - s  # the microbatch this stage works on at tick t
        if s == 0 and t < m_total:
            y = x_mb[t] + acts * 0 if chain else x_mb[t]
        else:
            y = acts
        if 0 <= m < m_total:
            for blk in blocks:
                y = run_block(blk, y, pos_mb[m], remat)
            if s == p - 1:
                outs.append(y)
        if t < m_total + p - 2:
            acts = ppermute(y, axis)
    mine = torch.stack(outs) if s == p - 1 else torch.zeros_like(x_mb) + (y * 0 if chain else 0)
    return psum(mine, axis)


def _forward(stages: Stages, m: int, xyz, feats) -> torch.Tensor:
    model = stages.model
    x, pos, inv = _embed(model, xyz, feats)
    outs = pipeline(stages, _split_mb(x, m), _split_mb(pos, m))
    return _head(model, outs.reshape(-1, *outs.shape[2:]), inv)


# ---------------------------------------------------------------- public API


def make_pp_forward(model, mesh: DeviceMesh, axis: str = "pp",
                    num_microbatches: Optional[int] = None) -> Callable:
    """``forward(xyz, feats) -> logits`` in eval mode on the rows it is
    given (on a dp x pp mesh, this rank's), the blocks pipelined in M
    microbatches (P by default) over ``axis``. Places the stages at the
    first call."""
    stages = Stages.of(model, mesh, axis)
    m = num_microbatches or stages.n_stages

    def forward(xyz, feats):
        stages.place()
        model.eval()
        with torch.inference_mode():
            return _forward(stages, m, xyz, feats)

    forward.stages = stages
    return forward


def make_pp_train_step(model, loss_cfg, optimizer, mesh: DeviceMesh, axis: str = "pp",
                       num_microbatches: Optional[int] = None,
                       dp_axis: Optional[str] = None):
    """Returns ``(step, stages)``. ``stages.place(optimizer)`` drops the
    other stages' blocks (the first step does it); ``step(batch, lr,
    class_weights) -> {"loss", "acc"}`` runs one update on this rank's rows
    (every row without ``dp_axis``). ``model`` is built with
    ``axis_name=dp_axis``. Without ``dp_axis`` every loss is supported
    (each rank sees the whole logits); with it ce/weighted_ce, summed over
    ``dp_axis`` before the division (pp.py:223-243)."""
    stages = Stages.of(model, mesh, axis)
    if dp_axis:
        check_decomposable(loss_cfg)
    m = num_microbatches or stages.n_stages
    loss_fn = loss_fn_for(loss_cfg)
    world = axis_group((dp_axis, axis) if dp_axis else axis)
    data = axis_group(dp_axis) if dp_axis else None
    r = dist.get_world_size(world)

    def step(batch, lr: float, class_weights) -> Dict[str, torch.Tensor]:
        stages.place(optimizer)
        set_lr(optimizer, lr)
        model.train()
        xyz, colors, labels = batch["points"], batch["colors"], batch["labels"]
        optimizer.zero_grad(set_to_none=True)
        logits = _forward(stages, m, xyz, colors)
        if dp_axis:
            cw = class_weights if loss_cfg.use_class_weights else None
            numer, denom = L.weighted_cross_entropy_sums(logits, labels, cw,
                                                         loss_cfg.label_smoothing)
            loss = psum(numer, dp_axis) / torch.clamp(psum(denom.to(numer.dtype), dp_axis),
                                                      min=1e-8)
        else:
            loss = loss_fn(logits, labels, xyz, class_weights)
        loss.backward()
        with torch.no_grad():
            blocks = {id(p) for b in stages.blocks for p in b.parameters()}
            grads = []
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            rest = [g for p, g in zip(model.parameters(), grads) if id(p) not in blocks]
            mine = [g for p, g in zip(model.parameters(), grads) if id(p) in blocks]
            # every rank holds L: a leaf's gradient is its holders' sum over R
            all_reduce_bucket_(rest, world, mean=False)
            if data is not None:
                all_reduce_bucket_(mine, data, mean=False)
            torch._foreach_div_(grads, float(r))
            acc = (logits.argmax(-1) == labels).float().mean().reshape(1)
            if data is not None:
                all_reduce_bucket_([acc], data)
        optimizer.step()
        return {"loss": loss.detach(), "acc": acc[0]}

    return step, stages


def make_pp_eval_step(model, num_classes: int, mesh: DeviceMesh, axis: str = "pp",
                      num_microbatches: Optional[int] = None,
                      dp_axis: Optional[str] = None) -> Callable:
    """``step(batch, class_weights, params=None) -> (confusion, loss)`` of
    the train loop's eval on the pipelined forward (pp.py:441-466): every
    rank holds the whole logits (of every row, gathered over ``dp_axis``).
    ``params`` (the EMA weights, this rank's leaves) stand in for the
    parameters."""
    from .sharding import _Swapped

    fwd = make_pp_forward(model, mesh, axis, num_microbatches)
    data = axis_group(dp_axis) if dp_axis else None

    def step(batch, class_weights, params=None):
        fwd.stages.place()
        with _Swapped(model, params):
            logits = fwd(batch["points"], batch["colors"])
        with torch.inference_mode():
            labels, mask = batch["labels"], batch["mask"]
            if data is not None:
                logits, labels, mask = (gather_plain(t, data) for t in (logits, labels, mask))
            loss = L.weighted_cross_entropy(logits, labels, class_weights)
            cm = M.masked_confusion_matrix(logits.argmax(-1), labels,
                                           mask[:, None].expand(labels.shape), num_classes)
        return cm, loss

    step.stages = fwd.stages
    return step
