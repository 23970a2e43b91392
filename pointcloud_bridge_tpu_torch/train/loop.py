"""Training engine of the port, single device (counterpart of
pointcloud_bridge_tpu/train/loop.py on its single-device branch).

Mirrors the reference trainer: timestamped experiment dir, logger and
scalar writer, code snapshot, Adam(wd=1e-4) with L2 in the gradient,
lr schedulers with warmup, optional EMA of the weights, class weights from
the label histogram, per-epoch validation with the metric suite, and
best/latest checkpoints. Metrics stay on the device during an epoch and are
fetched once at its end. The model computes in full float32 (TF32 is
turned off on CUDA) unless its own options say otherwise (the PTv3 family's
``compute_dtype`` and ``stream_dtype``). ``train.accum_steps`` > 1 splits
each batch into that many equal microbatches with one optimizer step
(:func:`make_train_step`). ``train.steps_per_dispatch`` = K > 1 runs K
full optimizer steps, and K validation batches, a dispatch over K stacked
host batches (:func:`group_batches`, :class:`MultiTrainStep`,
:class:`MultiEvalStep`): on the card a dispatch is one replay of a CUDA
graph of exactly the eager step's body, on the CPU the same K eager steps
in a loop. ``parallel.num_devices`` > 1 (or -1 over a world above one)
with ``parallel.mode`` dp, tp, fsdp, sp, pp or ep trains on a mesh inside
the initialised process group (parallel/engine.py).
"""

from __future__ import annotations

import itertools
import logging
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import losses as L
from ..config import Config
from ..models import Dropout, get_model
from ..models.common import sync_batchnorms
from ..ops import _kernels
from ..utils import metrics as M
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.logging import ScalarWriter, initialize_logger, snapshot_code
from .schedules import ReduceLROnPlateau, cosine_lr, step_decay_lr


def make_optimizer(params, weight_decay: float = 1e-4,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam(betas=(0.9, 0.999), eps=1e-8) with the weight decay added to the
    gradient before the moments (L2, not AdamW): the JAX package's
    ``optax.chain(add_decayed_weights(wd), scale_by_adam())``. The lr is set
    by each train step (:func:`set_lr`).

    ``capturable=True`` is torch's capturable Adam, which a CUDA graph can
    replay: the step count stays on the parameters' device and the lr is a
    0-d float32 tensor there, so the bias corrections are computed on the
    device in float32 (``(beta ** step - 1) / lr`` and its reciprocal, the
    square root of ``1 - beta2 ** step``), where the eager optimizer takes
    them in float64 on the host and rounds each to float32 once. The moments
    are the same bits either way; the update of a parameter may differ in
    its last bits. Only the multi-step path on the card uses it."""
    if not capturable:
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    params = list(params)
    lr = torch.zeros((), dtype=torch.float32, device=params[0].device)
    # foreach: the card's default, named so that a CPU run takes the same
    # arithmetic
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, capturable=True, foreach=True)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The lr of every group: a float for the eager optimizer, filled into
    the 0-d device tensor of a capturable one (a graph reads that tensor,
    so it stays the same object; a ``load_state_dict`` that put a float or
    another device's tensor in its place gets a new one, before any
    capture)."""
    for group in optimizer.param_groups:
        if not group.get("capturable"):
            group["lr"] = lr
            continue
        dev = group["params"][0].device
        if not torch.is_tensor(group["lr"]) or group["lr"].device != dev:
            group["lr"] = torch.zeros((), dtype=torch.float32, device=dev)
        group["lr"].fill_(lr)


def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> None:
    """ema = decay * ema + (1 - decay) * params, in place, after every
    optimizer step (loop.py:220-237)."""
    keys = list(ema)
    with torch.no_grad():
        torch._foreach_mul_([ema[k] for k in keys], decay)
        torch._foreach_add_([ema[k] for k in keys], [params[k].detach() for k in keys],
                            alpha=1.0 - decay)


def loss_fn_for(loss_cfg) -> Callable:
    """loss(logits, labels, xyz, class_weights) -> scalar, as the config
    names it (loop.py:131-153)."""
    name = loss_cfg.name

    def fn(logits, labels, xyz, class_weights):
        if name in ("ce", "weighted_ce"):
            cw = class_weights if loss_cfg.use_class_weights else None
            return L.weighted_cross_entropy(logits, labels, cw, loss_cfg.label_smoothing)
        if name == "bridge_structure":
            return L.bridge_structure_loss(
                logits, labels, xyz, alpha=loss_cfg.alpha, rel_margin=loss_cfg.rel_margin
            )
        if name == "sol":
            return L.sol_loss(logits, labels, xyz)
        raise ValueError(f"unknown loss '{name}'")

    return fn


def make_train_step(model: torch.nn.Module, loss_cfg, optimizer,
                    accum_steps: int = 1) -> Callable:
    """step(batch, lr, class_weights) -> {"loss", "acc"} as device tensors.

    One forward in train mode (BatchNorm batch statistics, running stats
    updated, dropout on), one backward, one optimizer step at ``lr``. The
    gradients stay in each parameter's ``.grad`` until the next step.

    With ``accum_steps`` > 1 (the counterpart of the JAX package's
    ``make_accum_train_step``, loop.py:257-322) the batch splits into that
    many equal microbatches, each a forward and a backward in turn: the
    BatchNorm running statistics chain from one microbatch to the next, the
    gradient is the mean of the microbatch gradients (each backward adds
    its loss's gradient over ``accum_steps``), and one optimizer step
    follows. The loss and accuracy are the means over the microbatches.
    """
    body = train_step_body(model, loss_cfg, optimizer, accum_steps)

    def step(batch, lr: float, class_weights) -> Dict[str, torch.Tensor]:
        set_lr(optimizer, lr)
        return body(batch, class_weights)

    return step


def train_step_body(model: torch.nn.Module, loss_cfg, optimizer,
                    accum_steps: int = 1) -> Callable:
    """body(batch, class_weights) -> {"loss", "acc"}: :func:`make_train_step`
    without setting the lr, which a CUDA graph of K steps runs K times."""
    loss_fn = loss_fn_for(loss_cfg)

    def body(batch, class_weights) -> Dict[str, torch.Tensor]:
        model.train()
        xyz, colors, labels = batch["points"], batch["colors"], batch["labels"]
        if xyz.shape[0] % accum_steps:
            raise ValueError(
                f"batch of {xyz.shape[0]} does not split into {accum_steps} microbatches")
        optimizer.zero_grad(set_to_none=True)
        losses, accs = [], []
        for mb in range(accum_steps):
            rows = slice(mb * xyz.shape[0] // accum_steps, (mb + 1) * xyz.shape[0] // accum_steps)
            logits = model(xyz[rows], colors[rows])
            loss = loss_fn(logits, labels[rows], xyz[rows], class_weights)
            (loss if accum_steps == 1 else loss / accum_steps).backward()
            losses.append(loss.detach())
            with torch.no_grad():
                accs.append((logits.argmax(-1) == labels[rows]).float().mean())
        optimizer.step()
        if accum_steps == 1:
            return {"loss": losses[0], "acc": accs[0]}
        return {"loss": torch.stack(losses).mean(), "acc": torch.stack(accs).mean()}

    return body


def make_eval_step(model: torch.nn.Module, num_classes: int) -> Callable:
    """step(batch, class_weights, params=None) -> (confusion [C, C], loss).

    Eval mode; only the rows that ``batch["mask"]`` marks count in the
    confusion matrix. ``params`` (name -> tensor) replaces the model's
    parameters for this call, as the EMA weights do in validation."""

    def step(batch, class_weights, params: Optional[Dict[str, torch.Tensor]] = None):
        model.eval()
        xyz, labels = batch["points"], batch["labels"]
        with torch.inference_mode():
            if params is None:
                logits = model(xyz, batch["colors"])
            else:
                logits = torch.func.functional_call(model, params, (xyz, batch["colors"]))
            loss = L.weighted_cross_entropy(logits, labels, class_weights)
            mask = batch["mask"][:, None].expand(labels.shape)
            cm = M.masked_confusion_matrix(logits.argmax(-1), labels, mask, num_classes)
        return cm, loss

    return step


def prefetch_to_device(batch_iter, put: Callable, size: int = 2):
    """Double-buffered input feed: a daemon thread converts and copies
    batches N+1..N+size while step N runs (loop.py:74-109). size <= 1
    feeds synchronously. An exception in the thread re-raises here."""
    if size <= 1:
        for b in batch_iter:
            yield put(b)
        return
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()

    def worker():
        try:
            for b in batch_iter:
                q.put(put(b))
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            q.put(("__prefetch_error__", e))
        q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "__prefetch_error__":
            raise item[1]
        yield item


def group_batches(batch_iter, k: int):
    """Stack consecutive same-shape numpy batches into [k, ...] dicts for
    :class:`MultiTrainStep` and :class:`MultiEvalStep` (loop.py:112-128). A
    shape change (the ragged final batch of an epoch) flushes the buffer
    un-stacked, and leftovers at iterator end pass through un-stacked: the
    caller dispatches on points.ndim (4 = stacked)."""
    buf = []
    for b in batch_iter:
        if buf and any(np.shape(b[key]) != np.shape(buf[0][key]) for key in buf[0]):
            yield from buf
            buf = []
        buf.append(b)
        if len(buf) == k:
            yield {key: np.stack([x[key] for x in buf]) for key in buf[0]}
            buf = []
    yield from buf


def model_generators(model: torch.nn.Module) -> list:
    """The generators a train step of ``model`` draws from besides torch's
    default one, each once: every Dropout's and a RandLA-Net's
    ``sampling_generator``."""
    found = {}
    for m in model.modules():
        for g in (getattr(m, "generator", None) if isinstance(m, Dropout) else None,
                  getattr(m, "sampling_generator", None)):
            if isinstance(g, torch.Generator):
                found[id(g)] = g
    return list(found.values())


class StepState:
    """Every tensor a train step mutates, cloned: the parameters, the
    buffers (BatchNorm statistics), the optimizer's state, the EMA tensors,
    and the generators' states (``generators`` and torch's default one on
    the device). :meth:`restore` writes them back in place with ``copy_``,
    never by ``load_state_dict``, which would put new tensors where a
    captured graph reads the old ones; optimizer state that did not exist at
    the snapshot (a fresh Adam's moments and step, made by its first step)
    is zeroed, which is what that first step made it."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 ema: Optional[Dict[str, torch.Tensor]] = None, generators: Sequence = ()):
        self.optimizer = optimizer
        self.tensors = [(t, t.detach().clone()) for t in itertools.chain(
            model.parameters(), model.buffers(), (ema or {}).values())]
        self.opt = {p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
                    for p, st in optimizer.state.items()}
        self.gens = [(g, g.get_state()) for g in generators]
        dev = next(model.parameters()).device
        self.cuda_rng = (dev, torch.cuda.get_rng_state(dev)) if dev.type == "cuda" else None

    def restore(self) -> None:
        with torch.no_grad():
            for t, saved in self.tensors:
                t.copy_(saved)
            for p, st in self.optimizer.state.items():
                saved = self.opt.get(p)
                for k, v in st.items():
                    if torch.is_tensor(v):
                        v.copy_(saved[k]) if saved is not None else v.zero_()
        for g, st in self.gens:
            g.set_state(st)
        if self.cuda_rng is not None:
            torch.cuda.set_rng_state(self.cuda_rng[1], self.cuda_rng[0])


class GraphSteps:
    """``run(slots, class_weights)`` over K batches captured in one CUDA
    graph, from static input buffers.

    The inputs of slot i are copied into their own buffers (one allocation
    a key and slot, so every step reads tensors laid out as an eager step's
    own) on the current stream, the stream the replay runs on, so the copy
    is ordered before it. Before the capture, one real step runs on a side
    stream (lazy initialisation: the optimizer's state, library handles,
    the kernels' shared-memory opt-ins), and ``state`` (a :class:`StepState`
    taken before it) is restored in place. ``generators`` are registered
    with the graph, so that every replay draws on from where the last draw
    ended, as K eager steps do; torch registers its default generator
    itself. Anything that fails in the capture or the replay raises: no
    path drops to eager steps.

    The bf16 flash-attention kernels encode their TMA tensor maps on the
    host at every call (csrc/flash_attn_bf16.cuh), and the capture bakes
    them into the graph by value, addresses included. That is safe only
    because a graph's buffers (its static inputs, its private memory pool
    and the parameters, gradients and optimizer state it was captured on)
    keep their addresses for the graph's life.

    The kernels' launch counters (ops/_kernels.py) count the wrappers'
    calls, so a replay adds nothing to them: ``launches`` holds what the
    capture's calls counted, one replay's launches of each kernel (the
    counters are set back after it: a capture launches nothing), and
    :meth:`launch_counts` multiplies them by the replays."""

    def __init__(self, run: Callable, batches: Dict[str, torch.Tensor], keys: Sequence[str],
                 class_weights: torch.Tensor, state: Optional[StepState] = None,
                 generators: Sequence = ()):
        k = batches[keys[0]].shape[0]
        self.keys = tuple(keys)
        self.inputs = [{key: torch.empty_like(batches[key][i]) for key in self.keys}
                       for i in range(k)]
        self.class_weights = torch.empty_like(class_weights)
        self._load(batches, class_weights)
        main, side = torch.cuda.current_stream(), torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            run(self.inputs[:1], self.class_weights)
        main.wait_stream(side)
        if state is not None:
            state.restore()
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        before = _kernels.launch_counts()
        # thread_local: the prefetch thread goes on copying batches to the
        # card while this thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = run(self.inputs, self.class_weights)
        after = _kernels.launch_counts()
        self.launches = {name: after[name] - before[name] for name in after}
        for k in _kernels.KERNELS:  # the capture recorded these and launched none
            k.launches = before[k.name]
        self.replays = 0

    def _load(self, batches, class_weights) -> None:
        for i, slot in enumerate(self.inputs):
            for key in self.keys:
                slot[key].copy_(batches[key][i])
        self.class_weights.copy_(class_weights)

    def __call__(self, batches, class_weights):
        """Copy the inputs in, replay, and return copies of the outputs (the
        next replay overwrites the graph's own)."""
        self._load(batches, class_weights)
        self.graph.replay()
        self.replays += 1
        if isinstance(self.outputs, dict):
            return {key: v.clone() for key, v in self.outputs.items()}
        return tuple(v.clone() for v in self.outputs)

    def launch_counts(self) -> dict:
        return {name: n * self.replays for name, n in self.launches.items()}


def _shape_key(batches: Dict[str, torch.Tensor], keys: Sequence[str]) -> tuple:
    return tuple((key, tuple(batches[key].shape), batches[key].dtype) for key in keys)


TRAIN_KEYS = ("points", "colors", "labels")
EVAL_KEYS = ("points", "colors", "labels", "mask")


class MultiTrainStep:
    """K full optimizer steps over a stacked batch ({points, colors, labels:
    [K, B, ...]}) in one dispatch (the JAX package's
    ``make_multi_train_step``, loop.py:199-254): K times exactly the body of
    :func:`make_train_step` (:func:`train_step_body`), each followed by the
    EMA update when ``ema`` is given. ``step(batches, lr, class_weights) ->
    {"loss": [K], "acc": [K]}``.

    On a CUDA device a dispatch is one replay of a CUDA graph of the K
    steps (:class:`GraphSteps`, one graph a stacked shape, captured at the
    first dispatch of that shape), so the optimizer must be capturable
    (``make_optimizer(..., capturable=True)``); its lr is filled once a
    dispatch, outside the graph. On the CPU, which a caller asks for, the
    same K steps run eagerly in a loop. ``body`` replaces the single-device
    body (parallel/train_step.py: the data-parallel one)."""

    def __init__(self, model: torch.nn.Module, loss_cfg, optimizer, k: int,
                 ema: Optional[Dict[str, torch.Tensor]] = None, ema_decay: float = 0.0,
                 body: Optional[Callable] = None):
        self.model, self.optimizer, self.k = model, optimizer, k
        self.body = body or train_step_body(model, loss_cfg, optimizer)
        self.ema, self.ema_decay = ema, ema_decay
        self.params = dict(model.named_parameters())
        self.graphs: Dict[tuple, GraphSteps] = {}

    def run(self, slots, class_weights) -> Dict[str, torch.Tensor]:
        metrics = []
        for b in slots:
            metrics.append(self.body(b, class_weights))
            if self.ema is not None:
                ema_update(self.ema, self.params, self.ema_decay)
        return {key: torch.stack([m[key] for m in metrics]) for key in ("loss", "acc")}

    def __call__(self, batches, lr: float, class_weights) -> Dict[str, torch.Tensor]:
        if batches["points"].shape[0] != self.k:
            raise ValueError(f"a stacked batch of {batches['points'].shape[0]}, not {self.k}")
        set_lr(self.optimizer, lr)
        if batches["points"].device.type != "cuda":
            return self.run([{key: batches[key][i] for key in TRAIN_KEYS}
                             for i in range(self.k)], class_weights)
        key = _shape_key(batches, TRAIN_KEYS)
        graph = self.graphs.get(key)
        if graph is None:
            if not all(g.get("capturable") for g in self.optimizer.param_groups):
                raise ValueError("a CUDA graph of train steps needs a capturable optimizer "
                                 "(make_optimizer(..., capturable=True))")
            gens = model_generators(self.model)
            graph = self.graphs[key] = GraphSteps(
                self.run, batches, TRAIN_KEYS, class_weights,
                StepState(self.model, self.optimizer, self.ema, gens), gens)
        return graph(batches, class_weights)

    def launch_counts(self) -> dict:
        """The kernel launches of every replay so far (see GraphSteps)."""
        return _sum_counts(g.launch_counts() for g in self.graphs.values())


class MultiEvalStep:
    """K eval batches over a stacked batch in one dispatch (the JAX
    package's ``make_multi_eval_step``, loop.py:331-348): ``step(batches,
    class_weights, params=None) -> (the K-summed confusion matrix [C, C],
    the stacked losses [K])``, ``eval_step`` of :func:`make_eval_step` K
    times. ``params`` (the EMA weights) are read in place, so a graph
    captured on them sees every later update. On a CUDA device a dispatch is
    one replay of a CUDA graph of the K batches under ``inference_mode``,
    one graph a stacked shape and weight set; on the CPU a loop."""

    def __init__(self, eval_step: Callable, k: int):
        self.eval_step, self.k = eval_step, k
        self.graphs: Dict[tuple, GraphSteps] = {}

    def run(self, slots, class_weights, params=None) -> tuple:
        with torch.inference_mode():
            cm_sum, losses = None, []
            for b in slots:
                cm, loss = self.eval_step(b, class_weights, params)
                cm_sum = cm if cm_sum is None else cm_sum + cm
                losses.append(loss)
            return cm_sum, torch.stack(losses)

    def __call__(self, batches, class_weights,
                 params: Optional[Dict[str, torch.Tensor]] = None) -> tuple:
        if batches["points"].shape[0] != self.k:
            raise ValueError(f"a stacked batch of {batches['points'].shape[0]}, not {self.k}")
        if batches["points"].device.type != "cuda":
            return self.run([{key: batches[key][i] for key in EVAL_KEYS}
                             for i in range(self.k)], class_weights, params)
        key = _shape_key(batches, EVAL_KEYS) + (None if params is None else id(params),)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = GraphSteps(
                lambda slots, cw: self.run(slots, cw, params), batches, EVAL_KEYS,
                class_weights)
        return graph(batches, class_weights)

    def launch_counts(self) -> dict:
        return _sum_counts(g.launch_counts() for g in self.graphs.values())


def _sum_counts(counts) -> dict:
    total = {k.name: 0 for k in _kernels.KERNELS}
    for c in counts:
        for name, n in c.items():
            total[name] += n
    return total


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch as the train and eval steps take it: points and
    colours float32, labels int64, the mask bool (block ids stay behind)."""
    out = {
        "points": torch.from_numpy(np.ascontiguousarray(batch["points"], np.float32)),
        "colors": torch.from_numpy(np.ascontiguousarray(batch["colors"], np.float32)),
        "labels": torch.from_numpy(np.asarray(batch["labels"], np.int64)),
    }
    if "mask" in batch:
        out["mask"] = torch.from_numpy(np.asarray(batch["mask"], bool))
    return {k: v.to(device) for k, v in out.items()}


def mesh_request(config: Config) -> Optional[int]:
    """The mesh's device count that ``config.parallel`` asks for, or None
    for the single-device trainer: ``num_devices`` > 1, or -1 (the world)
    when the initialised process group holds more than one rank
    (loop.py:396-399)."""
    ndev = int(config.parallel.num_devices)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if ndev > 1 or (ndev == -1 and world > 1):
        return world if ndev == -1 else ndev
    return None


def resolve_device(name: str) -> torch.device:
    """"auto" and "cuda" mean the first CUDA device, which must exist;
    "cpu" is for tests. A missing card is an error, never a silent CPU run."""
    if name == "auto":
        name = "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{name}': no CUDA device (torch.cuda.is_available() is False)"
        )
    return dev


def _check_dispatch(config: Config) -> None:
    tcfg = config.train
    if int(getattr(tcfg, "steps_per_dispatch", 1)) > 1 and int(getattr(tcfg, "accum_steps", 1)) > 1:
        # as the JAX trainer (loop.py:404-406)
        raise ValueError("steps_per_dispatch and accum_steps are mutually exclusive")


def train(
    config: Config,
    train_ds,
    val_ds=None,
    exp_dir: Optional[str] = None,
    model: Optional[torch.nn.Module] = None,
    resume: bool = False,
) -> Dict[str, Any]:
    """Full training run on ``config.device`` ("auto" = CUDA), or on a
    mesh of ranks when ``config.parallel`` asks for one (every rank calls
    ``train`` with the same arguments; rank 0 alone logs and writes the
    checkpoints, in the single-device layout). Returns
    {history, state, best_val_acc, exp_dir, model, class_weights,
    graph_launches};
    ``state`` holds the model's and the optimizer's state_dicts and the
    last epoch.

    resume=True continues from ``exp_dir/latest_checkpoint``, or else warm
    starts from ``exp_dir/best_model``; the epoch counter continues from the
    stored epoch. A weights-only checkpoint (no ``optimizer``) is a warm
    start with a fresh optimizer from epoch 1 (loop.py:476-526).
    """
    tcfg, mcfg = config.train, config.model
    _check_dispatch(config)
    engine = None
    ndev = mesh_request(config)
    if ndev is not None:
        from ..parallel.engine import MeshEngine
        from ..parallel.train_step import rank_seed

        engine = MeshEngine(config, ndev)
        device = engine.device
    else:
        device = resolve_device(config.device)
    main = engine is None or engine.is_main
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if exp_dir is None:
        ts = time.strftime("%m%d%H%M")
        exp_dir = os.path.join(config.exp_dir_root, f"exp_{ts}_{config.case}")
    if main:
        os.makedirs(exp_dir, exist_ok=True)
        logger = initialize_logger(exp_dir)
        writer = ScalarWriter(exp_dir)
        snapshot_code(exp_dir)
    else:
        logger, writer = logging.getLogger("pcb.rank"), None
        logger.addHandler(logging.NullHandler())
        logger.propagate = False

    # the mesh's BatchNorms take the whole batch's statistics: dp and sp as
    # the JAX trainer sets axis_name; tp, fsdp and ep too, since each rank
    # sees its rows alone where GSPMD's single program saw them all
    # (parallel/fsdp.py); sp also names the model's sp_axis
    axes = {} if engine is None else engine.model_axes()
    if model is None:
        gen = torch.Generator().manual_seed(tcfg.seed)
        model = get_model(mcfg.name, mcfg.num_classes, generator=gen, **dict(mcfg.extra, **axes))
    elif "sp_axis" in axes:
        raise ValueError("parallel.mode=sp builds its model itself (with sp_axis): pass none")
    elif axes:
        sync_batchnorms(model, axes["axis_name"])
    if engine is not None:
        engine.check_model(model)
    model.to(device)
    seed = tcfg.seed if engine is None else rank_seed(tcfg.seed, engine.data_rank)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = dropout_gen
    spd = max(1, int(getattr(tcfg, "steps_per_dispatch", 1)))
    # the multi-step path on the card replays CUDA graphs of the optimizer
    capturable = spd > 1 and device.type == "cuda"
    optimizer = make_optimizer(model.parameters(), tcfg.weight_decay, capturable)

    start_epoch = 1
    if resume:
        ckpt_path = os.path.join(exp_dir, "latest_checkpoint")
        if not os.path.exists(ckpt_path):
            ckpt_path = os.path.join(exp_dir, "best_model")
        if os.path.exists(ckpt_path):
            # decided by the stored keys, never by a failed restore: a real
            # mismatch raises (strict load, optimizer groups)
            ckpt = restore_checkpoint(ckpt_path, map_location=device)
            model.load_state_dict(ckpt["model"], strict=True)
            if "optimizer" in ckpt:
                optimizer.load_state_dict(ckpt["optimizer"])
                for group in optimizer.param_groups:  # the stored run's flag
                    group["capturable"] = capturable
                start_epoch = int(ckpt.get("epoch", 0)) + 1
                logger.info(f"resumed from {ckpt_path} at epoch {start_epoch}")
            else:
                logger.info(
                    f"warm start from {ckpt_path} (weights only; fresh optimizer state)"
                )

    params = dict(model.named_parameters())
    ema = None
    if getattr(tcfg, "ema_decay", 0.0) > 0.0:
        d = float(tcfg.ema_decay)
        ema = {k: p.detach().clone() for k, p in params.items()}
        ema_path = os.path.join(exp_dir, "latest_ema")
        if start_epoch > 1 and os.path.exists(ema_path):
            stored = restore_checkpoint(ema_path, map_location=device)["model"]
            ema = {k: stored[k].clone() for k in ema}
            logger.info("resumed EMA params")
    n_params = sum(p.numel() for p in params.values())
    logger.info(
        f"model={mcfg.name} params={n_params:,} classes={mcfg.num_classes} "
        f"blocks={len(train_ds)} batch={tcfg.batch_size} device={device}"
    )

    counts = train_ds.label_counts(mcfg.num_classes)
    class_weights = L.class_weights_from_counts(counts).to(device)
    logger.info(f"class weights: {class_weights.cpu().numpy()}")

    multi_step = multi_eval = None
    if engine is not None:
        steps = engine.build(model, config.loss, optimizer, mcfg.num_classes, spd, ema,
                             d if ema is not None else 0.0)
        train_step, eval_step, ema = steps["train_step"], steps["eval_step"], steps["ema"]
        multi_step, multi_eval = steps["multi_step"], steps["multi_eval"]
        params = dict(model.named_parameters())  # fsdp's are new (DTensor) ones
        put_batch = engine.put_batch
        logger.info(engine.describe())
    else:
        train_step = make_train_step(model, config.loss, optimizer,
                                     max(1, int(getattr(tcfg, "accum_steps", 1))))
        eval_step = make_eval_step(model, mcfg.num_classes)
        if spd > 1:
            multi_step = MultiTrainStep(model, config.loss, optimizer, spd, ema,
                                        d if ema is not None else 0.0)
            multi_eval = MultiEvalStep(eval_step, spd)

        def put_batch(b):
            return batch_to_device(b, device)

    if multi_step is not None:
        logger.info(f"multi-step dispatch: {spd} steps per graph replay" if capturable else
                    f"multi-step dispatch: {spd} steps per dispatch (eager, on the CPU)")

    def state_for_checkpoint():
        """The model's, the optimizer's and the EMA's state in the
        single-device layout (on a mesh a collective: every rank calls it)."""
        if engine is None:
            return model.state_dict(), optimizer.state_dict(), ema
        return (engine.full_model_state(model), engine.full_optimizer_state(model, optimizer),
                None if ema is None else engine.full_tensors(model, ema))

    plateau = ReduceLROnPlateau(
        lr=tcfg.learning_rate, factor=tcfg.plateau_factor,
        patience=tcfg.plateau_patience, min_lr=tcfg.min_lr,
    )
    lr = tcfg.learning_rate
    best_val_acc = -1.0
    history = []
    epoch = start_epoch - 1

    for epoch in range(start_epoch, tcfg.num_epochs + 1):
        if tcfg.scheduler == "cosine":
            lr = cosine_lr(tcfg.learning_rate, epoch - 1, tcfg.num_epochs)
        elif tcfg.scheduler == "step":
            lr = step_decay_lr(
                tcfg.learning_rate, epoch - 1, tcfg.step_decay, tcfg.step_every, tcfg.min_lr
            )
        # warmup scales whatever the scheduler chose; lr itself stays, so the
        # plateau state does not compound the factor across epochs
        eff_lr = lr
        wu = getattr(tcfg, "warmup_epochs", 0)
        if wu > 0 and epoch <= wu:
            eff_lr = lr * epoch / wu

        t0 = time.time()
        step_metrics = []
        batch_iter = train_ds.batches(tcfg.batch_size, shuffle=True, seed=tcfg.seed, epoch=epoch)
        if multi_step is not None:
            # K host batches stacked: one copy to the card and one dispatch;
            # the ragged epoch tail passes through as single steps
            batch_iter = group_batches(batch_iter, spd)
        for batch in prefetch_to_device(batch_iter, put_batch, tcfg.prefetch):
            if multi_step is not None and batch["points"].ndim == 4:
                step_metrics.append(multi_step(batch, eff_lr, class_weights))
                continue
            step_metrics.append(train_step(batch, eff_lr, class_weights))
            if ema is not None:
                ema_update(ema, params, d)
        if step_metrics:
            # [steps, 2], a multi-step dispatch giving K rows; one fetch per epoch
            fetched = torch.cat(
                [torch.stack([m["loss"].reshape(-1), m["acc"].reshape(-1)], 1)
                 for m in step_metrics]
            ).cpu().numpy()
            tr_loss, tr_acc = (float(v) for v in fetched.mean(0))
        else:
            tr_loss = tr_acc = 0.0
        row = {
            "epoch": epoch,
            "lr": eff_lr,
            "train_loss": tr_loss,
            "train_acc": tr_acc,
            "epoch_time_s": time.time() - t0,
        }

        # validate (and keep the best) with the deployed weights: the EMA
        # weights when enabled
        if val_ds is not None and len(val_ds) > 0:
            cms, losses = [], []
            val_iter = val_ds.batches(tcfg.batch_size, shuffle=False, drop_last=False)
            if multi_eval is not None:
                val_iter = group_batches(val_iter, spd)
            for batch in prefetch_to_device(val_iter, put_batch, tcfg.prefetch):
                if multi_eval is not None and batch["points"].ndim == 4:
                    cm, loss = multi_eval(batch, class_weights, ema)  # K-summed, [K]
                else:
                    cm, loss = eval_step(batch, class_weights, ema)
                cms.append(cm)
                losses.append(loss.reshape(-1))
            vb = sum(len(x) for x in losses)  # eval batches, not dispatches
            if vb:
                cm_total = torch.stack(cms).sum(0).cpu().numpy()
                val_loss = float(torch.cat(losses).sum().cpu())
            else:
                cm_total = np.zeros((mcfg.num_classes, mcfg.num_classes))
                val_loss = 0.0
            mets = M.metrics_from_confusion(cm_total)
            val_acc = mets["OA"]
            row.update(val_loss=val_loss / max(vb, 1), val_acc=val_acc,
                       val_miou=mets["mIoU"], val_macc=mets["mAcc"])
            for c, a in enumerate(mets["Acc_per_class"]):
                row[f"class_{c}_acc"] = float(a)
            if tcfg.scheduler == "plateau":
                lr = plateau.step(val_acc)
            if val_acc > best_val_acc:
                best_val_acc = val_acc
                model_sd, opt_sd, ema_sd = state_for_checkpoint()
                best = model_sd if ema_sd is None else {**model_sd, **ema_sd}
                if main:
                    save_checkpoint(
                        os.path.join(exp_dir, "best_model"),
                        {"model": best, "optimizer": opt_sd,
                         "epoch": epoch, "val_acc": float(val_acc)},
                    )

        model_sd, opt_sd, ema_sd = state_for_checkpoint()
        if main:
            save_checkpoint(
                os.path.join(exp_dir, "latest_checkpoint"),
                {"model": model_sd, "optimizer": opt_sd, "epoch": epoch},
            )
            if ema_sd is not None:  # raw weights above, EMA beside: exact resume
                save_checkpoint(os.path.join(exp_dir, "latest_ema"), {"model": ema_sd})
            writer.write(epoch, {k: v for k, v in row.items() if k != "epoch"})
        history.append(row)
        logger.info(" ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()
        ))

    if main:
        writer.close()
    model_sd, opt_sd, _ = state_for_checkpoint()
    return {
        "history": history,
        "state": {"model": model_sd, "optimizer": opt_sd, "epoch": epoch},
        "best_val_acc": best_val_acc,
        "exp_dir": exp_dir,
        "model": model,
        "class_weights": class_weights,
        # the kernel launches of the CUDA graphs' replays (GraphSteps), which
        # the launch counters do not see; None without multi-step dispatch
        "graph_launches": None if multi_step is None else _sum_counts(
            [multi_step.launch_counts(), multi_eval.launch_counts()]),
    }
