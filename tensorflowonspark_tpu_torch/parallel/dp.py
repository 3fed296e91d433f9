"""Synchronous training (port of the JAX package's ``parallel/dp.py``:
``TrainState``, ``SyncTrainer`` and its feed loop).

The reference jits one train step over a device mesh and donates the
old state to it.  Here the step runs eagerly on the device the
parameters live on.  ``state.params`` maps names to the model's own
parameter tensors (``dict(model.named_parameters())``), and the
optimizer updates them and its moments in place: this replaces the
donated state, so no second copy of the weights or the moments is made,
and the model holds the trained weights after every step.  Metrics stay
device tensors: no step synchronises with the host.

:meth:`SyncTrainer.train_on_feed` is the feed-driven loop of
``InputMode.SPARK``: it pulls batches from a
:class:`~..data.feed.DataFeed` and stops globally when any process runs
dry (:func:`all_hosts_ready` reduces a has-data flag over a ``gloo``
group on the CPU, so the flag never waits for the device).

``device_preprocess`` (a callable or a
:func:`~..data.preprocess.make_preprocess` kwargs dict) runs at the top
of every step on the device batch, so a narrow wire dtype (uint8,
uint16) crosses the host-to-device link narrow and widens on the card.

Several processes (one GPU each): the reference's default mesh puts
every device on ``data``, so under an initialised process group of more
than one rank every step averages the gradients over the ranks, and
:meth:`SyncTrainer.create_state` starts every rank from rank 0's
weights.  With ``mesh=`` (a :class:`..parallel.mesh.Mesh`) each rank's
loss is its share of the global loss: the gradients (and the reported
loss) are summed over the mesh's other axes (``seq``: each rank's loss
covers its slice of the sequence) and averaged over its ``data_axes``.
Either way it is one coalesced all-reduce after the backward, on the
default group's backend (NCCL on GPUs, gloo on the CPU), so every rank
applies the same update and reports the same loss.

``train_on_feed(checkpointer=)`` is the resume hook: at entry it
restores the checkpointer's latest step into the state and counts on
from it; every ``checkpoint_every`` steps, and at exit, it saves
durably and then commits the feed's partitions.

Model state (``has_model_state=True``, the BatchNorm models): the loss
takes and returns the non-trained collections, ``loss_fn(params,
model_state, batch, rng) -> (loss, (aux, new_model_state))``, and the
step writes the new state into the state's tensors in place (the
model's buffers, when the state was built from them).  Under a process
group the loss runs inside :func:`..models.layers.batch_stats_group` of
the data group, so BatchNorm statistics are the global batch's, as in
the reference's one program over the sharded batch.

Not ported yet, raising ``NotImplementedError`` that names its ROADMAP
item: sharded parameters (``rules``, ``annotations``).
"""

import logging
from collections.abc import Mapping

import numpy as np
import torch

from ..data import preprocess as pp_mod
from ..data.feed import place_tree
from ..models.layers import batch_stats_group
from . import mesh as mesh_mod
from ..utils import not_ported as _not_ported
from ..utils.tree import leaves as _leaves
from ..utils.tree import tree_map as _tree_map


_DP = "multi-GPU DP over torch.distributed"

logger = logging.getLogger(__name__)


class TrainState(object):
    """``(step, params, opt_state, model_state)``, as the reference's.

    ``step`` is an int64 device scalar, ``params`` a ``{name: tensor}``
    dict, ``opt_state`` the optimizer's state (a ``torch.optim``
    optimizer over ``params``); ``model_state`` a nested dict of tensors
    (``{"batch_stats": {buffer name: tensor}}``), ``{}`` for models
    without one.
    """

    def __init__(self, step, params, opt_state, model_state=None):
        self.step = step
        self.params = params
        self.opt_state = opt_state
        self.model_state = {} if model_state is None else model_state

    def replace(self, **kw):
        return TrainState(
            kw.get("step", self.step),
            kw.get("params", self.params),
            kw.get("opt_state", self.opt_state),
            kw.get("model_state", self.model_state),
        )


class SyncTrainer(object):
    """Runs the synchronous train step.

    Args:
      loss_fn: ``loss_fn(params, batch, rng) -> loss`` or ``-> (loss,
        aux_dict)`` (with ``has_aux=True``), e.g.
        :func:`~..models.transformer.loss_fn`; with
        ``has_model_state=True``, ``loss_fn(params, model_state, batch,
        rng) -> (loss, (aux_dict, new_model_state))`` (e.g.
        :func:`~..models.resnet.loss_fn`).
      optimizer: an :class:`~..optim.Optimizer` (``optim.adam``,
        ``optim.adamw``, ``optim.sgd``).
      device_preprocess: a callable ``fn(batch)`` (or ``fn(batch,
        rng)``, which receives the step's generator) or a
        ``make_preprocess`` kwargs dict, applied to the device batch at
        the top of every step.
      mesh: ``None`` (every rank of an initialised process group on
        ``data``) or a :class:`..parallel.mesh.Mesh` from
        :func:`..parallel.mesh.build_mesh`.
      data_axes: the mesh axes the batch is split over; gradients are
        averaged over them and summed over the mesh's other axes.
      rules, annotations: the reference's; only their defaults are
        ported.
    """

    def __init__(self, loss_fn, optimizer, mesh=None, rules=None,
                 annotations=None, has_aux=False, has_model_state=False,
                 data_axes=("data", "fsdp"), device_preprocess=None):
        for name, val in (("rules", rules), ("annotations", annotations)):
            if val is not None:
                raise _not_ported("SyncTrainer {0}=".format(name), _DP)
        if mesh is not None and not isinstance(mesh, mesh_mod.Mesh):
            raise TypeError(
                "mesh must be a tensorflowonspark_tpu_torch.parallel.mesh."
                "Mesh (build_mesh), got {0!r}".format(type(mesh).__name__)
            )
        self.mesh = mesh
        self.has_model_state = bool(has_model_state)
        self.device_preprocess = pp_mod.resolve_preprocess(
            device_preprocess)
        self._pre_takes_rng = (self.device_preprocess is not None
                               and pp_mod.takes_rng(self.device_preprocess))
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.has_aux = has_aux
        self.data_axes = data_axes
        self.device = None
        # (process group, data-parallel width) of the gradient reduction
        # and the group of the BatchNorm statistics; set by create_state
        self._reduce = (None, 1)
        self._stats_group = None

    # -- state ---------------------------------------------------------

    def create_state(self, params, model_state=None):
        """The state over ``params`` (``{name: tensor}``, all on one
        device, which the trainer then runs on) and ``model_state`` (a
        nested dict of tensors on that device, e.g. ``{"batch_stats":
        dict(model.named_buffers())}``).  The tensors are used as they
        are, not copied; under a process group every rank starts from
        the first rank's."""
        params = dict(params)
        devices = {p.device for p in params.values()}
        if len(devices) != 1:
            raise ValueError(
                "parameters must live on one device, got {0}".format(
                    sorted(str(d) for d in devices))
            )
        self.device = devices.pop()
        model_state = {} if model_state is None else model_state
        if any(t.device != self.device for t in _leaves(model_state)):
            raise ValueError("model state must live on the parameters' "
                             "device {0}".format(self.device))
        self._reduce, src = self._reduction()
        self._stats_group = self._data_group()
        if self._reduce[0] is not None:
            import torch.distributed as dist

            # every rank starts from the first rank's weights and state
            with torch.no_grad():
                for p in list(params.values()) + _leaves(model_state):
                    dist.broadcast(p, src, group=self._reduce[0])
        opt_state = self.optimizer.init(params)
        step = torch.zeros((), dtype=torch.int64, device=self.device)
        return TrainState(step, params, opt_state, model_state)

    def _reduction(self):
        """``((group, data width), broadcast source)`` of the gradient
        reduction: ``group`` is ``None`` when there is one rank."""
        if self.mesh is not None:
            if self.mesh.world_group is None:
                return (None, 1), 0
            width = mesh_mod.mesh_axis_size(self.mesh, *self.data_axes)
            return (self.mesh.world_group, width), self.mesh.ranks[0]
        import torch.distributed as dist

        if (not dist.is_available() or not dist.is_initialized()
                or dist.get_world_size() == 1):
            return (None, 1), 0
        return (dist.group.WORLD, dist.get_world_size()), 0

    def _data_group(self):
        """The process group the batch is split over (``None``: one
        rank): BatchNorm reduces its statistics over it."""
        group = self._reduce[0]
        if group is None or self.mesh is None:
            return group
        axes = [a for a in self.data_axes if a in self.mesh.axis_names
                and self.mesh.axis_size(a) > 1]
        if len(axes) > 1:
            raise _not_ported("model state over several data axes {0}"
                              .format(axes), _DP)
        return self.mesh.group(axes[0]) if axes else None

    def _all_reduce(self, grads, scalars):
        """Gradients and scalar metrics summed over the reduction group
        and divided by the data-parallel width, in one f32 all-reduce."""
        import torch.distributed as dist

        group, width = self._reduce
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [s.detach().reshape(1).float() for s in scalars])
        dist.all_reduce(flat, group=group)
        flat.mul_(1.0 / width)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        return out, list(flat[at:].unbind())

    # -- steps ---------------------------------------------------------

    def _place(self, batch):
        """A host batch (a dict, tuple or list of arrays, nested, or one
        array) as device tensors, leaf by leaf: on a GPU through pinned
        memory without waiting for the device (:func:`place_tree`)."""
        return place_tree(batch, self.device)

    def _train_step(self, state, batch, rng):
        pre = self.device_preprocess
        if pre is not None:
            batch = pre(batch, rng) if self._pre_takes_rng else pre(batch)
        params = state.params
        new_state = None
        if self.has_model_state:
            with batch_stats_group(self._stats_group):
                loss, (aux, new_state) = self.loss_fn(
                    params, state.model_state, batch, rng)
        else:
            out = self.loss_fn(params, batch, rng)
            loss, aux = out if self.has_aux else (out, {})
        grads = torch.autograd.grad(loss, list(params.values()))
        # detached: a metric keeps no autograd graph alive across steps
        metrics = {name: torch.as_tensor(v).detach()
                   for name, v in aux.items()}
        metrics["loss"] = loss.detach()
        if self._reduce[0] is not None:
            names = [n for n, v in metrics.items()
                     if v.numel() == 1 and v.is_floating_point()]
            grads, values = self._all_reduce(
                grads, [metrics[n] for n in names])
            metrics.update(zip(names, values))
        # in place: parameters and moments are the long-lived state
        self.optimizer.update(state.opt_state, params, grads)
        state = state.replace(step=state.step + 1)
        if new_state is not None:
            state = state.replace(
                model_state=_carry(state.model_state, new_state))
        return state, metrics

    def step(self, state, batch, rng=None):
        """One synchronous step on a host batch (placed here)."""
        return self._train_step(state, self._place(batch), rng)

    def step_on_device(self, state, device_batch, rng=None):
        """One step on an already device-resident batch."""
        return self._train_step(state, device_batch, rng)

    def multi_step(self, state, stacked_batch, rngs=None):
        """K steps over a host ``[K, ...]`` stack (any pytree of arrays),
        placed on the device once.  Returns ``(state, metrics)`` with
        metrics stacked ``[K]``."""
        return self.multi_step_on_device(state, self._place(stacked_batch),
                                         rngs)

    def multi_step_on_device(self, state, device_stacked, rngs=None):
        """K steps over a device-resident ``[K, ...]`` stack in one
        Python loop with no host synchronisation inside (the reference
        fuses them with ``lax.scan``); metrics stacked ``[K]``."""
        k = len(_leaves(device_stacked)[0])
        history = []
        for i in range(k):
            batch = _tree_map(lambda x: x[i], device_stacked)
            state, metrics = self._train_step(
                state, batch, None if rngs is None else rngs[i])
            history.append(metrics)
        return state, {
            name: torch.stack([torch.as_tensor(m[name]) for m in history])
            for name in history[0]
        }

    def batch_sharding(self):
        """Where a host batch should be placed for :meth:`step_on_device`:
        the trainer's device."""
        return self.device

    def eval_step(self, state, batch, apply_fn):
        """``apply_fn(params, device_batch)`` without gradients."""
        with torch.no_grad():
            return apply_fn(state.params, self._place(batch))

    # -- feed-driven training (InputMode.SPARK) ------------------------

    def train_on_feed(self, state, feed, batch_size, preprocess=None,
                      rng=None, max_steps=None, log_every=100,
                      steps_per_execution=1, metrics_callback=None,
                      columnar=False, terminate_on_max_steps=True,
                      checkpointer=None, checkpoint_every=0,
                      step_callback=None):
        """Run the synchronized feed loop: pull batches from a
        :class:`~..data.feed.DataFeed` and stop globally when any
        process runs dry.

        Args:
          preprocess: ``fn(batch) -> batch pytree``; in row mode
            ``batch`` is the list of rows, in columnar mode the
            stacked-columns pytree from ``feed.next_arrays``.
          rng: a ``torch.Generator`` (or ``None``) handed to every step.
          max_steps: stop after this many steps of this call.
          log_every: log the loss every this many steps when INFO
            logging is on (the log line reads the loss on the host).
          steps_per_execution: collect up to this many globally ready
            batches, stack them on the host and run them through
            :meth:`multi_step_on_device` after one placement.
          metrics_callback: ``fn(step, metrics)`` after each group, with
            the device-resident metrics of its last step.
          columnar: consume via ``feed.next_arrays`` (fixed-shape
            numeric rows); default False takes any row via
            ``feed.next_batch``.
          terminate_on_max_steps: when the step cap ends training with
            data in flight, terminate the feed so the feeders' joins
            return; pass False to resume from the same feed later.
          checkpointer: a :class:`~..checkpoint.Checkpointer`, the resume
            hook.  At entry, when it holds a step, ``state`` is restored
            from the latest one and the step count goes on from it (so
            ``max_steps`` caps the total); every ``checkpoint_every``
            steps and at exit the state is saved with ``wait=True`` and
            then ``feed.commit_partitions()`` is called (at exit also
            when that step was already saved).
          checkpoint_every: step spacing of the periodic saves (0: only
            the final save).
          step_callback: ``fn(step)`` before each executed group.

        Returns the final state.
        """
        if steps_per_execution < 1:
            raise ValueError("steps_per_execution must be >= 1, got "
                             "{0}".format(steps_per_execution))
        steps = 0
        if checkpointer is not None and checkpointer.latest_step() is not None:
            state = checkpointer.restore(state)
            steps = int(state.step)  # one host read, before the loop
            logger.info("resumed from checkpoint at step %d", steps)
        stop = False
        while not stop:
            if max_steps is not None and steps >= max_steps:
                break
            limit = steps_per_execution
            if max_steps is not None:
                limit = min(limit, max_steps - steps)
            group, stop = collect_ready_group(
                feed, batch_size, limit, columnar=bool(columnar),
                preprocess=preprocess)
            if stop:
                logger.info("global stop after %d steps", steps)
            if not group:
                break
            if step_callback is not None:
                step_callback(steps)
            if len(group) == 1:
                state, metrics = self.step_on_device(
                    state, self._place(group[0]), rng)
            else:
                stacked = _tree_map(lambda *xs: np.stack(xs), *group)
                state, metrics = self.multi_step_on_device(
                    state, self._place(stacked), [rng] * len(group))
                metrics = {name: m[-1] for name, m in metrics.items()}
            steps += len(group)
            if metrics_callback is not None:
                metrics_callback(steps, metrics)
            if (checkpointer is not None and checkpoint_every
                    and steps % checkpoint_every < len(group)):
                # durable before the commit: a committed partition must
                # not be lost to a crash between the two
                checkpointer.save(steps, state, wait=True)
                feed.commit_partitions()
            if (log_every and steps % log_every < len(group)
                    and logger.isEnabledFor(logging.INFO)):
                logger.info("step %d loss %.4f", steps,
                            float(metrics["loss"]))
        if (terminate_on_max_steps and max_steps is not None
                and steps >= max_steps and not feed.should_stop()):
            # a step cap ended training with data in flight: drain it and
            # mark the node 'terminating' so feeders stop waiting
            logger.info("max_steps reached; terminating the feed")
            feed.terminate()
        if checkpointer is not None:
            if checkpointer.latest_step() != steps:
                # the final save, unless this step is already on disk (a
                # periodic save, or a resumed run that made no progress)
                checkpointer.save(steps, state, wait=True)
            # the last commit, also when the final save was skipped: a
            # partition whose feeder delivered it after the last periodic
            # commit was consumed by the steps this durable state holds
            # (the reference commits only after a final save, and leaves
            # it delivered: ROADMAP C4)
            feed.commit_partitions()
        return state


def _carry(old, new):
    """The new model state, written into the old state's tensors in place
    where a leaf keeps its shape and type (so a model whose buffers are
    the state holds the new statistics), taken as it is elsewhere."""
    if isinstance(new, Mapping):
        old = old if isinstance(old, Mapping) else {}
        return {k: _carry(old.get(k), v) for k, v in new.items()}
    if (isinstance(old, torch.Tensor) and isinstance(new, torch.Tensor)
            and old.shape == new.shape and old.dtype == new.dtype):
        with torch.no_grad():
            old.copy_(new)
        return old
    return new


def collect_ready_group(feed, batch_size, limit, columnar=False,
                        preprocess=None):
    """Up to ``limit`` globally ready batches from a feed.

    The per-batch all-hosts agreement keeps the collected count the same
    in every process, so none enters a collective alone (a batch a ready
    process pulled in the failing round is dropped).  Returns ``(group,
    stopped)``: the ready batches (preprocessed or default-stacked) and
    whether the global stop fired.
    """
    group = []
    stopped = False
    for _ in range(limit):
        if columnar:
            batch, n = feed.next_arrays(batch_size)
            have = n == batch_size and not feed.should_stop()
        else:
            rows = feed.next_batch(batch_size)
            have = (bool(rows) and len(rows) == batch_size
                    and not feed.should_stop())
        if not all_hosts_ready(have):
            if have:
                logger.info("dropping one ready batch at global stop")
            stopped = True
            break
        if columnar:
            group.append(preprocess(batch) if preprocess else batch)
        else:
            group.append(preprocess(rows) if preprocess
                         else _default_batch(rows))
    return group, stopped


def _default_batch(rows):
    first = rows[0]
    if isinstance(first, dict):
        return {k: np.asarray([r[k] for r in rows]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.asarray(c) for c in zip(*rows))
    return np.asarray(rows)


#: the ``gloo`` group of the global-stop flag when the default group is
#: not ``gloo`` (``NodeContext.initialize_distributed`` sets it beside
#: an NCCL group)
_HOST_GROUP = [None]


def set_host_group(group):
    """Use ``group`` (a ``gloo`` process group) for :func:`all_hosts_ready`;
    ``None`` means the default group, which must then be ``gloo``."""
    _HOST_GROUP[0] = group


def host_group():
    """The group of :func:`all_hosts_ready` and the checkpoint barriers
    (``None``: the default group)."""
    return _HOST_GROUP[0]


def all_hosts_ready(local_flag):
    """AND-reduce a boolean across all ``torch.distributed`` processes.

    One process (or no process group) returns the flag itself.
    Otherwise the flag is a CPU tensor reduced over a ``gloo`` group:
    reading a flag reduced over NCCL would wait for the device, and the
    queued steps would stop overlapping the next group's feed.
    """
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        return bool(local_flag)
    flag = torch.tensor([1 if local_flag else 0], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=_HOST_GROUP[0])
    return bool(flag.item())
