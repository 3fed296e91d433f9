"""Synchronous training on one GPU (port of the JAX package's
``parallel/dp.py``: ``TrainState``, ``SyncTrainer`` and its feed loop).

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

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: data parallelism over several GPUs (``mesh``, ``rules``,
``annotations``), model state (``has_model_state``), on-device
preprocessing (``device_preprocess``) and checkpoint hooks
(``train_on_feed(checkpointer=...)``).
"""

import logging

import numpy as np
import torch

from ..utils import not_ported as _not_ported


_DP = "multi-GPU DP over torch.distributed"
_PREPROCESS = "device_preprocess and the shm ring"
_CKPT = "Checkpointing"

logger = logging.getLogger(__name__)


class TrainState(object):
    """``(step, params, opt_state, model_state)``, as the reference's.

    ``step`` is an int64 device scalar, ``params`` a ``{name: tensor}``
    dict, ``opt_state`` the optimizer's state (a ``torch.optim``
    optimizer over ``params``); ``model_state`` is always ``{}`` here.
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
        :func:`~..models.transformer.loss_fn`.
      optimizer: an :class:`~..optim.Optimizer` (``optim.adamw``,
        ``optim.sgd``).
      mesh, rules, annotations, has_model_state, device_preprocess: the
        reference's; only their defaults are ported.
      data_axes: kept for the reference's signature.
    """

    def __init__(self, loss_fn, optimizer, mesh=None, rules=None,
                 annotations=None, has_aux=False, has_model_state=False,
                 data_axes=("data", "fsdp"), device_preprocess=None):
        for name, val in (("mesh", mesh), ("rules", rules),
                          ("annotations", annotations)):
            if val is not None:
                raise _not_ported("SyncTrainer {0}=".format(name), _DP)
        if has_model_state:
            raise _not_ported(
                "SyncTrainer has_model_state=True", "model state "
                "(BatchNorm models: ResNet/UNet)"
            )
        if device_preprocess is not None:
            raise _not_ported("SyncTrainer device_preprocess=",
                              _PREPROCESS)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.has_aux = has_aux
        self.data_axes = data_axes
        self.device = None

    # -- state ---------------------------------------------------------

    def create_state(self, params, model_state=None):
        """The state over ``params`` (``{name: tensor}``, all on one
        device, which the trainer then runs on).  The tensors are used
        as they are, not copied."""
        if model_state:
            raise _not_ported(
                "model_state", "model state (BatchNorm models: ResNet/UNet)"
            )
        params = dict(params)
        devices = {p.device for p in params.values()}
        if len(devices) != 1:
            raise ValueError(
                "parameters must live on one device, got {0}".format(
                    sorted(str(d) for d in devices))
            )
        self.device = devices.pop()
        opt_state = self.optimizer.init(params)
        step = torch.zeros((), dtype=torch.int64, device=self.device)
        return TrainState(step, params, opt_state)

    # -- steps ---------------------------------------------------------

    def _place(self, batch):
        """A host batch (a dict, tuple or list of arrays, nested, or one
        array) as device tensors, leaf by leaf."""
        return _tree_map(
            lambda x: torch.as_tensor(np.asarray(x)).to(self.device), batch)

    def _train_step(self, state, batch, rng):
        params = state.params
        out = self.loss_fn(params, batch, rng)
        loss, aux = out if self.has_aux else (out, {})
        grads = torch.autograd.grad(loss, list(params.values()))
        # in place: parameters and moments are the long-lived state
        self.optimizer.update(state.opt_state, params, grads)
        # detached: a metric keeps no autograd graph alive across steps
        metrics = {name: torch.as_tensor(v).detach()
                   for name, v in aux.items()}
        metrics["loss"] = loss.detach()
        return state.replace(step=state.step + 1), metrics

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
          checkpointer, checkpoint_every: not ported (Checkpointing).
          step_callback: ``fn(step)`` before each executed group.

        Returns the final state.
        """
        if checkpointer is not None or checkpoint_every:
            raise _not_ported("train_on_feed checkpointer=", _CKPT)
        if steps_per_execution < 1:
            raise ValueError("steps_per_execution must be >= 1, got "
                             "{0}".format(steps_per_execution))
        steps = 0
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
        return state


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


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dicts, tuples and lists (nested), with
    ``rest`` trees of the same structure as further arguments."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
