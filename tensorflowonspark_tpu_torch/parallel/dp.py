"""Synchronous training on one GPU (port of the JAX package's
``parallel/dp.py``: ``TrainState`` and ``SyncTrainer``).

The reference jits one train step over a device mesh and donates the
old state to it.  Here the step runs eagerly on the device the
parameters live on.  ``state.params`` maps names to the model's own
parameter tensors (``dict(model.named_parameters())``), and the
optimizer updates them and its moments in place: this replaces the
donated state, so no second copy of the weights or the moments is made,
and the model holds the trained weights after every step.  Metrics stay
device tensors: no step synchronises with the host.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: data parallelism over several GPUs (``mesh``, ``rules``,
``annotations``), model state (``has_model_state``), on-device
preprocessing (``device_preprocess``) and the feed loop
(``train_on_feed``).
"""

import numpy as np
import torch


def _not_ported(what, item):
    return NotImplementedError(
        "{0} is not ported to the PyTorch package yet (ROADMAP queue A: "
        "{1})".format(what, item)
    )


_DP = "multi-GPU DP over torch.distributed"
_FEED = "train_on_feed with the DataFeed plane"


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
            raise _not_ported("SyncTrainer device_preprocess=", _FEED)
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
        """A host batch (dict of arrays) as device tensors."""
        return {
            name: torch.as_tensor(np.asarray(x)).to(self.device)
            for name, x in batch.items()
        }

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
        """K steps over a host ``[K, ...]`` stack, placed on the device
        once.  Returns ``(state, metrics)`` with metrics stacked ``[K]``."""
        return self.multi_step_on_device(state, self._place(stacked_batch),
                                         rngs)

    def multi_step_on_device(self, state, device_stacked, rngs=None):
        """K steps over a device-resident ``[K, ...]`` stack in one
        Python loop with no host synchronisation inside (the reference
        fuses them with ``lax.scan``); metrics stacked ``[K]``."""
        k = len(next(iter(device_stacked.values())))
        history = []
        for i in range(k):
            batch = {name: x[i] for name, x in device_stacked.items()}
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

    def train_on_feed(self, state, feed, batch_size, **kwargs):
        raise _not_ported("SyncTrainer.train_on_feed", _FEED)
