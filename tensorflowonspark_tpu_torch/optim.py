"""Optimizers with optax's signatures, defaults and update rules (the
port's counterpart of the ``optax.adam`` / ``optax.adamw`` /
``optax.sgd`` and ``optax.piecewise_constant_schedule`` the JAX package
trains with).

Each factory returns an :class:`Optimizer` that the trainer applies to
the master parameters: :meth:`Optimizer.init` builds the state, a
``torch.optim`` optimizer over the parameter tensors with every
hyperparameter passed explicitly, and :meth:`Optimizer.update` applies
one step to the parameters in place.  The defaults are optax's, not
torch's: ``optax.adamw`` decays weights by 1e-4 where
``torch.optim.AdamW`` decays by 1e-2.

The update rules are optax's:

- ``adamw``: ``p += -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with
  bias-corrected moments, computed op for op in optax's order and
  rounding (:class:`_AdamW`; ``torch.optim.AdamW`` applies the decay
  as ``p *= 1 - lr * wd`` first and folds the bias corrections into its
  step size, an equal update rounded elsewhere, a few ulp apart);
  ``adam`` is the same sequence without the decay term;
- ``sgd`` (``torch.optim.SGD``): ``t = g + momentum * t``; ``p -= lr *
  t`` (Nesterov: ``p -= lr * (g + momentum * t)``), plain ``p -= lr *
  g`` without momentum.

A learning rate may be a schedule, ``fn(count) -> rate``, as in optax:
it is called with the update count as an ``np.int32`` (0 for the first
update) and its value rounded to f32 before it scales the update.
:func:`piecewise_constant_schedule` is optax's.

The step is plain PyTorch: in the reference it is XLA code, not a
Pallas kernel.

:func:`state_tree` and :func:`load_state_tree` carry the optimizer's
state to a checkpoint and back (:mod:`..checkpoint`): Adam's and
AdamW's ``mu``, ``nu`` and ``count``, SGD's momentum buffers, each keyed
by parameter name, and a scheduled SGD's update ``count``, so a resumed
run's updates (and rates) equal an uninterrupted run's.
"""

import numpy as np
import torch


class Optimizer:
    """A factory the trainer applies to ``{name: tensor}`` parameters."""

    def __init__(self, make):
        self._make = make

    def init(self, params):
        """The optimizer state for ``params`` (a mapping name -> tensor)."""
        return self._make(list(params.values()))

    def update(self, opt_state, params, grads):
        """One step on ``params`` in place, from ``grads`` in the order of
        ``params``; the state's moments update in place too."""
        for p, g in zip(params.values(), grads):
            p.grad = g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)


def _rate(learning_rate, count):
    """The learning rate of update ``count`` (0 for the first), in f32."""
    if callable(learning_rate):
        return float(np.float32(learning_rate(np.int32(count))))
    return learning_rate


class _AdamW(torch.optim.Optimizer):
    """``optax.adamw`` (``scale_by_adam`` -> ``add_decayed_weights`` ->
    ``scale(-lr)`` -> ``apply_updates``) as multi-tensor PyTorch ops in
    the same order, the bias corrections in f32 as JAX computes them.
    ``weight_decay=None`` leaves out the decay step: ``optax.adam``."""

    def __init__(self, params, lr, b1, b2, eps, weight_decay):
        super().__init__(params, dict(lr=lr, betas=(b1, b2), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p),
                                         nu=torch.zeros_like(p), count=0)
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            count = self.state[params[0]]["count"] + 1
            for p in params:
                self.state[p]["count"] = count
            # mu = (1 - b1) * g + b1 * mu; nu = (1 - b2) * g^2 + b2 * nu
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            del sq
            one = np.float32(1)
            bc1 = float(one - np.float32(b1) ** np.float32(count))
            bc2 = float(one - np.float32(b2) ** np.float32(count))
            upd = torch._foreach_div(mus, bc1)
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(upd, den)
            del den
            if group["weight_decay"] is not None:
                torch._foreach_add_(
                    upd, torch._foreach_mul(params, group["weight_decay"]))
            # a schedule's count is optax's: 0 at the first update
            torch._foreach_mul_(upd, -_rate(group["lr"], count - 1))
            torch._foreach_add_(params, upd)


class _ScheduledSGD(torch.optim.SGD):
    """``torch.optim.SGD`` whose rate is ``schedule(count)``, with the
    update ``count`` kept here (``scale_by_schedule``'s state)."""

    def __init__(self, params, schedule, momentum, nesterov):
        super().__init__(params, lr=0.0, momentum=momentum,
                         nesterov=nesterov)
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            group["lr"] = _rate(self.schedule, self.count)
        super().step()
        self.count += 1


def _number(learning_rate):
    """A number as a float, a schedule (a callable) as it is."""
    if callable(learning_rate):
        return learning_rate
    if isinstance(learning_rate, bool) or not isinstance(
            learning_rate, (int, float)):
        raise TypeError(
            "learning_rate must be a number or a schedule, got "
            "{0!r}".format(learning_rate)
        )
    return float(learning_rate)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """Adam with ``optax.adam``'s defaults."""
    lr = _number(learning_rate)
    return Optimizer(lambda tensors: _AdamW(
        tensors, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=None,
    ))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    """AdamW with ``optax.adamw``'s defaults (``weight_decay=1e-4``)."""
    lr = _number(learning_rate)
    return Optimizer(lambda tensors: _AdamW(
        tensors, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
    ))


def sgd(learning_rate, momentum=None, nesterov=False):
    """SGD with ``optax.sgd``'s defaults (no momentum); ``nesterov``
    takes effect only with a momentum, as in optax."""
    lr = _number(learning_rate)
    mom = float(momentum) if momentum else 0.0
    nesterov = bool(nesterov) and mom > 0
    if callable(lr):
        return Optimizer(lambda tensors: _ScheduledSGD(
            tensors, lr, momentum=mom, nesterov=nesterov))
    return Optimizer(lambda tensors: torch.optim.SGD(
        tensors, lr=lr, momentum=mom, nesterov=nesterov,
    ))


def piecewise_constant_schedule(init_value, boundaries_and_scales=None):
    """``optax.piecewise_constant_schedule``: ``init_value`` times the
    product of every ``scale`` whose ``boundary <= count``, in f32."""
    if boundaries_and_scales is not None and any(
            scale < 0.0 for scale in boundaries_and_scales.values()):
        raise ValueError("`piecewise_constant_schedule` expects "
                         "non-negative scale factors")
    steps = sorted((boundaries_and_scales or {}).items())

    def schedule(count):
        value = np.float32(init_value)
        for boundary, scale in steps:
            if count >= boundary:
                value = np.float32(np.float32(scale) * value)
        return value

    return schedule


def _names(opt_state, params):
    """``{tensor id: name}`` of the optimizer's parameters."""
    names = {id(p): n for n, p in params.items()}
    for group in opt_state.param_groups:
        for p in group["params"]:
            if id(p) not in names:
                raise ValueError("the optimizer holds a tensor that is not "
                                 "among the named parameters")
    return names


def state_tree(opt_state, params):
    """The optimizer state of ``opt_state`` (what :meth:`Optimizer.init`
    returned over ``params``, a ``{name: tensor}`` dict) as a tree of
    tensors keyed by parameter name: ``{"mu": {...}, "nu": {...},
    "count": int64}`` for ``adam`` and ``adamw`` (empty before the first
    step), ``{"momentum": {...}}`` for ``sgd`` (the buffers that exist),
    with ``"count": int64`` when its rate is a schedule.  The tensors are
    the optimizer's own, not copies."""
    names = _names(opt_state, params)
    if isinstance(opt_state, _AdamW):
        mu, nu, count = {}, {}, 0
        for p, st in opt_state.state.items():
            if st:
                mu[names[id(p)]] = st["mu"]
                nu[names[id(p)]] = st["nu"]
                count = st["count"]
        return {"mu": mu, "nu": nu, "count": np.asarray(count, np.int64)}
    if isinstance(opt_state, torch.optim.SGD):
        tree = {"momentum": {
            names[id(p)]: st["momentum_buffer"]
            for p, st in opt_state.state.items()
            if st.get("momentum_buffer") is not None
        }}
        if isinstance(opt_state, _ScheduledSGD):
            tree["count"] = np.asarray(opt_state.count, np.int64)
        return tree
    raise TypeError("no state tree for optimizer {0!r}".format(
        type(opt_state).__name__))


def _moment(p, value):
    """``value`` (a tensor or numpy array) as a new tensor like ``p``."""
    src = value if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(value))
    if tuple(src.shape) != tuple(p.shape):
        raise ValueError("optimizer state of shape {0} for a parameter of "
                         "shape {1}".format(tuple(src.shape), tuple(p.shape)))
    return torch.empty_like(p).copy_(src)


def load_state_tree(opt_state, params, tree):
    """Set ``opt_state`` (over ``params``) from a :func:`state_tree` tree
    (arrays or tensors, e.g. as a checkpoint returns it); the state it
    held before is dropped."""
    names = _names(opt_state, params)
    by_name = {names[id(p)]: p for g in opt_state.param_groups
               for p in g["params"]}
    opt_state.state.clear()
    if isinstance(opt_state, _AdamW):
        mu, nu = tree.get("mu", {}), tree.get("nu", {})
        if set(mu) != set(nu) or not set(mu) <= set(by_name):
            raise ValueError("AdamW state names {0} do not match the "
                             "parameters".format(sorted(mu)))
        count = int(np.asarray(tree.get("count", 0)))
        for name in mu:
            p = by_name[name]
            opt_state.state[p] = {"mu": _moment(p, mu[name]),
                                  "nu": _moment(p, nu[name]),
                                  "count": count}
    elif isinstance(opt_state, torch.optim.SGD):
        bufs = tree.get("momentum", {})
        if not set(bufs) <= set(by_name):
            raise ValueError("SGD state names {0} do not match the "
                             "parameters".format(sorted(bufs)))
        for name, buf in bufs.items():
            opt_state.state[by_name[name]] = {
                "momentum_buffer": _moment(by_name[name], buf)}
        if isinstance(opt_state, _ScheduledSGD):
            opt_state.count = int(np.asarray(tree.get("count", 0)))
    else:
        raise TypeError("no state tree for optimizer {0!r}".format(
            type(opt_state).__name__))
