"""Optimizers with optax's signatures, defaults and update rules (the
port's counterpart of the ``optax.adamw`` / ``optax.sgd`` the JAX
package trains with).

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
- ``sgd`` (``torch.optim.SGD``): ``t = g + momentum * t``; ``p -= lr *
  t`` (Nesterov: ``p -= lr * (g + momentum * t)``), plain ``p -= lr *
  g`` without momentum.

The step is plain PyTorch: in the reference it is XLA code, not a
Pallas kernel.
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


class _AdamW(torch.optim.Optimizer):
    """``optax.adamw`` (``scale_by_adam`` -> ``add_decayed_weights`` ->
    ``scale(-lr)`` -> ``apply_updates``) as multi-tensor PyTorch ops in
    the same order, the bias corrections in f32 as JAX computes them."""

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
            torch._foreach_add_(
                upd, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)


def _number(learning_rate):
    if isinstance(learning_rate, bool) or not isinstance(
            learning_rate, (int, float)):
        raise TypeError(
            "learning_rate must be a number, got {0!r}".format(learning_rate)
        )
    return float(learning_rate)


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
    return Optimizer(lambda tensors: torch.optim.SGD(
        tensors, lr=lr, momentum=mom, nesterov=bool(nesterov) and mom > 0,
    ))
