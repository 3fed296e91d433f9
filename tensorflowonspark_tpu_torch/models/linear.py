"""Minimal linear-regression model and serving builder (port of the JAX
package's ``models/linear.py``): the pipeline API's acceptance workload
(``features . w + b``) and the smallest example of the serving-export
contract.

The parameters are a ``{"w": [dim], "b": []}`` dict of f32 tensors, the
Flax tree's own layout, so :func:`params_from_flax` and
:func:`tree_from_model` only move them between numpy and the device.
"""

import numpy as np
import torch

from tensorflowonspark_tpu_torch.compat import resolve_device
from tensorflowonspark_tpu_torch.models.layers import as_f32


def init_params(dim, rng=None, device=None):
    """Zero-initialised weights and bias for ``dim`` input features on
    ``device`` (default ``cuda``); ``rng`` is unused, as in the
    reference (least squares is convex)."""
    del rng
    device = resolve_device(device)
    return {"w": torch.zeros((dim,), dtype=torch.float32, device=device),
            "b": torch.zeros((), dtype=torch.float32, device=device)}


def apply(params, x):
    """``x @ w + b`` for a ``[batch, dim]`` feature matrix."""
    return torch.matmul(x, params["w"]) + params["b"]


def loss_fn(params, batch):
    """Mean-squared error over ``{"features", "label"}`` columns."""
    pred = apply(params, batch["features"])
    label = torch.reshape(batch["label"], pred.shape).to(pred.dtype)
    return torch.mean((pred - label) ** 2)


def params_from_flax(tree, device=None):
    """The ``{"w", "b"}`` tree (arrays or tensors) as f32 tensors on
    ``device`` (default ``cuda``); a missing, extra or misshapen leaf
    raises ``ValueError``."""
    device = resolve_device(device)
    if set(tree) != {"w", "b"}:
        raise ValueError("linear parameters are {{'w', 'b'}}, got "
                         "{0}".format(sorted(tree)))
    out = {k: as_f32(v).to(device) for k, v in tree.items()}
    if out["w"].ndim != 1 or out["b"].ndim != 0:
        raise ValueError("linear parameters need w [dim] and b [], got "
                         "{0} and {1}".format(tuple(out["w"].shape),
                                              tuple(out["b"].shape)))
    return out


def tree_from_model(params):
    """``params`` as the Flax tree of f32 numpy arrays (copies)."""
    return {k: np.array(v.detach().to(torch.float32).cpu().numpy())
            for k, v in params.items()}


def serving_builder(params, config):
    """``model_ref`` target: ``predict(batch) -> {"prediction"}`` from
    exported params; ``config`` may name the feature column
    (``input_name``, default ``"features"``) and the ``device`` (default
    ``cuda``)."""
    feature_key = config.get("input_name", "features")
    params = params_from_flax(params, config.get("device"))
    device = params["w"].device

    def predict(batch):
        x = torch.as_tensor(np.asarray(batch[feature_key])).to(
            device=device, dtype=torch.float32)
        with torch.no_grad():
            return {"prediction": apply(params, x).cpu().numpy()}

    return predict
