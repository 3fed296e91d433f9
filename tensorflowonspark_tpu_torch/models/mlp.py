"""MNIST model (port of the JAX package's ``models/mlp.py``): the
reference's smoke-test workload, Flatten -> Dense(512, relu) -> Dropout
-> Dense(10), in f32.

``MNISTNet(x, deterministic=True, rng=None)``: dropout (rate 0.2, kept
units scaled by ``1 / 0.8``) applies only when ``deterministic`` is
false and ``rng`` is a ``torch.Generator``, as the reference applies it
only with a key.  Weights cross to and from the Flax tree with
:func:`params_from_flax` / :func:`tree_from_model`
(:func:`..models.layers.load_flax`).  ``logical_axes`` (sharded
parameters) is not ported: ROADMAP queue A, multi-GPU DP.
"""

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.compat import resolve_device
from tensorflowonspark_tpu_torch.models import base, layers
from tensorflowonspark_tpu_torch.models.layers import (  # noqa: F401
    flax_variables as tree_from_model,
    load_flax as params_from_flax,
)


class MNISTNet(nn.Module):
    """``[B, 784]`` (or ``[B, 28, 28]``) -> ``[B, num_classes]`` f32
    logits; ``in_features`` is what Flax infers from the input."""

    def __init__(self, hidden=512, num_classes=10, dropout_rate=0.2,
                 in_features=784, device=None):
        super().__init__()
        device = layers.model_device(device)
        self.dropout_rate = dropout_rate
        self.dense1 = layers.Dense(in_features, hidden, device=device)
        self.dense2 = layers.Dense(hidden, num_classes, device=device)

    def forward(self, x, deterministic=True, rng=None):
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        x = F.relu(self.dense1(x))
        if not deterministic and rng is not None:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
            x = torch.where(mask, x / keep, 0.0)
        return self.dense2(x)


def serving_builder(params, config):
    """``model_ref`` target for serving exports of :class:`MNISTNet`:
    ``predict({"image": [B, 784]}) -> {"logits", "prediction"}``;
    ``config`` takes ``hidden``, ``num_classes``, ``input_name`` and
    ``device`` (default ``cuda``)."""
    model = MNISTNet(hidden=config.get("hidden", 512),
                     num_classes=config.get("num_classes", 10),
                     device=resolve_device(config.get("device")))
    params_from_flax(base.as_variables(params), model)
    model.requires_grad_(False)

    def outputs(logits):
        return {"logits": logits.cpu().numpy(),
                "prediction": torch.argmax(logits, dim=-1).to(
                    torch.int32).cpu().numpy()}

    return base.make_serving_predict(
        model, config.get("input_name", "image"), outputs,
        input_dtype=torch.float32)


def loss_fn(model):
    """Softmax cross-entropy with an ``accuracy`` aux; ``batch`` is
    ``(images, labels)`` or ``{"image", "label"}``.  Returns ``loss(params,
    batch, rng) -> (loss, {"accuracy"})``; ``rng`` (a generator or
    ``None``) drives the dropout."""

    def _loss(params, batch, rng):
        if isinstance(batch, dict):
            images, labels = batch["image"], batch["label"]
        else:
            images, labels = batch
        logits = torch.func.functional_call(
            model, params, (images,), {"deterministic": False, "rng": rng})
        return layers.cross_entropy(logits, labels)

    return _loss

