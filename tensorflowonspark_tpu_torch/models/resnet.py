"""ResNets (port of the JAX package's ``models/resnet.py``): the
reference's throughput benchmark workloads, ResNet56 on CIFAR-10-sized
inputs and ResNet50 at 224 px.

Inputs are NHWC ``[B, H, W, 3]`` at the API, as in the reference, so the
same numpy batches feed both packages; inside, the models run on the
``[B, C, H, W]`` view of them (``channels_last`` in memory, what cuDNN
prefers), compute convolutions and BatchNorm outputs in ``dtype``
(default bf16) over f32 weights, and return f32 logits.  The layers'
arithmetic is Flax's (:mod:`.layers`: "SAME" padding, max pooling,
BatchNorm's biased variance and running averages).

BatchNorm statistics are model state.  ``model(x, train=True)`` returns
``(logits, batch_stats)``, the new running averages keyed as the model's
buffers (``"stem.bn.mean"``), and leaves the buffers as they are (the
reference's ``apply(..., mutable=["batch_stats"])``); ``model(x)`` reads
the buffers.  :func:`loss_fn` follows the trainer's model-state contract,
so a trainer is built as::

    trainer = dp.SyncTrainer(resnet.loss_fn(model), opt,
                             has_model_state=True)
    state = trainer.create_state(dict(model.named_parameters()),
                                 {"batch_stats": dict(model.named_buffers())})

Weights cross to and from the Flax variables (``{"params",
"batch_stats"}``) with :func:`params_from_flax` / :func:`tree_from_model`.
``logical_axes`` (sharded parameters) is not ported: ROADMAP queue A,
multi-GPU DP.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.compat import resolve_device
from tensorflowonspark_tpu_torch.models import base, layers
from tensorflowonspark_tpu_torch.models.layers import (  # noqa: F401
    flax_variables as tree_from_model,
    load_flax as params_from_flax,
)


class ConvBN(nn.Module):
    """Conv (no bias, "SAME") -> BatchNorm (momentum 0.9, eps 1e-5) ->
    optional relu, in ``dtype``."""

    def __init__(self, in_features, filters, kernel=3, strides=1,
                 dtype="bfloat16", use_relu=True, device=None):
        super().__init__()
        self.use_relu = use_relu
        self.conv = layers.Conv(in_features, filters, kernel, strides,
                                use_bias=False, dtype=dtype, device=device)
        self.bn = layers.BatchNorm(filters, momentum=0.9, epsilon=1e-5,
                                   dtype=dtype, device=device)

    def forward(self, x, train=False, updates=None):
        x = self.bn(self.conv(x), train, updates)
        return F.relu(x) if self.use_relu else x


class BasicBlock(nn.Module):
    def __init__(self, in_features, filters, strides=1, dtype="bfloat16",
                 device=None):
        super().__init__()
        self.c1 = ConvBN(in_features, filters, 3, strides, dtype,
                         device=device)
        self.c2 = ConvBN(filters, filters, 3, 1, dtype, use_relu=False,
                         device=device)
        # the reference projects when the shapes differ
        self.proj = None
        if in_features != filters or strides != 1:
            self.proj = ConvBN(in_features, filters, 1, strides, dtype,
                               use_relu=False, device=device)

    def forward(self, x, train=False, updates=None):
        y = self.c2(self.c1(x, train, updates), train, updates)
        shortcut = x if self.proj is None else self.proj(x, train, updates)
        return F.relu(y + shortcut)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features, filters, strides=1, dtype="bfloat16",
                 device=None):
        super().__init__()
        self.c1 = ConvBN(in_features, filters, 1, 1, dtype, device=device)
        self.c2 = ConvBN(filters, filters, 3, strides, dtype, device=device)
        self.c3 = ConvBN(filters, filters * 4, 1, 1, dtype, use_relu=False,
                         device=device)
        self.proj = None
        if in_features != filters * 4 or strides != 1:
            self.proj = ConvBN(in_features, filters * 4, 1, strides, dtype,
                               use_relu=False, device=device)

    def forward(self, x, train=False, updates=None):
        y = self.c1(x, train, updates)
        y = self.c3(self.c2(y, train, updates), train, updates)
        shortcut = x if self.proj is None else self.proj(x, train, updates)
        return F.relu(y + shortcut)


def _finish(model, x, train, updates):
    """Global average pool, the f32 ``fc`` head, and the train-mode
    ``(logits, batch_stats)`` pair."""
    logits = model.fc(x.mean(dim=(2, 3)).to(torch.float32))
    return (logits, updates) if train else logits


class ResNetCIFAR(nn.Module):
    """ResNet-v1 for 32x32 inputs (reference default depth 56: 3 stages
    of ``(depth - 2) // 6`` basic blocks, 16/32/64 filters)."""

    def __init__(self, depth=56, num_classes=10, dtype="bfloat16",
                 device=None):
        super().__init__()
        device = layers.model_device(device)
        self.dtype = layers.torch_dtype(dtype)
        n = (depth - 2) // 6
        self.stem = ConvBN(3, 16, 3, 1, dtype, device=device)
        in_features = 16
        for stage, filters in enumerate((16, 32, 64)):
            for block in range(n):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(
                    "stage%d_block%d" % (stage, block),
                    BasicBlock(in_features, filters, strides, dtype,
                               device=device))
                in_features = filters
        self.fc = layers.Dense(in_features, num_classes, device=device)
        layers.name_batch_norms(self)

    def forward(self, x, train=False):
        updates = {} if train else None
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for name, module in self.named_children():
            if name != "fc":
                x = module(x, train, updates)
        return _finish(self, x, train, updates)


def space_to_depth(x, block=2):
    """``[B, H, W, C] -> [B, H/b, W/b, b*b*C]`` (NHWC, b = block), as the
    reference's s2d stem transforms its input."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def conv7_to_s2d_kernel(w7):
    """Map a Flax-layout ``[7, 7, C, F]`` stem kernel (a tensor or an
    array; the same kind comes back) to the equivalent ``[4, 4, 4C, F]``
    space-to-depth kernel: zero-padded to 8x8 at the top and left and
    regrouped into 2x2 blocks.  With the block-space padding ``(2, 1)``
    the s2d stem computes the conv7 stem's function."""
    is_tensor = isinstance(w7, torch.Tensor)
    k7 = w7 if is_tensor else torch.tensor(np.asarray(w7))
    c, f = k7.shape[2], k7.shape[3]
    k8 = k7.new_zeros((8, 8, c, f))
    k8[1:, 1:] = k7
    k = k8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
    k = k.reshape(4, 4, 4 * c, f)
    return k if is_tensor else k.numpy()


class ResNet50(nn.Module):
    """Bottleneck ResNet-50 (v1.5: the stride in the 3x3) for 224x224
    inputs; ``stem`` ``"conv7"`` (7x7/s2) or ``"s2d"`` (space-to-depth
    and a 4x4/s1 conv, the same function under
    :func:`conv7_to_s2d_kernel`)."""

    def __init__(self, num_classes=1000, dtype="bfloat16",
                 stage_sizes=(3, 4, 6, 3), stem="conv7", device=None):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError("stem must be 'conv7' or 's2d', got "
                             "{0!r}".format(stem))
        device = layers.model_device(device)
        self.dtype = layers.torch_dtype(dtype)
        self.stem = stem
        if stem == "s2d":
            self.stem_conv = layers.Conv(
                12, 64, 4, 1, padding=[(2, 1), (2, 1)], use_bias=False,
                dtype=dtype, device=device)
        else:
            self.stem_conv = layers.Conv(
                3, 64, 7, 2, padding=[(3, 3), (3, 3)], use_bias=False,
                dtype=dtype, device=device)
        self.stem_bn = layers.BatchNorm(64, momentum=0.9, epsilon=1e-5,
                                        dtype=dtype, device=device)
        in_features = 64
        for stage, blocks in enumerate(stage_sizes):
            filters = 64 * (2 ** stage)
            for block in range(blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(
                    "stage%d_block%d" % (stage, block),
                    BottleneckBlock(in_features, filters, strides, dtype,
                                    device=device))
                in_features = filters * 4
        self.fc = layers.Dense(in_features, num_classes, device=device)
        layers.name_batch_norms(self)

    def forward(self, x, train=False):
        updates = {} if train else None
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        x = self.stem_conv(x.permute(0, 3, 1, 2))
        x = F.relu(self.stem_bn(x, train, updates))
        x = layers.max_pool(x, 3, 2)
        for name, module in self.named_children():
            if name.startswith("stage"):
                x = module(x, train, updates)
        return _finish(self, x, train, updates)


@dataclasses.dataclass
class CIFARSchedule:
    """The reference's piecewise learning rate (0.1 / 0.01 / 0.001 at
    epochs 91 and 136, scaled by ``batch_size / 128``), in f32; a
    schedule for :mod:`..optim`."""

    batch_size: int = 128
    steps_per_epoch: int = 390

    def __call__(self, step):
        scale = np.float32(self.batch_size / 128.0)
        e = np.float32(step) / np.float32(self.steps_per_epoch)
        lr = np.where(e < 91, np.float32(0.1),
                      np.where(e < 136, np.float32(0.01), np.float32(0.001)))
        return np.float32(lr * scale)


def loss_fn(model, weight_decay=2e-4):
    """Cross-entropy plus ``weight_decay`` times the L2 of every weight
    of more than one dimension, under the trainer's model-state contract
    (``SyncTrainer(has_model_state=True)``): ``loss(params, model_state,
    batch, rng) -> (loss, ({"accuracy"}, new_model_state))``, where
    ``model_state`` is ``{"batch_stats": {buffer name: tensor}}`` and
    ``batch`` is ``(images, labels)`` or ``{"image", "label"}``."""

    def _loss(params, model_state, batch, rng):
        if isinstance(batch, dict):
            images, labels = batch["image"], batch["label"]
        else:
            images, labels = batch
        logits, stats = torch.func.functional_call(
            model, {**params, **model_state.get("batch_stats", {})},
            (images,), {"train": True})
        nll, aux = layers.cross_entropy(logits, labels)
        l2 = sum(torch.sum(torch.square(p.to(torch.float32)))
                 for p in params.values() if p.ndim > 1)
        return nll + weight_decay * l2, (aux, {"batch_stats": stats})

    return _loss


def serving_builder(params, config):
    """``model_ref`` target for serving exports: ``predict({"image":
    [B, H, W, 3]}) -> {"logits", "prediction"}``.  ``config``: ``arch``
    (``"cifar"`` | ``"resnet50"``), ``depth``, ``num_classes``,
    ``input_name``, ``device`` (default ``cuda``).  The export must be
    the full variables dict ``{"params", "batch_stats"}``: BatchNorm
    serves from its running statistics."""
    device = resolve_device(config.get("device"))
    if config.get("arch", "cifar") == "resnet50":
        model = ResNet50(num_classes=config.get("num_classes", 1000),
                         device=device)
    else:
        model = ResNetCIFAR(depth=config.get("depth", 56),
                            num_classes=config.get("num_classes", 10),
                            device=device)
    params_from_flax(base.as_variables(
        params, require_collections=("batch_stats",)), model)
    model.requires_grad_(False)

    def outputs(logits):
        return {"logits": logits.to(torch.float32).cpu().numpy(),
                "prediction": torch.argmax(logits, dim=-1).to(
                    torch.int32).cpu().numpy()}

    return base.make_serving_predict(
        model, config.get("input_name", "image"), outputs,
        input_dtype=torch.float32)
