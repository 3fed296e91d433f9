"""UNet for image segmentation (port of the JAX package's
``models/unet.py``): the reference's segmentation workload, 128x128x3
in, per-pixel class logits out.

A depthwise-separable conv encoder (the MobileNet block: a depthwise 3x3
with ``groups=in_ch``, a pointwise 1x1, GroupNorm, relu6) with skip
connections and a transposed-conv decoder.  NHWC at the API, the
``[B, C, H, W]`` view inside (``channels_last`` in memory); convolutions
in ``dtype`` (default bf16) over f32 weights, GroupNorm in f32 with
Flax's epsilon (:mod:`.layers`), f32 logits ``[B, H, W, num_classes]``.
No model state.  Weights cross to and from the Flax tree with
:func:`params_from_flax` / :func:`tree_from_model`; the transposed
kernels are flipped on the way (:class:`..layers.ConvTranspose`).
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


class SepConv(nn.Module):
    """Depthwise-separable conv + group-norm + relu6."""

    def __init__(self, in_features, filters, strides=1, dtype="bfloat16",
                 device=None):
        super().__init__()
        self.dtype = layers.torch_dtype(dtype)
        self.dw = layers.Conv(in_features, in_features, 3, strides,
                              groups=in_features, use_bias=False,
                              dtype=dtype, device=device)
        self.pw = layers.Conv(in_features, filters, 1, use_bias=False,
                              dtype=dtype, device=device)
        self.GroupNorm_0 = layers.GroupNorm(min(8, filters), filters,
                                            device=device)

    def forward(self, x):
        x = self.GroupNorm_0(self.pw(self.dw(x)))
        return torch.clamp(F.relu(x), max=6.0).to(self.dtype)


class UpBlock(nn.Module):
    """Transpose-conv x2 upsample (the pix2pix upsample equivalent), then
    the skip connection on the channels."""

    def __init__(self, in_features, filters, dtype="bfloat16", device=None):
        super().__init__()
        self.dtype = layers.torch_dtype(dtype)
        self.up = layers.ConvTranspose(in_features, filters, 4, 2,
                                       use_bias=False, dtype=dtype,
                                       device=device)
        self.GroupNorm_0 = layers.GroupNorm(min(8, filters), filters,
                                            device=device)

    def forward(self, x, skip=None):
        x = F.relu(self.GroupNorm_0(self.up(x))).to(self.dtype)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return x


class UNet(nn.Module):
    """``[B, 128, 128, 3] -> [B, 128, 128, num_classes]`` f32 logits (any
    size divisible by 32)."""

    def __init__(self, num_classes=3, base_filters=32, dtype="bfloat16",
                 device=None):
        super().__init__()
        device = layers.model_device(device)
        self.dtype = layers.torch_dtype(dtype)
        f = base_filters
        self.stem = layers.Conv(3, f, 3, 2, use_bias=False, dtype=dtype,
                                device=device)
        down = (f * 2, f * 4, f * 8, f * 8)
        skips, ch = [], f
        for i, filters in enumerate(down):
            skips.append(ch)
            self.add_module("down%d" % i, SepConv(ch, filters, 2, dtype,
                                                  device=device))
            ch = filters
        for i, filters in enumerate((f * 8, f * 4, f * 2, f)):
            self.add_module("up%d" % i, UpBlock(ch, filters, dtype,
                                                device=device))
            ch = filters + skips[-(i + 1)]
        self.final_up = layers.ConvTranspose(ch, f, 4, 2, dtype=dtype,
                                             device=device)
        self.classifier = layers.Conv(f, num_classes, 1, device=device)

    def forward(self, x, train=False):
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))  # 1/2
        skips = []
        for i in range(4):  # 1/4 ... 1/32, collecting skips
            skips.append(x)
            x = getattr(self, "down%d" % i)(x)
        for i in range(4):  # back to 1/2 with the skips
            x = getattr(self, "up%d" % i)(x, skips[-(i + 1)])
        x = self.final_up(x)  # full size
        return self.classifier(x.to(torch.float32)).permute(0, 2, 3, 1)


def loss_fn(model):
    """Per-pixel cross-entropy with an ``accuracy`` aux; ``batch`` is
    ``(image, mask [B, H, W])`` or ``{"image", "mask"}``.  Returns
    ``loss(params, batch, rng) -> (loss, {"accuracy"})``."""

    def _loss(params, batch, rng):
        if isinstance(batch, dict):
            images, masks = batch["image"], batch["mask"]
        else:
            images, masks = batch
        logits = torch.func.functional_call(model, params, (images,),
                                            {"train": True})
        return layers.cross_entropy(logits, masks)

    return _loss


def serving_builder(params, config):
    """``model_ref`` target for serving exports: ``predict({"image":
    [B, H, W, 3]}) -> {"logits", "mask"}``; ``config`` takes
    ``num_classes``, ``base_filters``, ``input_name`` and ``device``
    (default ``cuda``)."""
    model = UNet(num_classes=config.get("num_classes", 3),
                 base_filters=config.get("base_filters", 32),
                 device=resolve_device(config.get("device")))
    params_from_flax(base.as_variables(params), model)
    model.requires_grad_(False)

    def outputs(logits):
        return {"logits": logits.to(torch.float32).cpu().numpy(),
                "mask": torch.argmax(logits, dim=-1).to(
                    torch.int32).cpu().numpy()}

    return base.make_serving_predict(
        model, config.get("input_name", "image"), outputs,
        input_dtype=torch.float32)
