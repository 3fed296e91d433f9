"""Shared serving scaffolding of the model builders (port of the JAX
package's ``models/base.py``, cut to :func:`as_variables` and
:func:`make_serving_predict`)."""

import numpy as np
import torch


def as_variables(params, require_collections=()):
    """Normalize a serving export into a variables dict.

    Accepts bare params or a ``{"params": ..., <collections>}`` dict;
    ``require_collections`` names collections that must be present (a
    missing one raises ``ValueError`` naming it).  The leaves are left
    as they are: the builder loads them into its model."""
    variables = params if "params" in params else {"params": params}
    missing = [c for c in require_collections if c not in variables]
    if missing:
        raise ValueError(
            "serving export is missing the {0} collection(s); export "
            "the full variables dict (e.g. save_for_serving(dir, "
            "{{'params': ..., 'batch_stats': ...}}))".format(missing)
        )
    return variables


def make_serving_predict(model, input_name, outputs,
                         input_dtype=torch.int64):
    """Shared scaffold for the builders' ``predict`` (see
    :mod:`..serving` for the contract).

    Args:
      model: the loaded ``nn.Module``; runs under ``torch.no_grad()`` on
        the device of its parameters.
      input_name: batch key carrying the input column, cast to
        ``input_dtype``.
      outputs: ``fn(model_output) -> {name: np.ndarray}``.
    """
    device = next(model.parameters()).device

    def predict(batch):
        x = torch.as_tensor(np.asarray(batch[input_name])).to(
            device=device, dtype=input_dtype)
        with torch.no_grad():
            return outputs(model(x))

    return predict
