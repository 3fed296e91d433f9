"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument.  ``None`` means the GPU:
the port runs on ``cuda`` unless the caller explicitly asks for the
CPU (as the CPU tests do), and it raises instead of quietly falling
back when no GPU is present.
"""

import torch


class NoCudaDevice(RuntimeError):
    """A GPU entry point was called on a machine without a CUDA device."""


def has_cuda():
    return torch.cuda.is_available()


def is_hopper(device=None):
    """True when ``device`` (default: the current CUDA device) has
    compute capability 9.0, the ``sm_90a`` target the kernels build for."""
    if not has_cuda():
        return False
    return torch.cuda.get_device_capability(device) == (9, 0)


def resolve_device(device=None):
    """``cuda`` unless the caller asks for ``"cpu"``.

    ``device`` may be ``None``, a string or a :class:`torch.device`.
    Asking for ``cuda`` (explicitly or by default) without a GPU raises
    :class:`NoCudaDevice`; any other device type raises ``ValueError``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            "device must be 'cuda' or 'cpu', got {0!r}".format(device)
        )
    if not has_cuda():
        raise NoCudaDevice(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch paths on the CPU"
        )
    return dev
