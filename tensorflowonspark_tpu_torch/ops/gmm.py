"""Grouped (ragged) matmul on the dropless-MoE layout (port of the JAX
package's ``ops/gmm.py``).

Layout contract (:func:`~.moe.dropless_layout`): ``x [N, D]`` holds the
tokens sorted by expert, ``N = T * bm``; each expert's run starts at a
multiple of the row tile ``bm``, so no row tile straddles two experts;
``tile_expert [T]`` (int32, non-decreasing) names the owner of row tile
``t``.  Pad rows are zero.

Three hand-written Hopper kernels in ``csrc/gmm.cu`` replace the TPU
kernels:

- K5 ``gmm_call``      ``y[t] = x[t] @ w[te[t]]``       (``_gmm_kernel``)
- K6 ``gmm_dxt_call``  ``dx[t] = dy[t] @ w[te[t]]^T``   (``_gmm_dxt_kernel``),
  reading ``w [E, D, F]`` in its stored layout
- K7 ``tgmm_call``     ``dw[e] = sum_{t: te[t]=e} x[t]^T dy[t]``
  (``_tgmm_kernel``); an expert that owns no tile gets exactly 0

Products accumulate in f32 and round once: ``y`` to x's type, ``dx`` to
dy's, ``dw`` (summed over the whole run) to x's.  :func:`grouped_matmul`
is a :class:`torch.autograd.Function` whose forward is K5 and whose
backward is K6 + K7 (``dw`` cast to w's type, as the reference's VJP
does).  A CUDA tensor launches the kernel (counted in ``launches``) or
raises; a CPU tensor runs the plain versions :func:`gmm_plain`,
:func:`gmm_dxt_plain` and :func:`tgmm_plain`, which round where the
kernels round.

Deliberate differences from the reference: the Mosaic/VMEM block
pickers (``_pick_bf``, ``_pick_bd``) are TPU rules and are not ported;
``bf``/``bd`` are accepted for the signature and change nothing; and
:func:`gmm_dxt_call` never returns ``None`` (the reference's
transposed-copy fallback for an ``F`` too wide for VMEM has no
counterpart on the GPU).  The kernels need ``bm`` to be a multiple of
their 128-row tile and ``D``, ``F`` multiples of 8.
"""

import torch

from tensorflowonspark_tpu_torch.ops import _build

#: the kernels' M tile: ``bm`` must be a multiple of it on the GPU
KERNEL_ROWS = 128
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_layout(n, bm, tile_expert):
    if bm <= 0 or n % bm != 0:
        raise ValueError(
            "grouped matmul needs N = T * bm rows; got N={0}, bm={1}".format(
                n, bm))
    t = n // bm
    if tuple(tile_expert.shape) != (t,):
        raise ValueError(
            "tile_expert must be [T] = [{0}], got {1}".format(
                t, tuple(tile_expert.shape)))


# -- plain PyTorch versions (the kernels' oracles) ---------------------


def gmm_plain(x, w, tile_expert, bm=256):
    """Plain version of K5: per row tile, an f32 product with the owning
    expert's weights, rounded once to x's type."""
    n, d = x.shape
    t = n // bm
    y = torch.bmm(x.reshape(t, bm, d).float(),
                  w.float()[tile_expert.long()])
    return y.reshape(n, -1).to(x.dtype)


def gmm_dxt_plain(dy, w, tile_expert, bm=256):
    """Plain version of K6: ``dy[t] @ w[te[t]]^T`` in f32, rounded once
    to dy's type."""
    n, f = dy.shape
    t = n // bm
    dx = torch.bmm(dy.reshape(t, bm, f).float(),
                   w.float()[tile_expert.long()].transpose(1, 2))
    return dx.reshape(n, -1).to(dy.dtype)


def tgmm_plain(x, dy, tile_expert, num_experts, bm=256):
    """Plain version of K7: per-tile ``x[t]^T dy[t]`` in f32, summed per
    expert in f32 and rounded once to x's type; experts that own no
    tile are 0."""
    n, d = x.shape
    f = dy.shape[1]
    t = n // bm
    parts = torch.bmm(x.reshape(t, bm, d).float().transpose(1, 2),
                      dy.reshape(t, bm, f).float())
    dw = torch.zeros((num_experts, d, f), dtype=torch.float32,
                     device=x.device)
    dw.index_add_(0, tile_expert.long(), parts)
    return dw.to(x.dtype)


def gmm_reference(x, w, tile_expert, bm=256):
    """The reference's numerics oracle: per-tile dense product in f32
    against the owning expert's weights, in x's type (the same function
    as :func:`gmm_plain`)."""
    return gmm_plain(x, w, tile_expert, bm=bm)


# -- kernel launches ---------------------------------------------------


def _kernel_operands(a, b, tile_expert, bm, names):
    """Validate the operands a kernel reads; return them contiguous."""
    if a.dtype not in KERNEL_DTYPES or b.dtype != a.dtype:
        raise ValueError(
            "gmm kernels take f32 or bf16 operands of one type; got {0} "
            "{1} and {2} {3}".format(names[0], a.dtype, names[1], b.dtype))
    if b.device != a.device or tile_expert.device != a.device:
        raise ValueError("gmm operands must be on one device")
    if tile_expert.dtype != torch.int32:
        raise ValueError("tile_expert must be int32, got {0}".format(
            tile_expert.dtype))
    if bm % KERNEL_ROWS != 0:
        raise ValueError(
            "the gmm kernels need bm to be a multiple of {0}, got "
            "{1}".format(KERNEL_ROWS, bm))
    for name, x in zip(names, (a, b)):
        if x.shape[-1] % 8 != 0 or x.shape[-2] % 8 != 0:
            raise ValueError(
                "gmm kernels need {0}'s last two dims to be multiples of "
                "8, got {1}".format(name, tuple(x.shape)))
    return a.contiguous(), b.contiguous(), tile_expert.contiguous()


def _launch(entry, count, *args, device):
    err = getattr(_build.load("gmm"), entry)(
        *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "{0} kernel launch failed with CUDA error {1}".format(entry, err))
    grouped_matmul.launches[count] += 1


def _device_kind(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            "grouped matmul runs on cuda or cpu tensors, got {0}".format(
                x.device))
    return x.device.type


def gmm_call(x, w, tile_expert, *, bm=256, bf=None, interpret=None):
    """Forward: ``y [N, F]`` in x's type for sorted ``x [N, D]`` and
    ``w [E, D, F]``.  ``bf`` and ``interpret`` are the reference's
    TPU knobs, accepted and unused.  Differentiate through
    :func:`grouped_matmul`."""
    n, d = x.shape
    e, d2, f = w.shape
    if d != d2:
        raise ValueError("x {0} and w {1} disagree on D".format(
            tuple(x.shape), tuple(w.shape)))
    _check_layout(n, bm, tile_expert)
    if _device_kind(x) == "cpu":
        return gmm_plain(x, w, tile_expert, bm=bm)
    x, w, te = _kernel_operands(x, w, tile_expert, bm, ("x", "w"))
    y = torch.empty((n, f), dtype=x.dtype, device=x.device)
    if y.numel():
        _launch("tfos_gmm", "gmm", x.data_ptr(), w.data_ptr(), te.data_ptr(),
                y.data_ptr(), n, d, f, e, bm, int(x.dtype == torch.bfloat16),
                device=x.device)
    return y


def gmm_dxt_call(dy, w, tile_expert, *, bm=256, bd=None, interpret=None):
    """``dx [N, D] = dy [N, F] @ w[te]^T`` in dy's type, reading
    ``w [E, D, F]`` in its stored layout (no transposed copy).  Never
    returns ``None``; ``bd`` and ``interpret`` are accepted and
    unused."""
    n, f = dy.shape
    e, d, f2 = w.shape
    if f != f2:
        raise ValueError("dy {0} and w {1} disagree on F".format(
            tuple(dy.shape), tuple(w.shape)))
    _check_layout(n, bm, tile_expert)
    if _device_kind(dy) == "cpu":
        return gmm_dxt_plain(dy, w, tile_expert, bm=bm)
    dy, w, te = _kernel_operands(dy, w, tile_expert, bm, ("dy", "w"))
    dx = torch.empty((n, d), dtype=dy.dtype, device=dy.device)
    if dx.numel():
        _launch("tfos_gmm_dxt", "gmm_dxt", dy.data_ptr(), w.data_ptr(),
                te.data_ptr(), dx.data_ptr(), n, d, f, e, bm,
                int(dy.dtype == torch.bfloat16), device=dy.device)
    return dx


def tgmm_call(x, dy, tile_expert, num_experts, *, bm=256, bd=None,
              bf=None, interpret=None):
    """``dw [E, D, F]`` in x's type: for each expert, the f32 sum over
    its row tiles of ``x[t]^T dy[t]``, rounded once; an expert that owns
    no tile gets exactly 0.  ``bd``, ``bf`` and ``interpret`` are
    accepted and unused."""
    n, d = x.shape
    n2, f = dy.shape
    if n != n2:
        raise ValueError("x {0} and dy {1} disagree on N".format(
            tuple(x.shape), tuple(dy.shape)))
    _check_layout(n, bm, tile_expert)
    if _device_kind(x) == "cpu":
        return tgmm_plain(x, dy, tile_expert, num_experts, bm=bm)
    x, dy, te = _kernel_operands(x, dy, tile_expert, bm, ("x", "dy"))
    dw = torch.empty((num_experts, d, f), dtype=x.dtype, device=x.device)
    if dw.numel():
        _launch("tfos_tgmm", "tgmm", x.data_ptr(), dy.data_ptr(),
                te.data_ptr(), dw.data_ptr(), n, d, f, num_experts, bm,
                int(x.dtype == torch.bfloat16), device=x.device)
    return dw


class _GroupedMatmul(torch.autograd.Function):
    """The reference's ``grouped_matmul`` custom VJP: forward K5, saving
    x, w and tile_expert; backward K6 (dx) and K7 (dw, cast to w's
    type)."""

    @staticmethod
    def forward(ctx, x, w, tile_expert, bm):
        ctx.save_for_backward(x, w, tile_expert)
        ctx.bm = bm
        return gmm_call(x, w, tile_expert, bm=bm)

    @staticmethod
    def backward(ctx, dy):
        x, w, tile_expert = ctx.saved_tensors
        bm = ctx.bm
        dx = gmm_dxt_call(dy, w, tile_expert, bm=bm)
        dw = tgmm_call(x, dy, tile_expert, w.shape[0], bm=bm).to(w.dtype)
        return dx, dw, None, None


def grouped_matmul(x, w, tile_expert, bm=256, bf=None):
    """Differentiable grouped matmul on the group-aligned sorted layout:
    ``x [N, D]`` (N = T*bm), ``w [E, D, F]``, ``tile_expert [T]`` ->
    ``y [N, F]``.  ``bf`` is the reference's TPU stripe width, accepted
    and unused."""
    return _GroupedMatmul.apply(x, w, tile_expert, int(bm))


#: kernel launches since the counts were last reset, per kernel (the
#: CPU path and the plain versions never touch them)
grouped_matmul.launches = {"gmm": 0, "gmm_dxt": 0, "tgmm": 0}
