"""Blockwise (flash) attention (port of the JAX package's
``ops/flash_attention.py``).

FlashAttention-2: the forward keeps a running max ``m``, normaliser
``l`` and an f32 accumulator per query row while it streams key/value
tiles, and saves the log-sum-exp ``lse = m + log(l)``; the backward
recomputes the probabilities from ``lse`` instead of storing them, and
uses ``delta = rowsum(f32 dO * f32 O)`` computed outside the kernels.

Three hand-written Hopper kernels in ``csrc/flash_attention.cu``
replace the TPU kernels: K2 (forward, ``_fwd_kernel``), K3 (dQ,
``_dq_kernel``) and K4 (dK/dV, ``_dkv_kernel``).  :func:`flash_attention`
is a :class:`torch.autograd.Function` whose forward launches K2 and
whose backward launches K3 and K4 for CUDA tensors; for CPU tensors it
runs the plain PyTorch versions :func:`flash_forward_reference` and
:func:`flash_backward_reference` (the kernels' oracles).  There is no
fallback from one to the other.  In bf16 all three are warp-specialised
Hopper kernels (``flash_fwd_wgmma``, ``flash_dq_wgmma``,
``flash_dkv_wgmma``: TMA loads into ``mbarrier`` rings feeding
``wgmma``); in f32 they are ``mma.sync``-shaped kernels computed with
FMAs.

The plain versions round where the reference kernels round: ``p`` to
``v``'s type before ``P·V``, ``p`` to ``dO``'s type before ``Pᵀ·dO``,
``dS`` to ``k``/``q``'s type before ``dS·K``/``dSᵀ·Q``, with a finite
``-1e30`` mask and ``lse = m + log(max(l, 1e-30))``.  Under GQA the
dK/dV contributions of a kv head's query heads are summed in f32 and
cast once.

Layout: q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]`` with ``H % Hkv ==
0`` (k/v never repeated); ``lse`` is f32 ``[B, H, S]``.
"""

import torch

from tensorflowonspark_tpu_torch.ops import _build

NEG_INF = -1e30  # finite mask sentinel: keeps exp() at 0 without NaNs

#: head dims and types the CUDA kernels are instantiated for
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class FlashShapeError(ValueError):
    """A head dim or type the CUDA flash kernels do not take.

    Raised by :func:`check_flash_shapes` when a flash model is built on
    the GPU, so an unsupported geometry fails at build time rather than
    at the first step."""


def check_flash_shapes(head_dim, dtype):
    """Validate ``head_dim`` and ``dtype`` (a torch dtype or its name)
    against what the kernels take: ``head_dim`` in
    :data:`KERNEL_HEAD_DIMS`, f32 or bf16.  Raises
    :class:`FlashShapeError`; returns ``None`` when legal."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None) or dtype
    problems = []
    if int(head_dim) not in KERNEL_HEAD_DIMS:
        problems.append("head_dim={0} must be one of {1}".format(
            head_dim, KERNEL_HEAD_DIMS))
    if dtype not in KERNEL_DTYPES:
        problems.append("dtype {0} is not one of {1}".format(
            dtype, [str(d) for d in KERNEL_DTYPES]))
    if problems:
        raise FlashShapeError(
            "shape not supported by the CUDA flash kernels: "
            + "; ".join(problems)
        )


def _fit_block(requested, seq_len):
    """Largest lane-aligned block <= requested that divides seq_len
    (so raising the *default* block size never breaks a sequence length
    that worked before; S=1536 fits 768, not 1024)."""
    b = min(requested, seq_len)
    if seq_len % b == 0:
        return b
    b -= b % 128  # lane-aligned candidates only
    while b >= 128:
        if seq_len % b == 0:
            return b
        b -= 128
    return None


def flash_supported(scale, seq_len, block_q, block_k):
    """Whether flash attention takes this shape/config: seq_len must
    tile by a lane-aligned block under both requested sizes (the
    reference's tiling rule, kept so a config that fails there fails
    here), and scale must be a plain number."""
    return (
        _fit_block(block_q, seq_len) is not None
        and _fit_block(block_k, seq_len) is not None
        and not isinstance(scale, torch.Tensor)
    )


def _block_sizes(seq_len, block_q, block_k):
    bq = _fit_block(block_q, seq_len)
    bk = _fit_block(block_k, seq_len)
    if bq is None or bk is None:
        raise ValueError(
            "flash attention needs seq_len {0} divisible by a "
            "lane-aligned block <= the requested sizes; pad the "
            "sequence or pass block_q/block_k".format(seq_len)
        )
    return bq, bk


# -- plain PyTorch versions (the kernels' oracles) ---------------------


def _logits(q, k, scale, causal, window):
    """Masked f32 logits ``[B, Hkv, G, S, S]`` (finite ``-1e30`` mask)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(s, device=q.device)[None, :]
        visible = qpos >= kpos
        if window:
            visible = visible & (kpos > qpos - window)
        logits = logits.masked_fill(~visible, NEG_INF)
    return logits


def _group_rows(x, hkv):
    """``[B, H, S]`` -> ``[B, Hkv, G, S, 1]``."""
    b, h, s = x.shape
    return x.reshape(b, hkv, h // hkv, s, 1)


def flash_forward_reference(q, k, v, *, causal, scale, window):
    """Plain version of K2: ``(out [B,S,H,D] in q's type, lse f32
    [B,H,S])``."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    logits = _logits(q, k, scale, causal, window)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    out = (acc / l_safe).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    lse = (m + torch.log(l_safe)).reshape(b, h, s)
    return out.to(q.dtype), lse


def _probs(q, k, lse, scale, causal, window):
    logits = _logits(q, k, scale, causal, window)
    return torch.exp(logits - _group_rows(lse, k.shape[2]))


def _delta(out, dout):
    """``rowsum(f32 dO * f32 O)`` as ``[B, H, S]``."""
    return (dout.float() * out.float()).sum(dim=-1).permute(0, 2, 1)


def _dscores(q, k, v, dout, lse, delta, scale, causal, window):
    """``(p, ds)`` f32 ``[B, Hkv, G, S, S]``."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    p = _probs(q, k, lse, scale, causal, window)
    dog = dout.reshape(b, s, hkv, h // hkv, d).float()
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - _group_rows(delta, hkv)) * scale
    return p, ds


def flash_dq_reference(q, k, v, dout, lse, delta, *, causal, scale, window):
    """Plain version of K3: ``dq [B,S,H,D]`` in q's type."""
    b, s, h, d = q.shape
    _, ds = _dscores(q, k, v, dout, lse, delta, scale, causal, window)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, s, h, d).to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, *, causal, scale,
                        window):
    """Plain version of K4: ``(dk, dv)`` ``[B,S,Hkv,D]`` in k's/v's type;
    the query heads of a kv head are summed in f32 and cast once."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    p, ds = _dscores(q, k, v, dout, lse, delta, scale, causal, window)
    qg = q.reshape(b, s, hkv, h // hkv, d)
    dog = dout.reshape(b, s, hkv, h // hkv, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dout.dtype).float(),
                      dog.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(),
                      qg.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_reference(q, k, v, out, lse, dout, *, causal, scale,
                             window):
    """Plain version of the backward (K3 and K4): ``(dq, dk, dv)``."""
    delta = _delta(out, dout)
    kw = dict(causal=causal, scale=scale, window=window)
    dq = flash_dq_reference(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_dkv_reference(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


# -- kernel launches ---------------------------------------------------


def _kernel_layout(x):
    """``x`` when the kernels can read it from its strides (unit last
    stride, 16-byte aligned rows), else a contiguous copy."""
    vec = 16 // x.element_size()
    if (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(st % vec == 0 for st in x.stride()[:3])):
        return x
    return x.contiguous()


def _kernel_operands(q, k, v, dout=None):
    """Validate what the kernels read (types, devices, shapes) and return
    ``q, k, v[, dout]`` in a layout they take."""
    check_flash_shapes(q.shape[-1], q.dtype)
    xs = (q, k, v) if dout is None else (q, k, v, dout)
    for x in xs:
        if x.dtype != q.dtype or x.device != q.device or x.dim() != 4:
            raise ValueError(
                "flash kernel operands must be 4-d, of one type and on one "
                "device; got {0} {1} {2} and {3} {4} {5}".format(
                    tuple(q.shape), q.dtype, q.device, tuple(x.shape),
                    x.dtype, x.device)
            )
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if (k.shape != v.shape or tuple(k.shape) != (b, s, hkv, d)
            or h % hkv != 0 or (dout is not None and dout.shape != q.shape)):
        raise ValueError(
            "flash kernels take q/dO [B,S,H,D] and k/v [B,S,Hkv,D] with "
            "H % Hkv == 0; got q={0} k={1} v={2}".format(
                tuple(q.shape), tuple(k.shape), tuple(v.shape))
        )
    return tuple(_kernel_layout(x) for x in xs)


def _rows(x, q, name):
    """``x`` as the contiguous f32 ``[B, H, S]`` the kernels read."""
    b, s, h, _ = q.shape
    if x.dtype != torch.float32 or tuple(x.shape) != (b, h, s) \
            or x.device != q.device:
        raise ValueError(
            "{0} must be f32 [B, H, S] = {1} on {2}; got {3} {4} on "
            "{5}".format(name, (b, h, s), q.device, x.dtype, tuple(x.shape),
                         x.device)
        )
    return x.contiguous()


def _strides(*xs):
    return [st for x in xs for st in x.stride()[:3]]


def _common(q, k, scale, causal, window):
    b, s, h, d = q.shape
    return [b, s, h, k.shape[2], d, float(scale), int(causal), int(window),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream]


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(
            "flash {0} kernel launch failed with CUDA error {1}".format(
                name, err)
        )


def _launch_fwd(q, k, v, scale, causal, window):
    """K2: ``(out, lse)``."""
    q, k, v = _kernel_operands(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.load("flash_attention")
    err = lib.tfos_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_strides(q, k, v),
        *_common(q, k, scale, causal, window),
    )
    _raise_on(err, "forward")
    flash_attention.launches["fwd"] += 1
    return out, lse


def _bwd_operands(q, k, v, dout, lse, delta):
    q, k, v, dout = _kernel_operands(q, k, v, dout)
    lse, delta = _rows(lse, q, "lse"), _rows(delta, q, "delta")
    ptrs = [x.data_ptr() for x in (q, k, v, dout, lse, delta)]
    return q, k, v, dout, ptrs, _strides(q, k, v, dout)


def _launch_dq(q, k, v, dout, lse, delta, scale, causal, window):
    """K3: ``dq`` from the saved ``lse`` and ``delta [B, H, S]``."""
    q, k, v, dout, ptrs, strides = _bwd_operands(q, k, v, dout, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    err = _build.load("flash_attention").tfos_flash_dq(
        *ptrs, dq.data_ptr(), *strides, *_common(q, k, scale, causal, window))
    _raise_on(err, "dq")
    flash_attention.launches["dq"] += 1
    return dq


def _launch_dkv(q, k, v, dout, lse, delta, scale, causal, window):
    """K4: ``(dk, dv)``, the query heads of each kv head summed inside."""
    q, k, v, dout, ptrs, strides = _bwd_operands(q, k, v, dout, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    err = _build.load("flash_attention").tfos_flash_dkv(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *strides,
        *_common(q, k, scale, causal, window))
    _raise_on(err, "dkv")
    flash_attention.launches["dkv"] += 1
    return dk, dv


def _launch_bwd(q, k, v, out, lse, dout, scale, causal, window):
    # the softmax-jacobian correction, outside the kernels as in the
    # reference
    delta = _delta(out, dout)
    dq = _launch_dq(q, k, v, dout, lse, delta, scale, causal, window)
    dk, dv = _launch_dkv(q, k, v, dout, lse, delta, scale, causal, window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward K2 (saving q, k,
    v, out and lse), backward K3 + K4 on CUDA tensors; the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        if q.device.type == "cpu":
            out, lse = flash_forward_reference(
                q, k, v, causal=causal, scale=scale, window=window)
        elif q.device.type == "cuda":
            out, lse = _launch_fwd(q, k, v, scale, causal, window)
        else:
            raise ValueError(
                "flash_attention runs on cuda or cpu tensors, got "
                "{0}".format(q.device)
            )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, window = ctx.args
        if q.device.type == "cpu":
            dq, dk, dv = flash_backward_reference(
                q, k, v, out, lse, dout, causal=causal, scale=scale,
                window=window)
        else:
            dq, dk, dv = _launch_bwd(q, k, v, out, lse, dout, scale, causal,
                                     window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, scale=None, block_q=1024,
                    block_k=1024, window=0):
    """Flash attention on ``[B, S, H, D]`` tensors (self-attention:
    q/k/v share the sequence length).

    Grouped-query attention: k/v may carry ``Hkv`` heads with
    ``H % Hkv == 0``; the kernels read each kv head for its whole query
    group, no repeated-kv materialization.

    ``window > 0`` is sliding-window (local) attention: position ``i``
    attends to ``[i-window+1, i]``; requires ``causal``.  Key tiles
    entirely behind the horizon are skipped, so compute is O(S·window).

    Differentiable (:class:`torch.autograd.Function`).  ``block_q`` /
    ``block_k`` keep the reference's tiling rule (``seq_len`` must
    divide by a lane-aligned block no larger than them); the CUDA
    kernels use their own tiles (64 rows in f32; 128 own and 64 or 128
    streamed rows in bf16) and mask a ragged tail.

    A CUDA ``q`` launches the kernels and counts each launch in
    ``flash_attention.launches`` (``fwd``, ``dq``, ``dkv``); a CPU ``q``
    runs the plain versions and counts nothing.
    """
    if k.shape != v.shape:
        raise ValueError(
            "k/v must match, got {0} {1}".format(k.shape, v.shape)
        )
    b, s, h, d = q.shape
    bk_, sk_, hkv, dk_ = k.shape
    if (b, s, d) != (bk_, sk_, dk_) or h % hkv != 0:
        raise ValueError(
            "flash attention is self-attention-shaped with grouped kv: "
            "q [B,S,H,D] vs k/v [B,S,Hkv,D], H % Hkv == 0; got q={0} "
            "k={1}".format(q.shape, k.shape)
        )
    if window:
        if window < 0:
            raise ValueError(
                "window must be positive, got {0}".format(window)
            )
        if not causal:
            raise ValueError("window attention requires causal=True")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _block_sizes(s, block_q, block_k)
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 int(window))


#: kernel launches since the counts were last reset, per kernel (the
#: CPU path and the plain versions never touch them)
flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
