"""Layer primitives on tensors, with the JAX package's dtype policy.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/layers.py``.
Activations are [B, T, C].  Weights are in torch layout: linear
[out, in], conv [Cout, Cin/groups, K] (``models/params.from_jax`` converts
the JAX [in, out] and [K, Cin/groups, Cout] leaves once, at load).

- ``linear`` casts x and w to the compute dtype, accumulates in fp32,
  returns fp32 and adds the bias in fp32; its backward is explicit
  (``_Matmul``), with the JAX package's plain and fast rules;
- ``layer_norm`` computes in fp32 and returns the input dtype;
- ``conv1d`` and ``conv2d`` return the operand dtype.  ``conv2d`` keeps
  torch's layout, x [B, C, H, W] and w [Cout, Cin, KH, KW], where the JAX
  package's is NHWC with an HWIO kernel; ``models/params`` converts the
  kernel at load, and the models put the axes where the JAX models have
  them;
- ``max_pool2d`` keeps the floor-division output size (VALID);
- ``batch_norm`` computes in fp32 and returns the input dtype; in training
  it normalises with the batch's biased variance and moves the running
  statistics towards its mean and unbiased variance, over every data
  shard of a data-parallel step (``parallel/mesh.batch_shard``);
- ``gelu`` is exact (erf) unless ``approximate`` selects the tanh form;
- ``embedding`` gathers rows of a [num, dim] table, which keeps that
  layout in both packages.

While ``torch.export`` records a program (``torch.compiler.is_exporting``),
the products whose formulation depends on the device (``linear``'s,
``conv1d``'s and ``conv2d``'s) go through the ``scl_port`` ops of ``ops/custom_ops``, which
pick it when the program runs, on the CPU or on the card; eager calls
take the direct route, which costs no dispatch of an op.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from scl_deepfake_audio_detection_torch.ops import custom_ops  # noqa: F401  (registers the ops)
from scl_deepfake_audio_detection_torch.parallel import mesh as _mesh

from scl_deepfake_audio_detection_torch.utils.tree import keyed_leaves


def dewire_pcm16(x: torch.Tensor) -> torch.Tensor:
    """Inverse of the int16 PCM wire format (``utils.audio_io.pcm16_encode``):
    int16 rescales to fp32, anything else passes through."""
    return x.float() / 32768.0 if x.dtype == torch.int16 else x


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def dropout(x: torch.Tensor, rate: float, train: bool = False,
            generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None,
            part: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Identity at eval or rate 0.  In training, a Bernoulli keep-mask at
    1 - rate drawn from ``generator`` (or the given boolean ``mask``, which
    lets a test hand in another framework's draws), and x / keep where kept.

    The draws do not depend on how a step is split: under a data-parallel
    step (``parallel/mesh.batch_shard``) the mask is the whole step's (drawn,
    or given) and x takes its shard's rows; ``part`` = (dim, index, count)
    says x is part ``index`` of ``count`` equal parts on ``dim`` of the
    tensor the mask is drawn for (a tensor-parallel shard)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shard = _mesh.current_shard()
    rows = shard is not None and x.shape[0] == shard.stop - shard.start
    if mask is None:
        shape = list(x.shape)
        if rows:
            shape[0] = shard.total
        if part is not None:
            shape[part[0]] *= part[2]
        mask = torch.rand(shape, device=x.device, generator=generator) < keep
    if rows and mask.shape[0] == shard.total:
        mask = mask[shard.start:shard.stop]
    if part is not None and mask.shape[part[0]] != x.shape[part[0]]:
        dim, index, count = part
        n = mask.shape[dim] // count
        mask = mask.narrow(dim, index * n, n)
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


def _mm_f32(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """x [N, in] @ w_t [in, out] with fp32 accumulation and an fp32 result.
    CUDA reads bf16 operands directly (``out_dtype``); the CPU upcasts,
    which gives the same exact products."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x, w_t, out_dtype=torch.float32)
    return torch.mm(x.float(), w_t.float())


def _matmul_fp32(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    if torch.compiler.is_exporting():
        return torch.ops.scl_port.mm_f32(x, w_t)
    return _mm_f32(x, w_t)


def _matmul_to(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ b with fp32 accumulation, rounded once to ``dtype``.  CUDA runs
    same-dtype operands as one cuBLAS GEMM (fp32 accumulation inside)."""
    if a.is_cuda and a.dtype == b.dtype:
        return torch.mm(a, b).to(dtype)
    return _matmul_fp32(a, b).to(dtype)


class _Matmul(torch.autograd.Function):
    """y = x @ w^T in fp32 from operands in the compute dtype, with the JAX
    package's two transpose rules (``ops/layers._matmul`` and
    ``_matmul_fast_bwd``):

    - plain: the fp32 cotangent against the operands, dX = dy W and
      dW = dy^T X with fp32 accumulation, each in its operand's dtype;
    - fast: the cotangent is first cast to the operand dtype, so both
      transpose GEMMs run on bf16 operands (one extra rounding of dy).

    Both have the same forward; with fp32 operands they are the same."""

    @staticmethod
    def forward(ctx, x2, w, fast_bwd):
        ctx.save_for_backward(x2, w)
        ctx.fast_bwd = fast_bwd
        return _matmul_fp32(x2, w.t())

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        if ctx.fast_bwd:
            dy = dy.to(w.dtype)
        need_dx, need_dw, _ = ctx.needs_input_grad
        dx = _matmul_to(dy, w.to(dy.dtype), x2.dtype) if need_dx else None
        dw = _matmul_to(dy.t(), x2.to(dy.dtype), w.dtype) if need_dw else None
        return dx, dw, None


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           compute_dtype: Optional[torch.dtype] = None,
           fast_bwd: bool = False) -> torch.Tensor:
    """x [..., in], w [out, in] -> fp32 [..., out]."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        y = _Matmul.apply(x2, w, fast_bwd)
    else:  # nothing to differentiate: skip the Function's host cost
        y = _matmul_fp32(x2, w.t())
    y = y.reshape(*x.shape[:-1], w.shape[0])
    return y if b is None else y + b.float()


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 layer norm over the last axis; returns x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


Padding = Union[str, Sequence[Tuple[int, int]]]


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: Padding = "VALID", groups: int = 1,
           dilation: int = 1,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [B, T, Cin], w [Cout, Cin/groups, K] -> [B, T', Cout] in the operand
    dtype.  ``padding`` is 'VALID' or [(lo, hi)]; the bias is added in the
    operand dtype."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if torch.compiler.is_exporting():
        (lo, hi), = [(0, 0)] if padding == "VALID" else padding
        return torch.ops.scl_port.conv1d(x, w, b, stride, lo, hi, groups, dilation)
    return _conv1d(x, w, b, stride, padding, groups, dilation)


def _conv1d(x, w, b, stride, padding, groups, dilation) -> torch.Tensor:
    """``conv1d`` on operands already in one dtype."""
    xc = x.transpose(1, 2)
    if padding != "VALID":
        (lo, hi), = padding
        xc = F.pad(xc, (lo, hi))
    bias = None if b is None else b.to(x.dtype)
    if not x.is_cuda and x.dtype != torch.float32:
        # The CPU computes the low-precision conv in fp32 (exact products,
        # fp32 sums, one rounding): torch's CPU bf16 grouped conv1d returns
        # wrong values (off by whole units at groups=4 in torch 2.13).
        y = F.conv1d(xc.float(), w.float(), None if bias is None else bias.float(),
                     stride=stride, groups=groups, dilation=dilation).to(x.dtype)
    else:
        y = F.conv1d(xc, w, bias, stride=stride, groups=groups, dilation=dilation)
    return y.transpose(1, 2)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride=(1, 1), padding: Padding = "VALID",
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [B, Cin, H, W], w [Cout, Cin, KH, KW] -> [B, Cout, H', W'] in the
    operand dtype.  ``padding`` is 'VALID' or [(top, bottom), (left,
    right)]; the bias is added in the operand dtype."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    sh, sw = _pair(stride)
    (pt, pb), (pl, pr) = ((0, 0), (0, 0)) if padding == "VALID" else padding
    if torch.compiler.is_exporting():
        return torch.ops.scl_port.conv2d(x, w, b, sh, sw, pt, pb, pl, pr)
    return _conv2d(x, w, b, (sh, sw), (pt, pb, pl, pr))


def _conv2d(x, w, b, stride, pads) -> torch.Tensor:
    """``conv2d`` on operands already in one dtype; ``pads`` is (top,
    bottom, left, right)."""
    pt, pb, pl, pr = pads
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        x, pad = F.pad(x, (pl, pr, pt, pb)), (0, 0)
    bias = None if b is None else b.to(x.dtype)
    if not x.is_cuda and x.dtype != torch.float32:
        # as conv1d: the CPU computes low-precision convs in fp32, rounds once
        return F.conv2d(x.float(), w.float(), None if bias is None else bias.float(),
                        stride=stride, padding=pad).to(x.dtype)
    return F.conv2d(x, w, bias, stride=stride, padding=pad)


def max_pool2d(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """Max pool over the last two axes of [B, C, H, W]; the stride defaults
    to the window, the output size is floor-divided (VALID)."""
    window = _pair(window)
    return F.max_pool2d(x, window, window if stride is None else _pair(stride))


def selu(x: torch.Tensor) -> torch.Tensor:
    return F.selu(x)


def init_embedding(table: torch.Tensor, std: Optional[float] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill a token table [num, dim] in place from N(0, std); std defaults
    to 1, as torch's ``nn.Embedding``."""
    return table.normal_(0.0, 1.0 if std is None else std, generator=generator)


def embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [num, dim] at integer ``ids`` [...] -> [..., dim],
    in the table's dtype."""
    return F.embedding(ids.long(), table)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, train: bool,
               eps: float = 1e-5, momentum: float = 0.1) -> torch.Tensor:
    """Batch norm of x [N, C, ...] over every axis but the channel axis 1,
    computed in fp32 (or x's wider dtype) and returned in x's dtype, by
    torch's fused batch norm.

    Training normalises with the batch's mean and biased variance and
    moves the fp32 running ``mean`` and ``var`` in place (no gradient) to
    ``(1 - momentum) * old + momentum * batch``, with the unbiased variance
    n / (n - 1), the JAX package's n / max(n - 1, 1) for every n > 1; a
    batch of one value a channel is refused (ValueError), where the JAX
    package moves the variance towards 0: the training views are never
    fewer than 2.  Eval normalises with the running statistics and leaves
    them as they are."""
    acc = torch.promote_types(x.dtype, torch.float32)
    shard = _mesh.current_shard() if train else None
    if shard is not None:
        return _synced_batch_norm(x, scale, bias, mean, var, eps, momentum, acc, shard)
    y = F.batch_norm(x.to(acc), mean, var, scale.to(acc), bias.to(acc), training=train,
                     momentum=momentum, eps=eps)
    return y.to(x.dtype)


def _synced_batch_norm(x, scale, bias, mean, var, eps, momentum, acc, shard):
    """Training batch norm over the values of every data shard (the JAX
    package's batch norm of a sharded batch; each shard holds as many, of
    its own clips, whether x is [N, C, ...] or the graph layers' [N * nodes,
    C]): the channel sums, then the sums of squared deviations from the
    whole batch's mean, each through a differentiable all-reduce over the
    data ranks; every rank moves the running statistics alike."""
    xa = x.to(acc)
    axes = [0] + list(range(2, x.dim()))
    n = shard.size * (xa.numel() // xa.shape[1])
    if n < 2:
        raise ValueError("batch norm in training needs more than one value a channel")
    shape = [1, -1] + [1] * (x.dim() - 2)
    m = _mesh.all_reduce_sum(xa.sum(axes), shard.group) / n
    d = xa - m.view(shape)
    v = _mesh.all_reduce_sum((d * d).sum(axes), shard.group) / n
    with torch.no_grad():
        mean.mul_(1.0 - momentum).add_(momentum * m.detach())
        var.mul_(1.0 - momentum).add_(momentum * v.detach() * (n / (n - 1)))
    y = d * torch.rsqrt(v + eps).view(shape) * scale.to(acc).view(shape) + bias.to(acc).view(shape)
    return y.to(x.dtype)


def _size(leaf) -> int:
    n = 1
    for d in leaf.shape:
        n *= int(d)
    return n


def param_count(params) -> int:
    """Parameters in a tree whose leaves have a ``shape`` (numpy arrays,
    tensors, ``meta`` tensors)."""
    return sum(_size(v) for _, v in keyed_leaves(params))


def param_table(params) -> str:
    """Per-leaf table of a JAX-layout parameter tree: path, count, share,
    shape, as the JAX package prints it (the reference's
    ``core_scripts/other_tools/script_model_para.py:26-43``)."""
    leaves = list(keyed_leaves(params))
    total = sum(_size(v) for _, v in leaves)
    lines = [f"Parameter number: {total:d}"]
    for name, v in leaves:
        n = _size(v)
        lines.append(f"Layer: {name}\tPara. num: {n:<10d} "
                     f"({100.0 * n / max(total, 1):04.1f}%)\tShape: {tuple(int(d) for d in v.shape)}")
    return "\n".join(lines)
