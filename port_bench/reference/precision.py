"""The control's lower precision: every product of the reference with its
operands rounded to float8 e4m3 and, in a backward, the gradient that comes
into it rounded to float8 e5m2 (the usual hybrid recipe of fp8 training),
each tensor scaled by its own absolute maximum so that it spans the format;
the product and everything else in float32.  It is the step below the
bfloat16 that the configurations state, the one a later change would be
tempted to take.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _rounded(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FORMATS[fmt], torch.ones_like(amax)).to(x.dtype)
    return (x.detach() / scale).to(fmt).to(x.dtype) * scale


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, torch.float8_e5m2)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 at a per-tensor scale, back in its dtype;
    the gradient passes straight through the rounding."""
    if not torch.is_tensor(x) or not x.is_floating_point():
        return x
    return x + (_rounded(x, torch.float8_e4m3fn) - x).detach()


def _product_out(y):
    """A product's output, whose gradient a backward rounds to e5m2."""
    if torch.is_tensor(y) and y.is_floating_point() and y.requires_grad:
        return _GradE5M2.apply(y)
    return y


@contextlib.contextmanager
def fp8_products():
    """Inside the block, ``F.linear``, the convolutions, ``torch.einsum``,
    ``torch.matmul``, ``torch.bmm`` and ``@`` round their operands to e4m3
    and the gradients of their outputs to e5m2."""
    saved = {(F, "linear"): F.linear, (F, "conv1d"): F.conv1d, (F, "conv2d"): F.conv2d,
             (F, "conv_transpose1d"): F.conv_transpose1d, (torch, "einsum"): torch.einsum,
             (torch, "matmul"): torch.matmul, (torch, "bmm"): torch.bmm,
             (torch.Tensor, "__matmul__"): torch.Tensor.__matmul__}

    def two(fn):
        def wrapped(a, b, *args, **kwargs):
            return _product_out(fn(round_fp8(a), round_fp8(b), *args, **kwargs))
        return wrapped

    def einsum(eq, *ops):
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        return _product_out(saved[torch, "einsum"](eq, *[round_fp8(o) for o in ops]))

    try:
        for (owner, name), fn in saved.items():
            setattr(owner, name, einsum if name == "einsum" else two(fn))
        yield
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)
