"""Blockwise int4 weight quantization, the QLoRA base (counterpart of the
reference's ``models/quant.py``).

The storage format is the reference's, bit for bit, so a quantized tree
carries across ``models/convert.py`` unchanged:

- each ``block_size`` slice of a kernel column along the input dim shares
  one bf16 scale, ``absmax / 7`` rounded to bf16 before it divides; values
  are rounded half to even and clipped to [-7, 7], so zero is exact;
- two nibbles per uint8 along the input dim, the even input row in the low
  nibble: an ``(in, out)`` kernel is ``(in/2, out)`` uint8 plus
  ``(in/block, out)`` bf16 scales.  Leading axes (a stack of experts) are
  carried through.

:class:`Int4Matmul` is the projection ``x @ dequantize(packed, scales)``
as a ``torch.autograd.Function``: the backward dequantizes again to form
``grad_x`` and returns no gradient for the base, so autograd never keeps a
dequantized weight alive between the forward and the backward (the
reference gets the same from XLA's rematerialisation).

Dequantization runs inside a ``torch.profiler`` range named
``int4_dequantize``, so a trace can tell its time from the products'.
"""

from __future__ import annotations

import torch


def quantize_int4(w: torch.Tensor, block_size: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """``(..., in, out)`` float -> (packed ``(..., in/2, out)`` uint8, scales
    ``(..., in/block, out)`` bf16), on ``w``'s device.

    ``in`` must divide by ``block_size`` and ``block_size`` must be even."""
    *lead, in_f, out_f = w.shape
    if in_f % block_size or block_size % 2:
        raise ValueError(f"in={in_f} must divide by even block_size={block_size}")
    wb = w.to(torch.float32).reshape(*lead, in_f // block_size, block_size, out_f)
    absmax = wb.abs().amax(dim=-2, keepdim=True)
    # the scale rounds to its stored precision BEFORE it divides, so the
    # round trip stays within scale/2 per element.  The 7 is a tensor: CUDA
    # turns a division by a Python scalar into a multiply by its reciprocal,
    # which rounds differently from the reference's true division
    seven = torch.full((), 7.0, dtype=torch.float32, device=w.device)
    scales = (absmax / seven).to(torch.bfloat16).to(torch.float32)
    q = torch.clamp(torch.round(wb / torch.clamp_min(scales, 1e-12)), -7, 7).to(torch.int8)
    del wb
    q = q.reshape(*lead, in_f, out_f)
    lo = (q[..., 0::2, :] & 0x0F).to(torch.uint8)
    hi = (q[..., 1::2, :] & 0x0F).to(torch.uint8)
    packed = lo | (hi << 4)
    return packed, scales.reshape(*lead, in_f // block_size, out_f).to(torch.bfloat16)


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor, *,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_int4` -> ``(..., in, out)`` in ``dtype``:
    the nibbles sign-extended and multiplied by the scale, with the bits of
    the reference's f32 multiply followed by a cast to ``dtype``."""
    with torch.profiler.record_function("int4_dequantize"):
        return _dequantize(packed, scales, dtype)


def _dequantize(packed: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    *lead, half, out_f = packed.shape
    in_f = half * 2
    n_blocks = scales.shape[-2]
    # shift each nibble to the top of a byte and back as int8: an arithmetic
    # shift sign-extends the 4-bit two's complement
    lo = (packed << 4).view(torch.int8) >> 4
    hi = packed.view(torch.int8) >> 4
    q = torch.stack([lo, hi], dim=-2).reshape(*lead, n_blocks, in_f // n_blocks, out_f)
    if dtype in (torch.float32, torch.bfloat16):
        # a nibble times a bf16 scale is exact in f32, so one multiply in
        # ``dtype`` rounds the exact product once, as the cast of the f32
        # product does: the same bits with half the memory traffic
        w = q.to(dtype) * scales.to(dtype).unsqueeze(-2)
    else:
        w = (q.to(torch.float32) * scales.to(torch.float32).unsqueeze(-2)).to(dtype)
    return w.reshape(*lead, in_f, out_f)


class Int4Matmul(torch.autograd.Function):
    """``x @ dequantize_int4(packed, scales, dtype)`` (batched over leading
    axes, as ``torch.matmul``).  Saves only ``packed`` and ``scales``; the
    backward dequantizes again for ``grad_x`` and gives the frozen base no
    gradient."""

    @staticmethod
    def forward(ctx, x, packed, scales, dtype):
        ctx.save_for_backward(packed, scales)
        ctx.dtype = dtype
        return x @ dequantize_int4(packed, scales, dtype=dtype)

    @staticmethod
    def backward(ctx, grad_y):
        packed, scales = ctx.saved_tensors
        w = dequantize_int4(packed, scales, dtype=ctx.dtype)
        return grad_y @ w.transpose(-1, -2), None, None, None


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The int4 projection ``x @ W`` of :class:`Int4Matmul`."""
    return Int4Matmul.apply(x, packed, scales, dtype)
