"""The matrix products of the references, in float32 or in fp8.

`matmul` is the plain float32 product (TF32 off: `no_tf32()`). `fp8` is
the product one precision step below the configurations' bfloat16, as fp8
training computes it: each operand scaled per tensor to its absolute
maximum and rounded to float8 (e4m3 forward; e5m2 for the gradient in the
backward), the product accumulated in float32. It is the control of the
output checks: a program that computed in fp8 has to fail them.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def matmul(a, b):
    return torch.matmul(a, b)


def _fake_quant(x, dtype, fmax):
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, fmax / amax, torch.ones_like(amax))
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        qa = _fake_quant(a, torch.float8_e4m3fn, _E4M3_MAX)
        qb = _fake_quant(b, torch.float8_e4m3fn, _E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fake_quant(g, torch.float8_e5m2, _E5M2_MAX)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # broadcast batch dimensions summed back to the operand's shape
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


def fp8(a, b):
    return _Fp8Matmul.apply(a, b)


PRECISIONS = {"float32": matmul, "fp8": fp8}
