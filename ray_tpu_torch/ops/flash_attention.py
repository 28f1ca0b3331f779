"""Flash attention forward: a hand-written CUDA kernel and its plain
PyTorch version.

Port of the forward half of `ray_tpu/ops/flash_attention.py`. There the
Pallas kernels `_fwd_single_kernel` (K/V in one chunk, T <= 2048) and
`_fwd_kernel` (online softmax across KV chunks, T > 2048) compute one
function; here one CUDA kernel, `csrc/flash_attention_fwd.cu`, covers
both (its header says how, what bounds it and what a later PR would
change). The TPU block-size policy and fallback rules do not carry over:
the kernel takes any T, masking the ragged last tile itself.

The wrapper's API matches `full_attention`: q is [B, T, H, D], k/v are
[B, T, H_kv, D] with H % H_kv == 0, read in place through their strides
(no transpose copies), so the q/k/v views of a fused QKV projection go
straight in.

* A CPU tensor takes `flash_attention_plain`, the kernel's function in
  plain PyTorch (scores and softmax in f32, P rounded to the value dtype
  before P·V, the -1e30 mask and the 1e-20 sum floor of
  `full_attention`).
* A CUDA tensor launches the kernel or raises: there is no fallback.
  The kernel takes bf16 and fp16 (tensor cores) and f32 (CUDA cores), at
  head_dim 16, 32, 64 or 128.
* The kernel has no gradient yet: serving calls it under
  `torch.inference_mode()`, and a CUDA tensor that requires grad is
  refused. The backward kernels and the `torch.autograd.Function` come
  with the training slice.

`flash_attention.launches` counts kernel launches (and nothing else), so
a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.parallel.ring_attention import NEG_INF, expand_kv_heads

KERNEL = "flash_attention_fwd"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: Optional[float] = None):
    """The kernel's function in plain PyTorch: returns (O [B, T, H, D] in
    q.dtype, lse [B, H, T] in f32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = expand_kv_heads(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)                                  # [B, H, T]
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    lse = m[..., 0] + torch.log(l)
    return out.to(q.dtype), lse


def _kernel_fn():
    fn = _build.load(KERNEL).flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q/k/v must be [B, T, H, D]")
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, t) or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)}/{tuple(v.shape)} do "
            f"not match q {tuple(q.shape)} (self-attention, [B, T, H_kv, D])")
    if h_kv == 0 or h % h_kv:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {h_kv} KV heads")
    if t == 0 or b == 0:
        raise ValueError("flash_attention: empty batch or sequence")
    if b > 65535 or h > 65535:
        raise ValueError("flash_attention: batch and heads must be "
                         "<= 65535 (grid limits)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"flash_attention: the CUDA kernel takes float32, float16 or "
            f"bfloat16 q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
            f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes "
                         f"head_dim {HEAD_DIMS}, got {d}")
    if any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward yet; call it "
            "under torch.inference_mode(). Gradients come with the "
            "training slice of the port (the backward kernels).")
    vec = 16 // q.element_size()  # the kernel reads 16-byte vectors
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or x.data_ptr() % 16 or any(
                s % vec for s in x.stride()[:3]):
            raise ValueError(
                f"flash_attention: {name} must have a contiguous last dim, "
                f"16-byte alignment and strides that are multiples of "
                f"{vec} elements, got strides {x.stride()}")


def _flash_attention_cuda(q, k, v, causal: bool, scale: float):
    _check_cuda_inputs(q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODE[q.dtype], d, b, h, k.shape[2],
                 t, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], float(scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """Drop-in for `full_attention` (q [B, T, H, D], k/v [B, T, H_kv, D]).
    Returns O [B, T, H, D] in q's dtype, or (O, lse [B, H, T] f32) with
    `return_lse=True`. CUDA tensors run the hand-written kernel (or
    raise), CPU tensors its plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        out, lse = _flash_attention_cuda(q, k, v, causal, scale)
    elif q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal=causal,
                                         scale=scale)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return (out, lse) if return_lse else out


flash_attention.launches = 0
