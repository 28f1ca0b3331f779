"""Flash attention: hand-written CUDA kernels, forward and backward, and
their plain PyTorch versions.

Port of `ray_tpu/ops/flash_attention.py`. There the Pallas kernels
`_fwd_single_kernel` (K/V in one chunk, T <= 2048) and `_fwd_kernel`
(online softmax across KV chunks, T > 2048) compute the forward; here one
CUDA kernel, `csrc/flash_attention_fwd.cu`, covers both. The backward
kernels `_bwd_single_kernel` (T <= 2048) and `_dq_kernel`/`_dkv_kernel`
(T > 2048) become the two kernels of `csrc/flash_attention_bwd.cu`, one
for dQ and one for dK/dV (each source's header says how, what bounds it
and what a later PR would change). The TPU block-size policy and fallback
rules do not carry over: the kernels take any T, masking the ragged last
tile themselves.

The wrapper's API matches `full_attention`: q is [B, T, H, D], k/v are
[B, T, H_kv, D] with H % H_kv == 0, read in place through their strides
(no transpose copies), so the q/k/v views of a fused QKV projection go
straight in.

* A CPU tensor takes `flash_attention_plain`, the kernel's function in
  plain PyTorch (scores and softmax in f32, P rounded to the value dtype
  before P·V, the -1e30 mask and the 1e-20 sum floor of
  `full_attention`).
* A CUDA tensor launches the kernel or raises: there is no fallback.
  The kernels take bf16 and fp16 (the Hopper route, "sm90": wgmma with
  register accumulators fed by a TMA ring, `csrc/hopper.cuh`) and f32
  (the "f32" route: CUDA-core FMAs), at head_dim 16, 32, 64 or 128; the C
  entry points choose the route by dtype (`kernel_routes` says which).
* Gradients: when grad is enabled and q, k or v requires grad,
  `flash_attention` runs through a `torch.autograd.Function` that saves
  q, k, v, O and lse; its backward is `flash_attention_bwd`, which
  dispatches the same way (the CUDA kernels or raise; the plain version
  `flash_attention_bwd_plain` for CPU tensors). Otherwise (serving, under
  `torch.inference_mode()`) the forward is called directly.

`flash_attention.launches` counts forward kernel launches and
`flash_attention_bwd.launches` backward kernel launches (two per backward
call: dQ, then dK/dV), and nothing else, so a run can show that its main
path went through the kernels. A CUDA graph capture (`parallel.
compile_cache`) adds to them too while nothing runs; the cache takes that
back and credits each replay with it.

Under a capture the forward's host side stays legal: it sets the
kernel's shared-memory attribute, encodes its TMA tensor maps from this
call's pointers and passes them by value, and allocates O and lse with
`torch.empty` (from the graph's pool); it never syncs. A replay so reads
and writes the addresses of capture time, which the compiled-step cache
keeps static.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.parallel.ring_attention import NEG_INF, expand_kv_heads

KERNEL = "flash_attention_fwd"
BWD_KERNEL = "flash_attention_bwd"
BWD_KERNELS_PER_CALL = 2  # dQ, then dK/dV
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _causal_mask(t, device):
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: Optional[float] = None):
    """The kernel's function in plain PyTorch: returns (O [B, T, H, D] in
    q.dtype, lse [B, H, T] in f32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = expand_kv_heads(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = torch.where(_causal_mask(q.shape[1], q.device), s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)                                  # [B, H, T]
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    lse = m[..., 0] + torch.log(l)
    return out.to(q.dtype), lse


def attention_delta(out, do):
    """delta = rowsum(dO * O) in f32, [B, H, T]: the softmax-jacobian term
    of the backward (`_bwd`'s XLA prologue in the JAX package)."""
    return torch.sum(do.float() * out.float(), dim=-1).transpose(1, 2)


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool = True,
                              scale: Optional[float] = None):
    """The backward kernels' function in plain PyTorch (the arithmetic of
    the Pallas `_bwd`): returns (dq, dk, dv) in the input dtypes, dk/dv
    [B, T, H_kv, D] summed over each KV head's query-head group."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    kx, vx = expand_kv_heads(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) * scale
    if causal:
        s = torch.where(_causal_mask(t, q.device), s, NEG_INF)
    p = torch.exp(s - lse[..., None])                         # [B,H,T,T]
    delta = attention_delta(out, do)                          # [B,H,T]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(v.dtype).float(), vx.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      kx.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    # expanded head h = hk * group + g reads KV head hk: sum over g
    dk = dk.reshape(b, t, h_kv, h // h_kv, d).sum(3)
    dv = dv.reshape(b, t, h_kv, h // h_kv, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_fn():
    fn = _build.load(KERNEL).flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_kernel_fns():
    lib = _build.load(BWD_KERNEL)
    fns = (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv)
    for fn in fns:
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return fns


_ROUTES = {90: "sm90", 0: "f32"}


def kernel_routes(dtype) -> dict:
    """The route each CUDA entry point takes for `dtype`, as the compiled
    libraries report it: {"fwd": "sm90" or "f32", "bwd": ...}. Builds the
    libraries if needed (needs nvcc)."""
    code = _DTYPE_CODE[dtype]
    return {"fwd": _ROUTES[_build.load(KERNEL).flash_attention_fwd_route(
                code)],
            "bwd": _ROUTES[_build.load(BWD_KERNEL).flash_attention_bwd_route(
                code)]}


def kernel_occupancy(dtype, head_dim: int) -> dict:
    """Dynamic shared memory (bytes) and resident blocks per SM of each
    kernel that `dtype` and `head_dim` launch, from the CUDA runtime on
    the current device: {"fwd": (smem, blocks), "bwd_dq": ...,
    "bwd_dkv": ...}, and "fwd_wg2" for the forward's two-warpgroup
    instance (bf16/fp16)."""
    code = _DTYPE_CODE[dtype]
    fwd = _build.load(KERNEL).flash_attention_fwd_occupancy
    bwd = _build.load(BWD_KERNEL).flash_attention_bwd_occupancy
    o = (ctypes.c_int * 4)()
    _launch(lambda: fwd(code, head_dim, o), "fwd occupancy")
    out = {"fwd": (o[0], o[1])}
    if code != 0:
        out["fwd_wg2"] = (o[2], o[3])
    for key, which in (("bwd_dq", 0), ("bwd_dkv", 1)):
        o = (ctypes.c_int * 2)()
        _launch(lambda: bwd(which, code, head_dim, o), f"{key} occupancy")
        out[key] = (o[0], o[1])
    return out


def _strides_ok(x):
    """What the kernels' copies need (TMA tensor maps; the f32 kernels'
    16-byte loads): a contiguous last dim, 16-byte alignment and strides
    that are multiples of 16 bytes."""
    vec = 16 // x.element_size()
    return x.stride(3) == 1 and x.data_ptr() % 16 == 0 and not any(
        s % vec for s in x.stride()[:3])


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
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _strides_ok(x):
            raise ValueError(
                f"flash_attention: {name} must have a contiguous last dim, "
                f"16-byte alignment and strides that are multiples of "
                f"{16 // x.element_size()} elements, got strides "
                f"{x.stride()}")


def _check_bwd_inputs(q, k, v, out, lse, do):
    """The backward launch's checks: the forward's on q/k/v, plus O and dO
    in q's shape and dtype and lse f32 [B, H, T]. Returns dO as the
    kernels read it: a dO whose strides they cannot take is copied to a
    contiguous tensor (a copy, not a fallback)."""
    _check_cuda_inputs(q, k, v)
    b, t, h, _ = q.shape
    for name, x in (("O", out), ("dO", do)):
        if x.dtype != q.dtype:
            raise TypeError(f"flash_attention_bwd: {name} must match q's "
                            f"dtype {q.dtype}, got {x.dtype}")
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(
                f"flash_attention_bwd: {name} must match q's shape "
                f"{tuple(q.shape)} on {q.device}, got {tuple(x.shape)} "
                f"on {x.device}")
    if (lse.shape != (b, h, t) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(
            f"flash_attention_bwd: lse must be f32 [B, H, T] = "
            f"{(b, h, t)} on {q.device}, got {lse.dtype} "
            f"{tuple(lse.shape)} on {lse.device}")
    return do if _strides_ok(do) else do.contiguous()


def _launch(fn, name, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def _flash_attention_cuda(q, k, v, causal: bool, scale: float):
    _check_cuda_inputs(q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(fn, KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), _DTYPE_CODE[q.dtype], d, b,
                h, k.shape[2], t, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *out.stride()[:3], float(scale),
                int(bool(causal)), stream)
    flash_attention.launches += 1
    return out, lse


def _flash_attention_bwd_cuda(q, k, v, out, lse, do, causal: bool,
                              scale: float):
    do = _check_bwd_inputs(q, k, v, out, lse, do)
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    lse = lse.contiguous()
    # delta in PyTorch ops, as the JAX package computes it in XLA
    delta = attention_delta(out, do).contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    strides = (ctypes.c_int64 * 21)(*(
        s for x in (q, k, v, do, dq, dk, dv) for s in x.stride()[:3]))
    dq_fn, dkv_fn = _bwd_kernel_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides),
                _DTYPE_CODE[q.dtype], d, b, h, h_kv, t, float(scale),
                int(bool(causal)), stream)
        _launch(dq_fn, f"{BWD_KERNEL} (dq)", *args)
        flash_attention_bwd.launches += 1
        _launch(dkv_fn, f"{BWD_KERNEL} (dkv)", *args)
        flash_attention_bwd.launches += 1
    return dq, dk, dv


def _forward(q, k, v, causal: bool, scale: float):
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of attention, given the forward's O and lse and the
    output gradient dO. CUDA tensors run the hand-written backward kernels
    (or raise), CPU tensors their plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _flash_attention_bwd_cuda(q, k, v, out, lse, do, causal,
                                         scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, scale=scale)
    raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """`jax.custom_vjp` of `_flash`: the forward saves q, k, v, O and lse,
    and the backward is `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """Drop-in for `full_attention` (q [B, T, H, D], k/v [B, T, H_kv, D]).
    Returns O [B, T, H, D] in q's dtype, or (O, lse [B, H, T] f32) with
    `return_lse=True`. CUDA tensors run the hand-written kernels (or
    raise), CPU tensors their plain versions. O is differentiable with
    respect to q, k and v (lse is not)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, causal, scale)
    else:
        out, lse = _forward(q, k, v, causal, scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd.launches = 0
