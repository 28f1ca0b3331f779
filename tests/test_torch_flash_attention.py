"""ray_tpu_torch attention against the JAX package.

The port's `flash_attention` (its plain path: these tensors lie on the
CPU) and `full_attention` must match JAX `full_attention` and the raw
Pallas forward kernels run in interpret mode — O and the per-row lse, in
f32, at atol/rtol 1e-5. The CUDA kernel itself is checked against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py);
here the wrapper's input checks, which guard that launch, are covered.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops.flash_attention import _flash, _fwd  # noqa: E402
from ray_tpu.parallel.ring_attention import (  # noqa: E402
    full_attention as jax_full_attention)
from ray_tpu_torch.ops.flash_attention import (  # noqa: E402
    _check_cuda_inputs, flash_attention, flash_attention_plain)
from ray_tpu_torch.parallel.ring_attention import (  # noqa: E402
    full_attention)

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(b, t, h, h_kv, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, h_kv, d)).astype(np.float32)
    return q, k, v


def _jax_lse(q, k, causal):
    """Per-row logsumexp [B, H, T] of the masked, scaled scores."""
    group = q.shape[2] // k.shape[2]
    kx = jnp.repeat(jnp.asarray(k), group, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kx) \
        * q.shape[-1] ** -0.5
    if causal:
        t = q.shape[1]
        s = jnp.where(jnp.tril(jnp.ones((t, t), bool)), s, -1e30)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("t", [64, 37])  # 37: a ragged last tile
@pytest.mark.parametrize("h_kv", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_full_attention(causal, h_kv, t):
    q, k, v = _qkv(2, t, 4, h_kv, seed=t + h_kv)
    ref = np.asarray(jax_full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    out, lse = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               return_lse=True)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal), **TOL)
    dense = full_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(dense.numpy(), ref, **TOL)


@pytest.mark.parametrize("block_k", [32, 64])  # chunked / single-chunk
@pytest.mark.parametrize("h_kv", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_interpret(causal, h_kv, block_k):
    """Against the raw Pallas kernels in interpret mode, run as
    tests/test_ops.py runs them: block_k == T reaches
    `_fwd_single_kernel`, block_k < T the chunked `_fwd_kernel`."""
    q, k, v = _qkv(1, 64, 4, h_kv, seed=7 + h_kv)
    qt, kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v))
    group = 4 // h_kv
    scale = 64 ** -0.5
    ref = np.asarray(_flash(qt, kt, vt, scale, causal, 32, block_k, group,
                            True).transpose(0, 2, 1, 3))
    _, ref_lse = _fwd(qt, kt, vt, scale, causal, 32, block_k, group, True)
    out, lse = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               return_lse=True)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **TOL)


def test_plain_path_keeps_dtype_and_counts_no_launch():
    """CPU tensors take the plain version: output in q's dtype, lse in
    f32, and the launch counter (kernel launches only) is untouched."""
    q, k, v = (_t(x).to(torch.bfloat16) for x in _qkv(1, 16, 4, 2))
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, return_lse=True)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 16)
    assert flash_attention.launches == before
    # P is rounded to the value dtype before P.V, as in the kernel
    ref, _ = flash_attention_plain(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max() < 3e-2


def test_unsupported_device_raises():
    q = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)


def _ok():
    return (torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16),
            torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16),
            torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16))


@pytest.mark.parametrize("case,exc,match", [
    ("head_dim", ValueError, "head_dim"),
    ("dtype", TypeError, "float32, float16 or"),
    ("groups", ValueError, "multiple of"),
    ("grad", RuntimeError, "training slice"),
    ("stride", ValueError, "contiguous last dim"),
    ("shape", ValueError, "do not match"),
])
def test_kernel_input_checks(case, exc, match):
    """What the CUDA launch refuses, checked before any pointer is
    passed (the checks are device-independent)."""
    q, k, v = _ok()
    _check_cuda_inputs(q, k, v)  # the base case is accepted
    if case == "head_dim":
        q, k, v = (x[..., :48].contiguous() for x in (q, k, v))
    elif case == "dtype":
        q, k, v = (x.to(torch.float64) for x in (q, k, v))
    elif case == "groups":
        k = v = torch.zeros(1, 8, 3, 64, dtype=torch.bfloat16)
    elif case == "grad":
        q = q.float().requires_grad_()
        k, v = k.float(), v.float()
    elif case == "stride":
        q = torch.zeros(1, 8, 4, 128, dtype=torch.bfloat16)[..., ::2]
    elif case == "shape":
        k = torch.zeros(1, 9, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(exc, match=match):
        _check_cuda_inputs(q, k, v)


def test_fused_qkv_views_are_accepted():
    """The split views of a fused QKV projection ([B, T, 3*H*D] cut in
    three) satisfy the kernel's stride rules: no copy is needed."""
    qkv = torch.zeros(2, 8, 3 * 12 * 64, dtype=torch.bfloat16)
    q, k, v = (x.reshape(2, 8, 12, 64) for x in qkv.split(768, dim=-1))
    assert not q.is_contiguous()
    _check_cuda_inputs(q, k, v)
