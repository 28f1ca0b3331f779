"""ray_tpu_torch on the card: the CUDA flash-attention kernel against
its plain version, and the engine on CUDA against the engine on the CPU.

Every test here needs an NVIDIA GPU and `nvcc` and skips without them.
On a machine with a card (and no JAX), run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)

pytestmark = pytest.mark.cuda

# kernel vs plain: both accumulate in f32; they differ in summation
# order and in the max each P element is rounded against (see
# chip_smoke.TOL), then O is rounded to the input dtype
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float16: (4e-3, 1e-3),
       torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 reference
    return torch.device("cuda")


@pytest.mark.parametrize("b,t,h,h_kv,d,dtype,causal", [
    (1, 16, 12, 12, 64, torch.bfloat16, True),
    (2, 100, 12, 4, 64, torch.bfloat16, True),     # ragged, GQA
    (1, 333, 4, 1, 128, torch.bfloat16, False),
    (1, 1024, 12, 12, 64, torch.float16, True),
    (1, 65, 4, 2, 64, torch.float32, True),
    (1, 130, 2, 2, 128, torch.float32, False),
    (2, 40, 2, 2, 32, torch.bfloat16, True),       # tiny GPT head_dim
    (1, 70, 4, 2, 16, torch.float32, True),        # tiny Llama head_dim
])
def test_kernel_matches_plain(cuda, b, t, h, h_kv, d, dtype, causal):
    gen = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn(b, t, n, d, generator=gen, device=cuda).to(dtype)
               for n in (h, h_kv, h_kv))
    before = flash_attention.launches
    with torch.inference_mode():
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    tol_o, tol_lse = TOL[dtype]
    assert out.dtype == dtype and lse.shape == (b, h, t)
    assert float((out.float() - ref.float()).abs().max()) <= tol_o
    assert float((lse - ref_lse).abs().max()) <= tol_lse


def test_requires_grad_is_refused(cuda):
    q = torch.randn(1, 16, 2, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="training slice"):
        flash_attention(q, q.detach(), q.detach())


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_engine_on_cuda_matches_cpu(cuda, family):
    """The tiny f32 engine emits the same greedy tokens on the card
    (flash kernel, f32 path) as on the CPU (plain path)."""
    from ray_tpu_torch.models import gpt, llama
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    mod = gpt if family == "gpt" else llama
    cfg = (gpt.GPTConfig if family == "gpt" else llama.LlamaConfig).tiny(
        dtype=torch.float32)
    params = mod.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    # projections 8x their init scale: the blocks, not the tied
    # embedding, then pick each token (varied streams, clear margins)
    params = {k: p * 8 if k.endswith(".weight") else p
              for k, p in params.items()}
    outs = []
    before = flash_attention.launches
    for dev in ("cpu", cuda):
        eng = LLMEngine(family, cfg,
                        {k: p.to(dev) for k, p in params.items()},
                        EngineConfig(batch_buckets=(1, 2, 4),
                                     prefill_buckets=(8, 16)), device=dev)
        reqs = [eng.submit(p, 6)
                for p in ([5, 9, 3], [7], list(range(1, 12)))]
        eng.run_until_idle()
        outs.append([r.result() for r in reqs])
        assert eng.shutdown() == 0
    assert outs[0] == outs[1]
    assert flash_attention.launches == before + 3 * cfg.n_layer
