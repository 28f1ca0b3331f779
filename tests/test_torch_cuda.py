"""ray_tpu_torch on the card: the CUDA flash-attention kernels (forward
and backward) against their plain versions, the engine on CUDA against
the engine on the CPU, a tiny training step on CUDA against the same
step on the CPU, the engine's CUDA graphs (`compiled_step`) against its
eager step functions, and the train plane's graphs (a miss runs the
step once, autograd inside a graph, donation, `fold_steps`,
`TrainStepRunner`'s static aux, checkpoints restored into a live carry),
and the port's runtime with the card as its GPU (the forward kernel in
a GPU worker on tensors from the store, a CUDA tensor put in a GPU
worker fetched by the driver onto the card, a CPU worker that cannot
see the card), and the distributed train plane (a one-rank NCCL
`TorchTrainer` whose captured step holds its all-reduce, a
`platform="cuda"` worker without a GPU refused), and Data and the
compiled DAG on the card (a fused `torch_stage` chain's held results, a
capture failure that raises, a CUDA tensor across a channel from a GPU
actor, a `TorchTrainer` GPU worker on a `streaming_split` shard), and
the autoscaler (a GPU node launched for a num_gpus=1 task and retired
once idle, the card's memory back), and the operator CLI (a head started
with no `--resources` detects the card; a `client://` driver puts a CUDA
tensor through the client server and holds the kernel in a num_gpus=1
task against its plain version), and `parallel/` (a one-rank NCCL mesh
step of the tiny GPT through `TrainStepRunner(mesh=)` against the same
step without a mesh, two gloo ranks sharing the card at tp=2).

Every test here needs an NVIDIA GPU and `nvcc` and skips without them.
On a machine with a card (and no JAX), run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.ops.flash_attention import (  # noqa: E402
    BWD_KERNELS_PER_CALL, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_plain)

pytestmark = pytest.mark.cuda

# kernel vs plain: both accumulate in f32; they differ in summation
# order and in the max each P element is rounded against (see
# chip_smoke.TOL), then O is rounded to the input dtype
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float16: (4e-3, 1e-3),
       torch.float32: (1e-4, 1e-4)}
# backward kernel vs plain, relative to each gradient's max: both build P
# from the same lse and round dS and P where Pallas does; f32 sums run in
# another order, so a dS element can round to the neighbouring bf16/fp16
# value, and dq/dk/dv are rounded to the input dtype (half an ulp: 2e-3
# in bf16, 2.4e-4 in fp16 of the max)
BWD_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 reference
    return torch.device("cuda")


# h_kv = FUSED: q, k and v are strided views of one [B, T, 3, H, D]
# tensor (GPT's fused QKV projection), read in place
FUSED = "fused"

SHAPES = [
    (1, 16, 12, 12, 64, torch.bfloat16, True),
    (2, 100, 12, 4, 64, torch.bfloat16, True),     # ragged, GQA
    (1, 333, 4, 1, 128, torch.bfloat16, False),
    (1, 1024, 12, 12, 64, torch.float16, True),
    (1, 65, 4, 2, 64, torch.float32, True),
    (1, 130, 2, 2, 128, torch.float32, False),
    (2, 40, 2, 2, 32, torch.bfloat16, True),       # tiny GPT head_dim
    (1, 70, 4, 2, 16, torch.float32, True),        # tiny Llama head_dim
    (2, 100, 12, FUSED, 64, torch.bfloat16, True),  # fused QKV views
    (1, 1, 4, 2, 64, torch.bfloat16, True),        # T = 1
    (2, 65, 4, 4, 64, torch.bfloat16, True),       # T = one 64-row tile + 1
    (1, 300, 8, 2, 128, torch.bfloat16, True),     # bf16 head_dim 128, GQA
    (2, 77, 4, 4, 16, torch.float16, False),       # fp16 head_dim 16
    # grids large enough for the forward's two-warpgroup (128-row) tiles
    (24, 129, 12, 4, 64, torch.bfloat16, True),    # T = 128 + 1, GQA
    (8, 300, 12, 12, 128, torch.float16, False),
]


def _inputs(gen, b, t, h, h_kv, d, dtype, device):
    """q, k, v and dO from `gen`: [B, T, H(_kv), D], or with h_kv = FUSED
    the three views of one [B, T, 3, H, D] tensor (row stride 3 H D)."""
    if h_kv == FUSED:
        qkv = torch.randn(b, t, 3, h, d, generator=gen, device=device)
        q, k, v = qkv.to(dtype).unbind(2)
    else:
        q, k, v = (torch.randn(b, t, n, d, generator=gen,
                               device=device).to(dtype)
                   for n in (h, h_kv, h_kv))
    do = torch.randn(b, t, h, d, generator=gen, device=device).to(dtype)
    return q, k, v, do


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("b,t,h,h_kv,d,dtype,causal", SHAPES)
def test_kernel_matches_plain(cuda, b, t, h, h_kv, d, dtype, causal):
    gen = torch.Generator(device=cuda).manual_seed(t)
    q, k, v, _ = _inputs(gen, b, t, h, h_kv, d, dtype, cuda)
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


@pytest.mark.parametrize("b,t,h,h_kv,d,dtype,causal", SHAPES)
def test_backward_kernel_matches_plain(cuda, b, t, h, h_kv, d, dtype,
                                       causal):
    gen = torch.Generator(device=cuda).manual_seed(t + 1)
    q, k, v, do = _inputs(gen, b, t, h, h_kv, d, dtype, cuda)
    with torch.inference_mode():
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        before = flash_attention_bwd.launches
        got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + BWD_KERNELS_PER_CALL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        # with one key (T = 1), P = 1 and dS = P (dP - delta) is 0 in exact
        # arithmetic: dq and dk are both sides' rounding noise of dP - delta
        # (summed in different orders), held to dv's scale instead of
        # their own max
        scale = want[2] if t == 1 else w
        err = float((g.float() - w.float()).abs().max()
                    / scale.float().abs().max())
        assert err <= BWD_TOL[dtype], (name, err)


def test_backward_is_deterministic(cuda):
    """Every gradient has one owner block and no atomics: two backward
    calls on the same inputs are bitwise equal (GQA, so dK/dV sum over a
    head group)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, do = _inputs(gen, 2, 1024, 12, 4, 64, torch.bfloat16, cuda)
    with torch.inference_mode():
        out, lse = flash_attention(q, k, v, return_lse=True)
        first = flash_attention_bwd(q, k, v, out, lse, do)
        second = flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_autograd_launches_the_backward_kernel(cuda):
    """A CUDA tensor that requires grad goes through the kernels both
    ways: the gradients are the backward wrapper's, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(2, 130, n, 64, generator=gen, device=cuda)
                   .to(torch.bfloat16) for n in (4, 2, 2, 4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v)
    out.backward(do)
    assert flash_attention.launches == fwd + 1
    assert flash_attention_bwd.launches == bwd + BWD_KERNELS_PER_CALL
    with torch.no_grad():
        o, lse = flash_attention(q, k, v, return_lse=True)
        want = flash_attention_bwd(q, k, v, o, lse, do)
    for x, w in zip((q, k, v), want):
        assert torch.equal(x.grad, w)


def _train_step_cpu_and_cuda(cuda, mod, net_cls, cfg):
    """One f32 train step of `cfg` on the CPU and on the card from the
    same weights and tokens: [(loss, grads, updated params)] for each."""
    from functools import partial

    from ray_tpu_torch.ops.fused_ce import fused_cross_entropy

    params = mod.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 41),
                         generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in ("cpu", cuda):
        net = net_cls.from_params(
            cfg, {n: p.clone().to(dev) for n, p in params.items()},
            attention_fn=partial(flash_attention, causal=True),
            trainable=True)
        opt = torch.optim.AdamW(net.parameters(), lr=3e-4,
                                weight_decay=1e-4)
        t = toks.to(dev)
        hidden, wte = net(t[:, :-1], return_hidden=True)
        loss = fused_cross_entropy(hidden, wte, t[:, 1:])
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in net.named_parameters()}
        opt.step()
        runs.append((float(loss.detach()), grads,
                     {n: p.detach().cpu() for n, p in
                      net.named_parameters()}))
    return runs


def _assert_steps_agree(runs):
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = runs
    assert abs(l_cpu - l_gpu) <= 1e-4 * abs(l_cpu)
    for n in g_cpu:
        assert _rel_err(g_gpu[n], g_cpu[n]) <= 1e-4, n
        assert float((p_gpu[n] - p_cpu[n]).abs().max()) <= 1.5e-5, n


def test_train_step_on_cuda_matches_cpu(cuda):
    """One tiny f32 train step (flash attention, fused CE, remat, AdamW
    3e-4 / wd 1e-4) on the card equals the same step on the CPU: loss,
    every gradient (relative to its max) and every updated parameter.
    Tolerance 1e-4: the f32 kernels and cuBLAS sum in another order than
    the CPU's plain versions, and `index_add_` adds dw's -onehot rows with
    atomics in a varying order (f32, ~1e-7 relative each)."""
    from ray_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.tiny(dtype=torch.float32)
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    runs = _train_step_cpu_and_cuda(cuda, gpt, gpt.GPT, cfg)
    assert flash_attention.launches == fwd + 2 * cfg.n_layer  # remat
    assert flash_attention_bwd.launches == \
        bwd + BWD_KERNELS_PER_CALL * cfg.n_layer
    _assert_steps_agree(runs)


def test_llama_train_step_on_cuda_matches_cpu(cuda):
    """The same for the tiny Llama (GQA 4:2 through both kernels at
    head_dim 16, the v view strided inside the fused QKV output, RoPE,
    remat), at the same tolerances for the same reasons."""
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    runs = _train_step_cpu_and_cuda(cuda, llama, llama.Llama, cfg)
    assert flash_attention.launches == fwd + 2 * cfg.n_layer  # remat
    assert flash_attention_bwd.launches == \
        bwd + BWD_KERNELS_PER_CALL * cfg.n_layer
    _assert_steps_agree(runs)


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
    for dev in ("cpu", cuda):
        eng = LLMEngine(family, cfg,
                        {k: p.to(dev) for k, p in params.items()},
                        EngineConfig(batch_buckets=(1, 2, 4),
                                     prefill_buckets=(8, 16)), device=dev)
        eng.warmup()  # on the card: captures every bucket's graph
        before = flash_attention.launches
        reqs = [eng.submit(p, 6)
                for p in ([5, 9, 3], [7], list(range(1, 12)))]
        eng.run_until_idle()
        outs.append([r.result() for r in reqs])
        assert eng.shutdown() == 0
    assert outs[0] == outs[1]
    # each prefill replay is credited the launches its capture counted
    assert flash_attention.launches == before + 3 * cfg.n_layer


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_spec_engine_on_cuda_matches_cpu(cuda, family):
    """Speculative decoding (K=3, a self-draft and a draft with its
    embedding rolled one row) on the card emits the plain CPU engine's
    greedy tokens; the draft prefills run the flash kernel too."""
    from ray_tpu_torch.models import gpt, llama
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    mod = gpt if family == "gpt" else llama
    cfg = (gpt.GPTConfig if family == "gpt" else llama.LlamaConfig).tiny(
        dtype=torch.float32)
    params = mod.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = {k: p * 8 if k.endswith(".weight") else p
              for k, p in params.items()}
    prompts = ([5, 9, 3], [7], list(range(1, 12)))
    buckets = dict(batch_buckets=(1, 2, 4), prefill_buckets=(8, 16))
    want = []
    eng = LLMEngine(family, cfg, params, EngineConfig(**buckets),
                    device="cpu")
    reqs = [eng.submit(p, 9) for p in prompts]
    eng.run_until_idle()
    want = [r.result() for r in reqs]
    assert eng.shutdown() == 0
    on_card = {k: p.to(cuda) for k, p in params.items()}
    rolled = {k: torch.roll(p, 1, 0) if k == "wte" else p
              for k, p in on_card.items()}
    for draft in (None, rolled):
        eng = LLMEngine(family, cfg, on_card,
                        EngineConfig(spec_k=3, **buckets), device=cuda,
                        draft_params=draft)
        eng.warmup()
        before = flash_attention.launches
        reqs = [eng.submit(p, 9) for p in prompts]
        eng.run_until_idle()
        assert [r.result() for r in reqs] == want
        assert eng.metrics()["spec_rounds"] > 0
        eng.quiesce()
        assert eng.shutdown() == 0
        assert flash_attention.launches == before + 6 * cfg.n_layer


# -- compiled_step: one CUDA graph per bucket ---------------------------------


def _graph_engine(cuda, family):
    """A tiny bf16 engine on the card with speculation on (every kind of
    bucket: prefill, decode, chunk, verify and the draft's), warmed up."""
    from ray_tpu_torch.models import gpt, llama
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    cls = gpt.GPTConfig if family == "gpt" else llama.LlamaConfig
    eng = LLMEngine(family, cls.tiny(dtype=torch.bfloat16), device=cuda,
                    engine_config=EngineConfig(
                        spec_k=2, batch_buckets=(1, 2),
                        prefill_buckets=(8, 16)))
    eng.warmup()
    return eng


def _fill_arena(eng, gen):
    for kv in (eng.kv, eng.kv_d):
        kv.k_pages.copy_(torch.randn(kv.k_pages.shape, generator=gen,
                                     device=kv.k_pages.device))
        kv.v_pages.copy_(torch.randn(kv.v_pages.shape, generator=gen,
                                     device=kv.v_pages.device))


def _bucket_calls(eng, gen):
    """(name, compiled fn, host args) for every bucket of `eng`, with
    random tokens, positions and page tables."""
    vocab = eng.model_cfg.vocab_size

    def ints(*shape, high):
        return torch.randint(0, high, shape, generator=gen,
                             device=gen.device).cpu()

    out = []
    for draft in (False, True):
        kv = eng.kv_d if draft else eng.kv
        width = eng.max_pages_per_seq_d if draft else eng.max_pages_per_seq
        pre = eng._d_prefill_fns if draft else eng._prefill_fns
        dec = eng._d_decode_fns if draft else eng._decode_fns
        for s, fn in pre.items():
            out.append((fn.__name__, fn, (ints(1, s, high=vocab),
                                          ints(1, high=s) + 1)))
        for b, fn in dec.items():
            out.append((fn.__name__, fn, (
                ints(b, high=vocab), ints(b, high=eng.model_cfg.max_seq_len
                                          // 2), kv.k_pages, kv.v_pages,
                ints(b, width, high=kv.num_pages))))
        chunk = eng._d_chunk_fn if draft else eng._chunk_fn
        c = eng._chunk_size
        out.append((chunk.__name__, chunk, (
            ints(1, c, high=vocab), ints(1, high=eng.model_cfg.max_seq_len
                                         - c), kv.k_pages, kv.v_pages,
            ints(1, width, high=kv.num_pages))))
    for b, fn in eng._verify_fns.items():
        k1 = eng.config.spec_k + 1
        out.append((fn.__name__, fn, (
            ints(b, k1, high=vocab), ints(b, high=eng.model_cfg.max_seq_len
                                          - k1), eng.kv.k_pages,
            eng.kv.v_pages, ints(b, eng.max_pages_per_seq,
                                 high=eng.kv.num_pages))))
    return out


# a replay runs the eager function's kernels on the same inputs; cuBLAS
# may choose another algorithm inside a capture, so bf16 results may
# round apart by a few ulps (bf16's ulp at |x| ~ 4 is 3e-2)
GRAPH_ATOL = 6e-2


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_graph_replay_matches_eager_step(cuda, family):
    """Every captured bucket (prefill, decode, chunk, verify, and the
    draft's) gives its eager step function's outputs on the same inputs
    and arena, also after the arena's contents changed: the graph reads
    the arena live."""
    from ray_tpu_torch.parallel import cache_stats
    eng = _graph_engine(cuda, family)
    gen = torch.Generator(device=cuda).manual_seed(7)
    calls = _bucket_calls(eng, gen)
    assert len(calls) == len(eng._step_fns())
    misses = cache_stats()["misses"]
    with torch.inference_mode():
        for fill in range(2):
            _fill_arena(eng, gen)
            for name, fn, args in calls:
                got = [x.clone() for x in fn(*args)]
                want = fn.__wrapped__(*(a.to(cuda) for a in args))
                for g, w in zip(got, want):
                    assert g.shape == w.shape and g.dtype == w.dtype, name
                    err = float((g.float() - w.float()).abs().max())
                    assert err <= GRAPH_ATOL, (name, fill, err)
    assert cache_stats()["misses"] == misses  # every call a replay
    assert eng.shutdown() == 0


def test_graph_replay_credits_kernel_launches(cuda):
    """A prefill replay counts the forward kernel once per layer, as an
    eager prefill does; the capture itself counts nothing."""
    eng = _graph_engine(cuda, "gpt")
    before = flash_attention.launches
    with torch.inference_mode():
        eng._prefill([[1] * 16], [16])
    assert flash_attention.launches == before + eng.model_cfg.n_layer
    assert eng.shutdown() == 0


def test_graph_new_shape_raises_retrace(cuda):
    from ray_tpu_torch.parallel import RetraceError
    eng = _graph_engine(cuda, "gpt")
    fn = eng._decode_fns[2]
    with torch.inference_mode(), pytest.raises(RetraceError):
        fn(torch.zeros(3, dtype=torch.long), torch.zeros(3, dtype=torch.long),
           eng.kv.k_pages, eng.kv.v_pages,
           torch.zeros(3, eng.max_pages_per_seq, dtype=torch.long))
    assert eng.shutdown() == 0


def test_graph_other_arena_storage_raises(cuda):
    """A live argument is captured by address: an arena tensor of the
    same shape in another storage must raise, not replay stale memory."""
    eng = _graph_engine(cuda, "llama")
    fn = eng._decode_fns[1]
    args = (torch.zeros(1, dtype=torch.long),
            torch.zeros(1, dtype=torch.long))
    table = torch.zeros(1, eng.max_pages_per_seq, dtype=torch.long)
    with torch.inference_mode():
        fn(*args, eng.kv.k_pages, eng.kv.v_pages, table)
        other = eng.kv.k_pages.clone()
        with pytest.raises(RuntimeError, match="another storage"):
            fn(*args, other, eng.kv.v_pages, table)
    assert eng.shutdown() == 0


def test_graph_capture_of_a_host_sync_fails(cuda):
    """A step function that syncs with the host cannot be captured: the
    call raises, and nothing falls back to the eager function."""
    from ray_tpu_torch.parallel import ExecutableCache, compiled_step
    cache = ExecutableCache()

    def syncing(x):
        return x * float(x.sum().item())

    fn = compiled_step(syncing, cache=cache)
    with pytest.raises(RuntimeError):
        fn(torch.ones(4, device=cuda))
    torch.cuda.synchronize()
    assert cache.size() == 0 and cache.stats.misses == 1


def test_engine_shutdown_releases_graphs(cuda):
    from ray_tpu_torch.parallel import global_cache
    entries = global_cache().size()
    eng = _graph_engine(cuda, "gpt")
    assert global_cache().size() == entries + len(eng._step_fns())
    assert eng.shutdown() == 0
    assert global_cache().size() == entries



# -- the train plane: autograd and donation inside graphs ----------------------


def test_graph_miss_runs_the_function_once(cuda):
    """A miss is the call: an in-place counter advances by exactly one on
    the miss (the eager run; the capture launches nothing) and by one on
    each replay."""
    from ray_tpu_torch.parallel import ExecutableCache, compiled_step

    def bump(counter):
        counter.add_(1)
        return counter

    cache = ExecutableCache()
    f = compiled_step(bump, donate_argnums=(0,), cache=cache)
    c = torch.zeros((), device=cuda)
    for i in range(1, 5):
        c = f(c)
        assert float(c) == i
    assert cache.stats.as_dict() == {"hits": 3, "misses": 1,
                                     "retraces": 0}


def _tiny_gpt_runner(cuda, cfg, seed, **forward_kw):
    """A tiny GPT on the card with AdamW(capturable) and its carry, and
    the train step of chip_smoke (forward, fused CE, backward, step);
    `forward_kw` goes to the model's forward."""
    from functools import partial

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops.fused_ce import fused_cross_entropy

    params = gpt.init_params(cfg, torch.Generator().manual_seed(seed),
                             cuda, dtype=torch.float32)
    net = gpt.GPT.from_params(cfg, params,
                              attention_fn=partial(flash_attention,
                                                   causal=True),
                              trainable=True)
    opt = torch.optim.AdamW(net.parameters(), lr=3e-4, weight_decay=1e-4,
                            capturable=True)
    named = dict(net.named_parameters())
    for p in named.values():
        opt.state[p] = {"step": torch.zeros((), device=cuda),
                        "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": torch.zeros_like(p)}
    carry = {"params": named,
             "step": {n: opt.state[p]["step"] for n, p in named.items()}}

    def step(carry, toks):
        hidden, wte = net(toks[:, :-1], return_hidden=True, **forward_kw)
        loss = fused_cross_entropy(hidden, wte, toks[:, 1:])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return carry, loss.detach()

    return net, carry, step


def _captured_train_step_matches_eager(cuda, remat):
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import global_cache
    from ray_tpu_torch.train import TrainStepRunner

    cfg = gpt.GPTConfig.tiny(dtype=torch.float32, remat=remat)
    # with remat each block's forward runs again in the backward
    fwd_per_step = cfg.n_layer * (2 if remat else 1)
    toks = [torch.randint(0, cfg.vocab_size, (2, 33),
                          generator=torch.Generator().manual_seed(i)
                          ).to(cuda) for i in range(3)]
    eager_net, eager_carry, eager_step = _tiny_gpt_runner(cuda, cfg, 0)
    want = [float(eager_step(eager_carry, t)[1]) for t in toks]
    net, carry, step = _tiny_gpt_runner(cuda, cfg, 0)
    runner = TrainStepRunner(step, device=cuda)
    before = runner.cache_stats()  # the process-wide cache's counters
    got = []
    for i, t in enumerate(toks):
        fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
        carry, loss = runner.run(carry, t)
        got.append(float(loss))
        assert flash_attention.launches == fwd + fwd_per_step
        assert flash_attention_bwd.launches == \
            bwd + BWD_KERNELS_PER_CALL * cfg.n_layer
        assert all(float(s) == i + 1 for s in carry["step"].values())
    after = runner.cache_stats()
    assert {n: after[n] - before[n] for n in after} == {
        "hits": 2, "misses": 1, "retraces": 0}
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for (n, p), q in zip(net.named_parameters(), eager_net.parameters()):
        assert float((p - q).abs().max()) <= 1e-5, n
    assert global_cache().evict(step) == 1


def test_graph_captures_a_train_step(cuda):
    """Forward, backward and AdamW(capturable=True) in one graph
    (`TrainStepRunner`, K=1) match the same step called eagerly, over 3
    steps from the same weights: losses (rtol 1e-5) and parameters (atol
    1e-5; f32, the same kernels, but `index_add_` adds dw's -onehot rows
    with atomics in a varying order and Adam amplifies a near-zero
    gradient's differences, as in test_adamw_steps_match_optax). Each
    replay launches both kernels n_layer times (backward: twice)."""
    _captured_train_step_matches_eager(cuda, remat=False)


def test_graph_captures_a_remat_train_step(cuda):
    """The same at the configurations' default, remat on: each block is
    recomputed in the captured backward (`torch.utils.checkpoint`, which
    stashes and restores the RNG state inside the capture), so each
    replay launches the forward kernel twice per layer."""
    _captured_train_step_matches_eager(cuda, remat=True)


def test_graph_capture_failure_after_the_call_took_effect(cuda):
    """A step that syncs with the host (it logs `loss.item()`) runs
    eagerly on the miss and then fails its capture. The error says that
    the call took effect and carries its result; the carry advanced by
    exactly that one AdamW step (the eager step's parameters; the capture
    launched nothing). A retry is one more eager step, and raises
    again."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import ExecutableCache, compiled_step

    cfg = gpt.GPTConfig.tiny(dtype=torch.float32, remat=False)
    toks = torch.randint(0, cfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(0)
                         ).to(cuda)
    eager_net, eager_carry, eager_step = _tiny_gpt_runner(cuda, cfg, 0)
    want = float(eager_step(eager_carry, toks)[1])
    net, carry, step = _tiny_gpt_runner(cuda, cfg, 0)
    logged = []

    def logging_step(carry, toks):
        carry, loss = step(carry, toks)
        logged.append(loss.item())  # a host sync: not capturable
        return carry, loss

    cache = ExecutableCache()
    f = compiled_step(logging_step, donate_argnums=(0,), cache=cache)
    with pytest.raises(RuntimeError) as info:
        f(carry, toks)
    torch.cuda.synchronize()
    assert any("took effect" in note
               for note in getattr(info.value, "__notes__", ())), info.value
    out_carry, loss = info.value.result
    assert out_carry["params"]["wte"] is carry["params"]["wte"]
    np.testing.assert_allclose([float(loss), logged[0]], [want, want],
                               rtol=1e-5)
    assert len(logged) == 1
    assert all(float(s) == 1 for s in carry["step"].values())
    for (n, p), q in zip(net.named_parameters(), eager_net.parameters()):
        assert float((p - q).abs().max()) <= 1e-5, n
    assert cache.size() == 0 and cache.stats.misses == 1
    with pytest.raises(RuntimeError):
        f(carry, toks)
    torch.cuda.synchronize()
    assert all(float(s) == 2 for s in carry["step"].values())


def _sgd(w, batch):
    """A functional step: returns a NEW carry tensor."""
    x, y = batch
    w = w.detach().requires_grad_()
    with torch.enable_grad():
        loss = torch.mean((x @ w - y) ** 2)
        (g,) = torch.autograd.grad(loss, w)
    return (w - 0.1 * g).detach(), loss.detach()


def _sgd_batches(cuda, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        x = torch.randn(16, 4, generator=gen)
        out.append((x.to(cuda), (x @ torch.arange(4.0)).to(cuda)))
    return out


def test_graph_donated_carry_round_trips(cuda):
    """A donated functional carry is copied back into its storage inside
    the graph: every call returns the donated storage, the next call
    accepts it, another storage raises, and the values are the eager
    step's."""
    from ray_tpu_torch.parallel import ExecutableCache, compiled_step

    batches = _sgd_batches(cuda, 4)
    w_ref, want = torch.zeros(4, device=cuda), []
    for b in batches:
        w_ref, loss = _sgd(w_ref, b)
        want.append(float(loss))
    f = compiled_step(_sgd, donate_argnums=(0,), cache=ExecutableCache())
    w = torch.zeros(4, device=cuda)
    ptr, got = w.data_ptr(), []
    for b in batches:
        w, loss = f(w, b)
        assert w.data_ptr() == ptr
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert torch.allclose(w, w_ref, rtol=1e-6, atol=0)
    with pytest.raises(RuntimeError, match="another storage"):
        f(torch.zeros(4, device=cuda), batches[0])


def test_fold_steps_k4_equals_four_single_calls(cuda):
    """Four steps as one graph walk the trajectory of four one-step
    graphs (the same kernels; rtol 1e-6)."""
    from ray_tpu_torch.parallel import (ExecutableCache, compiled_step,
                                        fold_steps, stack_batches)

    batches = _sgd_batches(cuda, 4, seed=1)
    single = compiled_step(_sgd, donate_argnums=(0,),
                           cache=ExecutableCache())
    w, want = torch.zeros(4, device=cuda), []
    for _ in range(2):
        for b in batches:
            w, loss = single(w, b)
            want.append(float(loss))
    multi = fold_steps(_sgd, 4, cache=ExecutableCache())
    stacked = stack_batches(batches)
    v, got = torch.zeros(4, device=cuda), []
    for _ in range(2):  # the miss, then a replay
        v, losses = multi(v, stacked)
        assert losses.shape == (4,)
        got.extend(losses.tolist())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert torch.allclose(v, w, rtol=1e-6, atol=0)
    assert multi.stats.as_dict() == {"hits": 1, "misses": 1,
                                     "retraces": 0}


def test_runner_aux_is_overwritten_unless_cloned(cuda):
    """The runner returns the graph's static aux: the next replay
    overwrites it, so a caller that keeps it across runs clones it."""
    from ray_tpu_torch.parallel import global_cache
    from ray_tpu_torch.train import TrainStepRunner

    def step(carry, batch):
        carry["w"].add_(batch)
        return carry, carry["w"].sum() * 1.0

    runner = TrainStepRunner(step, device=cuda)
    carry = {"w": torch.zeros(3, device=cuda)}
    carry, first = runner.run(carry, torch.ones(3, device=cuda))  # miss
    carry, second = runner.run(carry, torch.ones(3, device=cuda))
    kept = second.clone()
    carry, third = runner.run(carry, torch.ones(3, device=cuda))
    assert float(first) == 3.0 and float(kept) == 6.0
    assert third is second and float(second) == 9.0
    assert global_cache().evict(step) == 1


def test_checkpoint_restored_into_the_live_carry_keeps_replays_valid(
        cuda, tmp_path):
    """Save the carry, run two steps, copy the restored checkpoint into
    the live carry and run the same two steps again: the same losses
    (the same graph on the same state). Handing the restored tensors in
    as the carry instead raises: they are other storages."""
    from ray_tpu_torch.parallel import global_cache
    from ray_tpu_torch.train import TrainStepRunner, array_checkpoint

    batches = _sgd_batches(cuda, 4, seed=2)
    runner = TrainStepRunner(_sgd, device=cuda)
    w = torch.zeros(4, device=cuda)
    for b in batches[:2]:
        w, _ = runner.run(w, b)
    array_checkpoint.save_sharded(str(tmp_path / "ck"), {"w": w})
    first = []
    for b in batches[2:]:
        w, loss = runner.run(w, b)
        first.append(float(loss))
    restored = array_checkpoint.restore_sharded(str(tmp_path / "ck"),
                                                {"w": w})
    assert restored["w"].device == w.device
    with pytest.raises(RuntimeError, match="another storage"):
        runner.run(restored["w"], batches[2])
    w.copy_(restored["w"])
    again = []
    for b in batches[2:]:
        w, loss = runner.run(w, b)
        again.append(float(loss))
    assert again == first
    assert global_cache().evict(_sgd) == 1


def test_graph_capture_of_dropout_raises(cuda):
    """Dropout inside a captured step would replay the capture's masks:
    the step raises before its eager first run takes effect, so the
    carry is untouched (no AdamW step) and nothing is cached."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import ExecutableCache, compiled_step

    cfg = gpt.GPTConfig.tiny(dtype=torch.float32, dropout=0.1, remat=False)
    gen = torch.Generator(device=cuda).manual_seed(0)
    net, carry, step = _tiny_gpt_runner(cuda, cfg, 0, deterministic=False,
                                        generator=gen)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    cache = ExecutableCache()
    f = compiled_step(step, donate_argnums=(0,), cache=cache)
    with pytest.raises(NotImplementedError, match="dropout"):
        f(carry, torch.zeros(1, 9, dtype=torch.long, device=cuda))
    torch.cuda.synchronize()
    assert all(float(s) == 0 for s in carry["step"].values())
    for n, p in net.named_parameters():
        assert torch.equal(p, before[n]), n
    assert cache.size() == 0


def test_graph_capture_of_a_host_sync_in_backward_fails(cuda):
    """A host sync inside the backward (autograd's device thread) of a
    captured step still fails the capture, although the capture is
    thread_local: the sync is on the capturing stream."""
    from ray_tpu_torch.parallel import ExecutableCache, compiled_step

    class SyncInBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * float(g.sum().item())

    w = torch.ones(4, device=cuda, requires_grad=True)

    def step(w):
        SyncInBackward.apply(w).sum().backward()
        return w.grad

    cache = ExecutableCache()
    f = compiled_step(step, live_argnums=(0,), cache=cache)
    with pytest.raises(RuntimeError):
        f(w)
    torch.cuda.synchronize()
    assert cache.size() == 0 and cache.stats.misses == 1


# -- the port's runtime on the card ---------------------------------------

@pytest.fixture(scope="module")
def runtime():
    """A node of the port's runtime; it detects the card as its GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ray_tpu_torch.init(num_cpus=2, object_store_memory=512 << 20)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == \
            torch.cuda.device_count()
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_gpus=1)
def _flash_in_gpu_worker(q, k, v):
    with torch.inference_mode():
        out = flash_attention(q.cuda(), k.cuda(), v.cuda(), causal=True)
    return out.cpu(), os.environ.get("CUDA_VISIBLE_DEVICES")


@ray_tpu_torch.remote(num_gpus=1)
def _put_a_cuda_tensor(n):
    t = torch.arange(n, dtype=torch.float32, device="cuda") * 0.5
    return [ray_tpu_torch.put(t)]


@ray_tpu_torch.remote
def _cpu_worker_view():
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            torch.cuda.is_available(), torch.cuda.device_count())


def test_gpu_task_runs_the_kernel_on_store_tensors(runtime):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 200, 4, 64, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    refs = [runtime.put(x) for x in (q, k, v)]
    out, visible = runtime.get(_flash_in_gpu_worker.remote(*refs),
                               timeout=300)
    with torch.inference_mode():
        mine = flash_attention(q.cuda(), k.cuda(), v.cuda(),
                               causal=True).cpu()
    assert visible == "0"
    assert out.dtype == torch.bfloat16 and torch.equal(out, mine)


def test_cuda_tensor_put_in_a_gpu_worker_arrives_on_cuda(runtime):
    n = 3_000_000
    (ref,) = runtime.get(_put_a_cuda_tensor.remote(n), timeout=300)
    got = runtime.get(ref, timeout=300)
    assert got.device.type == "cuda"
    assert torch.equal(got, torch.arange(n, dtype=torch.float32,
                                         device="cuda") * 0.5)


def test_cpu_worker_cannot_see_the_card(runtime):
    visible, available, count = runtime.get(_cpu_worker_view.remote(),
                                            timeout=300)
    assert (visible, available, count) == ("", False, 0)


# -- Serve on the card: a GPU replica --------------------------------------

def test_gpu_replica_serves_bound_to_the_card(runtime):
    """`build_app` on CUDA: the replica holds the card (num_gpus=1, its
    CUDA_VISIBLE_DEVICES names it, the node's GPU is taken while it
    lives), answers with the tokens of an in-process engine drawn from
    the same seed on the card, and publishes its arena record."""
    import json

    from ray_tpu_torch import serve
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_ref import get_core_worker
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    ecfg = {"batch_buckets": (1, 2), "prefill_buckets": (16, 32)}
    eng = LLMEngine(model="gpt", seed=3, device="cuda",
                    engine_config=EngineConfig(**ecfg))
    want = eng.submit([5, 9, 3, 7], 8)
    eng.run_until_idle(timeout=120)
    want = want.result(timeout=60)
    eng.shutdown()
    handle = serve.run(serve.llm.build_app(
        name="llm-card", model="gpt", seed=3, engine_config=ecfg))
    try:
        m = handle.engine_metrics.remote().result(timeout=300)
        assert runtime.available_resources().get("GPU", 0) == 0
        assert handle.generate_once.remote([5, 9, 3, 7], 8).result(
            timeout=120) == want
        store = get_core_worker().store
        oid = ObjectID.from_hex(m["kv_arena_id"])
        record = json.loads(bytes(store.get_buffer(oid, timeout=0)))
        store.release(oid)
        assert record["device"] == "cuda:0" and record["nbytes"] > 0
    finally:
        serve.shutdown()
    deadline = time.monotonic() + 60
    while runtime.available_resources().get("GPU", 0) < 1:
        assert time.monotonic() < deadline, "the replica kept the GPU"
        time.sleep(0.2)


@ray_tpu_torch.remote(num_cpus=1)
def _llm_deployment_in_a_cpu_worker():
    from ray_tpu_torch.serve.llm import LLMDeployment
    LLMDeployment(model="gpt")


def test_cpu_worker_replica_refuses_cuda(runtime):
    """A replica that holds no GPU sees no card: `device="cuda"` raises
    in `__init__` (in a CPU worker: "no CUDA device") and the deployment
    answers nothing; it never serves on the CPU."""
    from ray_tpu_torch import serve

    with pytest.raises(Exception, match="no CUDA device"):
        runtime.get(_llm_deployment_in_a_cpu_worker.remote(), timeout=300)
    handle = serve.run(serve.llm.build_app(
        name="llm-nogpu", model="gpt", ray_actor_options={"num_cpus": 1}))
    try:
        with pytest.raises(Exception):
            handle.generate_once.remote([1, 2], 2).result(timeout=300)
    finally:
        serve.shutdown()


# -- the distributed train plane on the card -------------------------------

def _make_nccl_loop():
    # a factory: cloudpickle sends the loop by value (the train worker
    # cannot import this test module)
    def loop(config):
        import json as json_
        import os as os_
        import tempfile

        import torch as torch_
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.train import TrainStepRunner
        from ray_tpu_torch.train import array_checkpoint as ac

        world = dist.get_world_size()
        gen = torch_.Generator(device="cuda").manual_seed(0)
        w0 = torch_.randn(256, 256, device="cuda", generator=gen)
        x = torch_.randn(64, 256, device="cuda", generator=gen)

        def step(carry, data):
            w = carry["w"]
            loss = (data @ w).square().mean()
            loss.backward()
            # the mean gradient and loss over the group, in the graph
            flat = torch_.cat([w.grad.reshape(-1),
                               loss.detach().reshape(1)])
            dist.all_reduce(flat)
            flat.div_(world)
            with torch_.no_grad():
                w.sub_(0.1 * flat[:-1].view_as(w))
            w.grad = None
            return carry, flat[-1]

        carry = {"w": w0.clone().requires_grad_(True)}
        runner = TrainStepRunner(step, device="cuda")
        losses = []
        for _ in range(3):
            carry, loss = runner.run(carry, x)
            losses.append(float(loss))
        # the same steps eagerly, with no group
        w = w0.clone().requires_grad_(True)
        eager = []
        for _ in range(3):
            loss = (x @ w).square().mean()
            loss.backward()
            with torch_.no_grad():
                w.sub_(0.1 * w.grad)
            w.grad = None
            eager.append(float(loss))
        d = tempfile.mkdtemp()
        ac.save_sharded(d, {"w": carry["w"].detach()})
        with open(os_.path.join(d, "asv_index.0.json")) as f:
            index = json_.load(f)
        train.report({
            "backend": dist.get_backend(), "world": world,
            "device": torch_.cuda.current_device(),
            "visible": os_.environ.get("CUDA_VISIBLE_DEVICES"),
            "losses": losses, "eager": eager,
            "cache": runner.cache_stats(),
            "index": [index["process"], index["num_processes"]],
            "w_equal": bool(torch_.equal(carry["w"].detach(),
                                         w.detach()))})

    return loop


def test_one_rank_nccl_trainer_captures_its_all_reduce(runtime, tmp_path):
    """A `TorchTrainer` GPU worker in a one-rank NCCL group: the step,
    its all-reduce included, is captured on the first call and replayed
    after (one miss, then hits), gives the eager steps' losses and
    weights, and `array_checkpoint` under the group saves process 0 of
    1."""
    from ray_tpu_torch import train
    from ray_tpu_torch.air import RunConfig, ScalingConfig

    result = train.TorchTrainer(
        _make_nccl_loop(),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        backend_config=train.TorchConfig(distributed="on",
                                         platform="cuda"),
        run_config=RunConfig(storage_path=str(tmp_path), name="nccl"),
    ).fit()
    m = result.metrics
    assert (m["backend"], m["world"], m["device"], m["visible"]) == (
        "nccl", 1, 0, "0")
    assert m["cache"]["misses"] == 1 and m["cache"]["hits"] == 2
    assert m["cache"]["retraces"] == 0
    np.testing.assert_allclose(m["losses"], m["eager"], rtol=1e-6)
    assert m["w_equal"]
    assert m["index"] == [0, 1]


def test_cuda_platform_worker_without_a_gpu_raises(runtime, tmp_path):
    """`TorchConfig(platform="cuda")` on a worker that holds no GPU
    (CUDA_VISIBLE_DEVICES is empty) fails the run; it never trains on
    the CPU."""
    from ray_tpu_torch import train
    from ray_tpu_torch.air import RunConfig, ScalingConfig

    def loop(config):
        train.report({"ran": True})

    with pytest.raises(Exception, match="sees no CUDA device"):
        train.TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=1),
            backend_config=train.TorchConfig(platform="cuda"),
            run_config=RunConfig(storage_path=str(tmp_path), name="nogpu"),
        ).fit()


# -- Data and the compiled DAG on the card ---------------------------------

def test_fused_dag_results_held_across_executes_stay_distinct(cuda):
    """A fused `torch_stage` chain on the card is one graph (one miss,
    then replays); `execute` returns copies, so two results held across
    executes stay distinct, each its own input's."""
    from ray_tpu_torch import dag as dag_mod

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(64, 64, device=cuda, generator=gen)

    def matmul(x):
        return x @ w

    def act(y):
        return torch.tanh(y).sum(dim=-1)

    node = dag_mod.bind(dag_mod.torch_stage(act), dag_mod.bind(
        dag_mod.torch_stage(matmul), dag_mod.InputNode()))
    compiled = node.experimental_compile()
    xs = [torch.randn(8, 64, device=cuda, generator=gen) for _ in range(3)]
    try:
        outs = [compiled.execute(x) for x in xs]
        torch.cuda.synchronize()
        stats = compiled._fused.stats.as_dict()
        for x, out in zip(xs, outs):
            torch.testing.assert_close(out, act(matmul(x)))
        assert len({o.data_ptr() for o in outs}) == 3
    finally:
        compiled.teardown()
    assert stats["misses"] >= 1 and stats["hits"] >= 2


def test_fused_dag_capture_failure_raises(cuda):
    """A chain whose capture fails (a host sync) raises at its first
    execute; it never falls back to the lazy path."""
    from ray_tpu_torch import dag as dag_mod

    def synced(x):
        return x * float(x.sum())  # a host sync: not capturable

    compiled = dag_mod.bind(dag_mod.torch_stage(synced),
                            dag_mod.InputNode()).experimental_compile()
    try:
        with pytest.raises(Exception) as err:
            compiled.execute(torch.ones(4, device=cuda))
        assert "compiled_step: capturing" in "".join(
            getattr(err.value, "__notes__", []))
    finally:
        compiled.teardown()


@ray_tpu_torch.remote(num_gpus=1)
class _CudaStage:
    def scale(self, x):
        return x.cuda() * 2.0


def test_cuda_tensor_crosses_a_channel_from_a_gpu_actor(runtime):
    """A compiled actor graph whose GPU actor returns a CUDA tensor: the
    frame copies it to the host and the driver reads it onto its card."""
    from ray_tpu_torch import dag as dag_mod

    actor = _CudaStage.remote()
    compiled = dag_mod.bind(actor.scale,
                            dag_mod.InputNode()).experimental_compile()
    assert compiled._channels is not None
    try:
        for seed in range(3):
            x = torch.randn(16, 8, generator=torch.Generator().manual_seed(
                seed), dtype=torch.float32).to(torch.bfloat16)
            got = compiled.execute(x)
            assert got.device.type == "cuda" and got.dtype == torch.bfloat16
            assert torch.equal(got.cpu(), x * 2.0)
    finally:
        compiled.teardown()
        ray_tpu_torch.kill(actor)


def _make_shard_loop():
    # a factory: cloudpickle sends the loop by value
    def loop(config):
        import torch as torch_

        from ray_tpu_torch import train

        shard = train.get_dataset_shard("train")
        total, ids = 0, []
        for b in shard.iter_batches(batch_size=16, prefetch_batches=2):
            x = torch_.from_numpy(b["x"]).pin_memory().to(
                "cuda", non_blocking=True)
            total += int(x.sum())
            ids += b["id"].tolist()
        train.report({"total": total, "ids": ids,
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})

    return loop


def test_trainer_gpu_worker_consumes_a_streaming_split_shard(runtime,
                                                             tmp_path):
    """A `TorchTrainer` GPU worker consumes its `streaming_split` shard
    (a map_batches run in tasks) and moves the batches to the card."""
    from ray_tpu_torch import data, train
    from ray_tpu_torch.air import RunConfig, ScalingConfig

    ds = data.range(256, parallelism=8).map_batches(
        lambda b: {"id": b["id"], "x": b["id"] * 3})
    result = train.TorchTrainer(
        _make_shard_loop(),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        backend_config=train.TorchConfig(distributed="off",
                                         platform="cuda"),
        run_config=RunConfig(storage_path=str(tmp_path), name="shard"),
        datasets={"train": ds},
    ).fit()
    m = result.metrics
    assert m["visible"] == "0"
    assert sorted(m["ids"]) == list(range(256))
    assert m["total"] == 3 * sum(range(256))


# -- the autoscaler on the card -------------------------------------------

AUTOSCALED_GPU_SCRIPT = r'''
import json, time
import torch
import ray_tpu_torch
from ray_tpu_torch._private.node import Cluster
from ray_tpu_torch.autoscaler import (Autoscaler, FakeMultiNodeProvider,
                                      NodeType)
from ray_tpu_torch.util import state


@ray_tpu_torch.remote(num_gpus=1)
def on_the_card():
    import os
    from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)
    q, k, v = (torch.randn(1, 128, 2, 64, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    want, _lse = flash_attention_plain(q, k, v, causal=True)
    err = float((flash_attention(q, k, v, causal=True).float()
                 - want.float()).abs().max())
    return dict(node=ray_tpu_torch.get_runtime_context().get_node_id(),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"), err=err,
                launches=flash_attention.launches)


torch.cuda.init()
free0 = torch.cuda.mem_get_info()[0]
cluster = Cluster(head_resources={"CPU": 1.0},
                  object_store_memory=256 << 20)
out = {}
try:
    ray_tpu_torch.init(address=cluster.gcs_addr)
    out["head_gpus"] = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
    provider = FakeMultiNodeProvider(cluster)
    scaler = Autoscaler(cluster.gcs_addr, provider,
                        [NodeType("gpu", {"CPU": 1.0, "GPU": 1.0})],
                        max_workers=1, idle_timeout_s=3.0,
                        update_interval_s=0.5).start()
    res = ray_tpu_torch.get(on_the_card.remote(), timeout=300)
    (inst,) = provider.non_terminated_nodes()
    out.update(res, gpu_node=inst.node_ids[0])
    deadline = time.monotonic() + 60
    while provider.non_terminated_nodes() and time.monotonic() < deadline:
        time.sleep(0.2)
    out["retired"] = not provider.non_terminated_nodes()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(
            n["NodeID"] == inst.node_ids[0] and n["Alive"]
            for n in state.list_nodes()):
        time.sleep(0.2)
    out["dead"] = any(n["NodeID"] == inst.node_ids[0] and not n["Alive"]
                      for n in state.list_nodes())
    deadline = time.monotonic() + 60
    while torch.cuda.mem_get_info()[0] < free0 - (256 << 20) and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    out["memory_back"] = torch.cuda.mem_get_info()[0] >= free0 - (256 << 20)
    scaler.stop()
finally:
    ray_tpu_torch.shutdown()
    cluster.shutdown()
print(json.dumps(out))
'''


def test_autoscaled_gpu_node_runs_a_gpu_task_and_retires_when_idle():
    """A head with no GPU, and the autoscaler with a `{"GPU": 1}` node
    type: a num_gpus=1 task makes it launch a GPU node, whose worker runs
    the forward kernel on the card; once idle the node is terminated,
    shows dead, and the card's memory comes back."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-c", AUTOSCALED_GPU_SCRIPT], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)), capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["head_gpus"] == 0.0
    assert got["node"] == got["gpu_node"] and got["visible"] == "0"
    assert got["err"] < 2e-2 and got["launches"] >= 1
    assert got["retired"] and got["dead"] and got["memory_back"]


CLI_CLIENT_SCRIPT = r'''
import json, sys

import torch

import ray_tpu_torch


@ray_tpu_torch.remote(num_gpus=1)
def kernel_task(seed):
    import torch

    from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(1, 1024, 12, 64, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    with torch.inference_mode():
        flash_attention.launches = 0
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        launches = flash_attention.launches
        ref, ref_lse = flash_attention_plain(q, k, v, causal=True)
    return [float((out.float() - ref.float()).abs().max()),
            float((lse - ref_lse).abs().max()), launches]


ray_tpu_torch.init(address=f"client://{sys.argv[1]}")
x = torch.arange(1 << 20, dtype=torch.float32, device="cuda") * 0.25
back = ray_tpu_torch.get(ray_tpu_torch.put(x))
kernel = ray_tpu_torch.get(kernel_task.remote(0), timeout=600)
ray_tpu_torch.shutdown()
print(json.dumps(dict(same=bool(back.is_cuda and torch.equal(back, x)),
                      kernel=kernel)))
'''


def test_cli_head_detects_the_card_and_a_client_task_runs_the_kernel(
        tmp_path):
    """`python -m ray_tpu_torch start --head` with no `--resources`
    advertises the card as its GPU (F14); a `client://` driver's CUDA
    tensor round-trips through the client server, and its num_gpus=1
    task holds the forward kernel at GPT-2's prefill shape against the
    plain version (one launch)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root),
               RAY_TPU_TORCH_CLI_STATE_FILE=str(tmp_path / "cli.json"))
    env.pop("RAY_TPU_GPU_COUNT", None)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    cli = [sys.executable, "-m", "ray_tpu_torch"]

    def run(args):
        out = subprocess.run(cli + args, env=env, cwd=root,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    run(["start", "--head", "--port", "0"])
    server = None
    try:
        gcs = json.loads((tmp_path / "cli.json").read_text())["gcs_addr"]
        status = run(["status", "--address", gcs])
        assert f"'GPU': {float(torch.cuda.device_count())}" in status, status
        server = subprocess.Popen(
            cli + ["client-server", "--address", gcs, "--port", "0"],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        line = server.stdout.readline()
        assert line.startswith("CLIENT_SERVER_READY"), line
        out = subprocess.run(
            [sys.executable, "-c", CLI_CLIENT_SCRIPT, line.split()[1]],
            env=env, cwd=root, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-4000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        err, lse_err, launches = got["kernel"]
        tol_o, tol_lse = TOL[torch.bfloat16]
        assert got["same"] and err <= tol_o and lse_err <= tol_lse, got
        assert launches == 1, got
    finally:
        if server is not None:
            server.terminate()
            server.wait(timeout=30)
        run(["stop"])


def _tiny_sharded(strategy, seed=5, batch=4, seq=64):
    """The tiny GPT (bf16 compute, f32 masters) placed on `strategy`'s mesh
    of the current group, through `chip_smoke._sharded_setup`."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke._sharded_setup(strategy, "tiny", seed, batch, seq,
                                     "cuda", capturable=True)


def test_one_rank_nccl_mesh_step_matches_the_unsharded_step(cuda,
                                                            tmp_path):
    """A one-rank NCCL mesh: the tiny GPT's sharded step captured by
    `TrainStepRunner(mesh=)` (one miss, then replays) gives the losses of
    the same step without a mesh (the plain model on the same weights and
    batch, also graphed), and launches the flash kernels per step."""
    import torch.distributed as dist
    from functools import partial

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops.fused_ce import fused_cross_entropy
    from ray_tpu_torch.parallel import ShardingStrategy, global_cache
    from ray_tpu_torch.train import TrainStepRunner

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        s = _tiny_sharded(ShardingStrategy())
        assert s["mesh"].shape == {"dp": 1} and s["backend"] == "nccl"
        runner = TrainStepRunner(s["step"], mesh=s["mesh"], device="cuda")
        stats0 = runner.cache_stats()  # the process's cache: its history
        flash_attention.launches = flash_attention_bwd.launches = 0
        carry, got = s["carry"], []
        for _ in range(3):
            carry, loss = runner.run(carry, s["data"])
            got.append(float(loss))
        n_layer = s["cfg"].n_layer
        assert flash_attention.launches == 3 * n_layer
        assert flash_attention_bwd.launches == \
            3 * n_layer * BWD_KERNELS_PER_CALL
        stats = runner.cache_stats()
        assert {k: stats[k] - stats0[k] for k in stats} == \
            {"hits": 2, "misses": 1, "retraces": 0}
        global_cache().evict(runner._compiled)
    finally:
        dist.destroy_process_group()

    # the same weights and batch through the unsharded model
    cfg = s["cfg"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    net = gpt.GPT.from_params(
        cfg, gpt.init_params(cfg, gen, device="cuda", dtype=torch.float32),
        attention_fn=partial(flash_attention, causal=True), trainable=True)
    opt = torch.optim.AdamW(net.parameters(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4, capturable=True)
    import chip_smoke

    carry = chip_smoke._adamw_carry(net, opt)

    def step(carry, data):
        hidden, wte = net(data["x"], return_hidden=True)
        loss = fused_cross_entropy(hidden, wte, data["y"])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return carry, loss.detach()

    runner = TrainStepRunner(step, device="cuda")
    want = []
    for _ in range(3):
        carry, loss = runner.run(carry, s["data"])
        want.append(float(loss))
    global_cache().evict(runner._compiled)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_two_gloo_ranks_share_the_card_at_tp2(cuda):
    """Two processes on the one card in one gloo group: at tp=2 (the
    kernels on one head a rank) their eager sharded steps give the losses
    of a dp=2 pair (each rank half the batch, every head) on the same
    weights and batch, within `chip_smoke`'s pair tolerance."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    (one, two), _ = chip_smoke._parallel_pair([{"dp": 2}, {"tp": 2}],
                                              "tiny", 5, 4, 64, "cuda")
    assert one[0]["losses"] == one[1]["losses"]
    assert two[0]["losses"] == two[1]["losses"]
    np.testing.assert_allclose(two[0]["losses"], one[0]["losses"],
                               rtol=chip_smoke.PARALLEL_SPLIT_LOSS_RTOL)
    n = chip_smoke.PARALLEL_PAIR_STEPS * 2  # the tiny GPT's two layers
    assert [r["fwd_launches"] for r in two] == [n, n]
    assert two[0]["local_shapes"]["h0.attn_qkv.weight"] == [96, 64]
