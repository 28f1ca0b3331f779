"""ray_tpu_torch on the card: the CUDA flash-attention kernels (forward
and backward) against their plain versions, the engine on CUDA against
the engine on the CPU, a tiny training step on CUDA against the same
step on the CPU, the engine's CUDA graphs (`compiled_step`) against its
eager step functions, and the train plane's graphs (a miss runs the
step once, autograd inside a graph, donation, `fold_steps`,
`TrainStepRunner`'s static aux, checkpoints restored into a live carry).

Every test here needs an NVIDIA GPU and `nvcc` and skips without them.
On a machine with a card (and no JAX), run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
