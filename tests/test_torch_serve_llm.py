"""ray_tpu_torch serve.llm: the paged KV cache's accounting and the
continuous-batching engine, held to the JAX engine.

The load-bearing properties, as for the JAX engine:
  * page accounting is exact — leaks fail loudly at quiesce, shared
    prefix pages are refcounted;
  * the port's engine and the JAX engine, given the same weights, emit
    IDENTICAL greedy tokens;
  * continuous batching, prefix-cache reuse and chunked prefill produce
    the same tokens as one-at-a-time full-forward greedy decoding;
  * speculative decoding (a self-draft, a rolled-embedding draft, a
    fresh draft) emits exactly the plain engine's and the JAX spec
    engine's tokens, with no page leaked in either arena.
Everything runs in f32 on the CPU (device="cpu", asked for explicitly).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.serve.llm import (  # noqa: E402
    EngineConfig, KVCacheError, LLMEngine, OutOfPagesError, PagedKVCache,
    PrefixCache, RequestRejected)

PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5, 6, 7, 8], [11, 13]]
NEW = [6, 9, 3, 7]  # different lengths -> staggered leave/join


# ---------------------------------------------------------------------------
# paged KV cache: allocation accounting
# ---------------------------------------------------------------------------


def _cache(**kw):
    base = dict(num_pages=8, n_layer=2, block_size=4, n_kv_head=2,
                head_dim=4, device="cpu")
    base.update(kw)
    return PagedKVCache(**base)


def test_page_alloc_free_roundtrip():
    kv = _cache()
    owner = object()
    assert kv.free_pages == 8 and kv.live_pages == 0
    pages = kv.alloc(3, owner)
    assert len(pages) == 3 and len(set(pages)) == 3
    assert kv.free_pages == 5 and kv.live_pages == 3
    assert abs(kv.utilization() - 3 / 8) < 1e-9
    kv.free(pages, owner)
    assert kv.free_pages == 8 and kv.live_pages == 0
    kv.assert_quiesced()
    assert kv.close() == 0


def test_page_double_free_and_foreign_free_raise():
    kv = _cache()
    a, b = object(), object()
    pa = kv.alloc(2, a)
    kv.alloc(2, b)
    with pytest.raises(KVCacheError):
        kv.free(pa, b)  # foreign owner
    kv.free(pa, a)
    with pytest.raises(KVCacheError):
        kv.free(pa, a)  # double free
    assert kv.live_pages == 2


def test_page_exhaustion_is_atomic():
    kv = _cache(num_pages=4)
    kv.alloc(3, "x")
    with pytest.raises(OutOfPagesError):
        kv.alloc(2, "y")
    assert kv.free_pages == 1
    assert kv.pages_for_tokens(1) == 1
    assert kv.pages_for_tokens(4) == 1
    assert kv.pages_for_tokens(5) == 2


def test_leak_detected_at_quiesce():
    kv = _cache()
    kv.alloc(1, "leaker")
    with pytest.raises(KVCacheError, match="leak"):
        kv.assert_quiesced()
    assert kv.close() == 1  # close reports the leak


def test_append_and_prefill_layout():
    kv = _cache(num_pages=4, n_layer=2, block_size=4, n_kv_head=2,
                head_dim=3)
    pages = kv.alloc(2, "s")
    rng = np.random.default_rng(0)
    k_seq = torch.from_numpy(rng.normal(size=(6, 2, 2, 3)).astype(np.float32))
    v_seq = torch.from_numpy(rng.normal(size=(6, 2, 2, 3)).astype(np.float32))
    kv.write_prefill(pages, k_seq, v_seq, 6)
    # token t lives at page[t // block], offset t % block
    for t in range(6):
        page, off = pages[t // 4], t % 4
        assert torch.equal(kv.k_pages[page, :, off], k_seq[t])
        assert torch.equal(kv.v_pages[page, :, off], v_seq[t])
    # an unaligned chunk write (start > 0) and one appended token
    kv.write_prefill(pages, k_seq[:1] * 2, v_seq[:1] * 2, 1, start=5)
    assert torch.equal(kv.k_pages[pages[1], :, 1], k_seq[0] * 2)
    k7 = torch.from_numpy(rng.normal(size=(2, 2, 3)).astype(np.float32))
    v7 = torch.from_numpy(rng.normal(size=(2, 2, 3)).astype(np.float32))
    kv.append(pages, 6, k7, v7)
    assert torch.equal(kv.k_pages[pages[1], :, 2], k7)
    assert torch.equal(kv.v_pages[pages[1], :, 2], v7)


def test_prefix_cache_hit_and_miss():
    kv = _cache(num_pages=16)
    pc = PrefixCache(kv)
    prompt = list(range(100, 110))  # 10 tokens, block 4 -> 2 full pages
    a = object()
    pages_a, cached = pc.acquire(prompt, a, kv.pages_for_tokens(10))
    assert cached == 0
    pc.insert(prompt, pages_a)
    assert pc.stats()["misses"] == 1 and pc.stats()["hits"] == 0
    b = object()
    pages_b, cached = pc.acquire(prompt, b, kv.pages_for_tokens(10))
    assert cached == 8
    assert pages_b[:2] == pages_a[:2] and pages_b[2] != pages_a[2]
    assert kv.page_refcount(pages_a[0]) == 4
    other = prompt[:4] + [999] * 6
    pages_c, cached = pc.acquire(other, object(), kv.pages_for_tokens(10))
    assert cached == 4 and pages_c[0] == pages_a[0]
    st = pc.stats()
    assert st["hits"] == 2 and st["hit_tokens"] == 12
    assert st["miss_tokens"] == 10 + 2 + 6


def test_prefix_partial_page_boundary_never_aliased():
    kv = _cache(num_pages=16)
    pc = PrefixCache(kv)
    prompt = list(range(7))  # 1 full page + 3 tokens
    pages, _ = pc.acquire(prompt, object(), kv.pages_for_tokens(7))
    pc.insert(prompt, pages)
    assert pc.entries == 1
    pages_b, cached = pc.acquire(prompt, object(), kv.pages_for_tokens(7))
    assert cached == 4 and pages_b[1] != pages[1]
    aligned = list(range(50, 58))  # exactly 2 pages
    pages_c, _ = pc.acquire(aligned, object(), kv.pages_for_tokens(8))
    pc.insert(aligned, pages_c)
    pages_d, cached = pc.acquire(aligned, object(), kv.pages_for_tokens(8))
    assert cached == 4  # the last page holds the last token
    assert pages_d[1] != pages_c[1]


def test_aliased_free_keeps_shared_pages():
    kv = _cache(num_pages=16)
    pc = PrefixCache(kv)
    a, b = object(), object()
    prompt = list(range(10))
    pages_a, _ = pc.acquire(prompt, a, 3)
    pc.insert(prompt, pages_a)
    pages_b, cached = pc.acquire(prompt, b, 3)
    assert cached == 8
    shared = pages_b[:2]
    kv.write_prefill(pages_a, torch.ones(8, 2, 2, 4), torch.ones(8, 2, 2, 4),
                     8)
    free_before = kv.free_pages
    kv.free(pages_a, a)
    assert kv.free_pages == free_before + 1
    for p in shared:
        assert kv.page_refcount(p) >= 2
        assert float(kv.k_pages[p].sum()) > 0
    with pytest.raises(KVCacheError, match="not held by owner"):
        kv.free(pages_a, a)
    kv.free(pages_b, b)
    assert kv.page_refcount(shared[0]) == 2
    kv.assert_quiesced()
    pc.drain()
    assert kv.free_pages == kv.num_pages
    assert kv.close() == 0


def test_refcount_zero_reuse():
    kv = _cache(num_pages=4)
    pc = PrefixCache(kv)
    a = object()
    pages, _ = pc.acquire(list(range(8)), a, 2)
    pc.insert(list(range(8)), pages)
    pc.drain()
    assert kv.page_refcount(pages[0]) == 1
    assert pages[0] not in kv._free
    kv.free(pages, a)
    assert pages[0] in kv._free


def test_lru_eviction_under_arena_pressure():
    kv = _cache(num_pages=6)
    pc = PrefixCache(kv)
    p1, p2 = list(range(0, 8)), list(range(100, 108))
    for p, owner in ((p1, object()), (p2, object())):
        pages, _ = pc.acquire(p, owner, 2)
        pc.insert(p, pages)
        kv.free(pages, owner)
    assert kv.free_pages == 2 and pc.entries >= 2
    toucher = object()
    pt, cached = pc.acquire(p2, toucher, 2)  # p2 becomes MRU
    assert cached == 4
    kv.free(pt, toucher)
    assert len(kv.alloc(4, "big")) == 4
    assert pc.stats()["evicted"] >= 1
    _, cached = pc.acquire(p2, object(), 2)
    assert cached == 4  # the MRU entry survived the pressure


def test_assert_quiesced_with_cached_prefixes():
    kv = _cache(num_pages=16)
    pc = PrefixCache(kv)
    a = object()
    prompt = list(range(12))
    pages, _ = pc.acquire(prompt, a, 3)
    pc.insert(prompt, pages)
    with pytest.raises(KVCacheError, match="leak"):
        kv.assert_quiesced()
    kv.free(pages, a)
    kv.assert_quiesced()
    assert kv.cached_pages == 3 and kv.live_pages == 0
    pc.drain()
    assert kv.close() == 0


# ---------------------------------------------------------------------------
# engine: the port against the JAX engine, same weights (f32, CPU)
# ---------------------------------------------------------------------------


def _jax_variables(model):
    if model == "gpt":
        from ray_tpu.models import gpt as jmod
        net = jmod.GPT(jmod.GPTConfig.tiny(dtype=jnp.float32))
    else:
        from ray_tpu.models import llama as jmod
        net = jmod.Llama(jmod.LlamaConfig.tiny(dtype=jnp.float32))
    variables = jax.jit(net.init)(jax.random.PRNGKey(0),
                                  jnp.ones((1, 8), jnp.int32))

    # At init scale a tiny tied-head model just repeats its last token;
    # Dense kernels 8x larger make the blocks, not the embedding, pick
    # each token, so equal streams really test the decode math.
    def scale(path, x):
        return x * 8.0 if any(getattr(p, "key", None) == "kernel"
                              for p in path) else x

    return jmod, jax.tree_util.tree_map_with_path(scale, variables)


def _port_engine(model, params, **cfg_kw):
    base = dict(batch_buckets=(1, 2, 4), prefill_buckets=(8, 16))
    base.update(cfg_kw)
    return LLMEngine(model=model, params=params,
                     engine_config=EngineConfig(**base), device="cpu")


class _Family:
    def __init__(self, model):
        from ray_tpu_torch.models import gpt as tgpt, llama as tllama
        self.model = model
        jmod, self.variables = _jax_variables(model)
        tree = jax.tree_util.tree_map(np.asarray,
                                      jmod.unboxed_params(self.variables))
        if model == "gpt":
            self.cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
            self.params = convert.gpt_params_from_jax(tree, self.cfg, "cpu")
            self.net = tgpt.GPT.from_params(self.cfg, self.params)
        else:
            self.cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
            self.params = convert.llama_params_from_jax(tree, self.cfg,
                                                        "cpu")
            self.net = tllama.Llama.from_params(self.cfg, self.params)

    def engine(self, **cfg_kw):
        return _port_engine(self.model, self.params, **cfg_kw)

    def greedy(self, prompt, max_new):
        """One-at-a-time greedy over the port's FULL forward pass."""
        toks, out = list(prompt), []
        with torch.inference_mode():
            for _ in range(max_new):
                logits = self.net(torch.tensor([toks]))
                nxt = int(torch.argmax(logits[0, -1]))
                out.append(nxt)
                toks.append(nxt)
        return out


@pytest.fixture(scope="module", params=["gpt", "llama"])
def fam(request):
    return _Family(request.param)


def _run(eng, prompts, new, **submit_kw):
    reqs = [eng.submit(p, n, **submit_kw) for p, n in zip(prompts, new)]
    eng.run_until_idle(timeout=120)
    return [r.result(timeout=30) for r in reqs], reqs


def test_tokens_identical_to_jax_engine(fam):
    """Same weights, same prompts: the port's engine emits exactly the
    JAX engine's greedy tokens."""
    from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
    jeng = JaxLLMEngine(model=fam.model, params=fam.variables,
                        engine_config=JaxEngineConfig(
                            batch_buckets=(1, 2, 4),
                            prefill_buckets=(8, 16)))
    try:
        want, _ = _run(jeng, PROMPTS, NEW, tenant="none")
        jeng.quiesce()
    finally:
        assert jeng.shutdown() == 0
    eng = fam.engine()
    try:
        got, reqs = _run(eng, PROMPTS, NEW)
        assert got == want
        assert all(r.finish_reason == "length" for r in reqs)
        eng.quiesce()
    finally:
        assert eng.shutdown() == 0  # zero leaked pages


def test_continuous_batching_matches_one_at_a_time(fam):
    eng = fam.engine()
    try:
        got, _ = _run(eng, PROMPTS, NEW)
        for p, n, g in zip(PROMPTS, NEW, got):
            assert g == fam.greedy(p, n), (p, n)
        m = eng.metrics()
        assert m["requests_completed"] == 4
        assert m["tokens_generated"] == sum(NEW)
        assert m["compiled_step_calls"]["prefill:8"] == 4
        eng.quiesce()
        assert eng.metrics()["kv_pages_live"] == 0
    finally:
        assert eng.shutdown() == 0


def test_prefix_cache_reuse_matches_cold(fam):
    rng = np.random.RandomState(4)
    shared = list(rng.randint(1, 500, size=13))
    prompts = [shared + list(rng.randint(1, 500, size=3)) for _ in range(3)]
    cold = fam.engine(block_size=4, prefix_cache=0)
    try:
        want, _ = _run(cold, prompts, [5] * 3)
    finally:
        assert cold.shutdown() == 0
    eng = fam.engine(block_size=4, prefix_cache=1)
    try:
        got, _ = _run(eng, prompts, [5] * 3)
        assert got == want
        m = eng.metrics()
        # 13-token shared prefix = 3 full pages (block 4): requests 2+3
        # alias them and run only their suffix through chunk_step
        assert m["prefix_cache_hits"] == 2
        assert m["prefix_cache_hit_tokens"] == 24
        assert m["chunk_steps"] == 2
        eng.quiesce()  # cached pages are not leaks
        assert m["kv_pages_cached"] > 0 and m["kv_pages_live"] == 0
    finally:
        assert eng.shutdown() == 0  # drain happens here


def test_chunked_prefill_matches_oneshot(fam):
    rng = np.random.RandomState(3)
    long_p = list(rng.randint(1, 500, size=27))   # > max bucket 16
    short_p = list(rng.randint(1, 500, size=5))
    eng = fam.engine(batch_buckets=(1, 2), block_size=4, prefill_chunk=8,
                     prefix_cache=0)
    try:
        got, _ = _run(eng, [long_p, short_p], [6, 6])
        assert got == [fam.greedy(long_p, 6), fam.greedy(short_p, 6)]
        assert eng.metrics()["chunk_steps"] >= 4  # 27 tokens / 8 wide
        eng.quiesce()
    finally:
        assert eng.shutdown() == 0


# ---------------------------------------------------------------------------
# speculative decoding: the port's spec engine against its plain engine and
# the JAX spec engine, same weights
# ---------------------------------------------------------------------------

SPEC_K = 3
SPEC_NEW = [9, 12, 4, 10]  # long enough for several rounds side by side


def _rolled(params):
    """The JAX test's `_adversarial_draft` on the port's params: the
    embedding rolled one row, so the draft's tied head scores a shifted
    vocabulary and most proposals are rejected."""
    return {n: torch.roll(p, 1, 0) if n == "wte" else p
            for n, p in params.items()}


def _spec_engine(fam, draft, **cfg_kw):
    kw = {} if draft == "self" else dict(draft_params=_rolled(fam.params))
    base = dict(batch_buckets=(1, 2, 4), prefill_buckets=(8, 16),
                spec_k=SPEC_K)
    base.update(cfg_kw)
    eng = LLMEngine(model=fam.model, params=fam.params,
                    engine_config=EngineConfig(**base), device="cpu", **kw)
    eng.warmup()
    return eng


def _spec_metrics(m):
    return {k: m[k] for k in ("spec_rounds", "spec_proposed",
                              "spec_accepted")}


@pytest.mark.parametrize("draft", ["self", "adversarial"])
def test_spec_tokens_match_plain_and_jax_engine(fam, draft):
    """With spec_k > 0 the port emits exactly its plain engine's greedy
    tokens and the JAX spec engine's (the same draft on the same weights,
    with the same rounds and acceptances); a self-draft accepts every
    proposal, the rolled draft fewer; both arenas end with zero live
    pages."""
    from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
    plain = fam.engine()
    try:
        want, _ = _run(plain, PROMPTS, SPEC_NEW)
    finally:
        assert plain.shutdown() == 0
    jeng = JaxLLMEngine(model=fam.model, params=fam.variables,
                        engine_config=JaxEngineConfig(
                            batch_buckets=(1, 2, 4),
                            prefill_buckets=(8, 16), spec_k=SPEC_K))
    if draft == "adversarial":
        jeng.draft_params = jax.tree_util.tree_map_with_path(
            lambda path, x: jnp.roll(x, 1, axis=0)
            if any(getattr(p, "key", None) == "wte" for p in path) else x,
            fam.variables)
    try:
        jax_got, _ = _run(jeng, PROMPTS, SPEC_NEW, tenant="none")
        jax_m = _spec_metrics(jeng.metrics())
        jeng.quiesce()
    finally:
        assert jeng.shutdown() == 0
    eng = _spec_engine(fam, draft)
    try:
        got, reqs = _run(eng, PROMPTS, SPEC_NEW)
        assert got == want
        assert got == jax_got
        assert all(r.finish_reason == "length" for r in reqs)
        m = eng.metrics()
        assert _spec_metrics(m) == jax_m
        assert m["spec_k"] == SPEC_K and m["spec_rounds"] > 0
        assert m["compiled_step_calls"]["verify:2"] > 0  # lanes side by side
        if draft == "self":
            assert m["spec_accepted"] == m["spec_proposed"]
            assert eng.d_net is eng.net  # the target's own tensors
        else:
            assert m["spec_accepted"] < m["spec_proposed"]
        eng.quiesce()
        assert eng.kv.live_pages == 0 and eng.kv_d.live_pages == 0
    finally:
        assert eng.shutdown() == 0


def test_spec_with_prefix_cache_matches_cold(fam):
    """Prefix-cache hits alias the target's pages; the draft still
    prefills each whole prompt in its own arena."""
    rng = np.random.RandomState(4)
    shared = list(rng.randint(1, 500, size=13))
    prompts = [shared + list(rng.randint(1, 500, size=3)) for _ in range(3)]
    cold = fam.engine(block_size=4, prefix_cache=0)
    try:
        want, _ = _run(cold, prompts, [8] * 3)
    finally:
        assert cold.shutdown() == 0
    eng = _spec_engine(fam, "adversarial", block_size=4, prefix_cache=1)
    try:
        got, _ = _run(eng, prompts, [8] * 3)
        assert got == want
        m = eng.metrics()
        assert m["prefix_cache_hits"] == 2
        assert m["compiled_step_calls"]["draft_prefill:16"] == 3
        eng.quiesce()
        assert eng.kv_d.live_pages == 0
    finally:
        assert eng.shutdown() == 0


def test_spec_with_chunked_prefill_matches_plain(fam):
    """A prompt longer than every bucket windows into both models chunk
    by chunk (the draft's own chunk path)."""
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(1, 500, size=27)),
               list(rng.randint(1, 500, size=5))]
    kw = dict(batch_buckets=(1, 2), block_size=4, prefill_chunk=8,
              prefix_cache=0)
    plain = fam.engine(**kw)
    try:
        want, _ = _run(plain, prompts, [7, 7])
    finally:
        assert plain.shutdown() == 0
    eng = _spec_engine(fam, "self", **kw)
    try:
        got, _ = _run(eng, prompts, [7, 7])
        assert got == want
        assert eng.metrics()["compiled_step_calls"]["draft_chunk:8"] == 4
        eng.quiesce()
    finally:
        assert eng.shutdown() == 0


def test_spec_fresh_draft_from_draft_cfg(fam):
    """`draft_cfg` alone: an independent one-layer draft with fresh
    weights from `seed + 1`; the tokens are still plain greedy's."""
    import dataclasses
    plain = fam.engine()
    try:
        want, _ = _run(plain, PROMPTS, SPEC_NEW)
    finally:
        assert plain.shutdown() == 0
    eng = LLMEngine(model=fam.model, params=fam.params, device="cpu",
                    draft_cfg=dataclasses.replace(fam.cfg, n_layer=1),
                    engine_config=EngineConfig(
                        batch_buckets=(1, 2, 4), prefill_buckets=(8, 16),
                        spec_k=SPEC_K))
    try:
        assert eng.d_net.config.n_layer == 1 and eng.kv_d.n_layer == 1
        got, _ = _run(eng, PROMPTS, SPEC_NEW)
        assert got == want
        eng.quiesce()
    finally:
        assert eng.shutdown() == 0
    with pytest.raises(ValueError, match="vocab_size"):
        LLMEngine(model=fam.model, params=fam.params, device="cpu",
                  draft_cfg=dataclasses.replace(fam.cfg, vocab_size=256),
                  engine_config=EngineConfig(spec_k=SPEC_K))


@pytest.mark.parametrize("model", ["gpt", "llama"])
def test_spec_request_filling_max_seq_len(model):
    """A request of exactly max_seq_len tokens: near its end the draft
    runs past the last position of the position tables (its proposals
    there lie past the request's end); the tokens are still plain
    greedy's."""
    from ray_tpu_torch.models import gpt as tgpt, llama as tllama
    mod = tgpt.GPTConfig if model == "gpt" else tllama.LlamaConfig
    cfg = mod.tiny(dtype=torch.float32, max_seq_len=32)
    base = dict(batch_buckets=(1, 2), prefill_buckets=(8, 16))
    prompts, new = [[5, 9, 3, 7, 1, 2], [4] * 14], [26, 18]
    plain = LLMEngine(model=model, model_cfg=cfg, device="cpu",
                      engine_config=EngineConfig(**base))
    try:
        want, _ = _run(plain, prompts, new)
    finally:
        assert plain.shutdown() == 0
    eng = LLMEngine(model=model, model_cfg=cfg, device="cpu",
                    engine_config=EngineConfig(spec_k=SPEC_K, **base))
    try:
        got, _ = _run(eng, prompts, new)
        assert got == want
        eng.quiesce()
    finally:
        assert eng.shutdown() == 0


def test_spec_admission_rolls_back_target_pages():
    """When the draft arena cannot take a request, admission frees the
    target pages it just took and the request waits; it runs once the
    draft pages come free."""
    eng = _port_engine("gpt", None, spec_k=SPEC_K, prefix_cache=0)
    try:
        hog = eng.kv_d.alloc(eng.kv_d.free_pages, "hog")
        req = eng.submit([5, 9, 3], 4)
        assert not eng.step()  # nothing admitted
        assert eng.metrics()["queue_depth"] == 1
        assert eng.kv.live_pages == 0
        assert eng.kv.free_pages == eng.kv.num_pages
        eng.kv_d.free(hog, "hog")
        eng.run_until_idle()
        assert len(req.result(timeout=10)) == 4
        eng.quiesce()
    finally:
        assert eng.shutdown() == 0


@pytest.fixture(scope="module")
def llama_engine():
    eng = _port_engine("llama", None)
    eng.warmup()
    yield eng
    assert eng.shutdown() == 0


def test_submit_validation(llama_engine):
    with pytest.raises(RequestRejected, match="empty"):
        llama_engine.submit([], 4)
    with pytest.raises(RequestRejected, match="prefill bucket"):
        llama_engine.submit(list(range(17)), 4)  # largest bucket is 16
    with pytest.raises(RequestRejected, match="max_seq_len"):
        llama_engine.submit([1, 2], 1000)


def test_engine_deadline_shed(llama_engine):
    req = llama_engine.submit([4, 4], 4, timeout_s=0.001)
    time.sleep(0.05)
    before = llama_engine.metrics()["requests_timed_out"]
    llama_engine.run_until_idle()
    with pytest.raises(RequestRejected, match="deadline"):
        req.result(timeout=10)
    assert llama_engine.metrics()["requests_timed_out"] == before + 1
    assert req.tokens == []


def test_streaming_order_and_indices(llama_engine):
    req = llama_engine.submit([5, 9, 3], 6)
    llama_engine.run_until_idle()
    streamed = list(req.stream(timeout=30))
    assert streamed == req.result(timeout=5) and len(streamed) == 6


def test_pump_thread_and_queueing_past_capacity(llama_engine):
    """More requests than max_running: the overflow waits and completes
    as pages free up, stepped by the pump thread; zero pages live after."""
    llama_engine.start()
    try:
        reqs = [llama_engine.submit([2 + (i % 5)], 5) for i in range(10)]
        outs = [r.result(timeout=60) for r in reqs]
        assert all(len(o) == 5 for o in outs)
        assert outs[0] == outs[5]  # same prompt, same tokens
        llama_engine.quiesce()
        assert llama_engine.metrics()["kv_pages_live"] == 0
    finally:
        llama_engine.stop()


def test_no_gpu_means_no_silent_cpu_run():
    """Without a GPU an entry point raises unless the caller asks for
    the CPU: nothing quietly carries on on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ray_tpu_torch.models import gpt as tgpt
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(4, 1, 4, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpt.init_params(tgpt.GPTConfig.tiny(), torch.Generator())
