"""Continuous-batching LLM engine on PyTorch.

Port of `ray_tpu/serve/llm/engine.py`: Orca-style iteration-level
scheduling (every `step()` interleaves at most `max_prefills_per_step`
prompt prefills with one decode iteration over the whole running set;
sequences join and leave the decode batch between steps, and a finished
sequence frees its KV pages at once). Prompts pad into prefill buckets
and the decode batch into batch buckets, as in the JAX engine, and each
bucket owns its own `parallel.compiled_step` wrapper with
``on_retrace="error"``: where the JAX engine holds one AOT executable
per bucket, the port holds one captured CUDA graph per bucket (on the
CPU, the eager step function under the same cache keys and counters).
`warmup()` captures every bucket, so steady-state serving is one graph
replay per step function call and can never silently recapture
(`parallel.cache_stats()` proves it). The graphs read the KV arena and
the weights live, by address; their outputs are overwritten by the next
replay of the same graph, so every caller below consumes them (argmax,
an arena write) before that. `shutdown()` evicts the graphs.

Prefill runs the model with the hand-written flash-attention kernel
(`ray_tpu_torch.ops.flash_attention`); decode and chunk attention are
plain PyTorch over the paged cache, as the JAX package leaves them to
XLA.

The KV plane is a `PagedKVCache` in device memory: decode hands the
model the whole arena plus per-sequence page-table rows, and the new
token's K/V is written into the sequence's tail page after the step.
Greedy (argmax) sampling keeps generation deterministic.

Speculative decoding (`EngineConfig.spec_k = K > 0`, greedy case): a
draft model of the same family (the target itself unless `draft_cfg` /
`draft_params` name another) keeps its own `PagedKVCache`, prefills each
prompt after the target's first token, and proposes K tokens per round;
the target scores all K+1 positions in one chunk forward (the verify
window) and the longest matching prefix plus the target's next token is
emitted, so the tokens are exactly plain greedy's. Where the JAX engine
copies the draft's [B, V] logits to the host at every draft step, the
port takes the argmax on the device and copies only the [B] token ids
(and [B, K+1] ids after verify).

All device work runs under `torch.inference_mode()` on the engine's one
device, on the current stream, from whichever thread steps the engine
(the caller's, or the pump thread after `start()`).

Observability, as in the JAX engine: requests carry the request
recorder's phase stamps and every finished, timed-out or failed request
emits one engine record (`util.request_recorder`); prefills run inside
`llm.prefill` / `llm.prefill_chunk` spans (`util.tracing`); every step
is recorded by the step profiler (`util.step_profiler`); the `/metrics`
text is a `serve_llm` callback on the port's registry (`util.metrics`);
and the pump thread beats a deadman probe (`_private.health`).

Not ported yet: the native dispatch-ring intake and the shared-memory
arena (`store=`, with its `kv_arena_id`).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch._private import health as _health
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel.compile_cache import compiled_step
from ray_tpu_torch.serve.llm.kv_cache import (OutOfPagesError, PagedKVCache,
                                              PrefixCache)
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import request_recorder as _rr
from ray_tpu_torch.util import step_profiler as _sp
from ray_tpu_torch.util import tracing as _tracing


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_tuple(name: str, default: Tuple[int, ...]) -> Tuple[int, ...]:
    raw = os.environ.get(name)
    if not raw:
        return default
    return tuple(sorted(int(x) for x in raw.split(",") if x.strip()))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Scheduler + cache knobs (env-overridable, same names as the JAX
    engine's)."""

    block_size: int = 0            # RAY_TPU_LLM_BLOCK_SIZE (default 16)
    num_pages: int = 0             # 0 -> worst case for max_running
    batch_buckets: Tuple[int, ...] = ()    # RAY_TPU_LLM_BATCH_BUCKETS
    prefill_buckets: Tuple[int, ...] = ()  # RAY_TPU_LLM_PREFILL_BUCKETS
    max_running: int = 0           # RAY_TPU_LLM_MAX_RUNNING
    max_prefills_per_step: int = 1
    eos_token: Optional[int] = None
    # copy-on-write shared-prefix page reuse (RAY_TPU_LLM_PREFIX_CACHE,
    # default on; -1 = unset)
    prefix_cache: int = -1
    # chunked prefill window (RAY_TPU_LLM_PREFILL_CHUNK, 0 = off: long
    # prompts then stay capped at the largest prefill bucket)
    prefill_chunk: int = -1
    # speculative decoding draft length K (RAY_TPU_LLM_SPEC_K, 0 = off)
    spec_k: int = -1

    def resolved(self, max_seq_len: int) -> "EngineConfig":
        block = self.block_size or _env_int("RAY_TPU_LLM_BLOCK_SIZE", 16)
        batch = self.batch_buckets or _env_tuple(
            "RAY_TPU_LLM_BATCH_BUCKETS", (1, 2, 4, 8))
        prefill = self.prefill_buckets or _env_tuple(
            "RAY_TPU_LLM_PREFILL_BUCKETS", (16, 32, 64, 128))
        prefill = tuple(s for s in prefill if s <= max_seq_len) or \
            (max_seq_len,)
        max_running = self.max_running or _env_int(
            "RAY_TPU_LLM_MAX_RUNNING", max(batch))
        max_running = min(max_running, max(batch))
        pages_per_seq = -(-max_seq_len // block)
        num_pages = self.num_pages or max_running * pages_per_seq
        prefix = self.prefix_cache
        if prefix < 0:
            prefix = _env_int("RAY_TPU_LLM_PREFIX_CACHE", 1)
        chunk = self.prefill_chunk
        if chunk < 0:
            chunk = _env_int("RAY_TPU_LLM_PREFILL_CHUNK", 0)
        chunk = min(chunk, max_seq_len)
        spec = self.spec_k
        if spec < 0:
            spec = _env_int("RAY_TPU_LLM_SPEC_K", 0)
        return dataclasses.replace(
            self, block_size=block, num_pages=num_pages,
            batch_buckets=batch, prefill_buckets=prefill,
            max_running=max_running, prefix_cache=int(bool(prefix)),
            prefill_chunk=max(0, chunk), spec_k=max(0, spec))


class RequestRejected(RuntimeError):
    pass


_req_counter = itertools.count(1)

# the k_pages, v_pages arguments of the decode, chunk and verify step
# functions: a graph reads the arena in place, by address
_ARENA_ARGS = (2, 3)


class Request:
    """One generation request; tokens stream into `out_q` as produced.

    Queue items: ("token", index, token_id) per generated token, then
    one terminal ("done", reason) / ("error", message).
    """

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 deadline: Optional[float], request_id: str,
                 tenant: str = "none"):
        self.id = request_id
        self.tenant = tenant  # submitting job's label
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline
        self.out_q: "queue.Queue" = queue.Queue()
        self.tokens: List[int] = []   # generated tokens, in order
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.finish_reason: Optional[str] = None
        self.submit_ts = time.monotonic()
        self.finish_ts: Optional[float] = None
        # request-recorder phase stamps (monotonic) and the request
        # context captured at submit(): the pump thread cannot see the
        # submitter's contextvars, so the ctx rides the Request
        self.ctx: Optional[dict] = None
        self.submit_wall = time.time()
        self.first_consider_ts: Optional[float] = None
        self.admit_ts: Optional[float] = None
        self.prefill_ms = 0.0
        self.first_token_ts: Optional[float] = None
        self.last_token_ts: Optional[float] = None

    def __repr__(self):
        return f"Request({self.id})"

    # -- consumer side ---------------------------------------------------

    def result(self, timeout: Optional[float] = 60.0) -> List[int]:
        """Block until generation finishes; returns the generated ids."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} not done "
                               f"after {timeout}s")
        if self.error is not None:
            raise RequestRejected(self.error)
        return list(self.tokens)

    def stream(self, timeout: float = 60.0):
        """Yield generated token ids as the engine produces them."""
        while True:
            kind, *rest = self.out_q.get(timeout=timeout)
            if kind == "token":
                yield rest[1]
            elif kind == "done":
                return
            else:
                raise RequestRejected(rest[0])

    # -- engine side -----------------------------------------------------

    def _emit(self, token: int):
        # per-token recorder cost: one monotonic read (TPOT = span
        # between the first and last of these stamps)
        now = time.monotonic()
        if self.first_token_ts is None:
            self.first_token_ts = now
        self.last_token_ts = now
        self.tokens.append(token)
        self.out_q.put(("token", len(self.tokens) - 1, token))

    def _finish(self, reason: str):
        self.finish_reason = reason
        self.finish_ts = time.monotonic()
        self.out_q.put(("done", reason))
        self.done.set()

    def _fail(self, msg: str):
        self.error = msg
        self.finish_ts = time.monotonic()
        self.out_q.put(("error", msg))
        self.done.set()


class _Sequence:
    """A running request's decode state.

    `pos` is the number of tokens in the TARGET KV cache (= prompt +
    generated - 1 in steady state: the newest token rides as the next
    dispatch's input). `prefilled` is the chunked-prefill frontier (it
    starts at the prefix-cache hit length). `d_pages`/`d_prefilled`/
    `d_pos` are the draft model's mirror state when speculative decoding
    is on: `d_pos` is the draft cache frontier, which lags `pos` by at
    most one token after a fully-accepted round (the next round's
    catch-up closes the gap)."""

    __slots__ = ("req", "pages", "pos", "prefilled", "d_pages",
                 "d_prefilled", "d_pos")

    def __init__(self, req: Request, pages: List[int], pos: int,
                 cached: int = 0, d_pages: Optional[List[int]] = None):
        self.req = req
        self.pages = pages
        self.pos = pos  # tokens already written to the KV cache
        self.prefilled = pos or cached
        self.d_pages = d_pages
        self.d_prefilled = 0
        self.d_pos = 0

    @property
    def last_token(self) -> int:
        toks = self.req.tokens
        return toks[-1] if toks else self.req.prompt[-1]

    @property
    def n_generated(self) -> int:
        return len(self.req.tokens)


class LLMEngine:
    """Continuous-batching engine for one model replica on one device.

    `model` selects the family ("llama" | "gpt"); `model_cfg` defaults
    to the family's tiny config in float32. `params` is the port's param
    dict (`models.<family>.init_params` or `models.convert`); None draws
    fresh weights from `seed`. `device` defaults to "cuda" and raises
    without a GPU; pass "cpu" to run on the host explicitly.

    With `spec_k > 0` the draft model is the target itself (sharing its
    tensors) unless `draft_params` (with `draft_cfg`, default the
    target's config) names another; `draft_cfg` alone draws fresh draft
    weights from `seed + 1`. The draft is of the same family, with the
    target's vocabulary and `max_seq_len`.

    On a CUDA device every bucket's step function is a captured CUDA
    graph in one memory pool of the engine's own (its graphs never run
    at the same time); `warmup()` captures them all.
    """

    def __init__(self, model: str = "llama", model_cfg=None, params=None,
                 engine_config: Optional[EngineConfig] = None,
                 seed: int = 0, device=None, draft_cfg=None,
                 draft_params=None):
        if model == "llama":
            from ray_tpu_torch.models import llama as mod
            self.model_cfg = model_cfg or mod.LlamaConfig.tiny(
                dtype=torch.float32)
            net_cls = mod.Llama
        elif model == "gpt":
            from ray_tpu_torch.models import gpt as mod
            self.model_cfg = model_cfg or mod.GPTConfig.tiny(
                dtype=torch.float32)
            net_cls = mod.GPT
        else:
            raise ValueError(f"unknown model family {model!r}")
        self.device = resolve_device(device)
        self.model_name = model
        self._mod = mod
        cfg = (engine_config or EngineConfig()).resolved(
            self.model_cfg.max_seq_len)
        self.config = cfg
        self.max_pages_per_seq = -(-self.model_cfg.max_seq_len
                                   // cfg.block_size)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = mod.init_params(self.model_cfg, gen, self.device)
        self.params = params
        # prefill runs the hand-written flash-attention kernel
        self.net = net_cls.from_params(self.model_cfg, params,
                                       attention_fn=flash_attention)
        self.kv = self._arena(self.model_cfg, cfg.num_pages)
        self.prefix = PrefixCache(self.kv) if cfg.prefix_cache else None
        # one chunk width (B=1, C=_chunk_size) covers both chunked
        # prefill windows and prefix-cache-hit suffixes
        self._chunk_size = cfg.prefill_chunk or max(cfg.prefill_buckets)
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)

        # speculative decoding: the draft's own net and KV arena
        self.draft_cfg = self.draft_params = self.d_net = None
        self.kv_d: Optional[PagedKVCache] = None
        if cfg.spec_k > 0:
            self.draft_cfg = draft_cfg or self.model_cfg
            for field in ("vocab_size", "max_seq_len"):
                if getattr(self.draft_cfg, field) != \
                        getattr(self.model_cfg, field):
                    raise ValueError(
                        f"draft {field} {getattr(self.draft_cfg, field)} "
                        f"!= the target's {getattr(self.model_cfg, field)}")
            if draft_params is None and draft_cfg is None:
                draft_params = params  # self-draft: the target's tensors
            elif draft_params is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    seed + 1)
                draft_params = mod.init_params(self.draft_cfg, gen,
                                               self.device)
            self.draft_params = draft_params
            self.d_net = self.net if draft_params is params and \
                self.draft_cfg == self.model_cfg else net_cls.from_params(
                    self.draft_cfg, draft_params,
                    attention_fn=flash_attention)
            # a fully-accepted round leaves the draft frontier K tokens
            # past the target's, so its reservation is K tokens wider
            self.max_pages_per_seq_d = -(-(self.model_cfg.max_seq_len
                                           + cfg.spec_k)
                                         // cfg.block_size)
            self.kv_d = self._arena(
                self.draft_cfg, cfg.max_running * self.max_pages_per_seq_d)

        # one compiled_step wrapper per bucket: each sees exactly one
        # abstract signature, so on_retrace="error" turns any shape
        # drift in steady-state serving into a loud failure
        self._prefill_fns = {s: self._compiled(self._make_prefill_fn(s))
                             for s in cfg.prefill_buckets}
        self._decode_fns = {
            b: self._compiled(self._make_decode_fn(b), _ARENA_ARGS)
            for b in cfg.batch_buckets}
        self._chunk_fn = self._compiled(
            self._make_chunk_fn(self._chunk_size, "chunk"), _ARENA_ARGS)
        if cfg.spec_k > 0:
            # verify: one target chunk forward per batch bucket at the
            # window K+1 ([last_committed, draft_1..draft_K]), so the
            # accept length can vary without a new signature
            self._verify_fns = {
                b: self._compiled(self._make_verify_fn(b, cfg.spec_k + 1),
                                  _ARENA_ARGS)
                for b in cfg.batch_buckets}
            self._d_decode_fns = {
                b: self._compiled(self._make_decode_fn(b, draft=True),
                                  _ARENA_ARGS)
                for b in cfg.batch_buckets}
            self._d_prefill_fns = {
                s: self._compiled(self._make_prefill_fn(s, draft=True))
                for s in cfg.prefill_buckets}
            self._d_chunk_fn = self._compiled(self._make_chunk_fn(
                self._chunk_size, "draft_chunk", draft=True), _ARENA_ARGS)

        self._waiting: List[Request] = []
        self._prefilling: List[_Sequence] = []
        self._running: List[_Sequence] = []
        self._lock = threading.Lock()       # guards queues + counters
        self._step_lock = threading.Lock()  # serializes step()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pump_probe: Optional[_health.LoopProbe] = None
        self._step_no = 0
        self.counters: Dict[str, float] = {
            # requests_failed as in the JAX engine's counters, where no
            # path increments it either (shut-down requests are recorded
            # as "failed" by the request recorder)
            "requests_submitted": 0, "requests_completed": 0,
            "requests_failed": 0, "requests_timed_out": 0,
            "tokens_generated": 0, "prefill_steps": 0,
            "decode_steps": 0, "prefill_ms": 0.0, "decode_ms": 0.0,
            "chunk_steps": 0, "spec_rounds": 0, "spec_proposed": 0,
            "spec_accepted": 0,
        }
        # per-bucket compiled_step calls: (kind, bucket) -> calls; every
        # entry maps onto one graph (one step function)
        self.bucket_calls: Dict[Tuple[str, int], int] = {}
        # per-tenant rows: shed decisions and throughput per job label
        self.tenant_counters: Dict[str, Dict[str, float]] = {}
        _metrics.DEFAULT_REGISTRY.register_callback(
            "serve_llm", self._metrics_text)

    def _arena(self, model_cfg, num_pages: int) -> PagedKVCache:
        kvh = getattr(model_cfg, "n_kv_head", model_cfg.n_head)
        return PagedKVCache(
            num_pages, model_cfg.n_layer, self.config.block_size, kvh,
            model_cfg.d_model // model_cfg.n_head, dtype=model_cfg.dtype,
            device=self.device)

    # -- step functions ---------------------------------------------------
    # One function per bucket, named as in the JAX engine; each closes
    # over its model (weights captured by address) and takes the KV
    # arena as live arguments (`_ARENA_ARGS`) where it reads the cache.

    def _compiled(self, fn, live_argnums=()):
        return compiled_step(fn, live_argnums=live_argnums,
                             device=self.device, pool=self._graph_pool,
                             on_retrace="error")

    def _model(self, draft: bool):
        if draft:
            return self.d_net, self.draft_cfg
        return self.net, self.model_cfg

    def _make_prefill_fn(self, bucket: int, draft: bool = False):
        mod = self._mod
        net, cfg = self._model(draft)

        def fn(tokens, true_len):
            return mod.prefill_step(net, cfg, tokens, true_len)

        fn.__name__ = f"llm_{'draft_' if draft else ''}prefill_s{bucket}"
        return fn

    def _make_decode_fn(self, batch: int, draft: bool = False):
        mod = self._mod
        net, cfg = self._model(draft)

        def fn(tokens, positions, k_pages, v_pages, page_table):
            return mod.decode_step(net, cfg, tokens, positions, k_pages,
                                   v_pages, page_table)

        fn.__name__ = f"llm_{'draft_' if draft else ''}decode_b{batch}"
        return fn

    def _make_chunk_fn(self, width: int, tag: str, draft: bool = False):
        mod = self._mod
        net, cfg = self._model(draft)

        def fn(tokens, start, k_pages, v_pages, page_table):
            return mod.chunk_step(net, cfg, tokens, start, k_pages,
                                  v_pages, page_table)

        fn.__name__ = f"llm_{tag}_c{width}"
        return fn

    def _make_verify_fn(self, batch: int, width: int):
        fn = self._make_chunk_fn(width, "verify")
        fn.__name__ = f"llm_verify_b{batch}_c{width}"
        return fn

    def _step_fns(self):
        """Every compiled step function of this engine."""
        fns = [*self._prefill_fns.values(), *self._decode_fns.values(),
               self._chunk_fn]
        if self.kv_d is not None:
            fns += [*self._verify_fns.values(),
                    *self._d_prefill_fns.values(),
                    *self._d_decode_fns.values(), self._d_chunk_fn]
        return fns

    # Dispatch. Integer inputs go in as host tensors, which a graph
    # copies through its pinned staging buffers; the arena goes in live.

    @staticmethod
    def _ints(values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.long)

    def _run(self, fn, *args):
        return fn(*args)

    def _prefill(self, tokens, true_len, draft: bool = False):
        fns = self._d_prefill_fns if draft else self._prefill_fns
        return self._run(fns[len(tokens[0])], self._ints(tokens),
                         self._ints(true_len))

    def _decode(self, tokens, positions, page_table, draft: bool = False):
        fns = self._d_decode_fns if draft else self._decode_fns
        kv = self.kv_d if draft else self.kv
        return self._run(fns[len(tokens)], self._ints(tokens),
                         self._ints(positions), kv.k_pages, kv.v_pages,
                         self._ints(page_table))

    def _chunk(self, tokens, start, page_table, draft: bool = False):
        fn = self._d_chunk_fn if draft else self._chunk_fn
        kv = self.kv_d if draft else self.kv
        return self._run(fn, self._ints(tokens), self._ints(start),
                         kv.k_pages, kv.v_pages, self._ints(page_table))

    def _verify(self, tokens, start, page_table):
        return self._run(self._verify_fns[len(tokens)], self._ints(tokens),
                         self._ints(start), self.kv.k_pages,
                         self.kv.v_pages, self._ints(page_table))

    def _note_call(self, kind: str, bucket: int):
        """Per-(kind, bucket) dispatch counter: one row per graph
        actually exercised."""
        with self._lock:
            key = (kind, bucket)
            self.bucket_calls[key] = self.bucket_calls.get(key, 0) + 1

    def warmup(self):
        """Capture every bucket up front (on the CPU: run it once), so
        steady state is all cache hits: the target's prefill, decode and
        chunk buckets and, with speculation on, the verify windows and
        the draft's prefill, decode and chunk buckets. Captures run on
        the caller's thread; the pump thread replays."""
        with torch.inference_mode():
            for draft in (False, True) if self.kv_d is not None else \
                    (False,):
                width = self.max_pages_per_seq_d if draft else \
                    self.max_pages_per_seq
                for s in self.config.prefill_buckets:
                    self._prefill([[0] * s], [1], draft)
                for b in self.config.batch_buckets:
                    self._decode([0] * b, [0] * b, [[0] * width] * b, draft)
                self._chunk([[0] * self._chunk_size], [0], [[0] * width],
                            draft)
            if self.kv_d is not None:
                k1 = self.config.spec_k + 1
                for b in self.config.batch_buckets:
                    self._verify([[0] * k1] * b, [0] * b,
                                 [[0] * self.max_pages_per_seq] * b)

    # -- submission -------------------------------------------------------

    def _tenant_row(self, tenant: str) -> Dict[str, float]:
        """Per-tenant counter row; caller holds self._lock."""
        row = self.tenant_counters.get(tenant)
        if row is None:
            row = self.tenant_counters[tenant] = {
                "requests_submitted": 0, "requests_completed": 0,
                "requests_timed_out": 0, "tokens_generated": 0,
            }
        return row

    def submit(self, prompt: List[int], max_new_tokens: int = 16, *,
               request_id: Optional[str] = None,
               timeout_s: Optional[float] = None,
               tenant: str = "none") -> Request:
        if not prompt:
            raise RequestRejected("empty prompt")
        if not self.config.prefill_chunk:
            # chunked prefill off: a prompt must fit one prefill bucket
            limit = max(self.config.prefill_buckets)
            if len(prompt) > limit:
                raise RequestRejected(
                    f"prompt of {len(prompt)} tokens exceeds the "
                    f"largest prefill bucket ({limit})")
        total = len(prompt) + max_new_tokens
        if total > self.model_cfg.max_seq_len:
            raise RequestRejected(
                f"prompt+max_new_tokens {total} exceeds max_seq_len "
                f"{self.model_cfg.max_seq_len}")
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        req = Request(prompt, max_new_tokens, deadline,
                      request_id or f"llm-{next(_req_counter)}",
                      tenant=tenant)
        # a replica's serving(ctx) region is live during submit; the pump
        # thread reads the ctx back off the request
        req.ctx = _rr.current()
        with self._lock:
            self.counters["requests_submitted"] += 1
            self._tenant_row(tenant)["requests_submitted"] += 1
            self._waiting.append(req)
        self._work.set()
        return req

    # -- scheduler --------------------------------------------------------

    def step(self) -> bool:
        """One engine iteration: admit + prefill up to
        `max_prefills_per_step` prompts, then one decode pass over the
        running set. Returns False when there was nothing to do."""
        with self._step_lock, torch.inference_mode():
            t0 = time.perf_counter()
            prefill_ms = decode_ms = 0.0
            tokens_out = 0
            advanced = False
            self._shed_expired()
            for _ in range(self.config.max_prefills_per_step):
                if len(self._prefilling) < \
                        self.config.max_prefills_per_step:
                    self._admit_one()
                if not self._prefilling:
                    break
                t1 = time.perf_counter()
                # ONE chunk (or one-shot bucket prefill) per slot per
                # step: a long prompt spreads across steps while decode
                # below keeps running
                tokens_out += self._advance_prefill()
                advanced = True
                prefill_ms += (time.perf_counter() - t1) * 1e3
            if self._running:
                t1 = time.perf_counter()
                if self.kv_d is not None:
                    tokens_out += self._spec_decode_once()
                else:
                    tokens_out += self._decode_once()
                decode_ms += (time.perf_counter() - t1) * 1e3
            did = bool(tokens_out) or advanced
            if did:
                self._step_no += 1
                with self._lock:
                    self.counters["prefill_ms"] += prefill_ms
                    self.counters["decode_ms"] += decode_ms
                    self.counters["tokens_generated"] += tokens_out
                if _sp.enabled():
                    _sp.record_step(
                        self._step_no,
                        (time.perf_counter() - t0) * 1e3,
                        tokens=tokens_out, prefill_ms=prefill_ms,
                        decode_ms=decode_ms,
                        running=len(self._running))
            return did

    def _shed_expired(self):
        now = time.monotonic()
        with self._lock:
            keep = []
            shed = []
            for req in self._waiting:
                if req.deadline is not None and now > req.deadline:
                    self.counters["requests_timed_out"] += 1
                    self._tenant_row(req.tenant)["requests_timed_out"] += 1
                    shed.append(req)
                else:
                    keep.append(req)
            self._waiting = keep
        for req in shed:
            req._fail("deadline passed before admission")
            self._emit_request_record(req, "timed_out")

    def _admit_one(self) -> Optional[_Sequence]:
        """Pop the oldest waiting request whose worst-case page demand
        fits right now (pages reserved up front: a running sequence can
        never hit OutOfPages mid-decode). With the prefix cache on,
        admission aliases the longest cached full-page prefix into the
        new page table atomically with the remainder allocation — the
        sequence then prefills only the uncached suffix."""
        with self._lock:
            if not self._waiting or \
                    len(self._running) + len(self._prefilling) >= \
                    self.config.max_running:
                return None
            req = self._waiting[0]
            # the queue phase ends at the FIRST admission consideration:
            # time spent retrying the page reservation after this point
            # is admission wait, not queue wait
            if req.first_consider_ts is None:
                req.first_consider_ts = time.monotonic()
            need = self.kv.pages_for_tokens(
                len(req.prompt) + req.max_new_tokens)
            cached = 0
            try:
                if self.prefix is not None:
                    pages, cached = self.prefix.acquire(
                        req.prompt, req, need)
                else:
                    pages = self.kv.alloc(need, req)
            except OutOfPagesError:
                return None
            d_pages = None
            if self.kv_d is not None:
                try:
                    d_pages = self.kv_d.alloc(
                        self.kv_d.pages_for_tokens(
                            len(req.prompt) + req.max_new_tokens
                            + self.config.spec_k), req)
                except OutOfPagesError:
                    self.kv.free(pages, req)  # roll the target's back
                    return None
            req.admit_ts = time.monotonic()
            self._waiting.pop(0)
            seq = _Sequence(req, pages, pos=0, cached=cached,
                            d_pages=d_pages)
            self._prefilling.append(seq)
        return seq

    # -- prefill (one-shot bucket / chunked / prefix-cache suffix) --------

    def _advance_prefill(self) -> int:
        """Advance the oldest in-flight prefill by one unit of work: a
        one-shot bucket prefill when the whole prompt fits, otherwise one
        chunk of the target prompt, then (speculation on) one unit of the
        draft model's own prefill. Returns tokens emitted (1 exactly when
        the target's prefill completes: the first token comes before the
        draft has its prompt, so the draft does not delay it)."""
        seq = self._prefilling[0]
        req = seq.req
        s = len(req.prompt)
        emitted = 0
        if seq.prefilled < s:
            t0 = time.perf_counter()
            oneshot = (seq.prefilled == 0
                       and s <= max(self.config.prefill_buckets)
                       and (not self.config.prefill_chunk
                            or s <= self._chunk_size))
            if oneshot:
                emitted = self._prefill_oneshot(seq)
            else:
                emitted = self._chunk_advance(seq)
            req.prefill_ms += (time.perf_counter() - t0) * 1e3
        elif self.kv_d is not None and seq.d_prefilled < s:
            # after the first token: this time lies in the request's
            # decode span, so it is not prefill time (the JAX engine adds
            # it to both, and its phases then sum past the total)
            self._draft_prefill_advance(seq)
        ready = seq.prefilled >= s and \
            (self.kv_d is None or seq.d_prefilled >= s)
        if ready or seq.req.done.is_set():
            with self._lock:
                if seq in self._prefilling:
                    self._prefilling.remove(seq)
            if not seq.req.done.is_set():
                with self._lock:
                    self._running.append(seq)
        return emitted

    def _emit_first(self, seq: _Sequence, next_logits_row) -> int:
        """Emit the prompt's next token; on finish, release everything
        (a one-token request never reaches the running set)."""
        tok = int(torch.argmax(next_logits_row))
        seq.req._emit(tok)
        if self._seq_finished(seq, tok):
            self._finish(seq)
        return 1

    def _prefill_oneshot(self, seq: _Sequence) -> int:
        req = seq.req
        s = len(req.prompt)
        bucket = min(b for b in self.config.prefill_buckets if b >= s)
        attrs: Dict[str, Any] = {"bucket": bucket, "tokens_in": s}
        if req.ctx:
            attrs["req_id"] = req.ctx["req_id"]
            attrs["flow_id"] = f"req:{req.ctx['req_id']}"
        with _tracing.span("llm.prefill", kind="consumer", attrs=attrs):
            self._note_call("prefill", bucket)
            next_logits, k, v = self._prefill(
                [req.prompt + [0] * (bucket - s)], [s])
            # rows at and past s are padding: never cached
            self.kv.write_prefill(seq.pages, k[0], v[0], s)
            seq.prefilled = s
            seq.pos = s
            if self.prefix is not None:
                self.prefix.insert(req.prompt, seq.pages)
            with self._lock:
                self.counters["prefill_steps"] += 1
            return self._emit_first(seq, next_logits[0])

    def _chunk_advance(self, seq: _Sequence) -> int:
        """One chunk: forward the next `_chunk_size` prompt tokens
        against the pages filled so far (prefix-cache hits enter here
        with `prefilled == cached > 0`, so the cached pages are attended
        but never recomputed)."""
        req = seq.req
        s = len(req.prompt)
        c = self._chunk_size
        take = min(c, s - seq.prefilled)
        toks = req.prompt[seq.prefilled:seq.prefilled + take]
        table = seq.pages + [0] * (self.max_pages_per_seq - len(seq.pages))
        attrs: Dict[str, Any] = {"chunk": c, "start": seq.prefilled,
                                 "tokens_in": take}
        if req.ctx:
            attrs["req_id"] = req.ctx["req_id"]
            attrs["flow_id"] = f"req:{req.ctx['req_id']}"
        with _tracing.span("llm.prefill_chunk", kind="consumer",
                           attrs=attrs):
            self._note_call("chunk", c)
            logits, k, v = self._chunk([toks + [0] * (c - take)],
                                       [seq.prefilled], [table])
            self.kv.write_prefill(seq.pages, k[0], v[0], take,
                                  start=seq.prefilled)
            seq.prefilled += take
            with self._lock:
                self.counters["chunk_steps"] += 1
            if seq.prefilled < s:
                return 0
            seq.pos = s
            if self.prefix is not None:
                self.prefix.insert(req.prompt, seq.pages)
            with self._lock:
                self.counters["prefill_steps"] += 1
            return self._emit_first(seq, logits[0, take - 1])

    def _draft_prefill_advance(self, seq: _Sequence):
        """Give the draft model this sequence's prompt in its own KV
        pages. The draft never sees the prefix cache (its pages are per
        sequence), so it processes the whole prompt: one bucket forward
        (the flash kernel) when the prompt fits, else one chunk per
        step."""
        req = seq.req
        s = len(req.prompt)
        if seq.d_prefilled == 0 and s <= max(self.config.prefill_buckets):
            bucket = min(b for b in self.config.prefill_buckets if b >= s)
            self._note_call("draft_prefill", bucket)
            _, k, v = self._prefill([req.prompt + [0] * (bucket - s)], [s],
                                    draft=True)
            self.kv_d.write_prefill(seq.d_pages, k[0], v[0], s)
            seq.d_prefilled = s
        else:
            c = self._chunk_size
            take = min(c, s - seq.d_prefilled)
            toks = req.prompt[seq.d_prefilled:seq.d_prefilled + take]
            table = seq.d_pages + [0] * (self.max_pages_per_seq_d
                                         - len(seq.d_pages))
            self._note_call("draft_chunk", c)
            _, k, v = self._chunk([toks + [0] * (c - take)],
                                  [seq.d_prefilled], [table], draft=True)
            self.kv_d.write_prefill(seq.d_pages, k[0], v[0], take,
                                    start=seq.d_prefilled)
            seq.d_prefilled += take
        seq.d_pos = seq.d_prefilled

    def _decode_once(self) -> int:
        with self._lock:
            runs = list(self._running)
        bb = min(b for b in self.config.batch_buckets if b >= len(runs))
        pad = bb - len(runs)
        tokens = [seq.last_token for seq in runs] + [0] * pad
        positions = [seq.pos for seq in runs] + [0] * pad
        page_table = [
            seq.pages + [0] * (self.max_pages_per_seq - len(seq.pages))
            for seq in runs] + [[0] * self.max_pages_per_seq] * pad
        self._note_call("decode", bb)
        logits, new_k, new_v = self._decode(tokens, positions, page_table)
        next_tokens = torch.argmax(logits, dim=-1).tolist()  # one sync
        finished = []
        for i, seq in enumerate(runs):
            # the new token's K/V lands in the cache after the step
            self.kv.append(seq.pages, seq.pos, new_k[i], new_v[i])
            seq.pos += 1
            tok = next_tokens[i]
            seq.req._emit(tok)
            if self._seq_finished(seq, tok):
                finished.append(seq)
        with self._lock:
            self.counters["decode_steps"] += 1
        for seq in finished:
            self._finish(seq)
        return len(runs)

    def _spec_decode_once(self) -> int:
        """One speculative round over the running set (Leviathan et al.
        '23, greedy case): the draft proposes K tokens per sequence
        autoregressively, the target scores all K+1 positions in ONE
        chunk forward, and the longest proposal prefix that matches the
        target's own argmaxes is accepted, plus the target's next token
        after it, so every round emits >= 1 token and the stream is
        exactly plain greedy's.

        All lanes run the draft loop in lockstep: `max_gap + K` draft
        decodes per round, where a lane's gap (0 or 1) is its catch-up
        deficit after a fully-accepted round. A lane past its own
        `gap + K` budget idles in the batch (its output is neither
        appended nor read). Each draft step copies only the [bb] argmax
        ids to the host, and verify only its [bb, K+1] ids.
        """
        K = self.config.spec_k
        with self._lock:
            runs = list(self._running)
        n = len(runs)
        bb = min(b for b in self.config.batch_buckets if b >= n)
        full = [seq.req.prompt + seq.req.tokens for seq in runs]
        cur = [seq.d_pos for seq in runs]
        budget = [seq.pos - seq.d_pos + K for seq in runs]
        proposals: List[List[int]] = [[] for _ in range(n)]
        d_table = self._ints(
            [seq.d_pages + [0] * (self.max_pages_per_seq_d
                                  - len(seq.d_pages)) for seq in runs]
            + [[0] * self.max_pages_per_seq_d] * (bb - n))
        # a lane's draft positions can run past max_seq_len - 1 only
        # where its request ends first: clamp them into the position
        # tables (the proposals there are never verified into output)
        last_pos = self.draft_cfg.max_seq_len - 1
        for t in range(max(budget)):
            toks, poss = [0] * bb, [0] * bb
            active = [i for i in range(n) if t < budget[i]]
            for i in active:
                idx = cur[i]
                # a committed token (catch-up, or the round's first
                # input), else the lane's own last proposal
                toks[i] = full[i][idx] if idx < len(full[i]) else \
                    proposals[i][idx - len(full[i])]
                poss[i] = min(idx, last_pos)
            self._note_call("draft_decode", bb)
            d_logits, d_k, d_v = self._decode(toks, poss, d_table,
                                              draft=True)
            d_next = torch.argmax(d_logits, dim=-1).tolist()  # [bb] ids
            for i in active:
                self.kv_d.append(runs[i].d_pages, cur[i], d_k[i], d_v[i])
                cur[i] += 1
                if cur[i] > runs[i].pos:  # past catch-up: a proposal
                    proposals[i].append(d_next[i])
        # verify: the target scores [last_committed, d_1..d_K] at
        # positions pos..pos+K in one window
        pad = bb - n
        self._note_call("verify", bb)
        logits, new_k, new_v = self._verify(
            [[seq.last_token] + proposals[i][:K]
             for i, seq in enumerate(runs)] + [[0] * (K + 1)] * pad,
            [seq.pos for seq in runs] + [0] * pad,
            [seq.pages + [0] * (self.max_pages_per_seq - len(seq.pages))
             for seq in runs] + [[0] * self.max_pages_per_seq] * pad)
        greedy = torch.argmax(logits, dim=-1).tolist()  # [bb, K+1] ids
        tokens_out = accepted = 0
        finished = []
        for i, seq in enumerate(runs):
            a = 0  # accepted proposals: d_{j+1} must equal g_j
            while a < K and proposals[i][a] == greedy[i][a]:
                a += 1
            accepted += a
            # emit g_0..g_a, stopping at EOS / length where plain greedy
            # would have stopped
            emitted = 0
            fin = False
            for tok in greedy[i][:a + 1]:
                seq.req._emit(tok)
                emitted += 1
                if self._seq_finished(seq, tok):
                    fin = True
                    break
            tokens_out += emitted
            if fin:
                finished.append(seq)
                continue
            # commit K/V: verify rows 0..emitted-1 are exactly the
            # committed tokens' ([last, d_1..d_a] == [last, g_0..g_{a-1}]);
            # the draft cache is right through pos + min(a+1, K) (it
            # never saw g_a when a == K)
            self.kv.write_prefill(seq.pages, new_k[i], new_v[i], emitted,
                                  start=seq.pos)
            seq.d_pos = seq.pos + min(a + 1, K)
            seq.pos += emitted
        with self._lock:
            self.counters["decode_steps"] += 1
            self.counters["spec_rounds"] += 1
            self.counters["spec_proposed"] += K * n
            self.counters["spec_accepted"] += accepted
        for seq in finished:
            self._finish(seq)
        return tokens_out

    def _seq_finished(self, seq: _Sequence, tok: int) -> bool:
        if seq.n_generated >= seq.req.max_new_tokens:
            seq.req.finish_reason = "length"
            return True
        if self.config.eos_token is not None and \
                tok == self.config.eos_token:
            seq.req.finish_reason = "stop"
            return True
        return False

    def _finish(self, seq: _Sequence):
        # refcounted free: pages the prefix cache (or a sibling
        # sequence) still aliases survive this — only the refcount drops
        self.kv.free(seq.pages, seq.req)
        if seq.d_pages is not None:
            self.kv_d.free(seq.d_pages, seq.req)
        with self._lock:
            if seq in self._running:
                self._running.remove(seq)
            self.counters["requests_completed"] += 1
            row = self._tenant_row(seq.req.tenant)
            row["requests_completed"] += 1
            row["tokens_generated"] += len(seq.req.tokens)
        seq.req._finish(seq.req.finish_reason or "length")
        self._emit_request_record(seq.req, "ok")

    def _emit_request_record(self, req: Request, outcome: str):
        """Fold one finished request into the request recorder: engine
        role, authoritative phase split. The monotonic stamps submit ->
        first_consider (queue) -> admit (admission) -> first_token
        (prefill) -> last_token (decode) -> finish tile the end-to-end
        time, so the phases sum to the total."""
        if not _rr.enabled():
            return
        end = req.finish_ts or time.monotonic()
        first_consider = req.first_consider_ts or end
        admit = req.admit_ts or first_consider
        n = len(req.tokens)
        ttft_ms = decode_ms = None
        tpot_ms = None
        if req.first_token_ts is not None:
            ttft_ms = (req.first_token_ts - req.submit_ts) * 1e3
            decode_ms = (req.last_token_ts - req.first_token_ts) * 1e3
            if n > 1 and decode_ms > 0:
                tpot_ms = decode_ms / (n - 1)
        _rr.record_engine(
            req.ctx,
            ts=req.submit_wall,
            total_ms=(end - req.submit_ts) * 1e3,
            queue_ms=(first_consider - req.submit_ts) * 1e3,
            admission_ms=max(0.0, (admit - first_consider) * 1e3),
            prefill_ms=req.prefill_ms,
            decode_ms=decode_ms or 0.0,
            ttft_ms=ttft_ms, tpot_ms=tpot_ms,
            tokens_in=len(req.prompt), tokens_out=n,
            outcome=outcome, job=req.tenant,
            finish_reason=req.finish_reason or req.error or "")

    # -- pump thread ------------------------------------------------------

    def _probe_name(self) -> str:
        return f"llm_engine_pump_{id(self) & 0xffffff:06x}"

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        # deadman probe: one beat per pump pass, backlog read lock-free
        # (bare len() under the GIL: the watchdog must never need the
        # engine lock, or it could not fire while that lock is stuck)
        self._pump_probe = _health.watch_loop(
            self._probe_name(),
            backlog_fn=lambda: (len(self._waiting)
                                + len(self._prefilling)
                                + len(self._running)))
        _health.ensure_watchdog(source="SERVE_LLM")
        self._thread = threading.Thread(
            target=self._pump, name="llm-engine", daemon=True)
        self._thread.start()

    def _pump(self):
        while not self._stop.is_set():
            self._pump_probe.beat()
            if not self.step():
                self._work.clear()
                self._work.wait(0.02)

    def stop(self):
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
            _health.unwatch_loop(self._probe_name())

    # -- lifecycle / introspection ---------------------------------------

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._waiting or self._prefilling
                        or self._running)

    def run_until_idle(self, timeout: float = 60.0):
        """Drive the engine inline (no pump thread) until drained."""
        deadline = time.monotonic() + timeout
        while self.has_work():
            if time.monotonic() > deadline:
                raise TimeoutError("engine did not drain")
            if not self.step():
                time.sleep(0.001)

    def quiesce(self, timeout: float = 60.0):
        """Wait for all in-flight work, then prove zero live KV pages."""
        deadline = time.monotonic() + timeout
        while self.has_work():
            if time.monotonic() > deadline:
                raise TimeoutError("engine did not quiesce")
            if self._thread is None:
                self.step()
            else:
                time.sleep(0.002)
        # a request's done-event fires inside the step, before the
        # step's own counter accounting lands — barrier on any
        # in-flight step so metrics read after quiesce are settled
        with self._step_lock:
            pass
        self.kv.assert_quiesced()
        if self.kv_d is not None:
            self.kv_d.assert_quiesced()

    def shutdown(self) -> int:
        """Stop the pump, drop the KV arenas (the draft's too) and
        release the engine's graphs; returns leaked pages of both arenas
        (0 after a clean quiesce). Waiting requests are failed (and
        recorded so), and the `serve_llm` metrics callback is blanked."""
        self.stop()
        with self._lock:
            waiting, self._waiting = self._waiting, []
        for req in waiting:
            req._fail("engine shut down")
            self._emit_request_record(req, "failed")
        _metrics.DEFAULT_REGISTRY.register_callback(
            "serve_llm", lambda: "")
        if self.prefix is not None:
            # cached prefixes are reusable state, not leaks: release
            # them so close() reports only true sequence leaks
            self.prefix.drain()
        leaked = self.kv_d.close() if self.kv_d is not None else 0
        leaked += self.kv.close()
        # the graphs hold their static buffers and pool memory, and the
        # cache holds the step functions (and so the weights) until evicted
        for fn in self._step_fns():
            fn.cache.evict(fn)
        return leaked

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self.counters)
            out.update(
                queue_depth=len(self._waiting),
                prefilling=len(self._prefilling),
                running=len(self._running),
                kv_pages_live=self.kv.live_pages,
                kv_pages_cached=self.kv.cached_pages,
                kv_pages_total=self.kv.num_pages,
                kv_page_utilization=self.kv.utilization(),
                model=self.model_name,
                spec_k=self.config.spec_k,
                compiled_step_calls={
                    f"{kind}:{bucket}": calls
                    for (kind, bucket), calls in
                    sorted(self.bucket_calls.items())},
                tenants={t: dict(row)
                         for t, row in self.tenant_counters.items()},
            )
        if self.prefix is not None:
            ps = self.prefix.stats()
            out.update(
                prefix_cache_hit_tokens=ps["hit_tokens"],
                prefix_cache_miss_tokens=ps["miss_tokens"],
                prefix_cache_hits=ps["hits"],
                prefix_cache_misses=ps["misses"],
                prefix_cache_entries=ps["entries"],
                prefix_cache_evicted=ps["evicted"],
            )
        if out["spec_rounds"]:
            # accepted draft tokens per round, over all lanes (as the JAX
            # engine reports it)
            out["spec_mean_accept"] = (out["spec_accepted"]
                                       / out["spec_rounds"])
        return out

    def _metrics_text(self) -> str:
        m = self.metrics()
        lines = [
            "# TYPE serve_llm_running_seqs gauge",
            f"serve_llm_running_seqs {m['running']}",
            "# TYPE serve_llm_waiting_seqs gauge",
            f"serve_llm_waiting_seqs {m['queue_depth']}",
            "# TYPE serve_llm_kv_pages_live gauge",
            f"serve_llm_kv_pages_live {m['kv_pages_live']}",
            "# TYPE serve_llm_kv_page_utilization gauge",
            f"serve_llm_kv_page_utilization "
            f"{m['kv_page_utilization']:.6f}",
            "# TYPE serve_llm_tokens_generated_total counter",
            f"serve_llm_tokens_generated_total "
            f"{int(m['tokens_generated'])}",
            "# TYPE serve_llm_requests_completed_total counter",
            f"serve_llm_requests_completed_total "
            f"{int(m['requests_completed'])}",
            "# TYPE serve_llm_requests_timed_out_total counter",
            f"serve_llm_requests_timed_out_total "
            f"{int(m['requests_timed_out'])}",
            "# TYPE serve_llm_prefill_ms_total counter",
            f"serve_llm_prefill_ms_total {m['prefill_ms']:.3f}",
            "# TYPE serve_llm_decode_ms_total counter",
            f"serve_llm_decode_ms_total {m['decode_ms']:.3f}",
        ]
        if "prefix_cache_hit_tokens" in m:
            lines += [
                "# TYPE serve_llm_prefix_cache_hit_tokens_total counter",
                f"serve_llm_prefix_cache_hit_tokens_total "
                f"{int(m['prefix_cache_hit_tokens'])}",
                "# TYPE serve_llm_prefix_cache_miss_tokens_total counter",
                f"serve_llm_prefix_cache_miss_tokens_total "
                f"{int(m['prefix_cache_miss_tokens'])}",
                "# TYPE serve_llm_prefix_cache_entries gauge",
                f"serve_llm_prefix_cache_entries "
                f"{int(m['prefix_cache_entries'])}",
                "# TYPE serve_llm_kv_pages_cached gauge",
                f"serve_llm_kv_pages_cached "
                f"{int(m['kv_pages_cached'])}",
            ]
        if m.get("spec_k"):
            lines += [
                "# TYPE serve_llm_spec_proposed_total counter",
                f"serve_llm_spec_proposed_total "
                f"{int(m['spec_proposed'])}",
                "# TYPE serve_llm_spec_accepted_total counter",
                f"serve_llm_spec_accepted_total "
                f"{int(m['spec_accepted'])}",
                "# TYPE serve_llm_spec_rounds_total counter",
                f"serve_llm_spec_rounds_total "
                f"{int(m['spec_rounds'])}",
            ]
        if m.get("compiled_step_calls"):
            lines.append(
                "# TYPE serve_llm_compiled_step_calls_total counter")
            for key, calls in m["compiled_step_calls"].items():
                kind, bucket = key.rsplit(":", 1)
                lines.append(
                    f'serve_llm_compiled_step_calls_total'
                    f'{{kind="{kind}",bucket="{bucket}"}} {calls}')
        # per-tenant rows: shed decisions + throughput per job label
        for tenant, row in sorted(m.get("tenants", {}).items()):
            for key in ("requests_submitted", "requests_completed",
                        "requests_timed_out", "tokens_generated"):
                lines.append(
                    f'serve_llm_{key}_total{{job="{tenant}"}} '
                    f"{int(row[key])}")
        return "\n".join(lines) + "\n"
