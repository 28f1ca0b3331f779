"""Continuous-batching LLM engine on PyTorch.

Port of `ray_tpu/serve/llm/engine.py`: Orca-style iteration-level
scheduling (every `step()` interleaves at most `max_prefills_per_step`
prompt prefills with one decode iteration over the whole running set;
sequences join and leave the decode batch between steps, and a finished
sequence frees its KV pages at once). Prompts pad into prefill buckets
and the decode batch into batch buckets, as in the JAX engine. PyTorch
runs eagerly, so where the JAX engine holds one compiled executable per
bucket the port calls the model's step function directly per bucket;
`bucket_calls` counts the calls per (kind, bucket) all the same.

Prefill runs the model with the hand-written flash-attention kernel
(`ray_tpu_torch.ops.flash_attention`); decode and chunk attention are
plain PyTorch over the paged cache, as the JAX package leaves them to
XLA.

The KV plane is a `PagedKVCache` in device memory: decode hands the
model the whole arena plus per-sequence page-table rows, and the new
token's K/V is written into the sequence's tail page after the step.
Greedy (argmax) sampling keeps generation deterministic.

All device work runs under `torch.inference_mode()` on the engine's one
device, on the current stream, from whichever thread steps the engine
(the caller's, or the pump thread after `start()`).

Not ported yet: speculative decoding (`EngineConfig.spec_k > 0` raises
NotImplementedError), the native dispatch-ring intake, the request
recorder / tracing / step-profiler / health-probe hooks with the
`/metrics` text, and the shared-memory arena (`store=`).
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
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.serve.llm.kv_cache import (OutOfPagesError, PagedKVCache,
                                              PrefixCache)


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
    # speculative decoding draft length K (RAY_TPU_LLM_SPEC_K, 0 = off;
    # not ported yet: > 0 raises)
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
        self.tokens.append(token)
        self.out_q.put(("token", len(self.tokens) - 1, token))

    def _finish(self, reason: str):
        self.finish_reason = reason
        self.out_q.put(("done", reason))
        self.done.set()

    def _fail(self, msg: str):
        self.error = msg
        self.out_q.put(("error", msg))
        self.done.set()


class _Sequence:
    """A running request's decode state.

    `pos` is the number of tokens in the KV cache (= prompt + generated
    - 1 in steady state: the newest token rides as the next dispatch's
    input). `prefilled` is the chunked-prefill frontier (it starts at
    the prefix-cache hit length)."""

    __slots__ = ("req", "pages", "pos", "prefilled")

    def __init__(self, req: Request, pages: List[int], pos: int,
                 cached: int = 0):
        self.req = req
        self.pages = pages
        self.pos = pos  # tokens already written to the KV cache
        self.prefilled = pos or cached

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
    """

    def __init__(self, model: str = "llama", model_cfg=None, params=None,
                 engine_config: Optional[EngineConfig] = None,
                 seed: int = 0, device=None):
        if model == "llama":
            from ray_tpu_torch.models import llama as mod
            self.model_cfg = model_cfg or mod.LlamaConfig.tiny(
                dtype=torch.float32)
            n_kv_head = self.model_cfg.n_kv_head
            head_dim = self.model_cfg.head_dim
            net_cls = mod.Llama
        elif model == "gpt":
            from ray_tpu_torch.models import gpt as mod
            self.model_cfg = model_cfg or mod.GPTConfig.tiny(
                dtype=torch.float32)
            n_kv_head = self.model_cfg.n_head
            head_dim = self.model_cfg.d_model // self.model_cfg.n_head
            net_cls = mod.GPT
        else:
            raise ValueError(f"unknown model family {model!r}")
        self.device = resolve_device(device)
        self.model_name = model
        self._mod = mod
        cfg = (engine_config or EngineConfig()).resolved(
            self.model_cfg.max_seq_len)
        if cfg.spec_k > 0:
            raise NotImplementedError(
                "speculative decoding (spec_k > 0) is not ported yet")
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

        self.kv = PagedKVCache(
            cfg.num_pages, self.model_cfg.n_layer, cfg.block_size,
            n_kv_head, head_dim, dtype=self.model_cfg.dtype,
            device=self.device)
        self.prefix = PrefixCache(self.kv) if cfg.prefix_cache else None
        # one chunk width (B=1, C=_chunk_size) covers both chunked
        # prefill windows and prefix-cache-hit suffixes
        self._chunk_size = cfg.prefill_chunk or max(cfg.prefill_buckets)

        self._waiting: List[Request] = []
        self._prefilling: List[_Sequence] = []
        self._running: List[_Sequence] = []
        self._lock = threading.Lock()       # guards queues + counters
        self._step_lock = threading.Lock()  # serializes step()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.counters: Dict[str, float] = {
            "requests_submitted": 0, "requests_completed": 0,
            "requests_timed_out": 0,
            "tokens_generated": 0, "prefill_steps": 0,
            "decode_steps": 0, "prefill_ms": 0.0, "decode_ms": 0.0,
            "chunk_steps": 0,
        }
        # per-(kind, bucket) step-function calls
        self.bucket_calls: Dict[Tuple[str, int], int] = {}
        # per-tenant rows: shed decisions and throughput per job label
        self.tenant_counters: Dict[str, Dict[str, float]] = {}

    # -- step functions ---------------------------------------------------

    def _ints(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.long).to(self.device)

    def _prefill(self, tokens, true_len):
        return self._mod.prefill_step(self.net, self.model_cfg,
                                      self._ints(tokens),
                                      self._ints(true_len))

    def _decode(self, tokens, positions, page_table):
        return self._mod.decode_step(
            self.net, self.model_cfg, self._ints(tokens),
            self._ints(positions), self.kv.k_pages, self.kv.v_pages,
            self._ints(page_table))

    def _chunk(self, tokens, start, page_table):
        return self._mod.chunk_step(
            self.net, self.model_cfg, self._ints(tokens),
            self._ints(start), self.kv.k_pages, self.kv.v_pages,
            self._ints(page_table))

    def _note_call(self, kind: str, bucket: int):
        """Per-(kind, bucket) dispatch counter."""
        with self._lock:
            key = (kind, bucket)
            self.bucket_calls[key] = self.bucket_calls.get(key, 0) + 1

    def warmup(self):
        """Run every bucket once up front (first-use costs: the kernel
        build, library handles, allocator growth)."""
        zeros_table = [[0] * self.max_pages_per_seq]
        with torch.inference_mode():
            for s in self.config.prefill_buckets:
                self._prefill([[0] * s], [1])
            for b in self.config.batch_buckets:
                self._decode([0] * b, [0] * b, zeros_table * b)
            self._chunk([[0] * self._chunk_size], [0], zeros_table)

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
                tokens_out += self._decode_once()
                decode_ms += (time.perf_counter() - t1) * 1e3
            did = bool(tokens_out) or advanced
            if did:
                with self._lock:
                    self.counters["prefill_ms"] += prefill_ms
                    self.counters["decode_ms"] += decode_ms
                    self.counters["tokens_generated"] += tokens_out
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
            self._waiting.pop(0)
            seq = _Sequence(req, pages, pos=0, cached=cached)
            self._prefilling.append(seq)
        return seq

    # -- prefill (one-shot bucket / chunked / prefix-cache suffix) --------

    def _advance_prefill(self) -> int:
        """Advance the oldest in-flight prefill by one unit of work: a
        one-shot bucket prefill when the whole prompt fits, otherwise one
        chunk. Returns tokens emitted (1 exactly when prefill
        completes)."""
        seq = self._prefilling[0]
        req = seq.req
        s = len(req.prompt)
        emitted = 0
        if seq.prefilled < s:
            oneshot = (seq.prefilled == 0
                       and s <= max(self.config.prefill_buckets)
                       and (not self.config.prefill_chunk
                            or s <= self._chunk_size))
            if oneshot:
                emitted = self._prefill_oneshot(seq)
            else:
                emitted = self._chunk_advance(seq)
        if seq.prefilled >= s or seq.req.done.is_set():
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
        toks = [req.prompt + [0] * (bucket - s)]
        self._note_call("prefill", bucket)
        next_logits, k, v = self._prefill(toks, [s])
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
        with self._lock:
            if seq in self._running:
                self._running.remove(seq)
            self.counters["requests_completed"] += 1
            row = self._tenant_row(seq.req.tenant)
            row["requests_completed"] += 1
            row["tokens_generated"] += len(seq.req.tokens)
        seq.req._finish(seq.req.finish_reason or "length")

    # -- pump thread ------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._pump, name="llm-engine", daemon=True)
        self._thread.start()

    def _pump(self):
        while not self._stop.is_set():
            if not self.step():
                self._work.clear()
                self._work.wait(0.02)

    def stop(self):
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

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

    def shutdown(self) -> int:
        """Stop the pump and drop the KV arena; returns leaked pages
        (0 after a clean quiesce). Waiting requests are failed."""
        self.stop()
        with self._lock:
            waiting, self._waiting = self._waiting, []
        for req in waiting:
            req._fail("engine shut down")
        if self.prefix is not None:
            # cached prefixes are reusable state, not leaks: release
            # them so close() reports only true sequence leaks
            self.prefix.drain()
        return self.kv.close()

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
                bucket_calls={
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
        return out
