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

Not ported yet: the native dispatch-ring intake, the request recorder /
tracing / step-profiler / health-probe hooks with the `/metrics` text,
and the shared-memory arena (`store=`).
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
            "chunk_steps": 0, "spec_rounds": 0, "spec_proposed": 0,
            "spec_accepted": 0,
        }
        # per-(kind, bucket) step-function calls
        self.bucket_calls: Dict[Tuple[str, int], int] = {}
        # per-tenant rows: shed decisions and throughput per job label
        self.tenant_counters: Dict[str, Dict[str, float]] = {}

    def _arena(self, model_cfg, num_pages: int) -> PagedKVCache:
        kvh = getattr(model_cfg, "n_kv_head", model_cfg.n_head)
        return PagedKVCache(
            num_pages, model_cfg.n_layer, self.config.block_size, kvh,
            model_cfg.d_model // model_cfg.n_head, dtype=model_cfg.dtype,
            device=self.device)

    # -- step functions ---------------------------------------------------
    # `draft=True` runs the draft model on its own arena; the verify
    # window is the target's `_chunk` at width K+1.

    def _ints(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.long).to(self.device)

    def _model(self, draft: bool):
        if draft:
            return self.d_net, self.draft_cfg, self.kv_d
        return self.net, self.model_cfg, self.kv

    def _prefill(self, tokens, true_len, draft: bool = False):
        net, cfg, _ = self._model(draft)
        return self._mod.prefill_step(net, cfg, self._ints(tokens),
                                      self._ints(true_len))

    def _decode(self, tokens, positions, page_table, draft: bool = False):
        net, cfg, kv = self._model(draft)
        return self._mod.decode_step(
            net, cfg, self._ints(tokens), self._ints(positions),
            kv.k_pages, kv.v_pages, self._ints(page_table))

    def _chunk(self, tokens, start, page_table, draft: bool = False):
        net, cfg, kv = self._model(draft)
        return self._mod.chunk_step(
            net, cfg, self._ints(tokens), self._ints(start), kv.k_pages,
            kv.v_pages, self._ints(page_table))

    def _note_call(self, kind: str, bucket: int):
        """Per-(kind, bucket) dispatch counter."""
        with self._lock:
            key = (kind, bucket)
            self.bucket_calls[key] = self.bucket_calls.get(key, 0) + 1

    def warmup(self):
        """Run every bucket once up front (first-use costs: the kernel
        build, library handles, allocator growth): the draft's buckets
        and the verify window too when speculation is on."""
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
                    self._chunk([[0] * k1] * b, [0] * b,
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
                if self.kv_d is not None:
                    tokens_out += self._spec_decode_once()
                else:
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
            oneshot = (seq.prefilled == 0
                       and s <= max(self.config.prefill_buckets)
                       and (not self.config.prefill_chunk
                            or s <= self._chunk_size))
            if oneshot:
                emitted = self._prefill_oneshot(seq)
            else:
                emitted = self._chunk_advance(seq)
        elif self.kv_d is not None and seq.d_prefilled < s:
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
        logits, new_k, new_v = self._chunk(
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
        if self.kv_d is not None:
            self.kv_d.assert_quiesced()

    def shutdown(self) -> int:
        """Stop the pump and drop the KV arenas (the draft's too);
        returns leaked pages of both (0 after a clean quiesce). Waiting
        requests are failed."""
        self.stop()
        with self._lock:
            waiting, self._waiting = self._waiting, []
        for req in waiting:
            req._fail("engine shut down")
        if self.prefix is not None:
            # cached prefixes are reusable state, not leaks: release
            # them so close() reports only true sequence leaks
            self.prefix.drain()
        leaked = self.kv_d.close() if self.kv_d is not None else 0
        return leaked + self.kv.close()

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
        if out["spec_rounds"]:
            # accepted draft tokens per round, over all lanes (as the JAX
            # engine reports it)
            out["spec_mean_accept"] = (out["spec_accepted"]
                                       / out["spec_rounds"])
        return out
