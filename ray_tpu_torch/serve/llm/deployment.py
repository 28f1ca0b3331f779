"""serve.llm.LLMDeployment — an LLMEngine behind the Serve stack.

Each replica hosts one engine (pump thread + paged KV arena) and
streams tokens over the existing `handle_request_streaming` path:

    app = serve.llm.build_app(name="llm", num_replicas=2)
    handle = serve.run(app)
    for tok in handle.generate.options(stream=True).remote([1, 2, 3], 8):
        ...

The replica exports `get_autoscaling_metrics` so the controller's poll
sees queue depth + KV-page occupancy (autoscaling pressure) and the KV
arena id (dead-replica reclaim); the engine's own counters join the
node's /metrics scrape via the registry callback it registers.

The port's copy of `ray_tpu/serve/llm/deployment.py`. The deployment
takes `device=` (default ``"cuda"``: a replica that sees no GPU raises
in `__init__`, it never serves on the CPU unasked), and `build_app`
gives a CUDA deployment's replicas one GPU each (`num_gpus=1`), held
from spawn to death. `model_config` dicts keep the JAX meaning; a dtype
may be named (``"bfloat16"``). `params` (the port's param dict) serves
given weights instead of drawing them from `seed`.
`max_request_tokens` tells the controller, at deploy time, the longest
prompt the model accepts (its `max_seq_len`), so that the native
ring's request slots are sized from the model.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# the `max_seq_len` of the config a replica builds, known here without
# importing torch (the controller calls `LLMDeployment.max_request_tokens`
# and never imports torch): each family's default (`GPTConfig`,
# `LlamaConfig`), and that of the tiny config the engine builds when no
# `model_config` is given
DEFAULT_MAX_SEQ_LEN = {"gpt": 1024, "llama": 2048}
TINY_MAX_SEQ_LEN = 128


def _config(cls, fields: Dict[str, Any]):
    """`cls(**fields)` with dtype fields given by name resolved."""
    import torch

    fields = dict(fields)
    for key in ("dtype", "param_dtype"):
        if isinstance(fields.get(key), str):
            fields[key] = getattr(torch, fields[key])
    return cls(**fields)


class LLMDeployment:
    """Deployment callable: one continuous-batching engine per replica.

    `model` is the family ("llama" | "gpt"); `model_config` /
    `engine_config` are plain dicts so deployments stay picklable
    (resolved into the real config dataclasses replica-side). `seed`
    fixes the weight init — replicas of one deployment must agree so
    greedy streams are replayable across a replica death.
    """

    def __init__(self, model: str = "llama",
                 model_config: Optional[Dict[str, Any]] = None,
                 engine_config: Optional[Dict[str, Any]] = None,
                 draft_config: Optional[Dict[str, Any]] = None,
                 seed: int = 0, device: str = "cuda",
                 params: Optional[Dict[str, Any]] = None):
        from ray_tpu_torch.serve.llm.engine import EngineConfig, LLMEngine

        model_cfg = None
        draft_cfg = None
        if model == "llama":
            from ray_tpu_torch.models.llama import LlamaConfig as _Cfg
        else:
            from ray_tpu_torch.models.gpt import GPTConfig as _Cfg
        if model_config:
            model_cfg = _config(_Cfg, model_config)
        if draft_config:
            # a small same-family draft for speculative decoding (its
            # weights init replica-side from `seed`, like the target's,
            # so every replica drafts identically — the replay
            # determinism contract extends to speculation); without
            # this, spec_k > 0 self-drafts with the target weights
            draft_cfg = _config(_Cfg, draft_config)
        store = self._node_store()
        self.engine = LLMEngine(
            model=model, model_cfg=model_cfg, params=params,
            engine_config=EngineConfig(**(engine_config or {})),
            store=store, seed=seed, draft_cfg=draft_cfg, device=device)
        self.engine.warmup()
        self.engine.start()

    @staticmethod
    def _node_store():
        """The worker's shm store attachment, so the KV arena is
        published on the object plane (None outside a cluster)."""
        try:
            from ray_tpu_torch._private.object_ref import get_core_worker
            cw = get_core_worker()
            return cw.store if cw is not None else None
        except Exception:
            return None

    @staticmethod
    def max_request_tokens(init_args: tuple,
                           init_kwargs: Dict[str, Any]) -> int:
        """The longest prompt a replica built from these arguments
        accepts: its model's `max_seq_len` (the controller sizes the
        dispatch ring's request slots from it before any replica
        runs)."""
        import inspect

        bound = inspect.signature(LLMDeployment.__init__).bind(
            None, *init_args, **init_kwargs)
        bound.apply_defaults()
        cfg = bound.arguments["model_config"]
        if not cfg:
            return TINY_MAX_SEQ_LEN
        family = "llama" if bound.arguments["model"] == "llama" else "gpt"
        return int(cfg.get("max_seq_len", DEFAULT_MAX_SEQ_LEN[family]))

    # -- request path -----------------------------------------------------

    def generate(self, prompt: List[int], max_new_tokens: int = 16,
                 timeout_s: Optional[float] = None):
        """Generator: yields {"index", "token"} per generated token.
        Streamed to the caller chunk-by-chunk via
        `handle.generate.options(stream=True)`."""
        req = self.engine.submit([int(t) for t in prompt],
                                 int(max_new_tokens),
                                 timeout_s=timeout_s)
        emitted = 0
        while True:
            kind, *rest = req.out_q.get(timeout=120.0)
            if kind == "token":
                yield {"index": rest[0], "token": rest[1]}
                emitted += 1
            elif kind == "done":
                return
            else:
                raise RuntimeError(f"generation failed: {rest[0]}")

    def generate_once(self, prompt: List[int],
                      max_new_tokens: int = 16) -> List[int]:
        """Unary variant: the full generated token list in one reply."""
        req = self.engine.submit([int(t) for t in prompt],
                                 int(max_new_tokens))
        return req.result(timeout=120.0)

    # -- control plane ----------------------------------------------------

    def get_autoscaling_metrics(self) -> Dict[str, Any]:
        m = self.engine.metrics()
        out = {
            "queue_depth": float(m["queue_depth"]),
            "llm_running": float(m["running"]),
            "kv_pages_live": float(m["kv_pages_live"]),
            "kv_pages_cached": float(m.get("kv_pages_cached", 0)),
            "kv_pages_total": float(m["kv_pages_total"]),
            "kv_arena_id": m["kv_arena_id"],
        }
        # perf-plane rollups for the dashboard /api/serve_llm panel:
        # prefix-cache hit rate and mean speculative accept length
        hit = m.get("prefix_cache_hit_tokens")
        if hit is not None:
            total = hit + m.get("prefix_cache_miss_tokens", 0)
            out["prefix_cache_hit_rate"] = hit / total if total else 0.0
            out["prefix_cache_entries"] = float(
                m.get("prefix_cache_entries", 0))
        if m.get("spec_k"):
            out["spec_k"] = float(m["spec_k"])
            out["spec_mean_accept"] = float(m.get("spec_mean_accept", 0.0))
        return out

    def engine_metrics(self) -> Dict[str, Any]:
        return self.engine.metrics()

    def kernel_launches(self, reset: bool = False) -> Dict[str, int]:
        """This replica's kernel launch counts (`ops.LAUNCH_COUNTERS`,
        graph replays credited with their capture's launches); with
        `reset`, each is set to 0 after it is read."""
        from ray_tpu_torch.ops import LAUNCH_COUNTERS

        out = {fn.__name__: fn.launches for fn in LAUNCH_COUNTERS}
        if reset:
            for fn in LAUNCH_COUNTERS:
                fn.launches = 0
        return out

    def check_health(self) -> bool:
        return self.engine._thread is not None and \
            self.engine._thread.is_alive()

    def __del__(self):
        try:
            self.engine.shutdown()
        except Exception:
            pass


def build_app(name: str = "llm", num_replicas: int = 1,
              autoscaling_config: Optional[Dict[str, Any]] = None,
              ray_actor_options: Optional[Dict[str, Any]] = None,
              **init_kwargs):
    """Bind LLMDeployment into a deployable app:
    `serve.run(serve.llm.build_app(...))`. A CUDA deployment (the
    default `device`) asks one GPU per replica unless
    `ray_actor_options` says otherwise."""
    from ray_tpu_torch import serve

    if ray_actor_options is None and \
            str(init_kwargs.get("device", "cuda")).startswith("cuda"):
        ray_actor_options = {"num_gpus": 1}
    deco = serve.deployment(
        name=name,
        num_replicas=None if autoscaling_config else num_replicas,
        autoscaling_config=autoscaling_config,
        ray_actor_options=ray_actor_options)
    return deco(LLMDeployment).bind(**init_kwargs)
