"""Worker process entrypoint.

Reference: `python/ray/_private/workers/default_worker.py` — spawned by the
raylet's WorkerPool; connects a CoreWorker to its raylet + GCS, registers,
then blocks in the task-execution loop.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys

from ray_tpu_torch._private.config import SESSION_ROOT


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-addr", required=True)
    parser.add_argument("--gcs-addr", required=True)
    parser.add_argument("--store-name", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--job-id", required=True)
    parser.add_argument("--gpu-ids", default="")
    parser.add_argument("--runtime-env", default="")
    parser.add_argument("--session-dir", default=SESSION_ROOT)
    args = parser.parse_args()

    logging.basicConfig(
        level=logging.INFO,
        format=f"[worker {os.getpid()}] %(levelname)s %(name)s: %(message)s",
    )

    # The raylet's device assignment is CUDA_VISIBLE_DEVICES in this
    # process's environment, which CUDA reads when it first initialises:
    # nothing to apply here (the JAX worker re-applies JAX_PLATFORMS).

    from ray_tpu_torch._private import fault_injection as _fi
    from ray_tpu_torch._private.core_worker import CoreWorker
    from ray_tpu_torch._private.ids import JobID
    from ray_tpu_torch._private.object_store import ObjectStore

    _fi.set_role("worker")  # arm worker-scoped timed faults
    gpus = tuple(int(c) for c in args.gpu_ids.split(",") if c != "")
    store = ObjectStore.attach(args.store_name)
    cw = CoreWorker(
        mode="worker",
        gcs_addr=args.gcs_addr,
        raylet_addr=args.raylet_addr,
        job_id=JobID.from_hex(args.job_id),
        store=store,
        node_id_hex=args.node_id,
        gpu_ids=gpus,
    )
    cw.start()

    env_wire = None
    if args.runtime_env:
        import json

        from ray_tpu_torch._private import runtime_env as renv_mod

        env_wire = json.loads(args.runtime_env)
        # download + extract packages, apply cwd/sys.path before any
        # task runs (env_vars were applied by the raylet at spawn)
        renv_mod.materialize(
            cw, env_wire,
            os.path.join(args.session_dir, "runtime_envs"))
        # Running from a cached pip venv: pin it against LRU eviction
        # with THIS worker's pid — the pin dies with the pool, unlike a
        # raylet-pid marker which would pin every env forever.
        import sys as _sys

        if env_wire.get("pip") and _sys.prefix.startswith(
                renv_mod.pip_env_cache_root()):
            renv_mod.mark_pip_env_in_use(_sys.prefix)
        # introspectable via ray_tpu_torch.get_runtime_context()
        cw.current_runtime_env = env_wire

    async def register():
        from ray_tpu_torch._private import runtime_env as renv_mod

        raylet = await cw._clients.get(args.raylet_addr)
        await raylet.call("register_worker", {
            "worker_id": cw.worker_id.binary(),
            "addr": cw.address,
            "pid": os.getpid(),
            "job_id": cw.job_id.binary(),
            "gpu_ids": list(gpus),
            "runtime_env_hash": renv_mod.env_hash(env_wire),
        })

    cw._run_sync(register())

    async def raylet_watchdog():
        # Exit if the raylet disappears (reference: workers die with their
        # raylet via the unix-socket connection; here we poll).
        from ray_tpu_torch._private.rpc import ConnectionLost, RpcError

        while True:
            await asyncio.sleep(2.0)
            try:
                raylet = await cw._clients.get(args.raylet_addr)
                await raylet.call("node_info", {}, timeout=5.0)
            except (ConnectionLost, RpcError, OSError, asyncio.TimeoutError):
                logging.warning("raylet unreachable; worker exiting")
                os._exit(1)

    asyncio.run_coroutine_threadsafe(raylet_watchdog(), cw._loop)
    try:
        cw.run_task_loop()
    except KeyboardInterrupt:
        pass
    finally:
        cw.shutdown()
        sys.exit(0)


if __name__ == "__main__":
    main()
