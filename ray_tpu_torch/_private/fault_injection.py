"""Deterministic fault-injection plane (the chaos plane).

Failure handling must be *provable*, not incidental: instead of ad-hoc
SIGKILLs scattered through tests, a seeded `FaultPlan` drives named
injection points threaded through the layers where faults actually land —

  * ``rpc.send`` / ``rpc.recv``   — ClientPool frame loss, delay,
    duplication (`rpc.py` RpcClient)
  * ``gcs.heartbeat``             — delayed / swallowed heartbeat handling
  * ``gcs.health``                — stalled health-check cycles
  * ``raylet.spawn``              — worker spawn failures (first k spawns
    raise a non-RuntimeEnvSetupError, exercising the crash-loop breaker)
  * ``raylet.lease``              — delayed lease dispatch
  * ``raylet.kill_node``          — abrupt node death after N heartbeats
  * ``core_worker.pull``          — delayed object pulls
  * ``train.pre_commit``          — kill a train rank in the window between
    its own shard persist and the gang checkpoint commit

Activation: the ``RAY_TPU_CHAOS`` env var, parsed once per process at
import (each daemon is its own process and reads its own env — a test can
scope a fault to one node by setting the var only around that node's
spawn), or programmatically via :func:`install`. With no plan active every
injection point is a single ``_PLAN is not None`` global check — the
module global stays ``None`` and the hot paths (``RpcClient.call_nowait``,
lease dispatch) pay one attribute load.

Determinism: every probabilistic site draws from its OWN
``random.Random`` stream seeded by ``(seed, site)``, so the decision
sequence at a site depends only on the seed and that site's draw count —
never on how sites interleave across the event loop. The decisions are
recorded in :attr:`FaultPlan.schedule` (capped), so the same seed replays
the identical fault schedule and any chaos failure reproduces exactly.

Reference ground: the reference's chaos utilities
(`python/ray/_private/test_utils.py` WorkerKillerActor,
`python/ray/tests/test_chaos.py`) are cadence-based and unseeded; this
plane makes the schedule a first-class, replayable artifact.

Grammar (``;``-separated ``key=value`` pairs)::

    RAY_TPU_CHAOS="seed=7;rpc_drop=0.05;rpc_delay=0.2:0.01;rpc_dup=0.1;
                   rpc_match=heartbeat|pull_object;
                   heartbeat_delay=0.5;heartbeat_drop=0.2;health_delay=0.1;
                   spawn_fail=2;lease_delay=0.5:0.02;pull_delay=0.3:0.01;
                   kill_node=heartbeats:6;commit_kill=1:1"

  - probabilities are plain floats in [0, 1]
  - delay values are ``p:seconds`` (probability p, fixed delay) or bare
    ``seconds`` (always)
  - ``rpc_match`` scopes every rpc_* fault to methods containing any of
    the ``|``-separated substrings (default: all methods)
  - ``spawn_fail=k`` fails the first k worker spawns of the process
  - ``kill_node=heartbeats:N`` makes the raylet ``os._exit(1)`` after its
    N-th successful heartbeat
  - ``commit_kill=rank:index`` kills a train worker whose session has no
    restore checkpoint (i.e. the first attempt) right after it persisted
    its shard for report ``index`` — inside the gang-commit window

Timed schedule (wall-clock faults, PR 8): ``at=`` entries layer faults
that fire at seeded wall-clock *offsets* instead of draw counts — the
injection trigger a multi-hour soak needs (a preemption lands at minute
37, not at heartbeat #6). Grammar::

    at=<offset_s>:<fault>[:<arg>][@<role>]

repeatable (``at=…;at=…``) or ``|``-separated inside one value. Faults:

  - ``kill``              — ``os._exit(1)`` at the offset (abrupt death)
  - ``crash_loop:<k>``    — re-arm ``spawn_fail`` for the next k spawns
  - ``hb_brownout:<dur>`` — drop every GCS heartbeat for ``dur`` seconds
  - ``data_stall:<dur>``  — data-plane block reads stall for ``dur`` s
  - ``ckpt_fail[:<n>]``   — next n checkpoint persists raise ChaosError
  - ``drop_objects[:<frac>]`` — force-delete a seeded random `frac`
    (default 0.5) of this node's sealed shm objects WITHOUT killing the
    process — object loss decoupled from node loss (exercises lineage
    reconstruction while the raylet keeps serving)

``@role`` scopes the entry to processes of that role (``driver``,
``gcs``, ``raylet``, ``worker``, ``train`` — the last arms at train
SESSION init, so it targets actual train ranks rather than idle task
workers); unscoped entries arm in any process. Entries arm when
:func:`set_role` (called by each daemon's ``__main__``) or
:meth:`FaultPlan.arm_timed` runs. Offsets are anchored to the
``RAY_TPU_CHAOS_EPOCH`` wall-clock timestamp when that env var is set
(``at=37`` means 37 s into the SOAK regardless of when a restarted
attempt re-arms the plan; entries whose fire time already passed at arm
are recorded as expired and skipped); without the epoch, offsets run
from arm time. ``RAY_TPU_CHAOS_EPOCH=@<path>`` names a file that will
hold the timestamp: armed entries wait until it exists. The soak driver
exports that form and writes the file at the gang's first report, so a
fault never lands inside the workers' start-up, however long it takes.
A daemon timer thread sleeps to each offset and fires it; state flips
happen under ``_timed_lock`` but the fire itself (record / export /
exit) runs OUTSIDE the lock — raylint's blocking-under-lock checker
flags the inverted shape. When ``RAY_TPU_CHAOS_LOG`` is set, each timed
entry is gated by a once-sentinel file in that directory so a fault
fires exactly once per soak run even though restarted attempts re-read
the same plan from the environment and re-arm it.

Post-mortem export: with ``RAY_TPU_CHAOS_LOG=<dir>`` every process
dumps its replay artifact (spec, seed, the ``(site, draw_seq,
decision)`` schedule, timed entries + actual fire timestamps) to
``chaos-<role>-<pid>.json`` at exit — including synchronously before
every ``os._exit`` path, which ``atexit`` would miss.
:meth:`FaultPlan.from_artifact` rebuilds the identical plan from an
artifact, so any soak failure replays exactly.
"""

from __future__ import annotations

import asyncio
import atexit
import json
import logging
import os
import random
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

logger = logging.getLogger(__name__)

ENV_VAR = "RAY_TPU_CHAOS"
LOG_ENV = "RAY_TPU_CHAOS_LOG"
EPOCH_ENV = "RAY_TPU_CHAOS_EPOCH"
_LOG_CAP = 8192
# an entry armed after its anchored fire time fires anyway if it is at
# most this late (timer scheduling slop); later than this it expires
_ARM_GRACE_S = 1.0

_TIMED_FAULTS = ("kill", "crash_loop", "hb_brownout", "data_stall",
                 "ckpt_fail", "quota_flood", "drop_objects")
_ROLES = ("driver", "gcs", "raylet", "worker", "train")


def _epoch_base(now: float) -> Optional[float]:
    """The wall-clock base of timed offsets: RAY_TPU_CHAOS_EPOCH's
    timestamp, or the one its `@<path>` file holds (None while the file
    does not exist yet); `now` without the variable."""
    epoch = os.environ.get(EPOCH_ENV, "")
    if not epoch:
        return now
    if epoch.startswith("@"):
        try:
            with open(epoch[1:]) as f:
                return float(f.read())
        except (OSError, ValueError):
            return None
    try:
        return float(epoch)
    except ValueError:
        return now


class TimedFault(NamedTuple):
    """One wall-clock-scheduled fault: fires `offset` seconds after the
    plan is armed in a process whose role matches (None = any)."""
    offset: float
    fault: str
    arg: float
    role: Optional[str]


class ChaosError(RuntimeError):
    """An injected fault (deliberately NOT a RuntimeEnvSetupError: spawn
    chaos must exercise the generic spawn-failure path, including the
    crash-loop breaker's non-deterministic-exception counting)."""


def _parse_prob(value: str, key: str) -> float:
    p = float(value)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"{key}: probability {p} outside [0, 1]")
    return p


def _parse_delay(value: str, key: str) -> Tuple[float, float]:
    """'p:seconds' or bare 'seconds' (p=1)."""
    if ":" in value:
        p_str, s_str = value.split(":", 1)
        return _parse_prob(p_str, key), float(s_str)
    return 1.0, float(value)


def _parse_timed(value: str) -> List[TimedFault]:
    """Parse one ``at=`` value: ``|``-separated
    ``<offset>:<fault>[:<arg>][@<role>]`` entries."""
    out: List[TimedFault] = []
    for entry in filter(None, (e.strip() for e in value.split("|"))):
        role: Optional[str] = None
        body = entry
        if "@" in entry:
            body, role = entry.rsplit("@", 1)
            if role not in _ROLES:
                raise ValueError(
                    f"at: unknown role {role!r} (supported: {_ROLES})")
        parts = body.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"at: entry {entry!r} is not <offset>:<fault>[:<arg>]")
        offset = float(parts[0])
        fault = parts[1]
        if fault not in _TIMED_FAULTS:
            raise ValueError(f"at: unknown fault {fault!r} "
                             f"(supported: {_TIMED_FAULTS})")
        if fault == "kill":
            if len(parts) > 2:
                raise ValueError("at: kill takes no argument")
            arg = 0.0
        elif fault == "ckpt_fail":
            arg = float(parts[2]) if len(parts) > 2 else 1.0
        elif fault == "quota_flood":
            # window seconds; the flood hammers the registered target
            # (object-store puts) for the whole window
            arg = float(parts[2]) if len(parts) > 2 else 5.0
        elif fault == "drop_objects":
            # fraction of the node's sealed objects to force-delete
            arg = float(parts[2]) if len(parts) > 2 else 0.5
            if not 0.0 < arg <= 1.0:
                raise ValueError(
                    f"at: drop_objects fraction {arg} outside (0, 1]")
        else:  # crash_loop / hb_brownout / data_stall need an argument
            if len(parts) < 3:
                raise ValueError(f"at: {fault} requires an argument")
            arg = float(parts[2])
        out.append(TimedFault(offset, fault, arg, role))
    return out


class FaultPlan:
    """A parsed, seeded fault schedule. Immutable configuration +
    per-site deterministic RNG streams and draw counters."""

    def __init__(self, spec: str = ""):
        self.spec = spec
        self.seed = 0
        self.rpc_drop = 0.0
        self.rpc_dup = 0.0
        self.rpc_delay: Tuple[float, float] = (0.0, 0.0)
        self.rpc_recv_drop = 0.0
        self.rpc_recv_delay: Tuple[float, float] = (0.0, 0.0)
        self.rpc_match: Optional[Tuple[str, ...]] = None
        self.heartbeat_delay = 0.0
        self.heartbeat_drop = 0.0
        self.health_delay = 0.0
        self.spawn_fail = 0
        self.lease_delay: Tuple[float, float] = (0.0, 0.0)
        self.pull_delay: Tuple[float, float] = (0.0, 0.0)
        self.kill_node: Optional[Tuple[str, int]] = None
        self.commit_kill: Optional[Tuple[int, int]] = None
        self.timed: List[TimedFault] = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            if "=" not in part:
                raise ValueError(f"chaos spec entry {part!r} is not key=value")
            key, value = part.split("=", 1)
            key, value = key.strip(), value.strip()
            if key == "seed":
                self.seed = int(value)
            elif key == "rpc_drop":
                self.rpc_drop = _parse_prob(value, key)
            elif key == "rpc_dup":
                self.rpc_dup = _parse_prob(value, key)
            elif key == "rpc_delay":
                self.rpc_delay = _parse_delay(value, key)
            elif key == "rpc_recv_drop":
                self.rpc_recv_drop = _parse_prob(value, key)
            elif key == "rpc_recv_delay":
                self.rpc_recv_delay = _parse_delay(value, key)
            elif key == "rpc_match":
                self.rpc_match = tuple(
                    m for m in value.split("|") if m) or None
            elif key == "heartbeat_delay":
                self.heartbeat_delay = float(value)
            elif key == "heartbeat_drop":
                self.heartbeat_drop = _parse_prob(value, key)
            elif key == "health_delay":
                self.health_delay = float(value)
            elif key == "spawn_fail":
                self.spawn_fail = int(value)
            elif key == "lease_delay":
                self.lease_delay = _parse_delay(value, key)
            elif key == "pull_delay":
                self.pull_delay = _parse_delay(value, key)
            elif key == "kill_node":
                if ":" in value:
                    unit, n = value.split(":", 1)
                else:
                    unit, n = "heartbeats", value
                if unit != "heartbeats":
                    raise ValueError(
                        f"kill_node: unknown trigger {unit!r} "
                        f"(supported: heartbeats:N)")
                self.kill_node = (unit, int(n))
            elif key == "commit_kill":
                rank, index = value.split(":", 1)
                self.commit_kill = (int(rank), int(index))
            elif key == "at":
                self.timed.extend(_parse_timed(value))
            else:
                raise ValueError(f"unknown chaos key {key!r}")
        self._send_active = (self.rpc_drop > 0 or self.rpc_dup > 0
                             or self.rpc_delay[0] > 0)
        self._recv_active = (self.rpc_recv_drop > 0
                             or self.rpc_recv_delay[0] > 0)
        self._rngs: Dict[str, random.Random] = {}
        self._counts: Dict[str, int] = {}
        # the replayable artifact: (site, draw_seq, decision)
        self.schedule: List[Tuple[str, int, str]] = []
        self._spawn_attempts = 0
        self._heartbeats_sent = 0
        # -- timed-schedule state (guarded by _timed_lock where noted) --
        self.installed_ts = time.time()
        self.timed_fired: List[Dict[str, Any]] = []
        self._timed_lock = threading.Lock()
        self._timed_stop = threading.Event()
        self._armed: set = set()           # indices into self.timed
        self._brownout_until = 0.0         # wall ts; write under lock
        self._stall_until = 0.0            # wall ts; write under lock
        self._ckpt_fail_pending = 0        # write under lock
        self._flood_until = 0.0            # wall ts; write under lock

    # -- deterministic draw machinery -----------------------------------

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            # per-site stream: the decision sequence at one site is a pure
            # function of (seed, site, draw index) — event-loop interleaving
            # across sites cannot perturb it, which is what makes a chaos
            # failure replay exactly under the same seed
            rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def _record(self, site: str, decision: str) -> None:
        n = self._counts.get(site, 0)
        self._counts[site] = n + 1
        if len(self.schedule) < _LOG_CAP:
            self.schedule.append((site, n, decision))

    def _hit(self, site: str, p: float) -> bool:
        if p >= 1.0:
            return True
        return self._rng(site).random() < p

    def rng_for(self, site: str) -> random.Random:
        """Public per-site seeded stream for OTHER runtime randomness
        (scheduling tiebreaks, backoff jitter, …). Routing every
        probabilistic decision through a named site keeps the whole run
        a pure function of the seed — raylint's seeded-rng checker flags
        bare `random.*` in `_private/` for exactly this reason."""
        return self._rng(site)

    # -- rpc (ClientPool send/recv) -------------------------------------

    def _rpc_matches(self, method: str) -> bool:
        if self.rpc_match is None:
            return True
        return any(m in method for m in self.rpc_match)

    def rpc_send(self, method: str
                 ) -> Optional[Tuple[bool, bool, float]]:
        """(drop, dup, delay_s) for one outgoing frame, or None when no
        send faults apply to this method."""
        if not self._send_active or not self._rpc_matches(method):
            return None
        drop = self.rpc_drop > 0 and self._hit("rpc.send.drop", self.rpc_drop)
        dup = (not drop and self.rpc_dup > 0
               and self._hit("rpc.send.dup", self.rpc_dup))
        delay = 0.0
        dp, ds = self.rpc_delay
        if dp > 0 and self._hit("rpc.send.delay", dp):
            delay = ds
        if drop or dup or delay:
            self._record("rpc.send",
                         f"{method}:{'drop' if drop else ''}"
                         f"{'dup' if dup else ''}"
                         f"{f'delay={delay}' if delay else ''}")
            return (drop, dup, delay)
        return None

    def rpc_recv(self, method: str) -> Optional[Tuple[bool, float]]:
        """(drop, delay_s) for one incoming reply frame, or None."""
        if not self._recv_active or not self._rpc_matches(method):
            return None
        drop = (self.rpc_recv_drop > 0
                and self._hit("rpc.recv.drop", self.rpc_recv_drop))
        delay = 0.0
        dp, ds = self.rpc_recv_delay
        if dp > 0 and self._hit("rpc.recv.delay", dp):
            delay = ds
        if drop or delay:
            self._record("rpc.recv",
                         f"{method}:{'drop' if drop else ''}"
                         f"{f'delay={delay}' if delay else ''}")
            return (drop, delay)
        return None

    # -- gcs -------------------------------------------------------------

    async def gcs_heartbeat(self) -> bool:
        """Delay and/or swallow one heartbeat at the GCS handler. True
        means the heartbeat is dropped (handler must return without
        touching liveness state)."""
        if time.time() < self._brownout_until:
            self._record("gcs.heartbeat", "brownout-drop")
            return True
        if self.heartbeat_delay > 0:
            self._record("gcs.heartbeat", f"delay={self.heartbeat_delay}")
            await asyncio.sleep(self.heartbeat_delay)
        if self.heartbeat_drop > 0 and self._hit("gcs.heartbeat.drop",
                                                 self.heartbeat_drop):
            self._record("gcs.heartbeat", "drop")
            return True
        return False

    async def gcs_health_tick(self) -> None:
        """Stall one health-check cycle (models a wedged health checker:
        dead nodes detected late)."""
        if self.health_delay > 0:
            self._record("gcs.health", f"delay={self.health_delay}")
            await asyncio.sleep(self.health_delay)

    # -- raylet ----------------------------------------------------------

    def spawn_attempt(self) -> None:
        """Raise ChaosError for the first `spawn_fail` worker spawns of
        this raylet process."""
        # a timed crash_loop firing re-seeds spawn_fail/_spawn_attempts
        # from the schedule's timer thread — count under the same lock
        with self._timed_lock:
            if self.spawn_fail <= 0:
                return
            self._spawn_attempts += 1
            n, limit = self._spawn_attempts, self.spawn_fail
        if n <= limit:
            self._record("raylet.spawn", f"fail#{n}")
            raise ChaosError(
                f"chaos: injected worker spawn failure {n}/{limit}")

    async def lease_request(self) -> None:
        dp, ds = self.lease_delay
        if dp > 0 and self._hit("raylet.lease", dp):
            self._record("raylet.lease", f"delay={ds}")
            await asyncio.sleep(ds)

    def node_heartbeat_sent(self) -> None:
        """Abrupt node death: the raylet exits without any cleanup after
        its N-th successful heartbeat (models hardware loss — workers
        orphaned, arena left behind, GCS learns via missed heartbeats)."""
        if self.kill_node is None:
            return
        self._heartbeats_sent += 1
        if self._heartbeats_sent >= self.kill_node[1]:
            self._record("raylet.kill_node",
                         f"heartbeat#{self._heartbeats_sent}")
            logger.warning("chaos: killing node after %d heartbeats",
                           self._heartbeats_sent)
            self.export_artifact()  # atexit never runs past os._exit
            os._exit(1)

    # -- core worker -----------------------------------------------------

    async def object_pull(self) -> None:
        dp, ds = self.pull_delay
        if dp > 0 and self._hit("core_worker.pull", dp):
            self._record("core_worker.pull", f"delay={ds}")
            await asyncio.sleep(ds)

    # -- train session ---------------------------------------------------

    def train_pre_commit(self, world_rank: int, report_index: int,
                         fresh: bool) -> None:
        """Kill this rank between its own shard persist and the gang
        commit. Fires only on a session with no restore checkpoint
        (`fresh`), so the retried attempt survives the same plan."""
        if self.commit_kill is None or not fresh:
            return
        rank, index = self.commit_kill
        if world_rank == rank and report_index == index:
            self._record("train.pre_commit",
                         f"kill rank={rank} index={index}")
            logger.warning("chaos: killing rank %d before gang commit of "
                           "report %d", rank, index)
            self.export_artifact()  # atexit never runs past os._exit
            os._exit(1)

    def checkpoint_persist(self) -> None:
        """Raise ChaosError for the next `ckpt_fail` checkpoint persists
        (armed by the timed schedule). The failure propagates out of
        `report()` like a real storage fault, failing the attempt before
        the gang commit — the retry walks back to the last durable
        checkpoint."""
        fire = False
        with self._timed_lock:
            if self._ckpt_fail_pending > 0:
                self._ckpt_fail_pending -= 1
                fire = True
        if fire:
            self._record("train.ckpt_persist", "fail")
            raise ChaosError("chaos: injected checkpoint persist failure")

    # -- data plane ------------------------------------------------------

    def data_read_sync(self) -> None:
        """Synchronous data-source stall: block-read paths sleep out the
        remainder of an active `data_stall` window (models an ingest
        source brownout — object-store pulls stop completing)."""
        remaining = self._stall_until - time.time()
        if remaining > 0:
            self._record("data.read", f"stall={remaining:.3f}")
            time.sleep(remaining)

    # -- quota flood (multi-tenant overload containment) -----------------

    def flooding(self) -> bool:
        """True while a `quota_flood` window is active in this process."""
        return time.time() < self._flood_until

    def _quota_flood_run(self) -> None:
        """Hammer the registered flood target (an object-store put bound
        to this process's job — see set_quota_flood_target) for the
        window. The point is to PROVE containment: the offending job's
        puts get capped at its byte quota (rejections count up) while
        other jobs' objects and latency stay untouched."""
        puts = rejects = 0
        while not self._timed_stop.is_set() and \
                time.time() < self._flood_until:
            target = _FLOOD_TARGET
            if target is None:
                time.sleep(0.01)  # no store attached yet in this process
                continue
            try:
                target()
                puts += 1
            except Exception:  # noqa: BLE001 — QuotaExceeded/store full
                rejects += 1
            time.sleep(0.0005)  # hammer, but never a pure busy-spin
        self._record("timed.quota_flood.done",
                     f"puts={puts}:rejects={rejects}")

    # -- object loss (lineage recovery plane) ----------------------------

    def _drop_objects_run(self, frac: float) -> None:
        """Force-delete a seeded random `frac` of this node's sealed shm
        objects via the registered target (the raylet's store sweep —
        see set_drop_objects_target). The process survives: the point is
        object loss WITHOUT node loss, so lineage reconstruction gets
        exercised while leases, pulls and heartbeats keep flowing. The
        subset is drawn from the plan's own per-site stream, so the same
        seed always drops the same objects."""
        target = _DROP_TARGET
        if target is None:
            self._record("timed.drop_objects", "no-target")
            return
        try:
            dropped = target(frac, self.rng_for("timed.drop_objects"))
        except Exception:  # noqa: BLE001 — chaos must not kill the raylet
            logger.exception("chaos: drop_objects sweep failed")
            self._record("timed.drop_objects", "error")
            return
        self._record("timed.drop_objects", f"dropped={dropped}:frac={frac:g}")
        logger.warning("chaos: drop_objects force-deleted %d sealed objects "
                       "(frac=%g)", dropped, frac)

    # -- timed schedule (wall-clock offsets) -----------------------------

    def arm_timed(self, role: str) -> None:
        """Arm every not-yet-armed timed entry matching `role` (entries
        with no role match any process). Offsets are anchored to
        RAY_TPU_CHAOS_EPOCH when set (wall-clock soak time — a
        restarted attempt re-arming the plan keeps the original
        schedule; an `@<path>` epoch once its file exists), else to
        NOW. A daemon timer thread fires them.
        Idempotent per entry; entries already more than _ARM_GRACE_S
        past their anchored fire time expire instead of firing into the
        middle of a fresh attempt."""
        now = time.time()
        base = _epoch_base(now)
        due: List[Tuple[int, TimedFault]] = []
        with self._timed_lock:
            for i, tf in enumerate(self.timed):
                if i in self._armed:
                    continue
                if tf.role is not None and tf.role != role:
                    continue
                self._armed.add(i)
                due.append((i, tf))
        if base is not None:
            due = self._drop_expired(due, base, now)
        if not due:
            return
        thread = threading.Thread(
            target=self._timed_run, args=(due, base),
            daemon=True, name=f"chaos-timed-{role}")
        thread.start()

    def _drop_expired(self, due: List[Tuple[int, TimedFault]],
                      base: float, now: float
                      ) -> List[Tuple[int, TimedFault]]:
        """Record the entries more than _ARM_GRACE_S past their anchored
        fire time as expired; return the others."""
        kept = []
        for i, tf in due:
            if now - (base + tf.offset) > _ARM_GRACE_S:
                self._record(f"timed.{tf.fault}",
                             f"expired:t+{tf.offset:g}")
            else:
                kept.append((i, tf))
        return kept

    def _timed_run(self, due: List[Tuple[int, TimedFault]],
                   base: Optional[float]) -> None:
        """Timer loop: wait for the epoch file when the base is not
        known yet, then sleep to each anchored fire time and fire. All
        sleeping and firing happens OUTSIDE _timed_lock — only the
        state flip inside _fire_timed takes it."""
        while base is None:
            if self._timed_stop.wait(0.05):
                return
            now = time.time()
            base = _epoch_base(now)
            if base is not None:
                due = self._drop_expired(due, base, now)
        for _, tf in sorted(due, key=lambda d: d[1].offset):
            while not self._timed_stop.is_set():
                remaining = base + tf.offset - time.time()
                if remaining <= 0:
                    break
                self._timed_stop.wait(min(remaining, 0.05))
            if self._timed_stop.is_set():
                return
            self._fire_timed(tf)

    def _fire_timed(self, tf: TimedFault) -> None:
        if not self._claim_once(tf):
            return
        now = time.time()
        with self._timed_lock:
            if tf.fault == "hb_brownout":
                self._brownout_until = now + tf.arg
            elif tf.fault == "data_stall":
                self._stall_until = now + tf.arg
            elif tf.fault == "ckpt_fail":
                self._ckpt_fail_pending += int(tf.arg)
            elif tf.fault == "crash_loop":
                self.spawn_fail = int(tf.arg)
                self._spawn_attempts = 0
            elif tf.fault == "quota_flood":
                self._flood_until = now + tf.arg
        # record / log / export / exit OUTSIDE the lock: _record appends,
        # export does file IO, and os._exit never returns
        self._record(f"timed.{tf.fault}", f"t+{tf.offset}:{tf.arg}")
        self.timed_fired.append(
            {"fault": tf.fault, "offset": tf.offset, "arg": tf.arg,
             "ts": now})
        logger.warning("chaos: timed fault %s fired at t+%.1fs (role=%s)",
                       tf.fault, tf.offset, _ROLE)
        if tf.fault == "quota_flood":
            threading.Thread(target=self._quota_flood_run,
                             daemon=True, name="chaos-quota-flood").start()
        if tf.fault == "drop_objects":
            threading.Thread(target=self._drop_objects_run, args=(tf.arg,),
                             daemon=True, name="chaos-drop-objects").start()
        if tf.fault == "kill":
            self.export_artifact()  # atexit never runs past os._exit
            os._exit(1)

    def _claim_once(self, tf: TimedFault) -> bool:
        """With RAY_TPU_CHAOS_LOG set, each timed entry fires exactly
        once per soak run — restarted attempts re-arm the same plan from
        the environment, and the sentinel file (atomic O_EXCL create)
        makes the re-armed copy a no-op. For `kill` the sentinel also
        picks a single victim when several processes of the role armed
        the same entry. Without a log dir, fire once per process."""
        log_dir = os.environ.get(LOG_ENV, "")
        if not log_dir:
            return True
        tag = f"{tf.fault}-{tf.offset:g}-{tf.role or 'any'}"
        try:
            os.makedirs(log_dir, exist_ok=True)
            fd = os.open(os.path.join(log_dir, f"once-{tag}"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return True
        except FileExistsError:
            return False
        except OSError:
            return True  # unwritable dir: fall back to per-process fire

    # -- post-mortem artifact -------------------------------------------

    def export_artifact(self, path: Optional[str] = None
                        ) -> Optional[str]:
        """Dump the replay artifact to JSON: the full spec + seed (enough
        to rebuild the plan), the (site, draw_seq, decision) schedule,
        and the timed entries with their actual fire timestamps. Default
        destination: `$RAY_TPU_CHAOS_LOG/chaos-<role>-<pid>.json`
        (no-op when neither a path nor the env dir is given)."""
        if path is None:
            log_dir = os.environ.get(LOG_ENV, "")
            if not log_dir:
                return None
            path = os.path.join(
                log_dir, f"chaos-{_ROLE}-{os.getpid()}.json")
        data = {
            "version": 1,
            "spec": self.spec,
            "seed": self.seed,
            "role": _ROLE,
            "pid": os.getpid(),
            "installed_ts": self.installed_ts,
            "exported_ts": time.time(),
            "schedule": [list(s) for s in self.schedule],
            "counts": dict(self._counts),
            "timed": [tf._asdict() for tf in self.timed],
            "timed_fired": list(self.timed_fired),
        }
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1)
            os.replace(tmp, path)
            return path
        except OSError:
            logger.exception("chaos: artifact export to %s failed", path)
            return None

    @classmethod
    def from_artifact(cls, path: str) -> "FaultPlan":
        """Rebuild the exact plan a previous run used from its exported
        artifact: same spec → same seed → same per-site decision streams
        and the same timed schedule, so the failure replays."""
        with open(path) as f:
            data = json.load(f)
        return cls(data["spec"])


# ---------------------------------------------------------------------------
# process-global plan
# ---------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
_ROLE = "driver"
_ATEXIT_REGISTERED = False
# quota_flood victimizer: a zero-arg callable that performs one
# job-stamped object-store put; registered by CoreWorker once a store is
# attached, consumed by FaultPlan._quota_flood_run
_FLOOD_TARGET = None


def set_quota_flood_target(fn) -> None:
    """Register (or clear, with None) this process's quota-flood target.
    The callable must do ONE put charged to the process's job and let
    QuotaExceededError propagate — the flood loop counts rejections."""
    global _FLOOD_TARGET
    _FLOOD_TARGET = fn


# drop_objects victimizer: `fn(frac, rng) -> int` force-deletes a
# seeded random `frac` of the node's sealed objects and returns the
# count; registered by the raylet once its store exists.
_DROP_TARGET = None


def set_drop_objects_target(fn) -> None:
    """Register (or clear, with None) this process's drop_objects
    target. The callable takes (fraction, random.Random) so the victim
    subset is a pure function of the plan seed, and returns how many
    objects it deleted."""
    global _DROP_TARGET
    _DROP_TARGET = fn


def plan() -> Optional[FaultPlan]:
    return _PLAN


def active() -> bool:
    return _PLAN is not None


def role() -> str:
    return _ROLE


def set_role(r: str) -> None:
    """Declare this process's role (driver/gcs/raylet/worker) — called by
    each daemon's `__main__` before serving. Arms any role-scoped (and
    still-unarmed unscoped) timed entries of the active plan; offsets
    run from now."""
    global _ROLE
    if r not in _ROLES:
        raise ValueError(f"unknown chaos role {r!r}")
    _ROLE = r
    if _PLAN is not None:
        _PLAN.arm_timed(r)


def _atexit_export() -> None:
    p = _PLAN
    if p is not None:
        p.export_artifact()


def install(p: FaultPlan) -> FaultPlan:
    global _PLAN, _ATEXIT_REGISTERED
    if _PLAN is not None:
        _PLAN._timed_stop.set()
    _PLAN = p
    if not _ATEXIT_REGISTERED:
        # registered once; the hook reads the CURRENT plan, so it also
        # covers plans installed later in this process
        atexit.register(_atexit_export)
        _ATEXIT_REGISTERED = True
    logger.warning("chaos plane active: %s", p.spec or "<programmatic>")
    return p


def uninstall() -> None:
    global _PLAN
    if _PLAN is not None:
        _PLAN._timed_stop.set()
    _PLAN = None


def init_from_env() -> Optional[FaultPlan]:
    """(Re)read RAY_TPU_CHAOS. Called at import; tests may call it again
    after mutating the environment."""
    spec = os.environ.get(ENV_VAR, "")
    if spec:
        return install(FaultPlan(spec))
    uninstall()
    return None


init_from_env()
