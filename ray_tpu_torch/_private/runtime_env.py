"""Runtime environments: per-task/actor env vars + code shipping + pip.

Reference: `python/ray/runtime_env/runtime_env.py:152` (the RuntimeEnv
spec) and `python/ray/_private/runtime_env/{working_dir,py_modules,
pip}.py` (URI-addressed packages installed by the per-node agent). Here
the packages live in the GCS KV (content-addressed zips) and the WORKER
materializes them at startup — no separate agent process; the raylet
pools workers per runtime-env hash exactly like the reference's
per-runtime-env worker pools (worker_pool.h:159).

Supported fields: `env_vars` (dict), `working_dir` (local dir, shipped
and chdir'd), `py_modules` (list of local dirs, shipped and put on
sys.path), `pip` (requirements list / requirements.txt path / dict with
`packages` + `install_options`) — the raylet builds a content-addressed
cached venv per requirements set (reference `pip.py` URI caching) and
launches the pool's workers from the venv interpreter.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import zipfile
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import SESSION_ROOT

_KV_NS = "runtime_env"
_MAX_PACKAGE_BYTES = 100 * 1024 * 1024


# ---------------------------------------------------------------------------
# plugin seam (reference: python/ray/_private/runtime_env/plugin.py —
# RuntimeEnvPlugin ABC + the RAY_RUNTIME_ENV_PLUGINS registration env
# var). A plugin owns one runtime_env FIELD: it validates/uploads on the
# driver and materializes on the worker. The built-in fields
# (env_vars/working_dir/py_modules/pip) are handled natively below; any
# OTHER field must have a registered plugin — the seam where a
# container/hermetic-image backend slots in (zero-egress environments
# get no container plugin by default, but the extension point is load-
# bearing and tested).
# ---------------------------------------------------------------------------


class RuntimeEnvPlugin:
    """Owns one runtime_env field (`name`). Driver side: `prepare`
    validates the user value and returns its wire form (uploading any
    payloads — `upload(path) -> key` stores into the GCS KV). Worker
    side: `materialize` applies the wire value before any task runs
    (chdir, sys.path, env vars via os.environ)."""

    name: str = ""

    def prepare(self, value, upload) -> Any:
        return value

    def materialize(self, value, fetch, target_root: str) -> None:
        raise NotImplementedError


_plugins: Dict[str, RuntimeEnvPlugin] = {}
_env_plugins_loaded = False


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name:
        raise ValueError("plugin must set a field name")
    _plugins[plugin.name] = plugin


def _load_env_plugins() -> None:
    """One-time load of plugins named in RAY_TPU_RUNTIME_ENV_PLUGINS
    ("module:Class,module:Class" — the reference's env-var registration
    mechanism). Runs on both driver and worker, so a plugin's two
    halves resolve symmetrically."""
    global _env_plugins_loaded
    if _env_plugins_loaded:
        return
    spec = os.environ.get("RAY_TPU_RUNTIME_ENV_PLUGINS", "")
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        mod_name, _, cls_name = entry.partition(":")
        import importlib

        cls = getattr(importlib.import_module(mod_name), cls_name)
        register_plugin(cls())
    # marked loaded only after EVERY entry imported: a bad entry must
    # surface on each attempt, not silently freeze a partial registry
    _env_plugins_loaded = True


# ---------------------------------------------------------------------------
# pip venv isolation (reference python/ray/_private/runtime_env/pip.py)
# ---------------------------------------------------------------------------


def normalize_pip(pip) -> Dict:
    """Driver-side normalization of the `pip` field to its wire form:
    {"packages": [...], "install_options": [...]}. Accepts a requirements
    list, a requirements.txt path, or the dict form."""
    if isinstance(pip, str):
        with open(pip) as f:
            pkgs = [ln.strip() for ln in f
                    if ln.strip() and not ln.strip().startswith("#")]
        bad = [p for p in pkgs if p.startswith("-")]
        if bad:
            # directive lines reference driver-local files / global pip
            # state that won't exist on the node building the venv
            raise ValueError(
                f"requirements directives are not supported: {bad}; "
                "pass plain requirement specs, with pip flags in "
                '{"packages": [...], "install_options": [...]} form')
        return {"packages": pkgs, "install_options": []}
    if isinstance(pip, (list, tuple)):
        return {"packages": [str(p) for p in pip], "install_options": []}
    if isinstance(pip, dict):
        unknown = set(pip) - {"packages", "install_options"}
        if unknown:
            raise ValueError(f"unsupported pip fields: {unknown}")
        return {"packages": [str(p) for p in pip.get("packages", [])],
                "install_options": [str(o) for o in
                                    pip.get("install_options", [])]}
    raise TypeError(f"runtime_env pip must be list/str/dict, got {pip!r}")


def pip_env_cache_root() -> str:
    return os.environ.get("RAY_TPU_PIP_ENV_CACHE",
                          os.path.join(SESSION_ROOT, "pip_envs"))


class RuntimeEnvSetupError(RuntimeError):
    pass


# Per-process build coordination: one thread builds a given env while
# others wait, and a deterministic failure is remembered so a queue of
# tasks with a broken spec doesn't re-run the failing install per lease.
import threading as _threading

_pip_build_lock = _threading.Lock()
_pip_key_locks: Dict[str, _threading.Lock] = {}
_pip_failed: Dict[str, str] = {}

_PIP_CACHE_MAX_ENVS = int(os.environ.get("RAY_TPU_PIP_ENV_CACHE_MAX", "10"))


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else


def _venv_in_use(path: str) -> bool:
    """True if any live process holds an `.inuse.<pid>` marker on this
    venv (written by `mark_pip_env_in_use`). Stale markers from dead
    processes are pruned as a side effect."""
    in_use = False
    try:
        for name in os.listdir(path):
            if not name.startswith(".inuse."):
                continue
            try:
                pid = int(name.rsplit(".", 1)[1])
            except ValueError:
                continue
            if _pid_alive(pid):
                in_use = True
            else:
                try:
                    os.unlink(os.path.join(path, name))
                except OSError:
                    pass
    except OSError:
        pass
    return in_use


def mark_pip_env_in_use(dest: str) -> None:
    """Pin a venv against LRU eviction for this process's lifetime.
    Called by each pooled WORKER running from the venv interpreter
    (worker_main) — the pin lasts exactly as long as the workers that
    need the env, and crashes self-clean because the marker is checked
    against pid liveness (the reference refcounts URIs and deletes only
    on release — `runtime_env/pip.py`)."""
    try:
        open(os.path.join(dest, f".inuse.{os.getpid()}"), "w").close()
    except OSError:
        pass


def _evict_pip_cache(root: str, keep: str) -> None:
    """Bound the venv cache: beyond the cap, drop the least-recently-used
    entries (.ready mtime is touched on reuse) — skipping venvs whose
    interpreter is still backing a live process's worker pool. The
    reference refcounts URIs and deletes on release; an LRU cap with
    liveness pins is the agentless equivalent."""
    try:
        entries = [d for d in os.listdir(root)
                   if d != keep and ".tmp." not in d
                   and os.path.exists(os.path.join(root, d, ".ready"))]
        if len(entries) + 1 <= _PIP_CACHE_MAX_ENVS:
            return
        entries.sort(key=lambda d: os.path.getmtime(
            os.path.join(root, d, ".ready")))
        excess = len(entries) + 1 - _PIP_CACHE_MAX_ENVS
        for d in entries:
            if excess <= 0:
                break
            full = os.path.join(root, d)
            if _venv_in_use(full):
                continue  # live workers run from this interpreter
            shutil.rmtree(full, ignore_errors=True)
            excess -= 1
    except OSError:
        pass


def ensure_pip_env(pip_wire: Dict) -> str:
    """Build (or reuse) the cached venv for a requirements set; returns
    the venv interpreter path. Content-addressed by the normalized pip
    spec, so every job/worker with the same requirements shares one venv
    (reference pip.py URI caching). Safe under concurrent builders: each
    builds in a private tmp dir and the first atomic rename wins.

    The venv inherits the base interpreter's site-packages
    (--system-site-packages) so ray_tpu and its deps stay importable;
    pip resolves from the inherited site-packages, with an ensurepip
    bootstrap fallback for bases that carry no pip."""
    key = hashlib.sha1(json.dumps(
        pip_wire, sort_keys=True).encode()).hexdigest()[:20]
    root = pip_env_cache_root()
    dest = os.path.join(root, key)
    py = os.path.join(dest, "bin", "python")
    ready = os.path.join(dest, ".ready")
    with _pip_build_lock:
        key_lock = _pip_key_locks.setdefault(key, _threading.Lock())
    with key_lock:  # one builder per env per process; others wait here
        if key in _pip_failed:
            raise RuntimeEnvSetupError(_pip_failed[key])
        if os.path.exists(ready):
            try:
                os.utime(ready)  # LRU touch
            except OSError:
                pass
            return py
        try:
            # holding key_lock across the build is the point: it is the
            # per-env stripe that makes concurrent requesters wait for
            # one builder # raylint: disable=blocking-under-lock
            return _build_pip_env(pip_wire, root, dest, py, ready)
        except RuntimeEnvSetupError as e:
            _pip_failed[key] = str(e)
            raise


def _build_pip_env(pip_wire: Dict, root: str, dest: str, py: str,
                   ready: str) -> str:
    os.makedirs(root, exist_ok=True)
    # uuid component: unique across threads AND processes (pid alone
    # collides for two executor threads of one raylet)
    tmp = f"{dest}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
    try:
        subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages",
             "--without-pip", tmp],
            check=True, capture_output=True, timeout=120)
        # --system-site-packages exposes the ROOT interpreter's site dirs;
        # when the building interpreter is itself a venv (common: /opt
        # installs), its packages — ray_tpu's own deps — would be lost.
        # A .pth appends the builder's site dirs AFTER the new venv's own
        # site-packages, so pip-installed packages still shadow them.
        import glob as _glob
        import site as _site
        venv_sites = _glob.glob(
            os.path.join(tmp, "lib", "python*", "site-packages"))
        if venv_sites:
            with open(os.path.join(venv_sites[0], "_ray_tpu_base.pth"),
                      "w") as f:
                for p in _site.getsitepackages():
                    f.write(p + "\n")
        pkgs = pip_wire.get("packages", [])
        if pkgs:
            # `--without-pip` + `-m pip` rides the builder interpreter's
            # site-packages pip (exposed via --system-site-packages).
            # When the base install has no importable pip, bootstrap one
            # into the venv with ensurepip and retry — instead of failing
            # every pip runtime_env on such bases.
            install = ["-m", "pip", "install", "--quiet",
                       "--disable-pip-version-check",
                       *pip_wire.get("install_options", []), *pkgs]
            venv_py = os.path.join(tmp, "bin", "python")
            res = subprocess.run([venv_py, *install],
                                 capture_output=True, timeout=600)
            if (res.returncode != 0
                    and b"No module named pip" in res.stderr):
                boot = subprocess.run(
                    [venv_py, "-m", "ensurepip", "--upgrade"],
                    capture_output=True, timeout=300)
                if boot.returncode == 0:
                    res = subprocess.run([venv_py, *install],
                                         capture_output=True, timeout=600)
            if res.returncode != 0:
                raise RuntimeEnvSetupError(
                    "pip install failed for runtime_env "
                    f"{pkgs}: {res.stderr.decode(errors='replace')[-2000:]}")
        open(os.path.join(tmp, ".ready"), "w").close()
        try:
            os.rename(tmp, dest)
        except OSError:
            # a concurrent builder won the rename — same content, fine
            if not os.path.exists(ready):
                raise
        _evict_pip_cache(root, keep=os.path.basename(dest))
    except subprocess.CalledProcessError as e:
        raise RuntimeEnvSetupError(
            f"venv creation failed: {e.stderr.decode(errors='replace')}")
    except subprocess.TimeoutExpired as e:
        # a deterministic-enough failure: surface it instead of letting
        # the raylet treat it as transient and loop the full install
        raise RuntimeEnvSetupError(f"pip env build timed out: {e.cmd}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return py


def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(path):
            for name in files:
                full = os.path.join(root, name)
                zf.write(full, os.path.relpath(full, path))
    data = buf.getvalue()
    if len(data) > _MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(data)} bytes "
            f"(cap {_MAX_PACKAGE_BYTES})")
    return data


def prepare(cw, runtime_env: Dict) -> Dict:
    """Driver-side: upload local dirs to the GCS KV (content-addressed)
    and return the wire form carried in TaskSpec.runtime_env."""
    wire: Dict = {}
    env_vars = runtime_env.get("env_vars")
    if env_vars:
        wire["env_vars"] = {str(k): str(v) for k, v in env_vars.items()}

    def upload(path: str) -> str:
        data = _zip_dir(path)
        key = hashlib.sha1(data).hexdigest()[:20]
        cw._run_sync(cw.gcs.call("kv_put", {
            "ns": _KV_NS, "key": key.encode(), "value": data,
            "overwrite": False,
        }))
        return key

    if runtime_env.get("working_dir"):
        wire["working_dir"] = upload(runtime_env["working_dir"])
    if runtime_env.get("py_modules"):
        wire["py_modules"] = [
            {"key": upload(p), "name": os.path.basename(p.rstrip("/"))}
            for p in runtime_env["py_modules"]
        ]
    if runtime_env.get("pip"):
        wire["pip"] = normalize_pip(runtime_env["pip"])
    if runtime_env.get("conda"):
        if runtime_env.get("pip"):
            raise ValueError(
                "runtime_env cannot set both pip and conda (reference "
                "semantics: pip installs INTO a conda env via the "
                "spec's own pip section)")
        wire["conda"] = normalize_conda(runtime_env["conda"])
    _load_env_plugins()
    unknown = set(runtime_env) - {"env_vars", "working_dir", "py_modules",
                                  "pip", "conda"}
    for field_name in sorted(unknown):
        plugin = _plugins.get(field_name)
        if plugin is None:
            raise ValueError(
                f"unsupported runtime_env field {field_name!r} (no "
                f"registered plugin; see runtime_env.register_plugin / "
                f"RAY_TPU_RUNTIME_ENV_PLUGINS)")
        wire[field_name] = plugin.prepare(runtime_env[field_name], upload)
    # precompute the pooling identity once: scheduling_key() reads it on
    # every submit, which must not pay a json+sha1 per task
    wire["_hash"] = hashlib.sha1(
        json.dumps(wire, sort_keys=True).encode()).hexdigest()[:16]
    return wire


def merge_wire(base: Dict, override: Dict) -> Dict:
    """Field-wise inheritance of prepared (wire-form) runtime envs: the
    override's fields win, `env_vars` merge key-wise, and the pooling
    hash is recomputed for the combined env (reference semantics:
    `python/ray/_private/runtime_env/validation.py` parent/child merge).
    """
    merged = {k: v for k, v in base.items() if k != "_hash"}
    for k, v in override.items():
        if k == "_hash":
            continue
        if k == "env_vars":
            ev = dict(merged.get("env_vars") or {})
            ev.update(v or {})
            merged[k] = ev
        else:
            merged[k] = v
    if merged.get("pip") and merged.get("conda"):
        # prepare() validates single env dicts only; the merge can still
        # combine a job-level conda with a per-actor pip (or vice versa),
        # and the raylet's spawn path would silently prefer pip. The
        # reference raises on the combination — so do we.
        raise ValueError(
            "merged runtime_env cannot set both pip and conda (job-level "
            "and per-actor/task envs combined to a pip+conda env; "
            "reference semantics: pip installs INTO a conda env via the "
            "spec's own pip section)")
    merged["_hash"] = hashlib.sha1(
        json.dumps(merged, sort_keys=True).encode()).hexdigest()[:16]
    return merged


def env_hash(wire: Optional[Dict]) -> str:
    """Stable identity for worker pooling; empty env hashes to ''."""
    if not wire:
        return ""
    cached = wire.get("_hash")
    if cached is not None:
        return cached
    return hashlib.sha1(
        json.dumps(wire, sort_keys=True).encode()).hexdigest()[:16]


def materialize(cw, wire: Dict, target_root: str) -> None:
    """Worker-side: download + extract packages, apply sys.path/cwd.
    env_vars were already applied by the raylet at spawn."""
    os.makedirs(target_root, exist_ok=True)

    def fetch_extract(key: str, subdir: str) -> str:
        dest = os.path.join(target_root, subdir)
        if not os.path.isdir(dest):
            reply = cw._run_sync(cw.gcs.call("kv_get", {
                "ns": _KV_NS, "key": key.encode()}))
            data = reply["value"]
            if data is None:
                raise RuntimeError(f"runtime_env package {key} missing")
            # per-process tmp: concurrent workers materializing the same
            # env must not collide; whoever renames first wins, the
            # loser's rename failure is success (dest exists)
            tmp = f"{dest}.tmp.{os.getpid()}"
            with zipfile.ZipFile(io.BytesIO(data)) as zf:
                zf.extractall(tmp)
            try:
                os.replace(tmp, dest)
            except OSError:
                if not os.path.isdir(dest):
                    raise
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        return dest

    for mod in wire.get("py_modules", []):
        dest = fetch_extract(mod["key"], f"mod-{mod['key']}")
        # a module dir is importable by its own name: expose its parent
        parent = os.path.join(target_root, f"modroot-{mod['key']}")
        os.makedirs(parent, exist_ok=True)
        link = os.path.join(parent, mod["name"])
        try:
            os.symlink(dest, link)
        except FileExistsError:
            pass  # a concurrent worker won the race — same target
        if parent not in sys.path:
            sys.path.insert(0, parent)
    if wire.get("working_dir"):
        dest = fetch_extract(wire["working_dir"], f"wd-{wire['working_dir']}")
        os.chdir(dest)
        if dest not in sys.path:
            sys.path.insert(0, dest)

    _load_env_plugins()

    def fetch(key: str) -> bytes:
        reply = cw._run_sync(cw.gcs.call("kv_get", {
            "ns": _KV_NS, "key": key.encode()}))
        if reply["value"] is None:
            raise RuntimeError(f"runtime_env payload {key} missing")
        return reply["value"]

    # pip and conda are applied at SPAWN time (the raylet launches the
    # worker from the env's interpreter) — nothing to materialize here
    builtin = {"env_vars", "working_dir", "py_modules", "pip", "conda",
               "_hash"}
    for field_name in wire:
        if field_name in builtin:
            continue
        plugin = _plugins.get(field_name)
        if plugin is None:
            # iterate WIRE fields, not registered plugins: a field the
            # driver validated but this worker cannot apply must FAIL
            # the env setup, never silently run the task without its
            # declared environment (ship the plugin module via
            # py_modules + RAY_TPU_RUNTIME_ENV_PLUGINS)
            raise RuntimeError(
                f"runtime_env field {field_name!r} has no registered "
                f"plugin in this worker (set RAY_TPU_RUNTIME_ENV_PLUGINS "
                f"in env_vars and ship the module via py_modules)")
        plugin.materialize(wire[field_name], fetch, target_root)


# ---------------------------------------------------------------------------
# conda env isolation (reference python/ray/_private/runtime_env/conda.py:
# per-spec conda envs created by the agent, cached and reused). The worker
# interpreter comes FROM the env, so this is a native field like pip —
# the plugin seam cannot swap an already-running interpreter.
# ---------------------------------------------------------------------------


def normalize_conda(conda) -> Dict:
    """Driver-side normalization: an existing env NAME, a path to an
    environment.yml, or an inline spec dict (the yml's content)."""
    if isinstance(conda, str):
        if conda.endswith((".yml", ".yaml")):
            import yaml

            with open(conda) as f:
                spec = yaml.safe_load(f)
            if not isinstance(spec, dict):
                raise ValueError(f"malformed conda spec file {conda!r}")
            return {"spec": spec}
        return {"name": conda}
    if isinstance(conda, dict):
        return {"spec": conda}
    raise TypeError(
        f"runtime_env conda must be an env name, a spec file path, or a "
        f"spec dict, got {conda!r}")


def conda_env_cache_root() -> str:
    return os.environ.get("RAY_TPU_CONDA_ENV_CACHE",
                          os.path.join(SESSION_ROOT, "conda_envs"))


def _conda_exe() -> str:
    exe = os.environ.get("RAY_TPU_CONDA_EXE") or shutil.which("conda")
    if not exe or not (os.path.isfile(exe) and os.access(exe, os.X_OK)):
        # deterministic failure — a missing binary must fail the waiting
        # leases, not leave the raylet respawning/hanging
        raise RuntimeEnvSetupError(
            "runtime_env requests a conda env but no usable conda "
            f"executable is available on this node (looked at {exe!r}; "
            "install conda or set RAY_TPU_CONDA_EXE)")
    return exe


_conda_build_lock = _threading.Lock()
_conda_key_locks: Dict[str, _threading.Lock] = {}
_conda_failed: Dict[str, str] = {}


_conda_named_cache: Dict[str, str] = {}


def ensure_conda_env(conda_wire: Dict) -> str:
    """Resolve (building if needed) the conda env for a wire spec;
    returns the env's python interpreter path. Spec envs are
    content-addressed by the normalized spec and cached like pip venvs;
    named envs resolve through `conda run` (once per name — the mapping
    is stable for the node's lifetime, and a per-spawn subprocess would
    tax every worker of the pool)."""
    exe = _conda_exe()
    if conda_wire.get("name"):
        name = conda_wire["name"]
        cached = _conda_named_cache.get(name)
        if cached:
            return cached
        try:
            out = subprocess.run(
                [exe, "run", "-n", name, "python", "-c",
                 "import sys; print(sys.executable)"],
                check=True, capture_output=True, text=True, timeout=120)
        except (subprocess.CalledProcessError,
                subprocess.TimeoutExpired, OSError) as e:
            stderr = getattr(e, "stderr", "") or ""
            raise RuntimeEnvSetupError(
                f"conda env {name!r} not usable: "
                f"{stderr[-500:] or e}") from e
        lines = out.stdout.strip().splitlines()
        if not lines:
            # `conda run` exiting 0 with empty stdout must be a
            # deterministic setup failure: anything else (IndexError)
            # reads as transient, and the raylet would respawn forever
            # while the waiting leases hang
            raise RuntimeEnvSetupError(
                f"conda env {name!r}: `conda run` produced no interpreter "
                f"path (stderr: {(out.stderr or '').strip()[-500:] or 'empty'})")
        py = lines[-1]
        _conda_named_cache[name] = py
        return py
    spec = conda_wire["spec"]
    key = hashlib.sha1(json.dumps(
        spec, sort_keys=True).encode()).hexdigest()[:20]
    dest = os.path.join(conda_env_cache_root(), key)
    py = os.path.join(dest, "bin", "python")
    ready = os.path.join(dest, ".ready")
    with _conda_build_lock:
        key_lock = _conda_key_locks.setdefault(key, _threading.Lock())
    with key_lock:
        if key in _conda_failed:
            raise RuntimeEnvSetupError(_conda_failed[key])
        if os.path.exists(ready):
            try:
                os.utime(ready)
            except OSError:
                pass
            return py
        try:
            # per-env stripe held across the build by design (one
            # builder, everyone else waits)
            # raylint: disable=blocking-under-lock
            return _build_conda_env(exe, spec, dest, py, ready)
        except RuntimeEnvSetupError as e:
            _conda_failed[key] = str(e)
            raise


def _build_conda_env(exe: str, spec: Dict, dest: str, py: str,
                     ready: str) -> str:
    import yaml

    os.makedirs(conda_env_cache_root(), exist_ok=True)
    tmp = f"{dest}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
    spec_path = f"{tmp}.yml"
    with open(spec_path, "w") as f:
        yaml.safe_dump(spec, f)
    try:
        try:
            proc = subprocess.run(
                [exe, "env", "create", "-p", tmp, "-f", spec_path],
                capture_output=True, text=True, timeout=1800)
        except subprocess.TimeoutExpired as e:
            # deterministic-failure class: without this, the raylet
            # treats the raw TimeoutExpired as transient and re-runs the
            # 30-minute build forever while callers hang
            raise RuntimeEnvSetupError(
                "conda env create timed out after 1800s") from e
        except OSError as e:
            raise RuntimeEnvSetupError(
                f"conda executable failed to run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeEnvSetupError(
                f"conda env create failed (rc={proc.returncode}):\n"
                f"{proc.stderr[-2000:]}")
        if not os.path.exists(os.path.join(tmp, "bin", "python")):
            raise RuntimeEnvSetupError(
                "conda env create produced no python interpreter "
                f"under {tmp}")
        # Inject the running framework into the env (reference conda.py
        # injects ray + its deps the same way): a .pth appending the
        # builder's site dirs AFTER the env's own site-packages, so the
        # env's packages shadow them but ray_tpu stays importable.
        import glob as _glob
        import site as _site

        env_sites = _glob.glob(
            os.path.join(tmp, "lib", "python*", "site-packages"))
        if env_sites:
            repo_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            with open(os.path.join(env_sites[0], "_ray_tpu_base.pth"),
                      "w") as f:
                f.write(repo_root + "\n")
                for p in _site.getsitepackages():
                    f.write(p + "\n")
        with open(os.path.join(tmp, ".ready"), "w"):
            pass
        try:
            os.replace(tmp, dest)  # first builder wins
        except OSError:
            if not os.path.exists(ready):
                raise
        # same LRU cap as the pip venv cache — conda envs are even
        # bigger, and nothing else bounds the cache directory
        _evict_pip_cache(conda_env_cache_root(),
                         keep=os.path.basename(dest))
        return py
    finally:
        try:
            os.unlink(spec_path)
        except OSError:
            pass
        # failure (or a lost rename race) must not leak the
        # multi-hundred-MB partial env; on success tmp no longer exists
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# container stand-in: local overlay images (reference
# python/ray/_private/runtime_env/{container,image_uri}.py runs workers in
# podman; a zero-egress single-box deployment has no registry or container
# runtime, so the shipped plugin applies a LOCAL image directory as a
# userspace overlay — `<image>/site-packages` prepends sys.path,
# `<image>/bin` prepends PATH. The plugin seam accepts a real podman
# backend where one exists.)
# ---------------------------------------------------------------------------


class LocalImagePlugin(RuntimeEnvPlugin):
    name = "container"

    def prepare(self, value, upload) -> Any:
        if not isinstance(value, dict) or "image" not in value:
            raise ValueError(
                'runtime_env container must be {"image": <local overlay '
                'dir>} (zero-egress stand-in for the reference\'s podman '
                "images)")
        unknown = set(value) - {"image"}
        if unknown:
            raise ValueError(
                f"unsupported container fields: {sorted(unknown)}")
        return {"image": str(value["image"])}

    def materialize(self, value, fetch, target_root: str) -> None:
        image = value["image"]
        if not os.path.isdir(image):
            raise RuntimeError(
                f"container image dir {image!r} does not exist on this "
                f"node (images are node-local, like pulled containers)")
        site = os.path.join(image, "site-packages")
        if os.path.isdir(site) and site not in sys.path:
            sys.path.insert(0, site)
        bindir = os.path.join(image, "bin")
        if os.path.isdir(bindir):
            os.environ["PATH"] = (
                bindir + os.pathsep + os.environ.get("PATH", ""))


register_plugin(LocalImagePlugin())
