"""Versioned on-disk artifact store for compiled schedules and recipes.

Layout (one file per artifact, names fully determined by the key)::

    <root>/v<STORE_SCHEMA_VERSION>/
        meta.json                       # {"schema": N}
        <c-regime>/sched-<digest>.npz   # CompiledSchedule entries
        recipes/recipe-<digest>.npz     # payload-independent recipes

Schedule artifacts are keyed by the full process-cache key of
``repro_torch.core.schedule_ir.compiled_schedule`` — ``(op, algorithm,
num_nodes, procs_per_node, k_lanes, k, c, root, optimize,
pipeline_fingerprint, fault_fingerprint)`` — which carries the machine
shape (the topology triple), the payload, the optimizer pipeline
fingerprint, and the fault fingerprint.  The digest is the sha1 of the
canonical JSON of that tuple, so one key maps to exactly one file name:
concurrent writers race to ``os.replace`` byte-identical content and the
store can never hold two copies (or a torn half) of an artifact.  The
``c-regime`` directory level (latency/mixed/bandwidth, from the payload)
groups entries the way the selector's piecewise fits reason about them.

Recipe artifacts hold the ``(morder, round_ptr)`` permutation a
``recipe_safe`` pipeline recorded — payload-independent, so one recipe
replays at every payload size; their key is the schedule key minus ``c``.

**Versioning and eviction.**  Every artifact header records the store
schema, the ``PASS_PIPELINE_VERSION``, and (for optimized entries) the
pipeline fingerprint the entry was built under.  :meth:`warm_start`
deletes — never loads — any artifact whose pass-pipeline version or
fingerprint no longer matches the current pipeline
(``passes.mode_fingerprint``), whose header fails to parse, or whose
schema predates :data:`STORE_SCHEMA_VERSION` (older ``v*`` directories
are pruned wholesale).  A schedule cached under a stale optimizer is
silently wrong to serve; disk is the wrong place to keep it.

**Degraded entries** (the keying rule): fault-repaired schedules
persist under their fault fingerprint — part of the key, hence the file
name — and warm-start back under the same faulted key.  They are never
read back as healthy entries, because the healthy key hashes to a
different file.  Recipes never exist for repairs (repair is not
``recipe_safe``), so no recipe can smuggle a degraded rewrite either.

**Resilience.**  On a shared filesystem another process may
evict, re-publish, or bound the store underneath a reader, so every
read/write here tolerates concurrent evictors: an ENOENT or torn
(truncated/partial) artifact resolves to a cache miss — the caller
recomputes and republishes — counted in the ``store.read_races`` metric
and ``schedule_cache_info()["store_read_races"]``, never an exception.
Transient IO errors retry under the store's deterministic
:class:`~repro_torch.core.resilience.BackoffPolicy`; an artifact that keeps
failing is quarantined (``store.quarantined``) and skipped rather than
retried forever.  The *valid* artifact set is LRU/size-bounded
(``max_entries`` / ``max_bytes``, env ``REPRO_STORE_MAX_ENTRIES`` /
``REPRO_STORE_MAX_BYTES``): successful reads touch mtimes, and
:meth:`ArtifactStore.enforce_bounds` evicts oldest-first
(``store.lru_evictions``).  ``warm_start(verify=True)`` bounds its
analyzer pass under a :class:`~repro_torch.core.resilience.DeadlineBudget`,
newest-first, deferring the tail to lazy per-read verification.
"""

from __future__ import annotations

import errno
import json
import hashlib
import os
import tempfile
import threading
from pathlib import Path

import numpy as np

from repro_torch.core.resilience import BackoffPolicy, DeadlineBudget, \
    call_with_retries
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import TRACER

__all__ = [
    "STORE_SCHEMA_VERSION",
    "ArtifactStore",
    "c_regime",
    "default_store_root",
    "read_race_count",
    "set_io_fault_injector",
]

#: Bump when the artifact file format (not the schedule semantics) changes;
#: warm-start prunes every other ``v*`` directory.
STORE_SCHEMA_VERSION = 1

#: ``REPRO_STORE`` overrides the on-disk location; the default lives under
#: the ignored ``artifacts/`` directory next to the forensics dumps.
_ENV_VAR = "REPRO_STORE"
_DEFAULT_ROOT = os.path.join("artifacts", "schedule_store")


def default_store_root() -> str:
    """The store root: ``$REPRO_STORE`` or ``artifacts/schedule_store``."""
    return os.environ.get(_ENV_VAR) or _DEFAULT_ROOT


# -- shared-store race accounting and fault injection ----------------------
#
# Module-level because races are a property of the shared filesystem, not
# of one ArtifactStore instance; all mutation sits under _STATE_LOCK (the
# L001 lock-discipline rule).  The injector is the chaos/test hook: a
# callable (op, path) invoked before every artifact IO, free to raise.

_STATE_LOCK = threading.Lock()
_READ_RACES = 0
_IO_INJECTOR = None


def read_race_count() -> int:
    """Process-wide count of shared-store read races (concurrently
    deleted or torn artifacts resolved as cache misses)."""
    with _STATE_LOCK:
        return _READ_RACES


def _count_read_race(reason: str) -> None:
    global _READ_RACES
    with _STATE_LOCK:
        _READ_RACES += 1
    obs_metrics.counter("store.read_races").inc()
    TRACER.event("store.read_race", reason=reason)


def set_io_fault_injector(fn) -> None:
    """Install (or clear, with None) the IO fault-injection hook used by
    the chaos flaky-filesystem drill: ``fn(op, path)`` runs before every
    artifact read/write and may raise to simulate a failing disk."""
    global _IO_INJECTOR
    with _STATE_LOCK:
        _IO_INJECTOR = fn


def _maybe_inject(op: str, path) -> None:
    with _STATE_LOCK:
        fn = _IO_INJECTOR
    if fn is not None:
        fn(op, str(path))


def _env_int(name: str) -> int:
    try:
        return int(os.environ.get(name, "") or 0)
    except ValueError:
        return 0


class _ArtifactMiss(Exception):
    """Internal: a read that must resolve to a cache miss (ENOENT from a
    concurrent evictor, or a torn/truncated artifact)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def c_regime(c: int) -> str:
    """Payload regime bucket for the directory layout: the latency regime
    (alpha-dominated small blocks), the bandwidth regime (beta-dominated),
    and the mixed band between — the same coarse bands the selector's
    piecewise-affine fits resolve knees inside."""
    if c <= 64:
        return "latency"
    if c <= 8192:
        return "mixed"
    return "bandwidth"


def _canon(key: tuple) -> str:
    return json.dumps(list(key), separators=(",", ":"))


def _digest(kind: str, key: tuple) -> str:
    return hashlib.sha1(f"{kind}|{_canon(key)}".encode()).hexdigest()[:20]


class ArtifactStore:
    """Atomic, schema-versioned persistence for the schedule cache.

    Thread-safe by construction rather than by locking: every write goes
    to a unique temporary file in the destination directory and is
    published with one ``os.replace`` — readers see either the complete
    artifact or nothing — and the deterministic key→name mapping makes
    duplicate artifacts impossible.

    ``max_entries`` / ``max_bytes`` bound the valid artifact set (0 or
    None = unbounded; env ``REPRO_STORE_MAX_ENTRIES`` /
    ``REPRO_STORE_MAX_BYTES`` supply defaults).  ``retry`` is the
    deterministic backoff policy for transient IO; after
    ``quarantine_after`` consecutive hard failures an artifact path is
    quarantined and skipped (``store.quarantined``).
    """

    def __init__(self, root: str | os.PathLike | None = None, *,
                 max_entries: int | None = None,
                 max_bytes: int | None = None,
                 quarantine_after: int = 3,
                 retry: BackoffPolicy | None = None):
        self.root = Path(root if root is not None else default_store_root())
        self.max_entries = max_entries if max_entries is not None \
            else _env_int("REPRO_STORE_MAX_ENTRIES")
        self.max_bytes = max_bytes if max_bytes is not None \
            else _env_int("REPRO_STORE_MAX_BYTES")
        self.quarantine_after = quarantine_after
        self.retry = retry if retry is not None \
            else BackoffPolicy(base_s=1e-4, max_s=1e-2, max_attempts=3)
        self._lock = threading.Lock()
        self._fail_counts: dict[str, int] = {}
        self._quarantined: set[str] = set()
        self._verify_deferred: set[str] = set()

    # -- quarantine -----------------------------------------------------

    def _is_quarantined(self, path: Path) -> bool:
        with self._lock:
            return str(path) in self._quarantined

    def _note_failure(self, path: Path) -> None:
        with self._lock:
            n = self._fail_counts.get(str(path), 0) + 1
            self._fail_counts[str(path)] = n
            tripped = n >= self.quarantine_after \
                and str(path) not in self._quarantined
            if tripped:
                self._quarantined.add(str(path))
        if tripped:
            obs_metrics.counter("store.quarantined").inc()
            TRACER.event("store.quarantine", path=str(path), failures=n)

    def _note_success(self, path: Path) -> None:
        with self._lock:
            self._fail_counts.pop(str(path), None)

    def quarantine_info(self) -> dict:
        """Quarantined artifact paths and live failure counts."""
        with self._lock:
            return {"quarantined": sorted(self._quarantined),
                    "failures": dict(self._fail_counts)}

    def _pop_deferred(self, path: Path) -> bool:
        """True (once) if this artifact's verification was deferred by a
        budget-bounded ``warm_start(verify=True)``."""
        with self._lock:
            if str(path) in self._verify_deferred:
                self._verify_deferred.discard(str(path))
                return True
            return False

    def deferred_count(self) -> int:
        with self._lock:
            return len(self._verify_deferred)

    # -- layout ---------------------------------------------------------

    @property
    def schema_dir(self) -> Path:
        return self.root / f"v{STORE_SCHEMA_VERSION}"

    def _sched_path(self, key: tuple) -> Path:
        return (self.schema_dir / c_regime(int(key[6]))
                / f"sched-{_digest('sched', key)}.npz")

    def _recipe_path(self, rkey: tuple) -> Path:
        return self.schema_dir / "recipes" / f"recipe-{_digest('recipe', rkey)}.npz"

    def _write_meta(self) -> None:
        meta = self.schema_dir / "meta.json"
        if not meta.exists():
            self.schema_dir.mkdir(parents=True, exist_ok=True)
            self._atomic_write_bytes(
                meta, json.dumps({"schema": STORE_SCHEMA_VERSION}).encode()
            )

    # -- atomic writes --------------------------------------------------

    def _atomic_write_bytes(self, path: Path, data: bytes) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-", suffix=".part")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _savez_resilient(self, path: Path, header: dict, arrays: dict) -> bool:
        """Publish one artifact, retrying transient IO under the store's
        backoff policy.  Returns False (artifact not published — a later
        put or recompute recovers) instead of raising; repeated failures
        quarantine the path."""
        if self._is_quarantined(path):
            obs_metrics.counter("store.quarantine.skips").inc()
            return False

        def attempt():
            _maybe_inject("write", path)
            self._atomic_savez(path, header, arrays)

        try:
            call_with_retries(attempt, policy=self.retry,
                              retry_on=(OSError,), name="store.write",
                              salt=path.name)
        except OSError:
            self._note_failure(path)
            obs_metrics.counter("store.write_failures").inc()
            TRACER.event("store.write_failure", path=str(path))
            return False
        self._note_success(path)
        return True

    def _read_artifact(self, path: Path, loader):
        """Race- and fault-tolerant artifact read.  Returns ``(header,
        obj)`` or ``(None, None)`` for a miss: ENOENT (a concurrent
        evictor won) and torn/truncated files count as read races — the
        torn file is deleted so the next reader recomputes cleanly —
        while transient IO errors retry under the backoff policy and
        quarantine the path once exhausted.  Never raises."""

        def attempt():
            try:
                _maybe_inject("read", path)
                return loader(path)
            except FileNotFoundError as exc:
                raise _ArtifactMiss("enoent") from exc
            except OSError as exc:
                if exc.errno == errno.ENOENT:
                    raise _ArtifactMiss("enoent") from exc
                raise  # transient: retried by call_with_retries
            except Exception as exc:  # truncated zip, bad JSON, bad kind
                raise _ArtifactMiss("torn") from exc

        try:
            header, obj = call_with_retries(
                attempt, policy=self.retry, retry_on=(OSError,),
                name="store.read", salt=path.name)
        except _ArtifactMiss as miss:
            _count_read_race(miss.reason)
            if miss.reason == "torn":
                try:
                    path.unlink(missing_ok=True)
                except OSError:
                    pass
            return None, None
        except OSError:
            self._note_failure(path)
            obs_metrics.counter("store.read_failures").inc()
            TRACER.event("store.read_failure", path=str(path))
            return None, None
        self._note_success(path)
        return header, obj

    @staticmethod
    def _touch(path: Path) -> None:
        """Refresh mtime so LRU bounds see the read (best-effort: the
        artifact may be concurrently evicted)."""
        try:
            os.utime(path)
        except OSError:
            pass

    def _atomic_savez(self, path: Path, header: dict, arrays: dict) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-", suffix=".part")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, header=np.array(json.dumps(header)), **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- schedule artifacts ---------------------------------------------

    def put_schedule(self, key: tuple, cs) -> Path | None:
        """Persist one compiled-schedule cache entry; returns the artifact
        path, or None when the key is already on disk (puts are
        idempotent and cheap to repeat)."""
        from repro_torch.core.passes import PASS_PIPELINE_VERSION

        path = self._sched_path(key)
        if path.exists():
            return None
        self._write_meta()
        header = {
            "schema": STORE_SCHEMA_VERSION,
            "kind": "schedule",
            "key": list(key),
            "pass_pipeline_version": PASS_PIPELINE_VERSION,
            "regime": c_regime(int(key[6])),
            "op": cs.op,
            "algorithm": cs.algorithm,
            "p": int(cs.p),
            "k": int(cs.k),
            "has_blocks": bool(cs.has_blocks),
        }
        arrays = {
            "src": cs.src,
            "dst": cs.dst,
            "elems": cs.elems,
            "round_ptr": cs.round_ptr,
        }
        if cs.has_blocks:
            arrays["blk_ptr"] = cs.blk_ptr
            arrays["blk_ids"] = cs.blk_ids
        if not self._savez_resilient(path, header, arrays):
            return None
        obs_metrics.counter("store.puts").inc()
        if TRACER:
            TRACER.event("store.put", kind="schedule", op=cs.op,
                         algorithm=cs.algorithm)
        return path

    def get_schedule(self, key: tuple):
        """Load one schedule artifact (or None); the header key must match
        the requested key exactly — a digest collision or a hand-edited
        file must not serve the wrong schedule.  A concurrently deleted
        or torn file is a cache miss (counted as a read race), never an
        exception — the caller recomputes and republishes."""
        path = self._sched_path(key)
        if self._is_quarantined(path):
            obs_metrics.counter("store.quarantine.skips").inc()
            return None
        if not path.exists():
            return None
        header, obj = self._read_artifact(path, self._load_schedule)
        if header is None or tuple(header["key"]) != tuple(key):
            return None
        if self._pop_deferred(path):
            # warm_start(verify=True) ran out of budget before reaching
            # this artifact: verify lazily on first read
            if not self._statically_ok(header, obj):
                path.unlink(missing_ok=True)
                return None
        self._touch(path)
        return obj

    def _load_schedule(self, path: Path):
        from repro_torch.core.schedule_ir import CompiledSchedule

        with np.load(path, allow_pickle=False) as z:
            header = json.loads(str(z["header"][()]))
            if header.get("kind") != "schedule":
                raise ValueError(f"{path}: not a schedule artifact")
            cs = CompiledSchedule(
                op=header["op"],
                algorithm=header["algorithm"],
                p=int(header["p"]),
                k=int(header["k"]),
                src=z["src"].copy(),
                dst=z["dst"].copy(),
                elems=z["elems"].copy(),
                round_ptr=z["round_ptr"].copy(),
                blk_ptr=z["blk_ptr"].copy() if header["has_blocks"] else None,
                blk_ids=z["blk_ids"].copy() if header["has_blocks"] else None,
            )
        return header, cs

    # -- recipe artifacts -----------------------------------------------

    def put_recipe(self, rkey: tuple, rec: dict) -> Path | None:
        """Persist one payload-independent optimizer recipe."""
        from repro_torch.core.passes import PASS_PIPELINE_VERSION

        path = self._recipe_path(rkey)
        if path.exists():
            return None
        self._write_meta()
        header = {
            "schema": STORE_SCHEMA_VERSION,
            "kind": "recipe",
            "key": list(rkey),
            "pass_pipeline_version": PASS_PIPELINE_VERSION,
            "identity": bool(rec["identity"]),
            "validated": bool(rec["validated"]),
        }
        arrays = {}
        if not rec["identity"]:
            arrays["morder"] = rec["morder"]
            arrays["round_ptr"] = rec["round_ptr"]
        if not self._savez_resilient(path, header, arrays):
            return None
        obs_metrics.counter("store.puts").inc()
        if TRACER:
            TRACER.event("store.put", kind="recipe", op=rkey[0],
                         algorithm=rkey[1])
        return path

    def get_recipe(self, rkey: tuple) -> dict | None:
        path = self._recipe_path(rkey)
        if self._is_quarantined(path):
            obs_metrics.counter("store.quarantine.skips").inc()
            return None
        if not path.exists():
            return None
        header, rec = self._read_artifact(path, self._load_recipe)
        if header is None or tuple(header["key"]) != tuple(rkey):
            return None
        self._touch(path)
        return rec

    def _load_recipe(self, path: Path):
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(str(z["header"][()]))
            if header.get("kind") != "recipe":
                raise ValueError(f"{path}: not a recipe artifact")
            rec = {"identity": bool(header["identity"]),
                   "validated": bool(header["validated"])}
            if not rec["identity"]:
                rec["morder"] = z["morder"].copy()
                rec["round_ptr"] = z["round_ptr"].copy()
        return header, rec

    # -- bulk persistence ------------------------------------------------

    def persist_cache(self) -> dict:
        """Snapshot the live process cache (schedules + recipes) to disk.
        Idempotent: keys already on disk are skipped.  Degraded (faulted)
        entries persist under their fault-fingerprinted key — see the
        module notes — so nothing here can resurface as healthy."""
        from repro_torch.core.schedule_ir import cache_export

        entries, recipes = cache_export()
        wrote_s = wrote_r = 0
        for key, cs in entries.items():
            if self.put_schedule(key, cs) is not None:
                wrote_s += 1
        for rkey, rec in recipes.items():
            if self.put_recipe(rkey, rec) is not None:
                wrote_r += 1
        bounded = self.enforce_bounds()
        return {"schedules": wrote_s, "recipes": wrote_r,
                "cached_schedules": len(entries),
                "cached_recipes": len(recipes),
                "lru_evicted": bounded}

    # -- warm start -------------------------------------------------------

    def _artifact_paths(self) -> list[Path]:
        if not self.schema_dir.is_dir():
            return []
        return sorted(
            p for p in self.schema_dir.glob("**/*.npz") if p.is_file()
        )

    def _stale_reason(self, header: dict) -> str | None:
        """Why an artifact must be evicted, or None when it is servable."""
        from repro_torch.core.passes import PASS_PIPELINE_VERSION, mode_fingerprint
        from repro_torch.core.topology import Topology

        if header.get("schema") != STORE_SCHEMA_VERSION:
            return "schema"
        key = header.get("key")
        if not isinstance(key, list):
            return "malformed-key"
        if header["kind"] == "schedule":
            if len(key) != 11:
                return "malformed-key"
            optimize, fingerprint = key[8], key[9]
        else:
            if len(key) != 10:
                return "malformed-key"
            optimize, fingerprint = key[7], key[8]
        if optimize is None:
            # unoptimized generator output: pipeline-independent by
            # construction, valid across pass-pipeline bumps
            return None
        if header.get("pass_pipeline_version") != PASS_PIPELINE_VERSION:
            return "pipeline-version"
        topo = Topology(int(key[2]), int(key[3]), int(key[4]))
        try:
            current = mode_fingerprint(optimize, topo)
        except ValueError:
            return "unknown-mode"
        if fingerprint != current:
            return "fingerprint"
        return None

    def evict_stale(self) -> int:
        """Delete every artifact the current pipeline could not have
        produced (and any stale ``v*`` schema directory); returns the
        number of files removed."""
        import shutil

        removed = 0
        if self.root.is_dir():
            for d in self.root.iterdir():
                if d.is_dir() and d.name.startswith("v") \
                        and d != self.schema_dir:
                    shutil.rmtree(d, ignore_errors=True)
                    removed += 1
        if self.schema_dir.is_dir():
            # orphaned temp files from a writer killed mid-publish; a
            # live writer's temp may also go — its os.replace fails
            # ENOENT and the write retries or recomputes
            for tmp in self.schema_dir.glob("**/.tmp-*.part"):
                try:
                    tmp.unlink(missing_ok=True)
                    removed += 1
                except OSError:
                    pass
        for path in self._artifact_paths():
            try:
                with np.load(path, allow_pickle=False) as z:
                    header = json.loads(str(z["header"][()]))
                reason = self._stale_reason(header)
            except Exception:
                reason = "corrupt"
            if reason is not None:
                path.unlink(missing_ok=True)
                removed += 1
                obs_metrics.counter("store.evictions").inc()
                if TRACER:
                    TRACER.event("store.evict", path=str(path), reason=reason)
        return removed

    def enforce_bounds(self) -> int:
        """LRU-evict valid artifacts (oldest mtime first — successful
        reads touch) until ``max_entries`` / ``max_bytes`` hold; returns
        the number evicted.  No-op when both bounds are unset."""
        if not self.max_entries and not self.max_bytes:
            return 0
        infos = []
        for p in self._artifact_paths():
            try:
                st = p.stat()
            except OSError:
                continue  # concurrent evictor won
            infos.append((st.st_mtime, st.st_size, p))
        infos.sort(key=lambda t: (t[0], str(t[2])))
        count = len(infos)
        total_bytes = sum(sz for _, sz, _ in infos)
        removed = 0
        for _, sz, p in infos:
            over_n = self.max_entries and count > self.max_entries
            over_b = self.max_bytes and total_bytes > self.max_bytes
            if not over_n and not over_b:
                break
            p.unlink(missing_ok=True)
            removed += 1
            count -= 1
            total_bytes -= sz
            obs_metrics.counter("store.lru_evictions").inc()
            if TRACER:
                TRACER.event("store.lru_evict", path=str(p))
        return removed

    def warm_start(self, *, reset_selector: bool = True,
                   verify: bool = False,
                   budget_s: float | None = None) -> dict:
        """Load every valid artifact into the process cache and recipe
        table (``schedule_ir.cache_seed``), evicting stale or corrupt
        files on the way, then invalidate the selector's in-memory caches
        (``selector_cache_reset``) so no pre-warm-start ``Choice`` can
        outlive a bumped artifact.  Returns a report dict.

        ``verify=True`` runs the static analyzer
        (:func:`repro_torch.core.analyze.analyze_schedule`) over every loaded
        schedule and refuses to seed one that fails — the artifact digest
        only covers the *key*, so a content-corrupted file (bit rot, a
        partial write, a hostile edit) loads cleanly and would otherwise
        be served verbatim to every consumer.  Rejected artifacts are
        deleted and counted under ``rejected``.

        Seeded keys are marked *store-resident*: any later cache miss on
        one of them counts as a store recompile
        (``schedule_cache_info()["store_recompiles"]``) — the regression
        the load benchmark gates at zero.

        ``budget_s`` (env ``REPRO_STORE_VERIFY_BUDGET_S``) bounds the
        verification pass under a deadline budget: artifacts are walked
        newest-first and, once the budget expires, the tail is *not*
        seeded — it stays on disk, marked for lazy per-read verification
        in :meth:`get_schedule` — so engine startup has a predictable
        worst case on an oversized store.  Counted under ``deferred``."""
        from repro_torch.core.schedule_ir import cache_seed

        sp = TRACER.start("store.warm_start", root=str(self.root)) \
            if TRACER else None
        try:
            evicted = self.evict_stale()
            lru_evicted = self.enforce_bounds()
            if budget_s is None:
                try:
                    budget_s = float(
                        os.environ.get("REPRO_STORE_VERIFY_BUDGET_S", "")
                        or 0)
                except ValueError:
                    budget_s = 0.0
            budget = DeadlineBudget(budget_s) \
                if (verify and budget_s and budget_s > 0) else None
            paths = self._artifact_paths()
            if budget is not None:
                # newest artifacts verify first; the tail defers
                paths.sort(key=self._mtime_key, reverse=True)
            entries: dict[tuple, object] = {}
            recipes: dict[tuple, dict] = {}
            corrupt = rejected = deferred = races = 0
            for path in paths:
                try:
                    with np.load(path, allow_pickle=False) as z:
                        header = json.loads(str(z["header"][()]))
                    if header["kind"] == "schedule":
                        header, cs = self._load_schedule(path)
                        if verify:
                            if budget is not None and budget.expired():
                                deferred += 1
                                with self._lock:
                                    self._verify_deferred.add(str(path))
                                TRACER.event("store.verify_deferred",
                                             path=str(path))
                                continue
                            if not self._statically_ok(header, cs):
                                rejected += 1
                                path.unlink(missing_ok=True)
                                continue
                        entries[tuple(header["key"])] = cs
                    else:
                        header, rec = self._load_recipe(path)
                        recipes[tuple(header["key"])] = rec
                except FileNotFoundError:
                    # concurrent evictor won the race mid-walk: a miss,
                    # not corruption
                    races += 1
                    _count_read_race("enoent")
                except Exception:
                    corrupt += 1
                    path.unlink(missing_ok=True)
            seeded = cache_seed(entries, recipes, resident=True)
            if reset_selector:
                from repro_torch.core.selector import selector_cache_reset

                selector_cache_reset()
            report = {
                "schedules": len(entries),
                "recipes": len(recipes),
                "seeded": seeded,
                "evicted": evicted,
                "lru_evicted": lru_evicted,
                "corrupt": corrupt,
                "rejected": rejected,
                "deferred": deferred,
                "read_races": races,
            }
            obs_metrics.counter("store.warm_start.schedules").inc(
                len(entries))
            obs_metrics.counter("store.warm_start.recipes").inc(len(recipes))
            obs_metrics.counter("store.warm_start.evicted").inc(
                evicted + corrupt + rejected)
            obs_metrics.counter("store.warm_start.deferred").inc(deferred)
        except BaseException:
            if sp:
                TRACER.finish(sp, outcome="error")
            raise
        if sp:
            TRACER.finish(sp, **report)
        return report

    @staticmethod
    def _mtime_key(path: Path) -> tuple:
        try:
            return (path.stat().st_mtime, str(path))
        except OSError:
            return (0.0, str(path))

    @staticmethod
    def _statically_ok(header: dict, cs) -> bool:
        """``warm_start(verify=True)`` gate: a loaded schedule must pass
        the static analyzer's error-severity checks before it may be
        seeded into the process cache.  The node partitioning comes from
        the cache key (``key[3]`` is ``procs_per_node``); budget checks
        default to warnings, so only structural corruption (bad CSR,
        rank out of range, dead messages, broken conservation) rejects.
        Fault-degraded artifacts (``key[10]`` set) skip the conservation
        gate: a reverted repair legitimately fails degraded budgets, and
        relay rewrites re-apportion payloads."""
        from repro_torch.core.analyze import analyze_schedule

        key = header.get("key") or []
        if len(key) > 10 and key[10] is not None:
            return True
        n = int(key[3]) if len(key) > 3 else None
        try:
            report = analyze_schedule(cs, procs_per_node=n)
        except Exception:
            return False
        if not report.ok:
            obs_metrics.counter("store.warm_start.rejects").inc()
            return False
        return True

    # -- maintenance ------------------------------------------------------

    def entries(self) -> list[dict]:
        """Headers of every readable artifact (diagnostics/tests)."""
        out = []
        for path in self._artifact_paths():
            try:
                with np.load(path, allow_pickle=False) as z:
                    header = json.loads(str(z["header"][()]))
                header["path"] = str(path)
                out.append(header)
            except Exception:
                continue
        return out

    def clear(self) -> None:
        """Delete the store directory tree."""
        import shutil

        shutil.rmtree(self.root, ignore_errors=True)
