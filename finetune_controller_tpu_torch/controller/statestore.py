"""Async document state store — the control plane's source of truth.

Capability parity with the reference's ``MongoDBManager`` (``app/database/db.py``,
710 LoC — SURVEY.md §2 component 7): jobs / metrics / datasets / archived_jobs
collections, indexed lookups, paginated job queries with server-side computed
fields, metadata merge on status updates, archive-on-delete. The engine is an
embedded document store instead of an external MongoDB server — the reference's
Mongo is an external C++ process (SURVEY.md §2.2), so "external document store"
is the delegation seam we replace with an embedded one. The public API is
transport-agnostic, so a Mongo-backed implementation can be swapped in behind
the same interface.

Two engines behind one interface:

- ``sqlite`` (default when a state dir is given) — one WAL-mode SQLite file,
  a table per collection, every read served from the database and every
  read-modify-write inside a ``BEGIN IMMEDIATE`` transaction.  This is the
  **multi-process-safe** engine: the deployed layout runs the API server and
  the monitor as separate processes against one state dir, exactly like the
  reference's two deployments share one MongoDB (``app/database/db.py:51``,
  ``Dockerfile.monitor:30``), so job state written by the monitor must be
  immediately visible to — and never clobbered by — the API process.
- ``jsonl`` — append-only JSONL log + in-memory indexes.  Single-process
  only (no cross-process locking or reload); kept for inspectability and as
  the in-memory engine's persistence format.

Fixes a reference wart on the way: the monitor's N+1 per-job DB reads
(``app/core/monitor.py:151-158``) are avoided by :meth:`StateStore.get_jobs_by_ids`.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import sqlite3
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Callable

from .schemas import (
    DatabaseStatus,
    DatasetRecord,
    JobRecord,
    MetricsDocument,
    PaginatedTableResponse,
    PromotionStatus,
)


def generate_short_uuid() -> str:
    """8-char lowercase job-id suffix (reference: ``app/utils/naming.py:4-6``)."""
    return uuid.uuid4().hex[:8]


class Collection:
    """One named document collection with unique-key index and file persistence.

    Persistence is an append-only JSONL log: each write appends the changed
    document (or a ``{"__tombstone__": key}`` record for deletes); load replays
    the log last-record-wins. The log compacts in place once it grows past
    ~4x the live document count, so a single write is O(doc) amortised rather
    than O(collection) — the monitor's per-tick status updates stay cheap even
    with thousands of accumulated jobs. All file I/O runs off the event loop.
    """

    _COMPACT_MIN_RECORDS = 1024

    def __init__(self, path: Path | None, key: str, index_fields: tuple[str, ...] = ()):
        self._path = path
        self._key = key
        self._docs: dict[str, dict[str, Any]] = {}
        self._lock = asyncio.Lock()
        self._loaded = False
        self._log_records = 0
        # secondary equality indexes: field -> value -> set of primary keys
        # (reference: Mongo ``_ensure_indexes``, ``db.py:77-105``)
        self._index_fields = index_fields
        self._index: dict[str, dict[Any, set[str]]] = {f: {} for f in index_fields}

    def _index_add(self, doc: dict[str, Any]) -> None:
        for f in self._index_fields:
            self._index[f].setdefault(doc.get(f), set()).add(doc[self._key])

    def _index_remove(self, doc: dict[str, Any]) -> None:
        for f in self._index_fields:
            bucket = self._index[f].get(doc.get(f))
            if bucket is not None:
                bucket.discard(doc[self._key])
                if not bucket:
                    del self._index[f][doc.get(f)]

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        if self._path is not None and self._path.exists():
            with self._path.open() as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    self._log_records += 1
                    if "__tombstone__" in rec:
                        old = self._docs.pop(rec["__tombstone__"], None)
                        if old is not None:
                            self._index_remove(old)
                    else:
                        old = self._docs.get(rec[self._key])
                        if old is not None:
                            self._index_remove(old)
                        # ftc: ignore[lock-discipline] -- every caller holds the collection's asyncio lock ACROSS its to_thread hop, so the loader thread and loop-side writers are serialized by it
                        self._docs[rec[self._key]] = rec
                        self._index_add(rec)

    def _append(self, record: dict[str, Any]) -> None:
        if self._path is None:
            return
        self._path.parent.mkdir(parents=True, exist_ok=True)
        with self._path.open("a") as f:
            f.write(json.dumps(record) + "\n")
        self._log_records += 1
        if self._log_records >= max(self._COMPACT_MIN_RECORDS, 4 * len(self._docs)):
            self._compact()

    def _compact(self) -> None:
        tmp = self._path.with_suffix(".tmp")
        with tmp.open("w") as f:
            for doc in self._docs.values():
                f.write(json.dumps(doc) + "\n")
        tmp.replace(self._path)
        self._log_records = len(self._docs)

    async def insert(self, doc: dict[str, Any]) -> None:
        async with self._lock:
            await asyncio.to_thread(self._load)
            doc = dict(doc)
            old = self._docs.get(doc[self._key])
            if old is not None:
                self._index_remove(old)
            self._docs[doc[self._key]] = doc
            self._index_add(doc)
            await asyncio.to_thread(self._append, doc)

    async def get(self, key: str) -> dict[str, Any] | None:
        async with self._lock:
            await asyncio.to_thread(self._load)
            doc = self._docs.get(key)
            return dict(doc) if doc else None

    async def update(self, key: str, fields: dict[str, Any]) -> bool:
        """Atomic set of top-level fields (reference: Mongo ``update_one`` with
        ``$set``, ``db.py:217-219``)."""
        async with self._lock:
            await asyncio.to_thread(self._load)
            doc = self._docs.get(key)
            if doc is None:
                return False
            self._index_remove(doc)
            doc.update(fields)
            self._index_add(doc)
            await asyncio.to_thread(self._append, doc)
            return True

    async def update_if(
        self,
        key: str,
        fields: dict[str, Any],
        predicate: Callable[[dict[str, Any]], bool],
    ) -> bool:
        """Compare-and-set: apply ``fields`` only when ``predicate(doc)`` holds,
        read and write under the collection lock (the guard+transition pattern
        concurrent HTTP handlers need — a bare read-then-update has an await
        window where a second request slips through)."""
        async with self._lock:
            await asyncio.to_thread(self._load)
            doc = self._docs.get(key)
            if doc is None or not predicate(doc):
                return False
            self._index_remove(doc)
            doc.update(fields)
            self._index_add(doc)
            await asyncio.to_thread(self._append, doc)
            return True

    async def merge_subdoc(self, key: str, field: str, patch: dict[str, Any]) -> bool:
        """Last-writer-wins merge into a dict field (reference metadata merge,
        ``db.py:206-215``)."""
        async with self._lock:
            await asyncio.to_thread(self._load)
            doc = self._docs.get(key)
            if doc is None:
                return False
            sub = dict(doc.get(field) or {})
            sub.update(patch)
            doc[field] = sub
            await asyncio.to_thread(self._append, doc)
            return True

    async def append_to_list(
        self,
        key: str,
        field: str,
        item: dict[str, Any],
        dedupe_key: str | None = None,
    ) -> bool:
        """Atomic append to a list field.  ``dedupe_key`` makes the append
        idempotent: when an existing element carries the same ``"key"`` the
        append is skipped (False) — the exactly-once handle the job event
        timeline rides (docs/observability.md)."""
        async with self._lock:
            await asyncio.to_thread(self._load)
            doc = self._docs.get(key)
            if doc is None:
                return False
            items = list(doc.get(field) or [])
            if dedupe_key is not None and any(
                isinstance(e, dict) and e.get("key") == dedupe_key
                for e in items
            ):
                return False
            items.append(item)
            doc[field] = items
            await asyncio.to_thread(self._append, doc)
            return True

    async def extend_list(
        self, key: str, field: str, new_items: list[dict[str, Any]]
    ) -> int:
        """Batch append: every item is deduped on its ``"key"`` (against the
        stored list AND within the batch), all survivors land in ONE write —
        the trainer-event ingest's per-event-RMW fix.  Returns the number
        appended (0 when the doc is gone or everything was a duplicate)."""
        async with self._lock:
            await asyncio.to_thread(self._load)
            doc = self._docs.get(key)
            if doc is None:
                return 0
            items = list(doc.get(field) or [])
            seen = {
                e.get("key") for e in items
                if isinstance(e, dict) and e.get("key") is not None
            }
            added = 0
            for item in new_items:
                k = item.get("key")
                if k is not None and k in seen:
                    continue
                if k is not None:
                    seen.add(k)
                items.append(item)
                added += 1
            if added:
                doc[field] = items
                await asyncio.to_thread(self._append, doc)
            return added

    async def delete(self, key: str) -> dict[str, Any] | None:
        async with self._lock:
            await asyncio.to_thread(self._load)
            doc = self._docs.pop(key, None)
            if doc is not None:
                self._index_remove(doc)
                await asyncio.to_thread(self._append, {"__tombstone__": key})
            return doc

    async def find(
        self,
        predicate: Callable[[dict[str, Any]], bool] | None = None,
        *,
        eq: dict[str, Any] | None = None,
    ) -> list[dict[str, Any]]:
        """``eq`` filters on indexed fields WITHOUT scanning the collection
        (the in-memory-index promise); ``predicate`` refines the candidates."""
        async with self._lock:
            await asyncio.to_thread(self._load)
            if eq:
                keys: set[str] | None = None
                for f, v in eq.items():
                    if f not in self._index:
                        raise KeyError(f"field {f!r} is not indexed on this collection")
                    bucket = self._index[f].get(v, set())
                    keys = bucket if keys is None else keys & bucket
                # primary-key order: set iteration is hash-randomized, and
                # paginated callers need a deterministic tie-break
                docs = [dict(self._docs[k]) for k in sorted(keys or ())]
            else:
                docs = [dict(d) for d in self._docs.values()]
        if predicate is not None:
            docs = [d for d in docs if predicate(d)]
        return docs

    async def count(
        self, predicate: Callable[[dict[str, Any]], bool] | None = None
    ) -> int:
        return len(await self.find(predicate))


class _SqliteDB:
    """One shared WAL-mode SQLite database holding every collection's table.

    All statements run on worker threads (via ``asyncio.to_thread``) under a
    process-local mutex — SQLite's cross-PROCESS coordination is the WAL +
    busy-timeout machinery; the mutex only serializes this process's threads
    over the single connection.
    """

    def __init__(self, path: Path):
        self._path = path
        self._lock = threading.Lock()
        self._conn: sqlite3.Connection | None = None
        self._pid: int | None = None

    def run(self, fn: Callable[[sqlite3.Connection], Any]) -> Any:
        with self._lock:
            if self._conn is None or self._pid != os.getpid():
                # (re)connect lazily; a forked child must not reuse the
                # parent's connection (sqlite documents this as corruption)
                self._path.parent.mkdir(parents=True, exist_ok=True)
                # The WAL switch on a brand-new database can report "database
                # is locked" when sibling worker processes race it at boot
                # (observed killing a --workers fork under load); it succeeds
                # on the sibling's heels, so retry the CONNECT PHASE only —
                # a locked error out of fn() itself propagates as before.
                for attempt in range(5):
                    conn = sqlite3.connect(
                        self._path, timeout=30.0, check_same_thread=False,
                        isolation_level=None,  # autocommit; RMW uses BEGIN IMMEDIATE
                    )
                    try:
                        conn.execute("PRAGMA journal_mode=WAL")
                        conn.execute("PRAGMA synchronous=NORMAL")
                        conn.execute("PRAGMA busy_timeout=30000")
                    except sqlite3.OperationalError:
                        conn.close()
                        if attempt == 4:
                            raise
                        time.sleep(0.05 * (2 ** attempt))
                        continue
                    break
                self._conn, self._pid = conn, os.getpid()
            return fn(self._conn)

    def close(self) -> None:
        with self._lock:
            if self._conn is not None and self._pid == os.getpid():
                self._conn.close()
            self._conn = None


class SqliteCollection:
    """``Collection``-compatible engine over a shared :class:`_SqliteDB`.

    Every read goes to the database (no in-memory cache to go stale under a
    concurrent writer process) and every read-modify-write runs inside a
    ``BEGIN IMMEDIATE`` transaction, so two processes interleaving
    ``update``/``update_if``/``merge_subdoc`` cannot lose each other's writes.
    """

    def __init__(self, db: _SqliteDB, name: str, key: str,
                 index_fields: tuple[str, ...] = ()):
        self._db = db
        self._name = name
        self._key = key
        self._index_fields = index_fields
        self._ready = False

    def _ensure(self, conn: sqlite3.Connection) -> None:
        if self._ready:
            return
        conn.execute(
            f'CREATE TABLE IF NOT EXISTS "{self._name}" '
            "(key TEXT PRIMARY KEY, doc TEXT NOT NULL)"
        )
        for f in self._index_fields:
            # expression index = the Mongo secondary index of the jsonl engine
            conn.execute(
                f'CREATE INDEX IF NOT EXISTS "idx_{self._name}_{f}" '
                f"ON \"{self._name}\" (json_extract(doc, '$.{f}'))"
            )
        self._ready = True

    async def insert(self, doc: dict[str, Any]) -> None:
        doc = dict(doc)

        def op(conn: sqlite3.Connection) -> None:
            self._ensure(conn)
            conn.execute(
                f'INSERT INTO "{self._name}" (key, doc) VALUES (?, ?) '
                "ON CONFLICT(key) DO UPDATE SET doc = excluded.doc",
                (doc[self._key], json.dumps(doc)),
            )

        await asyncio.to_thread(self._db.run, op)

    async def get(self, key: str) -> dict[str, Any] | None:
        def op(conn: sqlite3.Connection) -> dict[str, Any] | None:
            self._ensure(conn)
            row = conn.execute(
                f'SELECT doc FROM "{self._name}" WHERE key = ?', (key,)
            ).fetchone()
            return json.loads(row[0]) if row else None

        return await asyncio.to_thread(self._db.run, op)

    def _rmw(
        self,
        key: str,
        mutate: Callable[[dict[str, Any]], dict[str, Any] | None],
    ) -> bool:
        """Transactional read-modify-write; ``mutate`` returns the new doc or
        ``None`` to abort (predicate failed)."""

        def op(conn: sqlite3.Connection) -> bool:
            self._ensure(conn)
            conn.execute("BEGIN IMMEDIATE")
            try:
                row = conn.execute(
                    f'SELECT doc FROM "{self._name}" WHERE key = ?', (key,)
                ).fetchone()
                if row is None:
                    conn.execute("ROLLBACK")
                    return False
                new = mutate(json.loads(row[0]))
                if new is None:
                    conn.execute("ROLLBACK")
                    return False
                conn.execute(
                    f'UPDATE "{self._name}" SET doc = ? WHERE key = ?',
                    (json.dumps(new), key),
                )
                conn.execute("COMMIT")
                return True
            except BaseException:
                conn.execute("ROLLBACK")
                raise

        return self._db.run(op)

    async def update(self, key: str, fields: dict[str, Any]) -> bool:
        return await asyncio.to_thread(
            self._rmw, key, lambda doc: {**doc, **fields}
        )

    async def update_if(
        self,
        key: str,
        fields: dict[str, Any],
        predicate: Callable[[dict[str, Any]], bool],
    ) -> bool:
        return await asyncio.to_thread(
            self._rmw, key,
            lambda doc: {**doc, **fields} if predicate(doc) else None,
        )

    async def merge_subdoc(self, key: str, field: str, patch: dict[str, Any]) -> bool:
        def mutate(doc: dict[str, Any]) -> dict[str, Any]:
            sub = dict(doc.get(field) or {})
            sub.update(patch)
            return {**doc, field: sub}

        return await asyncio.to_thread(self._rmw, key, mutate)

    async def append_to_list(
        self,
        key: str,
        field: str,
        item: dict[str, Any],
        dedupe_key: str | None = None,
    ) -> bool:
        """Jsonl-engine parity: transactional list append with idempotency
        (the read and the deduped write share one ``BEGIN IMMEDIATE``)."""

        def mutate(doc: dict[str, Any]) -> dict[str, Any] | None:
            items = list(doc.get(field) or [])
            if dedupe_key is not None and any(
                isinstance(e, dict) and e.get("key") == dedupe_key
                for e in items
            ):
                return None
            return {**doc, field: items + [item]}

        return await asyncio.to_thread(self._rmw, key, mutate)

    async def extend_list(
        self, key: str, field: str, new_items: list[dict[str, Any]]
    ) -> int:
        """Jsonl-engine parity: batch list append, per-item ``"key"`` dedupe,
        one transaction.  Returns the number appended."""
        added = 0

        def mutate(doc: dict[str, Any]) -> dict[str, Any] | None:
            nonlocal added
            added = 0
            items = list(doc.get(field) or [])
            seen = {
                e.get("key") for e in items
                if isinstance(e, dict) and e.get("key") is not None
            }
            for item in new_items:
                k = item.get("key")
                if k is not None and k in seen:
                    continue
                if k is not None:
                    seen.add(k)
                items.append(item)
                added += 1
            if not added:
                return None
            return {**doc, field: items}

        await asyncio.to_thread(self._rmw, key, mutate)
        return added

    async def delete(self, key: str) -> dict[str, Any] | None:
        def op(conn: sqlite3.Connection) -> dict[str, Any] | None:
            self._ensure(conn)
            conn.execute("BEGIN IMMEDIATE")
            try:
                row = conn.execute(
                    f'SELECT doc FROM "{self._name}" WHERE key = ?', (key,)
                ).fetchone()
                if row is None:
                    conn.execute("ROLLBACK")
                    return None
                conn.execute(
                    f'DELETE FROM "{self._name}" WHERE key = ?', (key,)
                )
                conn.execute("COMMIT")
                return json.loads(row[0])
            except BaseException:
                conn.execute("ROLLBACK")
                raise

        return await asyncio.to_thread(self._db.run, op)

    async def find(
        self,
        predicate: Callable[[dict[str, Any]], bool] | None = None,
        *,
        eq: dict[str, Any] | None = None,
    ) -> list[dict[str, Any]]:
        def op(conn: sqlite3.Connection) -> list[dict[str, Any]]:
            self._ensure(conn)
            if eq:
                clauses, params = [], []
                for f, v in eq.items():
                    if f not in self._index_fields:
                        raise KeyError(
                            f"field {f!r} is not indexed on this collection"
                        )
                    # IS (not =) so eq-on-None matches missing/null fields,
                    # mirroring the jsonl engine's dict.get semantics
                    clauses.append(f"json_extract(doc, '$.{f}') IS ?")
                    params.append(v)
                rows = conn.execute(
                    f'SELECT doc FROM "{self._name}" '
                    f"WHERE {' AND '.join(clauses)} ORDER BY key",
                    params,
                ).fetchall()
            else:
                rows = conn.execute(
                    f'SELECT doc FROM "{self._name}" ORDER BY rowid'
                ).fetchall()
            return [json.loads(r[0]) for r in rows]

        docs = await asyncio.to_thread(self._db.run, op)
        if predicate is not None:
            docs = [d for d in docs if predicate(d)]
        return docs

    async def count(
        self, predicate: Callable[[dict[str, Any]], bool] | None = None
    ) -> int:
        return len(await self.find(predicate))


class StateStore:
    """Domain-level store over four collections (reference: ``MongoDBManager``).

    ``state_dir=None`` keeps everything in memory (the unit-test seam the
    reference never had).  With a state dir, ``backend`` picks the engine:
    ``"sqlite"`` (default; multi-process-safe WAL database) or ``"jsonl"``
    (single-process append-only log).  Existing jsonl state is migrated into
    the database on :meth:`connect`, so a round-2 state dir upgrades in place.
    """

    _COLLECTIONS: tuple[tuple[str, str, tuple[str, ...]], ...] = (
        ("jobs", "job_id", ("user_id", "status")),
        ("archived_jobs", "job_id", ()),
        ("metrics", "job_id", ()),
        ("datasets", "dataset_id", ("user_id",)),
    )

    def __init__(
        self,
        state_dir: Path | str | None = None,
        backend: str | None = None,
    ):
        self._dir = Path(state_dir).expanduser() if state_dir is not None else None
        if backend is None:
            backend = os.environ.get("FTC_STATE_BACKEND", "sqlite")
        if backend not in ("sqlite", "jsonl"):
            # a typo'd value silently running the single-process jsonl engine
            # under the two-process deployment would be exactly the
            # lost-update corruption the sqlite engine exists to prevent
            raise ValueError(
                f"unknown state backend {backend!r}: expected 'sqlite' or 'jsonl'"
            )
        self._backend = backend if self._dir is not None else "memory"
        self._db: _SqliteDB | None = None

        if self._dir is not None and self._backend == "sqlite":
            self._db = _SqliteDB(self._dir / "state.db")

            def make(name: str, key: str, idx: tuple[str, ...]):
                return SqliteCollection(self._db, name, key, idx)
        else:
            def make(name: str, key: str, idx: tuple[str, ...]):
                path = None if self._dir is None else self._dir / f"{name}.jsonl"
                return Collection(path, key, index_fields=idx)

        for name, key, idx in self._COLLECTIONS:
            setattr(self, name, make(name, key, idx))
        self._connected = False
        #: rate-limit windows for the memory/jsonl engines (per-process —
        #: the sqlite engine keeps them in the database, cross-process)
        self._mem_rate: dict[str, collections.deque] = {}

    # -- lifecycle (reference: connect/_ensure_indexes, db.py:33-105) --------

    async def connect(self) -> None:
        if self._dir is not None:
            self._dir.mkdir(parents=True, exist_ok=True)
            if self._backend == "sqlite":
                await self._migrate_jsonl()
        self._connected = True

    async def _migrate_jsonl(self) -> None:
        """One-way import of legacy jsonl logs into the sqlite engine.

        The emptiness check and the import run inside ONE ``BEGIN IMMEDIATE``
        transaction per collection: two processes starting concurrently must
        not both see "empty" and have the late importer resurrect stale
        legacy docs over the early one's fresh writes.  After the import the
        legacy log is renamed to ``*.jsonl.migrated`` — once sqlite owns the
        dir the jsonl is never authoritative again, so a later restart with a
        legitimately-empty table (all jobs archived) must not re-import
        deleted documents from it.
        """
        for name, key, idx in self._COLLECTIONS:
            legacy = self._dir / f"{name}.jsonl"
            coll = getattr(self, name)
            if not legacy.exists():
                continue
            old = Collection(legacy, key, index_fields=idx)
            docs = await old.find()

            def op(conn: sqlite3.Connection, coll=coll, docs=docs) -> None:
                coll._ensure(conn)
                conn.execute("BEGIN IMMEDIATE")
                try:
                    n = conn.execute(
                        f'SELECT COUNT(*) FROM "{coll._name}"'
                    ).fetchone()[0]
                    if n == 0:
                        for doc in docs:
                            conn.execute(
                                f'INSERT INTO "{coll._name}" (key, doc) '
                                "VALUES (?, ?)",
                                (doc[coll._key], json.dumps(doc)),
                            )
                    conn.execute("COMMIT")
                except BaseException:
                    conn.execute("ROLLBACK")
                    raise

            await asyncio.to_thread(self._db.run, op)
            try:
                legacy.rename(legacy.with_suffix(".jsonl.migrated"))
            except OSError:
                pass  # a concurrent starter renamed it first — fine

    async def close(self) -> None:
        if self._db is not None:
            await asyncio.to_thread(self._db.close)
        self._connected = False

    # -- jobs (reference: db.py:107-379) -------------------------------------

    async def create_job(self, job: JobRecord) -> None:
        await self.jobs.insert(job.model_dump(mode="json"))

    async def get_job(self, job_id: str) -> JobRecord | None:
        doc = await self.jobs.get(job_id)
        return JobRecord(**doc) if doc else None

    async def get_jobs_by_ids(self, job_ids: list[str]) -> dict[str, JobRecord]:
        """Batch fetch — kills the reference monitor's N+1 pattern
        (``app/core/monitor.py:151-158``)."""
        wanted = set(job_ids)
        docs = await self.jobs.find(lambda d: d["job_id"] in wanted)
        return {d["job_id"]: JobRecord(**d) for d in docs}

    async def get_active_jobs(self) -> list[JobRecord]:
        """Every job not in a final state — the monitor's lost-job sweep input."""
        final = {s.value for s in DatabaseStatus.final_states()}
        docs = await self.jobs.find(lambda d: d["status"] not in final)
        return [JobRecord(**d) for d in docs]

    async def get_jobs_by_status(self, status: DatabaseStatus) -> list[JobRecord]:
        """Indexed status lookup — the retry supervisor polls for RETRYING
        jobs every monitor tick, which must not scan the whole collection."""
        docs = await self.jobs.find(eq={"status": DatabaseStatus(status).value})
        return [JobRecord(**d) for d in docs]

    async def update_job_status(
        self,
        job_id: str,
        status: DatabaseStatus,
        *,
        metadata: dict[str, Any] | None = None,
        **fields: Any,
    ) -> bool:
        """Status update + metadata merge (reference: ``db.py:195-228``)."""
        ok = await self.jobs.update(
            job_id,
            {"status": DatabaseStatus(status).value, **_jsonify(fields)},
        )
        if ok and metadata:
            await self.jobs.merge_subdoc(job_id, "metadata", _jsonify(metadata))
        return ok

    async def transition_job_status(
        self,
        job_id: str,
        expect: DatabaseStatus,
        status: DatabaseStatus,
        *,
        metadata: dict[str, Any] | None = None,
        **fields: Any,
    ) -> bool:
        """Compare-and-set status transition: applies only while the job is
        still in ``expect``.  The retry supervisor's resubmit path needs this
        — a user cancel landing inside the resubmit's await window must not
        be silently overwritten back to QUEUED."""
        ok = await self.jobs.update_if(
            job_id,
            {"status": DatabaseStatus(status).value, **_jsonify(fields)},
            lambda doc: doc.get("status") == DatabaseStatus(expect).value,
        )
        if ok and metadata:
            await self.jobs.merge_subdoc(job_id, "metadata", _jsonify(metadata))
        return ok

    async def update_job_promotion(
        self,
        job_id: str,
        promotion_status: PromotionStatus,
        promotion_uri: str | None = None,
    ) -> bool:
        """Reference: ``db.py:230-255``."""
        fields: dict[str, Any] = {
            "promotion_status": PromotionStatus(promotion_status).value
        }
        if promotion_uri is not None:
            fields["promotion_uri"] = promotion_uri
        return await self.jobs.update(job_id, fields)

    async def begin_promotion(
        self,
        job_id: str,
        promotion_status: PromotionStatus,
        promotion_uri: str,
        expect_from: list[PromotionStatus | str] | None = None,
    ) -> bool:
        """Atomically claim a promote/unpromote transition: succeeds only if no
        transition is already in flight AND (when ``expect_from`` is given) the
        current state is one of the expected sources. Returns False when
        another request won or the state moved underneath the caller —
        promote-while-DELETING and unpromote-while-IN_PROGRESS lose here, in
        the store's consistency domain, not in handler guards racing on
        awaits."""
        in_flight = {
            PromotionStatus.IN_PROGRESS.value,
            PromotionStatus.DELETING.value,
        }
        expect = (
            None if expect_from is None
            else {PromotionStatus(s).value for s in expect_from}
        )

        def ok(doc: dict) -> bool:
            cur = doc.get("promotion_status")
            if cur in in_flight:
                return False
            return expect is None or cur in expect

        return await self.jobs.update_if(
            job_id,
            {
                "promotion_status": PromotionStatus(promotion_status).value,
                "promotion_uri": promotion_uri,
            },
            ok,
        )

    async def transition_job_promotion(
        self,
        job_id: str,
        expect: list[PromotionStatus | str],
        promotion_status: PromotionStatus,
        promotion_uri: str | None = None,
    ) -> bool:
        """Compare-and-set promotion transition (the job-status CAS shape):
        applies only while the job is still in one of ``expect``.  The
        promotion task's completion writes need this — a crash-recovery sweep
        or a concurrent unpromote landing mid-copy must not be stomped by the
        stale task's final blind write."""
        vals = {PromotionStatus(s).value for s in expect}
        fields: dict[str, Any] = {
            "promotion_status": PromotionStatus(promotion_status).value
        }
        if promotion_uri is not None:
            fields["promotion_uri"] = promotion_uri
        return await self.jobs.update_if(
            job_id, fields, lambda doc: doc.get("promotion_status") in vals
        )

    async def update_job_fields(self, job_id: str, **fields: Any) -> bool:
        return await self.jobs.update(job_id, _jsonify(fields))

    async def append_job_event(self, job_id: str, event: dict[str, Any]) -> bool:
        """Append one lifecycle event to the job's timeline
        (docs/observability.md).  Idempotent on ``event["key"]`` — an
        emitter that retries after a crash converges to exactly one event
        per transition instance.  False when the job is gone or the key was
        already recorded."""
        return await self.jobs.append_to_list(
            job_id, "events", event, dedupe_key=event.get("key")
        )

    async def append_job_events(
        self, job_id: str, events: list[dict[str, Any]]
    ) -> int:
        """Batch timeline append — same idempotency per event ``key``, ONE
        document write for the whole batch (the monitor's trainer-event
        ingest folds every new ``events.jsonl`` row per tick through this,
        instead of a doc-rewriting RMW per event).  Returns the number of
        events actually appended."""
        if not events:
            return 0
        return await self.jobs.extend_list(job_id, "events", events)

    async def merge_job_metadata(self, job_id: str, patch: dict[str, Any]) -> bool:
        """Metadata-only merge WITHOUT touching the status field — for
        bookkeeping writers (the monitor's trainer-event ingest watermark)
        that must never race a concurrent status transition back to a stale
        value."""
        return await self.jobs.merge_subdoc(job_id, "metadata", _jsonify(patch))

    async def find_jobs_with_promotion_in(
        self, states: list[PromotionStatus | str]
    ) -> list[JobRecord]:
        """Jobs whose promotion_status is in ``states`` — the promotion
        manager's crash-recovery sweep (kept a domain method so the remote
        state service can serve it; predicates don't cross the wire)."""
        vals = {PromotionStatus(s).value for s in states}
        docs = await self.jobs.find(
            lambda d: d.get("promotion_status") in vals
        )
        return [JobRecord(**d) for d in docs]

    async def get_user_jobs(
        self,
        user_id: str | None,
        *,
        page: int = 1,
        page_size: int = 20,
        status: DatabaseStatus | None = None,
        search: str | None = None,
        sort_by: str = "submitted_at",
        descending: bool = True,
    ) -> PaginatedTableResponse:
        """Paginated job table with computed fields.

        Mirrors the reference's server-side aggregation pipeline
        (``db.py:282-379`` + ``_job_pipeline_add_fields`` ``db.py:381-517``):
        ``duration``, ``status_merged`` (status + promotion), and a stable
        ``index_`` row number; filtering by status and free-text search.
        ``user_id=None`` lists all users' jobs (the admin view,
        ``app/main.py:1099-1297``).
        """
        eq: dict[str, Any] = {}
        if user_id is not None:
            eq["user_id"] = user_id
        if status is not None:
            eq["status"] = DatabaseStatus(status).value
        docs = await self.jobs.find(eq=eq or None)
        if search:
            needle = search.lower()
            docs = [
                d
                for d in docs
                if needle in d["job_id"].lower() or needle in d["model_name"].lower()
            ]
        docs.sort(key=lambda d: (d.get(sort_by) is None, d.get(sort_by)), reverse=descending)
        total = len(docs)
        lo = max(page - 1, 0) * page_size
        page_docs = docs[lo : lo + page_size]
        now = time.time()
        items = []
        for i, d in enumerate(page_docs):
            start, end = d.get("start_time"), d.get("end_time")
            duration = None
            if start is not None:
                duration = (end if end is not None else now) - start
            status_merged = d["status"]
            if d.get("promotion_status") not in (None, PromotionStatus.NOT_PROMOTED.value):
                status_merged = f"{d['status']}/{d['promotion_status']}"
            items.append(
                {**d, "duration": duration, "status_merged": status_merged,
                 "index_": lo + i}
            )
        return PaginatedTableResponse(
            total=total, page=page, page_size=page_size, items=items
        )

    async def purge_job(self, job_id: str) -> bool:
        """Hard-delete without archiving — submission rollback only."""
        return (await self.jobs.delete(job_id)) is not None

    async def delete_job(self, job_id: str) -> bool:
        """Archive-on-delete (reference: ``db.py:519-526``)."""
        doc = await self.jobs.delete(job_id)
        if doc is None:
            return False
        doc["archived_at"] = time.time()
        await self.archived_jobs.insert(doc)
        await self.metrics.delete(job_id)
        return True

    # -- metrics (reference: db.py:150-193,528) -------------------------------

    async def upsert_metrics(self, metrics: MetricsDocument) -> None:
        await self.metrics.insert(metrics.model_dump(mode="json"))

    async def get_metrics(self, job_id: str) -> MetricsDocument | None:
        doc = await self.metrics.get(job_id)
        return MetricsDocument(**doc) if doc else None

    # -- datasets (reference: db.py:534-706) ----------------------------------

    async def insert_dataset(self, dataset: DatasetRecord) -> None:
        await self.datasets.insert(dataset.model_dump(mode="json"))

    async def get_dataset(self, dataset_id: str) -> DatasetRecord | None:
        doc = await self.datasets.get(dataset_id)
        return DatasetRecord(**doc) if doc else None

    async def get_user_datasets(self, user_id: str) -> list[DatasetRecord]:
        docs = await self.datasets.find(eq={"user_id": user_id})
        docs.sort(key=lambda d: d["created_at"], reverse=True)
        return [DatasetRecord(**d) for d in docs]

    async def add_dataset_job_ref(self, dataset_id: str, job_id: str) -> bool:
        """Append a job reference (reference: ``db.py:681-699``)."""
        doc = await self.datasets.get(dataset_id)
        if doc is None:
            return False
        refs = list(doc.get("job_refs") or [])
        if job_id not in refs:
            refs.append(job_id)
        return await self.datasets.update(dataset_id, {"job_refs": refs})

    async def delete_dataset(self, dataset_id: str) -> bool:
        return (await self.datasets.delete(dataset_id)) is not None

    # -- rate limiting --------------------------------------------------------

    async def rate_limit_acquire(
        self, key: str, limit: int, window_s: float = 60.0
    ) -> bool:
        """Sliding-window rate-limit check-and-record, atomic in this store's
        consistency domain: memory/jsonl → per-process (dev), sqlite → all
        processes sharing the state dir, the remote state service → the whole
        cluster (the reference's per-process slowapi limits multiply by the
        worker count — ``app/main.py:377,525,714``; here the scope follows
        the store)."""
        if limit <= 0:
            return True
        now = time.time()
        if self._db is not None:
            # periodic prune: anonymous users key on client IP, so a scanned
            # deployment accumulates one row per distinct IP — fully-stale
            # rows (last hit older than their own window) are swept every
            # few hundred acquires instead of on every hot-path transaction
            self._rate_ops = getattr(self, "_rate_ops", 0) + 1
            prune = self._rate_ops % 512 == 0

            def op(conn: sqlite3.Connection) -> bool:
                conn.execute(
                    'CREATE TABLE IF NOT EXISTS "rate_limits" '
                    "(key TEXT PRIMARY KEY, hits TEXT NOT NULL, "
                    "last_hit REAL NOT NULL DEFAULT 0, "
                    "window_s REAL NOT NULL DEFAULT 60)"
                )
                conn.execute("BEGIN IMMEDIATE")
                try:
                    if prune:
                        conn.execute(
                            'DELETE FROM "rate_limits" '
                            "WHERE last_hit + window_s < ?", (now,)
                        )
                    row = conn.execute(
                        'SELECT hits FROM "rate_limits" WHERE key = ?', (key,)
                    ).fetchone()
                    hits = [
                        t for t in (json.loads(row[0]) if row else [])
                        if t > now - window_s
                    ]
                    ok = len(hits) < limit
                    if ok:
                        hits.append(now)
                    conn.execute(
                        'INSERT INTO "rate_limits" '
                        "(key, hits, last_hit, window_s) VALUES (?, ?, ?, ?) "
                        "ON CONFLICT(key) DO UPDATE SET hits = excluded.hits, "
                        "last_hit = excluded.last_hit, "
                        "window_s = excluded.window_s",
                        (key, json.dumps(hits), now, window_s),
                    )
                    conn.execute("COMMIT")
                    return ok
                except BaseException:
                    conn.execute("ROLLBACK")
                    raise

            return await asyncio.to_thread(self._db.run, op)

        if len(self._mem_rate) > 10_000:
            # sweep fully-stale keys so distinct clients don't grow forever
            stale = [
                k for k, dq in self._mem_rate.items()
                if not dq or dq[-1] <= now - window_s
            ]
            for k in stale:
                del self._mem_rate[k]
        q = self._mem_rate.setdefault(key, collections.deque())
        while q and q[0] <= now - window_s:
            q.popleft()
        if len(q) >= limit:
            return False
        q.append(now)
        return True


def _jsonify(fields: dict[str, Any]) -> dict[str, Any]:
    return {
        k: (v.value if isinstance(v, (DatabaseStatus, PromotionStatus)) else v)
        for k, v in fields.items()
    }
