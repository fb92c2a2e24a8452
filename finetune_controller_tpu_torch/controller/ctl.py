"""``ftc-ctl`` — terminal client for the control-plane API (counterpart of
``controller/ctl.py``, on the standard library's ``urllib``).

Submit, watch, stream logs, fetch metrics, promote — against any running
controller of either package (the port's ``controller/server.py`` answers
the same routes as the reference's).

    python -m finetune_controller_tpu_torch.controller.ctl [--api URL] [--token T] CMD ...

Commands:
    models                              list submittable models
    submit MODEL [--arg k=v ...] [--device D] [--task T] [--queue Q] [--priority P] [--dataset-file F | --dataset-url U | --dataset-id I] [--watch]
    jobs [--page N]                     paginated job table (incl. task type)
    queue                               tenant queues: usage/share/borrowed + pending
    serve                               serving sessions: slots/queue/tokens + prefix-cache hits
    status JOB_ID [--watch]             one job (``--watch`` polls to final)
    logs JOB_ID [--follow]              job logs (REST; --follow re-polls)
    metrics JOB_ID                      metrics rows (latest last)
    timeline JOB_ID                     lifecycle waterfall: where time went
    profile JOB_ID [--steps N]          arm the trainer's torch.profiler window on a live job
    artifacts JOB_ID [-o out.zip]       artifact inventory (or zip download)
    promote JOB_ID / unpromote JOB_ID
    cancel JOB_ID
    generate JOB_ID --tokens 1,2,3      decode from a promoted job's checkpoint
    dev-token [USER_ID]                 mint a dev token (local envs only)

Auth: ``--token`` or the FTC_CTL_TOKEN env var; the API URL defaults to
``FTC_CTL_API`` or http://localhost:8787.  The calls are synchronous;
``--watch`` and ``--follow`` poll every ``POLL_S`` seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any

FINAL_STATES = {"succeeded", "failed", "cancelled", "unknown"}
#: seconds between polls of ``--watch`` and ``--follow``
POLL_S = 2.0


class ApiError(RuntimeError):
    """HTTP-level failure; carries the status and any Retry-After hint so
    callers (``generate``'s bounded retry) can react without re-parsing."""

    def __init__(self, message: str, status: int = 0,
                 retry_after_s: float | None = None):
        super().__init__(message)
        self.status = status
        self.retry_after_s = retry_after_s


def _multipart(fields: dict[str, str], files: dict[str, tuple[str, bytes]]
               ) -> tuple[bytes, str]:
    boundary = f"ftcctl{os.urandom(8).hex()}"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
             f"{v}\r\n".encode() for k, v in fields.items()]
    for name, (filename, payload) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                     f'filename="{filename}"\r\nContent-Type: application/octet-stream'
                     f"\r\n\r\n".encode() + payload + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), \
        f"multipart/form-data; boundary={boundary}"


class Client:
    def __init__(self, base: str, token: str | None, timeout_s: float = 600.0):
        self.base = base.rstrip("/")
        self.token = token
        self.timeout_s = timeout_s

    def _open(self, method: str, path: str, *, params=None, json_body=None, data=None,
              content_type: str | None = None):
        url = f"{self.base}/api/v1{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        headers = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        if json_body is not None:
            data = json.dumps(json_body).encode()
            content_type = "application/json"
        if content_type:
            headers["Content-Type"] = content_type
        req = urllib.request.Request(url, data=data, method=method, headers=headers)
        try:
            return urllib.request.urlopen(req, timeout=self.timeout_s)
        except urllib.error.HTTPError as e:
            retry_after = None
            raw = e.headers.get("Retry-After") if e.headers else None
            if raw:
                try:
                    retry_after = float(raw)
                except ValueError:
                    pass  # HTTP-date form: ignore, callers fall back
            body = e.read().decode(errors="replace")
            raise ApiError(f"{method} {path} -> {e.code}: {body}", status=e.code,
                           retry_after_s=retry_after) from None

    def request(self, method: str, path: str, **kw) -> Any:
        with self._open(method, path, **kw) as resp:
            body = resp.read()
            if "json" in resp.headers.get("Content-Type", ""):
                return json.loads(body or b"null")
            return body.decode(errors="replace")

    def get(self, path: str, **kw) -> Any:
        return self.request("GET", path, **kw)

    def post(self, path: str, **kw) -> Any:
        return self.request("POST", path, **kw)

    def download(self, path: str, dest: str) -> None:
        """Stream a GET response body to ``dest``."""
        with self._open("GET", path) as resp, open(dest, "wb") as f:
            shutil.copyfileobj(resp, f, 1 << 20)


def _parse_args_kv(pairs: list[str]) -> dict[str, Any]:
    """k=v pairs with JSON-typed values (`lr=0.001 steps=50 name=run1`)."""
    out: dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--arg expects k=v, got {pair!r}")
        k, _, v = pair.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _print_json(obj: Any) -> None:
    print(json.dumps(obj, indent=2, default=str), flush=True)


def _watch_job(client: Client, job_id: str, interval_s: float | None = None) -> dict:
    last = None
    while True:
        job = client.get(f"/jobs/{job_id}")
        line = f"{job['status']}"
        if job.get("queue_position"):
            line += f" (queue #{job['queue_position']})"
        if line != last:
            print(f"[{time.strftime('%H:%M:%S')}] {line}", file=sys.stderr, flush=True)
            last = line
        if job["status"] in FINAL_STATES:
            return job
        time.sleep(POLL_S if interval_s is None else interval_s)


def cmd_submit(client: Client, ns: argparse.Namespace) -> int:
    arguments = _parse_args_kv(ns.arg or [])
    optional = {"device": ns.device, "task": ns.task, "queue": ns.queue,
                "priority": ns.priority}
    if ns.dataset_file:
        fields = {"model_name": ns.model, **{k: v for k, v in optional.items() if v},
                  "arguments": json.dumps(arguments)}
        with open(ns.dataset_file, "rb") as f:
            files = {"dataset_file": (os.path.basename(ns.dataset_file), f.read())}
        data, ctype = _multipart(fields, files)
        result = client.post("/jobs", data=data, content_type=ctype)
    else:
        body: dict[str, Any] = {"model_name": ns.model, "arguments": arguments}
        body.update({k: v for k, v in optional.items() if v})
        if ns.dataset_url:
            body["dataset_url"] = ns.dataset_url
        if ns.dataset_id:
            body["dataset_id"] = ns.dataset_id
        result = client.post("/jobs", json_body=body)
    _print_json(result)
    if ns.watch:
        job = _watch_job(client, result["job_id"])
        _print_json(job)
        return 0 if job["status"] == "succeeded" else 1
    return 0


def cmd_jobs(client: Client, ns: argparse.Namespace) -> int:
    page = client.get("/jobs", params={"page": str(ns.page)})
    rows = page.get("items", [])
    if not rows:
        print("no jobs")
        return 0
    width = max(len(r["job_id"]) for r in rows)
    for r in rows:
        dur = r.get("duration") or ""
        # the task type rides the job metadata (task_builder)
        task = (r.get("metadata") or {}).get("task") or ""
        print(f"{r['job_id']:<{width}}  {task:<12}  {r['status']:<10}  {dur}")
    print(f"(page {ns.page}, total {page.get('total')})")
    return 0


def cmd_status(client: Client, ns: argparse.Namespace) -> int:
    if ns.watch:
        job = _watch_job(client, ns.job_id)
        _print_json(job)
        return 0 if job["status"] == "succeeded" else 1
    _print_json(client.get(f"/jobs/{ns.job_id}"))
    return 0


def cmd_logs(client: Client, ns: argparse.Namespace) -> int:
    def fetch_new(seen: int) -> int:
        body = client.get(f"/jobs/{ns.job_id}/logs")
        lines = body.get("lines", []) if isinstance(body, dict) else body.splitlines()
        for line in lines[seen:]:
            print(line)
        return len(lines)

    seen = fetch_new(0)
    if not ns.follow:
        return 0
    while True:
        job = client.get(f"/jobs/{ns.job_id}")
        if job["status"] in FINAL_STATES:
            # drain the tail once more so lines written since the last fetch
            # are not dropped
            fetch_new(seen)
            return 0
        time.sleep(POLL_S)
        seen = fetch_new(seen)


def cmd_queue(client: Client, ns: argparse.Namespace) -> int:
    """Tenant-queue table from ``GET /admin/scheduler``: usage, weighted
    dominant share, borrowed chips, preemptions, and pending positions."""
    snap = client.get("/admin/scheduler")
    queues = snap.get("queues") or {}
    if not queues:
        print(f"no tenant queues (policy={snap.get('policy')})")
        return 0
    print(f"{'QUEUE':<16} {'WEIGHT':>6} {'RUN':>4} {'PEND':>5} "
          f"{'CHIPS':>6} {'SHARE':>7} {'BORROW':>7} {'PREEMPT':>8} "
          f"{'RESIZE':>7}")
    for name, q in sorted(queues.items()):
        print(
            f"{name:<16} {q['weight']:>6.1f} {q['running']:>4} "
            f"{q['depth']:>5} {q['used_chips_total']:>6} "
            f"{q['dominant_share']:>7.3f} {q['borrowed_chips']:>7.1f} "
            f"{q['preemptions']:>8} {q.get('resizes', 0):>7}"
        )
    pending = [(p["position"], p["job_id"], name)
               for name, q in queues.items() for p in q.get("pending", [])]
    for pos, job_id, qname in sorted(pending):
        print(f"  #{pos}  {job_id}  ({qname})")
    for job_id, s in sorted((snap.get("shrunk_workloads") or {}).items()):
        print(f"  ~{job_id}  {s['num_slices']}/{s['requested_slices']} slices "
              f"({s['queue']}, shrunk)")
    if snap.get("preemptions_total") is not None:
        print(f"(preemptions total: {snap['preemptions_total']}, "
              f"resizes total: {snap.get('resizes_total', 0)})")
    for h in (snap.get("resize_history") or [])[-5:]:
        who = f" for {h['preemptor']}" if h.get("preemptor") else ""
        print(f"  [{h['kind']}] {h['job_id']} "
              f"{h['from_slices']}->{h['to_slices']} slices{who}")
    return 0


def cmd_serve(client: Client, ns: argparse.Namespace) -> int:
    """Serving-fleet table from ``GET /admin/serve``: per-job aggregates
    plus one indented row per replica and per tenant adapter."""
    body = client.get("/admin/serve")
    sessions = body.get("sessions") or {}
    audit = body.get("shard_audit") or {}
    audit_line = (f"(shard audit: {audit.get('checks_total', 0)} leaf checks, "
                  f"{audit.get('violations_total', 0)} violations)" if audit else "")
    if not sessions:
        print("no serving sessions loaded")
        if audit_line:
            print(audit_line)
        return 0
    print(f"{'JOB':<24} {'MODE':>7} {'REPL':>5} {'SLOTS':>7} {'QUEUE':>5} "
          f"{'TOKENS':>8} {'HITS':>5} {'MISS':>5} {'SAVED':>8} "
          f"{'CACHE_MB':>8} {'PAGES':>9} {'TIER':>9} {'ADPT':>4}")
    for job_id, s in sorted(sessions.items()):
        slots = f"{s['slots_busy']}/{s['slots_total']}"
        repl = f"{s.get('replicas_healthy', 1)}/{s.get('replicas_total', 1)}"
        cache_mb = s.get("prefix_cache_bytes", 0) / (1 << 20)
        pages_total = s.get("kv_pages_total", 0)
        pages = f"{s.get('kv_pages_used', 0)}/{pages_total}" if pages_total else "-"
        tier = (f"{s.get('kv_pages_used', 0)}d/{s.get('kv_tier_host_pages_used', 0)}h"
                if s.get("kv_tier_host_pages_total", 0) else "-")
        print(f"{job_id:<24} {s.get('transport', 'inproc'):>7} {repl:>5} {slots:>7} "
              f"{s['queue_depth']:>5} {s['tokens_generated_total']:>8} "
              f"{s.get('prefix_hits_total', 0):>5} {s.get('prefix_misses_total', 0):>5} "
              f"{s.get('prefill_tokens_saved_total', 0):>8} {cache_mb:>8.1f} "
              f"{pages:>9} {tier:>9} {s.get('adapters_loaded', 0):>4}")
        for rid, r in sorted((s.get("replicas") or {}).items()):
            rpages = (f" pages {r.get('kv_pages_used', 0)}/{r.get('kv_pages_total', 0)}"
                      if r.get("kv_pages_total") else "")
            pid = f"pid {r['pid']} " if r.get("pid") else ""
            print(f"  {rid:<10} gen{r.get('generation', 0):<3} "
                  f"{r.get('state', '?'):<9} {pid}"
                  f"slots {r.get('slots_busy', 0)}/{r.get('slots_total', 0)} "
                  f"queue {r.get('queue_depth', 0)} "
                  f"tokens {r.get('tokens_generated_total', 0)}{rpages}")
        tokens_by = s.get("tokens_by_tenant") or {}
        lanes_by = s.get("lanes_by_tenant") or {}
        queue_by = s.get("queue_depth_by_tenant") or {}
        for aid, a in sorted((s.get("adapters") or {}).items()):
            print(f"  @{aid:<22} slot{a.get('slot', '?'):<3} r{a.get('rank', '?'):<3} "
                  f"lanes {lanes_by.get(aid, 0)} queue {queue_by.get(aid, 0)} "
                  f"tokens {tokens_by.get(aid, 0)}")
        extras = [f"{label} {s[key]}" for label, key in (
            ("failovers", "failovers_total"), ("restarts", "replica_restarts_total"),
            ("rollovers", "rollovers_total"), ("shed", "shed_total")) if s.get(key)]
        if extras:
            print(f"  ({', '.join(extras)})")
    if audit_line:
        print(audit_line)
    return 0


def cmd_metrics(client: Client, ns: argparse.Namespace) -> int:
    body = client.get(f"/jobs/{ns.job_id}/metrics")
    records = body.get("records", body)
    _print_json(records)
    # rlhf rollout health from the newest row: actor tok/s, buffer depth
    last = records[-1] if isinstance(records, list) and records else None
    if isinstance(last, dict) and last.get("actor_tokens_per_sec") not in (None, ""):
        def num(key: str) -> float | None:
            try:
                return float(last[key])
            except (KeyError, TypeError, ValueError):
                return None

        parts = [
            f"actor {num('actor_tokens_per_sec') or 0:.1f} tok/s "
            f"@v{int(num('actor_version') or 0)}",
            f"buffer depth {int(num('rollout_buffer_depth') or 0)} "
            f"staleness {num('rollout_staleness') or 0:.1f} ckpt",
        ]
        workers = num("rollout_workers_alive")
        if workers is not None:
            parts.append(f"workers {int(workers)} alive "
                         f"(respawns {int(num('rollout_respawns_total') or 0)}, "
                         f"dup pairs {int(num('rollout_dup_pairs_total') or 0)})")
        print(f"rollout: {'  '.join(parts)}")
    return 0


def _fmt_attrs(attrs: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))


def cmd_timeline(client: Client, ns: argparse.Namespace) -> int:
    """Waterfall of where the job's time went: each lifecycle event with its
    offset from submit and the gap to the next event."""
    body = client.get(f"/jobs/{ns.job_id}/timeline")
    events = body.get("events") or []
    if not events:
        print(f"no timeline events for {ns.job_id} (pre-observability job?)")
        return 0
    trace = (body.get("trace_id") or "")[:8]
    print(f"{ns.job_id}  trace={trace or '-'}  status={body.get('status')}")
    t0 = events[0]["ts"]
    for i, e in enumerate(events):
        gap = (events[i + 1]["ts"] - e["ts"]) if i + 1 < len(events) else None
        gap_s = f"{gap:>9.2f}s" if gap is not None else " " * 10
        print(f"{e['ts'] - t0:>9.2f}s  {gap_s}  {e['event']:<22} "
              f"{_fmt_attrs(e.get('attrs') or {})}")
    return 0


def cmd_generate(client: Client, ns: argparse.Namespace) -> int:
    """Token ids in, tokens out, from a promoted job's serving endpoint."""
    try:
        tokens = [int(t) for t in ns.tokens.replace(" ", "").split(",") if t]
    except ValueError:
        raise SystemExit(f"--tokens expects comma-separated ids, got {ns.tokens!r}")
    if not tokens:
        raise SystemExit("--tokens must name at least one token id")
    body: dict[str, Any] = {"tokens": tokens}
    for key in ("max_new_tokens", "temperature", "top_k", "eos_id", "seed", "adapter"):
        value = getattr(ns, key, None)
        if value is not None:
            body[key] = value
    try:
        result = client.post(f"/jobs/{ns.job_id}/generate", json_body=body)
    except ApiError as exc:
        # honor the server's Retry-After on a 429 with ONE bounded retry
        if exc.status != 429 or exc.retry_after_s is None:
            raise
        wait = min(30.0, max(0.0, exc.retry_after_s))
        print(f"server busy; retrying once in {wait:.0f}s (Retry-After)", file=sys.stderr)
        time.sleep(wait)
        result = client.post(f"/jobs/{ns.job_id}/generate", json_body=body)
    _print_json(result)
    return 0


def cmd_artifacts(client: Client, ns: argparse.Namespace) -> int:
    if ns.output:
        client.download(f"/jobs/{ns.job_id}/artifacts", ns.output)
        print(f"wrote {ns.output}", file=sys.stderr)
        return 0
    body = client.get(f"/jobs/{ns.job_id}/artifacts", params={"list": "1"})
    for a in body.get("artifacts", []):
        print(f"{a['size']:>12}  {a['path']}")
    return 0


def run(ns: argparse.Namespace) -> int:
    """Run one parsed command; raises :class:`ApiError` on an HTTP error."""
    client = Client(ns.api, ns.token)
    commands = {"submit": cmd_submit, "jobs": cmd_jobs, "queue": cmd_queue,
                "serve": cmd_serve, "status": cmd_status, "logs": cmd_logs,
                "metrics": cmd_metrics, "timeline": cmd_timeline,
                "artifacts": cmd_artifacts, "generate": cmd_generate}
    if ns.cmd in commands:
        return commands[ns.cmd](client, ns)
    if ns.cmd == "models":
        _print_json(client.get("/models"))
    elif ns.cmd in ("promote", "unpromote", "cancel"):
        _print_json(client.post(f"/jobs/{ns.job_id}/{ns.cmd}"))
    elif ns.cmd == "profile":
        # arm an on-demand torch.profiler window on a LIVE job
        _print_json(client.post(f"/jobs/{ns.job_id}/profile", json_body={"steps": ns.steps}))
    elif ns.cmd == "dev-token":
        print(client.post("/auth/dev-token", json_body={"user_id": ns.user_id})["access_token"])
    else:
        raise SystemExit(f"unknown command {ns.cmd!r}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ftc-ctl", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--api", default=os.environ.get("FTC_CTL_API", "http://localhost:8787"))
    p.add_argument("--token", default=os.environ.get("FTC_CTL_TOKEN"))
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("models")
    s = sub.add_parser("submit")
    s.add_argument("model")
    s.add_argument("--arg", action="append", metavar="K=V")
    s.add_argument("--device")
    s.add_argument("--task",
                   help="expected task type (causal_lm | multimodal | dpo | rlhf ...); the "
                        "server 400s on unknown values or a model/task mismatch")
    s.add_argument("--queue", help="tenant queue")
    s.add_argument("--priority", help="low | normal | high | integer")
    s.add_argument("--dataset-file")
    s.add_argument("--dataset-url")
    s.add_argument("--dataset-id")
    s.add_argument("--watch", action="store_true")
    s = sub.add_parser("jobs")
    s.add_argument("--page", type=int, default=1)
    sub.add_parser("queue")
    sub.add_parser("serve")
    for name in ("status", "logs", "metrics", "timeline", "artifacts",
                 "promote", "unpromote", "cancel"):
        s = sub.add_parser(name)
        s.add_argument("job_id")
        if name == "status":
            s.add_argument("--watch", action="store_true")
        if name == "logs":
            s.add_argument("--follow", action="store_true")
        if name == "artifacts":
            s.add_argument("--output", "-o",
                           help="download the artifact zip to this path "
                                "(default: list the inventory)")
    s = sub.add_parser("profile")
    s.add_argument("job_id")
    s.add_argument("--steps", type=int, default=5,
                   help="profiler window length in steps (the trace lands in profile/)")
    s = sub.add_parser("generate")
    s.add_argument("job_id")
    s.add_argument("--tokens", required=True,
                   help="comma-separated prompt token ids (e.g. 1,2,3)")
    s.add_argument("--max-new-tokens", type=int, default=None)
    s.add_argument("--temperature", type=float, default=None)
    s.add_argument("--top-k", type=int, default=None)
    s.add_argument("--eos-id", type=int, default=None)
    s.add_argument("--seed", type=int, default=None)
    s.add_argument("--adapter", default=None,
                   help="decode with this multiplexed tenant adapter (a LoRA job id "
                        "loaded via /admin/serve/.../adapters)")
    s = sub.add_parser("dev-token")
    s.add_argument("user_id", nargs="?", default="dev")
    return p


def main(argv: list[str] | None = None) -> int:
    ns = build_parser().parse_args(argv)
    try:
        return run(ns)
    except ApiError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    except urllib.error.URLError as exc:
        print(f"error: cannot reach {ns.api}: {exc.reason}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # downstream pipe closed early (| head ...)
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
