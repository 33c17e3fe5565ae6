"""The checker service's clients: ``python3 -m raft_tla_tpu_torch
submit|jobs|watch``.

The JAX CLI's three clients (``raft_tla_tpu/cli.py``), with every flag:
``submit <cfg>`` queues a check or simulate job on a service
(``server.py``; the cfg's content is sent, so the service needs no shared
filesystem) and with ``--wait`` prints its result; ``jobs`` lists the job
registry; ``watch [HOST:PORT | http://HOST:PORT]`` streams a run's
snapshots from the service's ``watch`` op (``--job`` scopes it to one
job) or polls a ``--metrics-port`` listener's ``/flight``.  Pure sockets:
this module imports neither torch nor the engines, so a client starts at
once and never touches the device (``__main__`` dispatches here before
``cli.py`` is imported; ``cli.py`` registers the same subcommands).
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import time
import urllib.error
import urllib.request

#: The subcommands this module serves.
COMMANDS = ("submit", "jobs", "watch")

#: ``submit --pipeline``: the port's plan names (``engine/bfs.py``
#: PLAN_NAMES), listed here so the clients need not import the engine.
PIPELINES = ("auto", "v1", "v2", "v3", "v4")


def add_parsers(sub) -> None:
    """The three subcommands' parsers on ``sub`` (the CLI's subparsers)."""
    sb = sub.add_parser(
        "submit",
        help="queue a check on a checker service as an async job "
             "(serving/): bounded admission, per-tenant fair "
             "scheduling, per-job event log + metrics; returns the "
             "job id (or --wait for the result)")
    sb.add_argument("cfg", help="TLC .cfg file (content is sent, so "
                                "the service needs no shared "
                                "filesystem)")
    sb.add_argument("--server", default="127.0.0.1:8610",
                    help="HOST:PORT of the checker service "
                         "(default %(default)s)")
    sb.add_argument("--tenant", default=None,
                    help="tenant id for fair scheduling + per-tenant "
                         "metrics (default: 'default')")
    sb.add_argument("--batch", type=int, default=None)
    sb.add_argument("--queue-capacity", type=int, default=None)
    sb.add_argument("--seen-capacity", type=int, default=None)
    sb.add_argument("--max-diameter", type=int, default=None)
    sb.add_argument("--max-seconds", type=float, default=None)
    sb.add_argument("--seed", type=int, default=0)
    sb.add_argument("--engine", choices=("single", "mesh", "auto"),
                    default=None)
    sb.add_argument("--pipeline", choices=PIPELINES, default=None)
    sb.add_argument("--trace", action="store_true",
                    help="record the counterexample trace (the server "
                         "default is off, like the check op): a "
                         "violating job's result then carries the "
                         "replayed numbered-state trace")
    sb.add_argument("--simulate", action="store_true",
                    help="submit a simulate job instead of a check")
    sb.add_argument("--mode", choices=("exhaustive", "swarm"),
                    default=None,
                    help="check-job tier: exhaustive BFS (default) or "
                         "the randomized-walk swarm — the cheap "
                         "high-QPS tier (engine/swarm.py)")
    sb.add_argument("--walks", type=int, default=None,
                    help="(swarm jobs) concurrent walks per device")
    sb.add_argument("--max-depth", type=int, default=None,
                    help="(swarm jobs) per-trace depth bound")
    sb.add_argument("--num-steps", type=int, default=None,
                    help="(simulate/swarm jobs) total walker-steps")
    sb.add_argument("--depth", type=int, default=None,
                    help="(simulate jobs) trace depth")
    sb.add_argument("--cache", action="store_true",
                    help="serve a repeat submission from the "
                         "fingerprint-keyed result cache (refused for "
                         "--max-seconds jobs — a truncated run is not "
                         "reusable)")
    sb.add_argument("--slo-seconds", type=float, default=None,
                    help="per-job turnaround SLO target (feeds the "
                         "jobs/slo_ok|slo_miss per-tenant counters; "
                         "default: the server's)")
    sb.add_argument("--wait", action="store_true",
                    help="poll until the job is terminal and print the "
                         "result (exit 1 on violation/failure)")
    sb.add_argument("--poll-interval", type=float, default=1.0)
    sb.add_argument("--timeout", type=float, default=15.0)
    sb.add_argument("--json", action="store_true",
                    help="print the full result JSON (with --wait)")

    jl = sub.add_parser(
        "jobs",
        help="list a checker service's job registry (queue depth, "
             "by-state counts, one row per job)")
    jl.add_argument("--server", default="127.0.0.1:8610",
                    help="HOST:PORT of the checker service "
                         "(default %(default)s)")
    jl.add_argument("--tenant", default=None,
                    help="only this tenant's jobs")
    jl.add_argument("--state", default=None,
                    help="only jobs in this state (queued/admitted/"
                         "running/done/failed/cancelled)")
    jl.add_argument("--timeout", type=float, default=15.0)
    jl.add_argument("--json", action="store_true")

    w = sub.add_parser(
        "watch",
        help="attach a live console to a running check (run attach): "
             "stream progress/coverage/fused-stage snapshots from a "
             "checker service's watch op, or poll a --metrics-port "
             "listener's /flight endpoint; --job scopes the stream to "
             "one async job")
    w.add_argument("target", nargs="?", default="127.0.0.1:8610",
                   help="HOST:PORT of a checker service (default "
                        "%(default)s), or http://HOST:PORT of a "
                        "--metrics-port listener")
    w.add_argument("--job", default=None, metavar="JOB_ID",
                   help="watch ONE async job (serving/): job state "
                        "snapshots while it queues, ring progress "
                        "while it runs, closed by its terminal state "
                        "— never reaped as idle while the job is "
                        "alive (exit 0 done, 1 failed/cancelled)")
    w.add_argument("--interval", type=float, default=2.0,
                   help="seconds between snapshots (default 2)")
    w.add_argument("--count", type=int, default=0,
                   help="snapshots before exiting; 0 (default) = until "
                        "the watched run ends")
    w.add_argument("--timeout", type=float, default=15.0,
                   help="connect/read timeout per request (default 15)")
    w.add_argument("--json", action="store_true",
                   help="print raw snapshot JSON lines instead of the "
                        "rendered console lines")


def _render_watch_line(snap: dict) -> str:
    """One console line per watch snapshot — the TLC-style progress
    shape (obs/flight.py records), annotated with the run context."""
    run = snap.get("run") or {}
    prog = snap.get("progress") or {}
    level = snap.get("level") or {}
    parts = []
    if prog:
        parts.append(
            f"distinct {prog.get('distinct', 0):,} | generated "
            f"{prog.get('generated', 0):,} | diameter "
            f"{prog.get('diameter', 0)} | frontier "
            f"{prog.get('frontier', 0):,} | next "
            f"{prog.get('next_count', 0):,} | elapsed "
            f"{prog.get('elapsed', 0):,.0f}s")
    elif level:
        parts.append(
            f"level {level.get('level')} done | distinct "
            f"{level.get('distinct', 0):,} | generated "
            f"{level.get('generated', 0):,}")
    else:
        parts.append("no telemetry yet")
    ctx = " ".join(str(run[k]) for k in ("engine", "pipeline")
                   if run.get(k))
    live = "live" if snap.get("armed") else "idle"
    job = snap.get("job")
    if job is not None:
        # Per-job watch: the job's registry state leads; ring telemetry
        # (progress) renders only while this job owns the device.
        head = f"job {job['id']} [{job['state']}]"
        if snap.get("running"):
            if prog:
                return f"watch[{head}] {parts[0]}" \
                    + (f"  ({ctx})" if ctx else "")
            return f"watch[{head}] compiling/warming — no progress yet"
        return f"watch[{head}] tenant={job.get('tenant')}"
    return f"watch[{live}] {parts[0]}" + (f"  ({ctx})" if ctx else "")


def _watch_http(url: str, interval: float, count: int, timeout: float,
                as_json: bool) -> int:
    """Poll a --metrics-port listener's /flight endpoint and render a
    console; exits when the watched run's run_end shows up (or after
    --count polls).  Tolerates a listener that is not up YET (the watch
    is usually launched alongside the run) with a bounded retry."""
    base = url.rstrip("/")
    if not base.endswith("/flight"):
        base += "/flight"
    # Watchers render only the newest record per kind — ask the
    # listener to trim (full-ring polls would serialize hundreds of KB
    # per tick under the recorder lock the engine writes through).
    poll_url = base + "?last=8"

    def _refused(exc) -> bool:
        """Connection REFUSED (listener torn down) vs merely slow
        (timeout on a pegged host mid-build): only refusal means
        the run process is gone."""
        reason = getattr(exc, "reason", exc)
        return isinstance(reason, ConnectionRefusedError)

    sent = 0
    refused = 0
    attach_end_seq = None
    t_start = time.monotonic()
    t_last_ok = None
    while True:
        try:
            with urllib.request.urlopen(poll_url, timeout=timeout) as r:
                doc = json.loads(r.read().decode())
            refused = 0
            t_last_ok = time.monotonic()
        except (OSError, urllib.error.URLError, ValueError) as e:
            refused = refused + 1 if _refused(e) else 0
            if sent and refused >= 3:
                # The listener answered before and now actively refuses:
                # the run process exited (the CLI tears the listener
                # down at run end) — a completed watch, not a failure.
                # Slow/timed-out polls (host pegged by an engine build) do
                # NOT count: the console must ride those out.
                print("watch: listener gone — run process exited",
                      flush=True)
                return 0
            # Give-up budgets are ELAPSED-time based (failure counts
            # would stretch with the per-poll timeout): 300 s of
            # silence after a successful poll, and a generous 600 s
            # for the listener to come up at all — it only binds after
            # the imports and the engine build (the server watch op's
            # in-process grace is shorter, 120 s, because there the
            # process is already up).
            now = time.monotonic()
            if sent and t_last_ok is not None and now - t_last_ok > 300.0:
                print("watch: listener unresponsive too long; giving up",
                      file=sys.stderr)
                return 1
            if not sent and now - t_start > 600.0:
                print("watch: listener unreachable; giving up",
                      file=sys.stderr)
                return 1
            time.sleep(interval)
            continue
        records = doc.get("records") or {}
        events = records.get("event") or []
        run_ends = [e for e in events if e.get("event") == "run_end"]
        if attach_end_seq is None:
            # First successful poll: note the newest pre-existing
            # run_end so only a run ending AFTER attach closes the
            # console.
            attach_end_seq = run_ends[-1]["seq"] if run_ends else 0
        snap = {
            "armed": bool(doc.get("armed")),
            "run": (records.get("run_context") or [None])[-1],
            "progress": (records.get("progress") or [None])[-1],
            "level": next((e for e in reversed(events)
                           if e.get("event") == "level_complete"), None),
        }
        print(json.dumps(doc, default=str) if as_json
              else _render_watch_line(snap), flush=True)
        sent += 1
        ended = run_ends and run_ends[-1]["seq"] > attach_end_seq
        if ended:
            end = run_ends[-1]
            print(f"watch: run ended — stop_reason="
                  f"{end.get('stop_reason')} distinct="
                  f"{end.get('distinct')} generated="
                  f"{end.get('generated')}", flush=True)
            return 0
        if count and sent >= count:
            return 0
        time.sleep(interval)


def _client_call(target: str, req: dict, timeout: float) -> dict:
    """One request/response line against a checker service (pure
    client, no device) — the submit/jobs subcommands' transport."""
    host, _, port = target.partition(":")
    with socket.create_connection((host or "127.0.0.1",
                                   int(port or 8610)),
                                  timeout=timeout) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        s.settimeout(timeout)
        f = s.makefile("rb")
        line = f.readline()
    if not line:
        raise OSError("connection closed by server")
    return json.loads(line)


def _run_submit(args) -> int:
    """``submit``: queue a check on a checker service as an async job
    (serving/).  Sends cfg CONTENT (cfg_text), so the service need not
    share a filesystem with the client.  --wait polls until the job is
    terminal and renders the result."""
    try:
        with open(args.cfg, encoding="utf-8") as f:
            cfg_text = f.read()
    except OSError as e:
        print(f"submit: cannot read {args.cfg}: {e}", file=sys.stderr)
        return 2
    inner = {"op": "simulate" if args.simulate else "check",
             "cfg_text": cfg_text}
    if args.trace and not args.simulate:
        inner["trace"] = True
    for key, val in (("batch", args.batch),
                     ("queue_capacity", args.queue_capacity),
                     ("seen_capacity", args.seen_capacity),
                     ("max_diameter", args.max_diameter),
                     ("max_seconds", args.max_seconds),
                     ("seed", args.seed or None),
                     ("engine", args.engine),
                     ("pipeline", args.pipeline),
                     ("mode", getattr(args, "mode", None)),
                     ("walks", getattr(args, "walks", None)),
                     ("max_depth", getattr(args, "max_depth", None)),
                     ("num_steps", getattr(args, "num_steps", None)),
                     ("depth", getattr(args, "depth", None))):
        if val is not None:
            inner[key] = val
    req = {"op": "submit", "tenant": args.tenant, "job": inner}
    if args.cache:
        req["cache"] = True
    if args.slo_seconds is not None:
        req["slo_seconds"] = args.slo_seconds
    try:
        resp = _client_call(args.server, req, args.timeout)
    except (OSError, ValueError) as e:
        print(f"submit: {e}", file=sys.stderr)
        return 1
    if not resp.get("ok"):
        print(f"submit: {resp.get('error')}", file=sys.stderr)
        return 1
    job = resp["job"]
    # With --json stdout is reserved for the final result document
    # (scripts pipe it); the human status lines ride stderr instead.
    status_out = sys.stderr if args.json else sys.stdout
    print(f"job {job['id']} {job['state']} "
          f"(tenant {job['tenant']}, label {job.get('label')})",
          file=status_out)
    if not args.wait:
        return 0
    # The poll loop tolerates transient network errors (a server mid-
    # restart replays its journal and the job resumes): a few failed
    # polls print a note and retry; persistent failure exits cleanly
    # instead of a traceback.
    misses = 0
    while True:
        time.sleep(args.poll_interval)
        try:
            st = _client_call(args.server,
                              {"op": "status", "job_id": job["id"]},
                              args.timeout)
        except (OSError, ValueError) as e:
            misses += 1
            if misses >= 10:
                print(f"submit: lost the server while waiting ({e}); "
                      f"job {job['id']} may still run — poll with "
                      f"'jobs' or 'watch --job'", file=sys.stderr)
                return 1
            print(f"submit: poll failed ({e}); retrying",
                  file=sys.stderr)
            continue
        misses = 0
        if not st.get("ok"):
            print(f"submit: {st.get('error')}", file=sys.stderr)
            return 1
        job = st["job"]
        if job["state"] in ("done", "failed", "cancelled"):
            break
        print(f"job {job['id']} {job['state']}...", file=sys.stderr)
    print(f"job {job['id']} {job['state']} "
          f"(queue_wait {job.get('queue_wait_seconds')}s, run "
          f"{job.get('run_seconds')}s, turnaround "
          f"{job.get('turnaround_seconds')}s"
          + (", cached" if job.get("cached") else "") + ")",
          file=status_out)
    if job["state"] != "done":
        # A cancelled job has no error string — say what happened
        # rather than printing "error: None".
        print(f"job {job['state']}"
              + (f": {job['error']}" if job.get("error") else ""),
              file=sys.stderr)
        return 1
    try:
        res = _client_call(args.server,
                           {"op": "result", "job_id": job["id"]},
                           args.timeout)
    except (OSError, ValueError) as e:
        print(f"submit: cannot fetch result ({e}); job {job['id']} is "
              f"done — retry with the 'result' op", file=sys.stderr)
        return 1
    if not res.get("ok"):
        print(f"submit: {res.get('error')}", file=sys.stderr)
        return 1
    doc = res["result"]
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True, default=str))
    else:
        print(f"distinct {doc.get('distinct')} | generated "
              f"{doc.get('generated')} | diameter "
              f"{doc.get('diameter')} | stop {doc.get('stop_reason')}"
              if "distinct" in doc else json.dumps(doc, default=str))
    violated = doc.get("violation") is not None \
        or doc.get("deadlock") is not None
    return 1 if violated else 0


def _run_jobs(args) -> int:
    """``jobs``: list the service's job registry (one row per job)."""
    req = {"op": "jobs"}
    if args.tenant:
        req["tenant"] = args.tenant
    if args.state:
        req["state"] = args.state
    try:
        resp = _client_call(args.server, req, args.timeout)
    except (OSError, ValueError) as e:
        print(f"jobs: {e}", file=sys.stderr)
        return 1
    if not resp.get("ok"):
        print(f"jobs: {resp.get('error')}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(resp, indent=2, sort_keys=True, default=str))
        return 0
    print(f"queue {resp['queue_depth']}/{resp.get('queue_capacity')} "
          f"| running {resp['running']} | by_state "
          + " ".join(f"{k}={v}" for k, v in resp["by_state"].items()
                     if v))
    fmt = "{:18s} {:10s} {:9s} {:>9s} {:>8s} {:24s}"
    print(fmt.format("id", "tenant", "state", "wait_s", "run_s",
                     "label"))
    for j in resp["jobs"]:
        def _s(v):
            return f"{v:.2f}" if isinstance(v, (int, float)) else "--"
        print(fmt.format(j["id"], str(j["tenant"])[:10], j["state"],
                         _s(j.get("queue_wait_seconds")),
                         _s(j.get("run_seconds")),
                         str(j.get("label") or "-")[:24])
              + (f"  [{j['error']}]" if j.get("error") else "")
              + (f"  ({j['note']})" if j.get("note") else ""))
    return 0


def _watch_server(target: str, interval: float, count: int,
                  timeout: float, as_json: bool,
                  job: "str | None" = None) -> int:
    """Attach to a checker service's streaming watch op and render each
    snapshot line until the done record."""
    host, _, port = target.partition(":")
    try:
        s = socket.create_connection((host or "127.0.0.1",
                                      int(port or 8610)), timeout=timeout)
    except OSError as e:
        print(f"watch: cannot connect to {target}: {e}", file=sys.stderr)
        return 1
    with s:
        req = {"op": "watch", "interval": interval, "count": count}
        if job:
            req["job"] = job
        s.sendall((json.dumps(req) + "\n").encode())
        # Snapshot lines arrive one per interval — reads must outlast it.
        s.settimeout(max(timeout, interval * 3 + 5))
        f = s.makefile("rb")
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not rec.get("ok"):
                print(f"watch: {rec.get('error')}", file=sys.stderr)
                return 1
            if rec.get("done"):
                end = rec.get("run_end") or {}
                j = rec.get("job")
                if j is not None:
                    if rec.get("evicted"):
                        # Terminal-retention eviction raced the watch:
                        # the job reached a terminal state (only
                        # terminal jobs are evicted) but the final
                        # summary is gone; the last-seen state may be
                        # stale, so do not report it as the outcome.
                        print(f"watch: job {j['id']} completed and "
                              f"was evicted from the registry "
                              f"(retention cap); last seen "
                              f"{j['state']}", flush=True)
                        return 0
                    if rec.get("truncated") \
                            and j["state"] not in ("done", "failed",
                                                   "cancelled"):
                        print(f"watch: stream truncated after "
                              f"{rec.get('snapshots')} snapshot(s) — "
                              f"job {j['id']} still {j['state']}; "
                              f"re-attach to keep watching",
                              file=sys.stderr, flush=True)
                        return 1
                    print(f"watch: job {j['id']} {j['state']} after "
                          f"{rec.get('snapshots')} snapshot(s)"
                          + (f" — {j['error']}" if j.get("error")
                             else ""), flush=True)
                    return 0 if j["state"] == "done" else 1
                print(f"watch: done after {rec.get('snapshots')} "
                      f"snapshot(s)"
                      + (f" — stop_reason={end.get('stop_reason')} "
                         f"distinct={end.get('distinct')}"
                         if end else ""), flush=True)
                return 0
            print(json.dumps(rec, default=str) if as_json
                  else _render_watch_line(rec.get("watch") or {}),
                  flush=True)
    print("watch: connection closed by server", file=sys.stderr)
    return 1


def _run_watch(args) -> int:
    """``watch``: run attach.  No device, no cfg — pure client."""
    if args.target.startswith("http://") \
            or args.target.startswith("https://"):
        if args.job:
            print("watch: --job needs a checker service target "
                  "(HOST:PORT) — the HTTP /flight listener has no job "
                  "registry", file=sys.stderr)
            return 2
        return _watch_http(args.target, args.interval, args.count,
                           args.timeout, args.json)
    return _watch_server(args.target, args.interval, args.count,
                         args.timeout, args.json, job=args.job)


def run(args) -> int:
    """The parsed subcommand's exit code."""
    return {"submit": _run_submit, "jobs": _run_jobs,
            "watch": _run_watch}[args.cmd](args)


def main(argv=None) -> int:
    """``python3 -m raft_tla_tpu_torch submit|jobs|watch ...`` without the
    rest of the CLI."""
    ap = argparse.ArgumentParser(prog="raft_tla_tpu_torch")
    add_parsers(ap.add_subparsers(dest="cmd", required=True))
    return run(ap.parse_args(argv))
