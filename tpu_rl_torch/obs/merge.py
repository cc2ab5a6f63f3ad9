"""Merge per-role ``TraceRecorder`` dumps into one clock-corrected fleet

The port's own copy of ``tpu_rl.obs.merge``, unchanged in behaviour.
trace.

Every role dumps its own span ring (``trace.json`` for the learner,
``trace-<role>-<pid>.json`` for the others) with a ``meta`` block carrying
role/pid/host and the wall-clock anchor of its ``perf_counter`` epoch. This
module folds those rings onto ONE timeline:

1. **Clock correction** — the storage dump embeds ``meta.clock``, the
   :class:`~tpu_rl_torch.obs.clocksync.ClockSync` snapshot keyed ``role/host/pid``
   (offsets are remote-minus-reference, reference = the storage/learner
   host). Each ring's anchor is shifted by its source's offset; rings
   without an estimate (storage and learner themselves, or a source the
   estimator never saw) pass through unshifted.
2. **Flow synthesis** — spans tagged ``args.trace_id`` by the wire hops
   (worker tick, manager in/out, storage ingest, window close) are chained
   per trace id in corrected-time order and joined with Chrome flow events
   (``ph: s/t/f``), which Perfetto renders as linked arrows. The learner
   hop is synthesized: the shm data plane carries no per-window metadata,
   so the chain is closed onto the first ``train-step`` span that begins
   after the chain's ``window-close`` (flagged ``synthesized: true`` in the
   flow args — it is a plausible consumer, not a measured identity).

Run standalone (``python -m tpu_rl_torch.obs.merge result_dir/``) or let the
storage edge auto-merge at shutdown; both write ``fleet_trace.json`` next to
the inputs, atomically.
"""

from __future__ import annotations

import glob
import json
import os
import sys

MERGED_NAME = "fleet_trace.json"
# Spans that participate in a rollout's lineage chain, in hop order — used
# only for tie-breaking events at equal corrected timestamps.
_HOP_ORDER = {
    "worker-tick": 0,
    "relay-in": 1,
    "relay-out": 2,
    "storage-ingest": 3,
    "window-close": 4,
    "train-step": 5,
}


def load_trace(path: str) -> dict | None:
    """One TraceRecorder dump, or None when unreadable/not a trace doc."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return None
    return doc


def _doc_key(doc: dict) -> str:
    meta = doc.get("meta") or {}
    return f"{meta.get('role', '?')}/{meta.get('host', '?')}/{meta.get('pid', '?')}"


def merge_traces(docs: list[dict]) -> dict:
    """Merge loaded trace docs; see the module docstring for semantics."""
    # The reference clock map comes from whichever doc carries one (the
    # storage dump); later docs win, which is harmless — there is one
    # storage process per result_dir.
    clock: dict[str, dict] = {}
    for doc in docs:
        meta = doc.get("meta") or {}
        if isinstance(meta.get("clock"), dict):
            clock.update(meta["clock"])

    events: list[dict] = []
    roles: list[str] = []
    # (corrected_ts_us, hop_rank, pid, tid, name, dur_us) per lineage span
    chains: dict[int, list[tuple]] = {}
    train_steps: list[tuple] = []  # (corrected_ts_us, pid, tid, dur_us)

    for i, doc in enumerate(docs):
        meta = doc.get("meta") or {}
        role = str(meta.get("role") or "?")
        anchor_ns = meta.get("wall_anchor_ns")
        if not isinstance(anchor_ns, int):
            continue  # pre-anchor dump: no shared axis to place it on
        est = clock.get(_doc_key(doc))
        offset_ns = int(est.get("offset_ns", 0)) if isinstance(est, dict) else 0
        # Corrected wall microseconds of the ring's epoch: local anchor
        # pulled back onto the reference clock (remote = reference + offset).
        base_us = (anchor_ns - offset_ns) / 1e3
        roles.append(role)
        # pid collisions across hosts would fold two processes into one
        # Perfetto track — remap each doc to its own pid lane.
        pid = i
        for ev in doc.get("traceEvents", ()):
            if not isinstance(ev, dict):
                continue
            out = dict(ev)
            out["pid"] = pid
            if ev.get("ph") == "X":
                ts = base_us + float(ev.get("ts", 0.0))
                out["ts"] = ts
                args = ev.get("args")
                tid = ev.get("tid", 0)
                dur = float(ev.get("dur", 0.0))
                name = str(ev.get("name", ""))
                if isinstance(args, dict) and "trace_id" in args:
                    try:
                        trace_id = int(args["trace_id"])
                    except (TypeError, ValueError):
                        trace_id = None
                    if trace_id is not None:
                        chains.setdefault(trace_id, []).append(
                            (ts, _HOP_ORDER.get(name, 9), pid, tid, name, dur)
                        )
                if name == "train-step":
                    train_steps.append((ts, pid, tid, dur))
            events.append(out)

    if not events:
        return {
            "traceEvents": [],
            "displayTimeUnit": "ms",
            "meta": {"roles": [], "flows": 0, "clock": clock},
        }

    # Close each chain onto a plausible learner consumer: the first
    # train-step beginning at or after the chain's last measured hop.
    train_steps.sort()
    for hops in chains.values():
        hops.sort()
        if not train_steps or hops[-1][4] == "train-step":
            continue
        t_last = hops[-1][0]
        nxt = next((t for t in train_steps if t[0] >= t_last), None)
        if nxt is not None:
            ts, pid, tid, dur = nxt
            hops.append((ts, _HOP_ORDER["train-step"], pid, tid, "train-step", dur))

    # Normalize the axis so the merged trace starts near zero (dumps with
    # metadata only, no sampled span, leave nothing to shift).
    t0 = min((ev["ts"] for ev in events if ev.get("ph") == "X"), default=0.0)
    for ev in events:
        if ev.get("ph") == "X":
            ev["ts"] -= t0

    # Flow events: one s -> t... -> f arrow chain per trace id. Each step
    # binds to its hop's slice (same pid/tid, ts inside the slice).
    flows: list[dict] = []
    n_flows = 0
    for trace_id, hops in sorted(chains.items()):
        if len(hops) < 2:
            continue
        n_flows += 1
        last = len(hops) - 1
        for j, (ts, _rank, pid, tid, name, dur) in enumerate(hops):
            ph = "s" if j == 0 else ("f" if j == last else "t")
            ev = {
                "name": "rollout-lineage",
                "cat": "lineage",
                "ph": ph,
                # Bind inside the slice: the start anchors at the slice end
                # (the frame leaves the hop), later steps at the slice start.
                "ts": (ts - t0) + (dur if j == 0 else 0.0),
                "pid": pid,
                "tid": tid,
                "id": f"0x{trace_id:x}",
                "args": {
                    "trace_id": trace_id,
                    "hop": name,
                    "synthesized": name == "train-step",
                },
            }
            if ph == "f":
                ev["bp"] = "e"  # bind to the enclosing slice, not the next
            flows.append(ev)
    events.extend(flows)

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "meta": {
            "roles": sorted(set(roles)),
            "flows": n_flows,
            "clock": clock,
        },
    }


def find_trace_files(result_dir: str) -> list[str]:
    files = sorted(
        set(glob.glob(os.path.join(result_dir, "trace.json")))
        | set(glob.glob(os.path.join(result_dir, "trace-*.json")))
    )
    return [f for f in files if os.path.basename(f) != MERGED_NAME]


def merge_result_dir(result_dir: str, out_path: str | None = None) -> dict:
    """Merge every trace dump under ``result_dir`` -> ``fleet_trace.json``.
    Returns a summary dict (also useful to asserting callers)."""
    files = find_trace_files(result_dir)
    docs = [d for d in (load_trace(f) for f in files) if d is not None]
    merged = merge_traces(docs)
    out = out_path or os.path.join(result_dir, MERGED_NAME)
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(merged, f)
    os.replace(tmp, out)
    return {
        "out": out,
        "n_files": len(docs),
        "n_events": len(merged["traceEvents"]),
        "roles": merged["meta"]["roles"],
        "flows": merged["meta"]["flows"],
    }


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m tpu_rl_torch.obs.merge <result_dir>", file=sys.stderr)
        return 2
    result_dir = argv[0]
    if not os.path.isdir(result_dir):
        print(f"not a directory: {result_dir}", file=sys.stderr)
        return 2
    summary = merge_result_dir(result_dir)
    if summary["n_files"] == 0:
        print(f"no trace dumps found under {result_dir}", file=sys.stderr)
        return 1
    print(
        f"merged {summary['n_files']} trace file(s), "
        f"{summary['n_events']} events, {summary['flows']} linked flow(s), "
        f"roles={summary['roles']} -> {summary['out']}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
