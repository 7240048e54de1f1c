"""Replay a watchtower, autopilot, remediator or fleet canary journal of
the port offline: re-derive the alert/action stream, render a per-node timeline
(the port's twin of ``scripts/metrics_replay.py``, on
``tensorflowonspark_torch``; it imports no jax).

The live watchtower journals periodic ``metrics_snapshot()`` records and
every alert it fired into an append-only JSONL under
``<log_dir>/watchtower/journal.jsonl``.  This tool re-runs the SAME rule
engine (:func:`tensorflowonspark_torch.watchtower.replay_journal`) over that
file after the cluster is gone, so post-mortems answer "when did node 3
start straggling, and would today's thresholds have caught it" without a
live scrape window — and threshold changes can be evaluated against
recorded history (``--config``) before they ship.

An **autopilot** journal (``<log_dir>/autopilot/journal.jsonl``) is
detected automatically (``--kind`` overrides): the controller's decision
logic (:func:`tensorflowonspark_torch.autopilot.replay_journal`) is re-run
dry over the journaled snapshots, the live action stream
(proposed → applied → effect → kept/reverted) is printed, and the
live-vs-replay divergence — proposals the live run made that the replay
does not re-derive, and vice versa — is reported.  Divergence is expected
exactly where the live run ACTED: actuation changes the telemetry the
replay's snapshots recorded, so a kept action's follow-up proposals can
differ.  Config overrides answer "what would the controller have done at
other thresholds" against recorded history.

A **remediator** journal (``<log_dir>/remediator/journal.jsonl``) works
the same way (:func:`tensorflowonspark_torch.remediator.replay_journal`):
journaled watchtower alerts re-feed the action plane's decision logic
dry, the live proposed→applied→effect→kept/reverted topology-action
stream is printed, and the live-vs-replay proposal divergence reported.

A **fleet canary** journal (the ``CanaryController``'s ``journal_path``)
replays through :func:`tensorflowonspark_torch.fleet.replay_journal`: the
same window judgement the live controller ran is re-run over the journaled
per-tick samples, and the re-derived kept/reverted decisions are held
against the journaled ones.  Either package's canary journal replays here.

Usage:
  python scripts/metrics_replay_torch.py <journal.jsonl>            # human report
  python scripts/metrics_replay_torch.py <journal.jsonl> --json     # machine doc
  python scripts/metrics_replay_torch.py j.jsonl --config '{"straggler_z": 3}'
  python scripts/metrics_replay_torch.py j.jsonl --keys dispatch_count,infeed_batches
  python scripts/metrics_replay_torch.py autopilot/journal.jsonl    # autodetected

Exit status: 0 on a clean replay, 2 when the journal has no snapshot
records (nothing to evaluate; for a fleet journal: no sample records), 1
when a fleet journal's human report finds the re-derived decisions differ
from the journaled ones (``--json`` reports it as ``matches``).
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tensorflowonspark_torch import watchtower  # noqa: E402

#: default per-node timeline columns: cumulative counters shown as windowed
#: deltas between consecutive snapshots, gauges shown as the latest reading
DEFAULT_KEYS = ("step_ms_count", "train_mfu_pct_max", "train_loss_max",
                "train_nonfinite_loss", "dispatch_count")


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, float):
        if not math.isfinite(v):
            return repr(v)
        return "%.4g" % v
    return str(v)


def detect_kind(records):
    """``"autopilot"``, ``"remediator"``, ``"fleet"``, or ``"watchtower"``
    from the journal's own records: the autopilot meta carries a ``knobs``
    map, the remediator meta a ``families`` list, the fleet canary meta a
    ``canary`` marker; the watchtower meta has none of them and its
    stream is ``alert`` records."""
    for rec in records:
        if rec.get("kind") == "meta":
            if "knobs" in rec:
                return "autopilot"
            if "families" in rec:
                return "remediator"
            if rec.get("canary"):
                return "fleet"
            return "watchtower"
    for rec in records:
        if rec.get("kind") == "action":
            return "remediator" if "action" in rec else "autopilot"
        if rec.get("kind") == "alert":
            return "watchtower"
    return "watchtower"


def _proposals(actions):
    """The comparable decision set: ``(knob, to)`` of every proposal —
    replay runs dry, so only the proposed stage exists on both sides."""
    return {(a.get("knob"), str(a.get("to"))) for a in actions
            if a.get("stage") == "proposed"}


def autopilot_report(args, records, overrides):
    from tensorflowonspark_torch import autopilot

    result = autopilot.replay_journal(records, config=overrides)
    journaled = result["journaled_actions"]
    replayed = result["actions"]
    live, rep = _proposals(journaled), _proposals(replayed)
    divergence = {"live_only": sorted(live - rep),
                  "replay_only": sorted(rep - live)}

    if args.json:
        json.dump({"kind": "autopilot", "journal": args.journal,
                   "snapshots": result["snapshots"],
                   "config": result["config"],
                   "journaled_actions": journaled,
                   "replayed_actions": replayed,
                   "divergence": divergence}, sys.stdout, default=str)
        print()
        return 0 if result["snapshots"] else 2

    print("journal: %s (autopilot)" % args.journal)
    print("snapshot records: %d, journaled actions: %d, "
          "replayed proposals: %d"
          % (result["snapshots"], len(journaled), len(replayed)))
    t0 = min((r.get("time", 0.0) for r in records
              if r.get("kind") in ("snapshot", "action")), default=0.0)
    if journaled:
        print("\nlive action stream:")
        for a in journaled:
            eff = ""
            if a.get("stage") in ("effect", "kept", "reverted"):
                eff = "  objective %s -> %s" % (
                    _fmt(a.get("objective_before")),
                    _fmt(a.get("objective_after")))
            print("  [t+%7.1fs] #%-3s %-9s %-24s %s -> %s (%s)%s"
                  % (a.get("time", 0.0) - t0, a.get("seq"), a.get("stage"),
                     a.get("knob"), _fmt(a.get("from")), _fmt(a.get("to")),
                     a.get("signal"), eff))
    else:
        print("\nno actions journaled by the live run")
    if replayed:
        print("\nreplay-derived proposals (decision logic re-run dry):")
        for a in replayed:
            print("  [t+%7.1fs] %-24s %s -> %s (%s)"
                  % (a.get("time", 0.0) - t0, a.get("knob"),
                     _fmt(a.get("from")), _fmt(a.get("to")),
                     a.get("signal")))
    else:
        print("\nno proposals re-derived at these thresholds")
    if divergence["live_only"]:
        print("\nproposed live but not re-derived (actuation changed the "
              "telemetry the replay reads, or config overrides): %s"
              % divergence["live_only"])
    if divergence["replay_only"]:
        print("re-derived but never proposed live: %s"
              % divergence["replay_only"])
    if not divergence["live_only"] and not divergence["replay_only"]:
        print("\nlive and replay decision streams agree")
    if not result["snapshots"]:
        print("no snapshot records: nothing to evaluate", file=sys.stderr)
        return 2
    return 0


def _action_proposals(actions):
    """The comparable decision set for a remediator journal: ``(action,
    executor)`` of every proposal — replay runs dry, so only the proposed
    stage exists on both sides."""
    return {(a.get("action"), str(a.get("executor"))) for a in actions
            if a.get("stage") == "proposed"}


def remediator_report(args, records, overrides):
    from tensorflowonspark_torch import remediator

    result = remediator.replay_journal(records, config=overrides)
    journaled = result["journaled_actions"]
    replayed = result["actions"]
    live, rep = _action_proposals(journaled), _action_proposals(replayed)
    divergence = {"live_only": sorted(live - rep),
                  "replay_only": sorted(rep - live)}

    if args.json:
        json.dump({"kind": "remediator", "journal": args.journal,
                   "snapshots": result["snapshots"],
                   "alerts": result["alerts"],
                   "config": result["config"],
                   "journaled_actions": journaled,
                   "replayed_actions": replayed,
                   "divergence": divergence}, sys.stdout, default=str)
        print()
        return 0 if (result["snapshots"] or result["alerts"]) else 2

    print("journal: %s (remediator)" % args.journal)
    print("snapshot records: %d, alert records: %d, journaled actions: %d, "
          "replayed proposals: %d"
          % (result["snapshots"], result["alerts"], len(journaled),
             len(replayed)))
    t0 = min((r.get("time", 0.0) for r in records
              if r.get("kind") in ("snapshot", "action", "alert")),
             default=0.0)
    if journaled:
        print("\nlive action stream:")
        for a in journaled:
            eff = ""
            if a.get("stage") in ("effect", "kept", "reverted"):
                eff = "  objective %s -> %s" % (
                    _fmt(a.get("objective_before")),
                    _fmt(a.get("objective_after")))
            print("  [t+%7.1fs] #%-3s %-9s %-20s executor=%-6s (%s)%s"
                  % (a.get("time", 0.0) - t0, a.get("seq"), a.get("stage"),
                     a.get("action"), a.get("executor"), a.get("rule"), eff))
    else:
        print("\nno actions journaled by the live run")
    if replayed:
        print("\nreplay-derived proposals (decision logic re-run dry):")
        for a in replayed:
            print("  [t+%7.1fs] %-20s executor=%-6s (%s)"
                  % (a.get("time", 0.0) - t0, a.get("action"),
                     a.get("executor"), a.get("rule")))
    else:
        print("\nno proposals re-derived at these thresholds")
    if divergence["live_only"]:
        print("\nproposed live but not re-derived (actuation changed the "
              "telemetry the replay reads, or config overrides): %s"
              % divergence["live_only"])
    if divergence["replay_only"]:
        print("re-derived but never proposed live: %s"
              % divergence["replay_only"])
    if not divergence["live_only"] and not divergence["replay_only"]:
        print("\nlive and replay decision streams agree")
    if not result["snapshots"] and not result["alerts"]:
        print("no snapshot or alert records: nothing to evaluate",
              file=sys.stderr)
        return 2
    return 0


def fleet_report(args, records, overrides):
    """The fleet canary's journal: the port's
    :func:`~tensorflowonspark_torch.fleet.replay_journal` re-runs the window
    judgement over the journaled samples; the live stage stream and the
    live-vs-replay decision streams are printed."""
    from tensorflowonspark_torch import fleet

    result = fleet.replay_journal(records, config=overrides)
    derived, journaled = result["decisions"], result["journaled"]
    samples = sum(1 for r in records if r.get("kind") == "sample")
    stages = [r for r in records if r.get("kind") == "stage"]

    if args.json:
        json.dump({"kind": "fleet", "journal": args.journal,
                   "samples": samples, "config": result["config"],
                   "journaled_decisions": [list(d) for d in journaled],
                   "replayed_decisions": [list(d) for d in derived],
                   "matches": result["matches"]}, sys.stdout, default=str)
        print()
        return 0 if samples else 2

    print("journal: %s (fleet canary)" % args.journal)
    print("sample records: %d, stage records: %d, journaled decisions: %d, "
          "re-derived decisions: %d"
          % (samples, len(stages), len(journaled), len(derived)))
    t0 = min((r.get("time", 0.0) for r in records
              if r.get("kind") in ("sample", "stage")), default=0.0)
    if stages:
        print("\nlive canary stream:")
        for rec in stages:
            extra = ""
            if rec.get("stage") == "reverted":
                extra = "  reason=%s -> %s" % (rec.get("reason"),
                                               rec.get("rolled_back_to"))
            elif rec.get("stage") == "applied":
                extra = "  split=%s" % (rec.get("split"),)
            print("  [t+%7.1fs] %-9s %s@%s replica=%s%s"
                  % (rec.get("time", 0.0) - t0, rec.get("stage"),
                     rec.get("model"), rec.get("version"),
                     rec.get("replica", "-"), extra))
    else:
        print("\nno canary stages journaled by the live run")
    if derived:
        print("\nre-derived decisions (window judgement re-run over the "
              "journaled samples):")
        for stage, model, version in derived:
            print("  %-9s %s@%s" % (stage, model, version))
    else:
        print("\nno decisions re-derived from the samples")
    if result["matches"]:
        print("\nlive and replay decision streams agree")
    else:
        print("\nDIVERGENCE: journaled %s vs re-derived %s"
              % (journaled, derived))
    if not samples:
        print("no sample records: nothing to evaluate", file=sys.stderr)
        return 2
    return 0 if result["matches"] else 1


def build_timeline(records, result, keys):
    """One row per (snapshot time, node): selected counters plus the
    average step time derived from the ``step_ms_*`` histogram deltas and
    the rules that fired at that timestamp."""
    snaps = sorted((r for r in records if r.get("kind") == "snapshot"),
                   key=lambda r: r.get("time", 0))
    if not snaps:
        return []
    t0 = snaps[0].get("time", 0.0)
    alerts_by_time = {}
    for a in result["alerts"]:
        alerts_by_time.setdefault(round(a.get("time", 0.0), 3), []).append(a)
    prev = {}
    rows = []
    for rec in snaps:
        now = rec.get("time", 0.0)
        fired = alerts_by_time.get(round(now, 3), [])
        for node in sorted((rec.get("snapshot") or {}).get("nodes") or {}):
            c = rec["snapshot"]["nodes"][node]
            if not isinstance(c, dict):
                continue
            row = {"t": now - t0, "node": node}
            # avg ms/step over the delta from this node's previous snapshot
            p = prev.get(node, {})
            dn = c.get("step_ms_count", 0) - p.get("step_ms_count", 0)
            dus = c.get("step_ms_sum_us", 0) - p.get("step_ms_sum_us", 0)
            row["step_ms"] = dus / dn / 1000.0 if dn > 0 else None
            for key in keys:
                row[key] = c.get(key)
            row["alerts"] = ",".join(
                a.get("rule", "?") for a in fired
                if str(a.get("executor")) == node) or ""
            rows.append(row)
            prev[node] = c
    return rows


def render_table(rows, keys):
    cols = ["t", "node", "step_ms"] + list(keys) + ["alerts"]
    header = {"t": "t+secs", "step_ms": "ms/step"}
    table = [[header.get(c, c) for c in cols]]
    for row in rows:
        table.append(["%.1f" % row["t"] if c == "t" else _fmt(row.get(c))
                      for c in cols])
    widths = [max(len(r[i]) for r in table) for i in range(len(cols))]
    lines = []
    for i, r in enumerate(table):
        lines.append("  ".join(v.ljust(w) for v, w in zip(r, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Re-run the watchtower rule engine (or the autopilot "
                    "decision logic) over a metrics journal and render a "
                    "per-node timeline / action stream.")
    ap.add_argument("journal",
                    help="path to a watchtower or autopilot journal.jsonl")
    ap.add_argument("--kind",
                    choices=("auto", "watchtower", "autopilot",
                             "remediator", "fleet"),
                    default="auto",
                    help="journal flavor (default: detect from the meta "
                         "record)")
    ap.add_argument("--config", default=None,
                    help="JSON dict of rule-config overrides "
                         "(see watchtower.DEFAULT_CONFIG / "
                         "autopilot.DEFAULT_CONFIG)")
    ap.add_argument("--keys", default=",".join(DEFAULT_KEYS),
                    help="comma-separated counter keys for the timeline "
                         "columns (default: %(default)s)")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON document instead "
                         "of the human report")
    ap.add_argument("--limit", type=int, default=None,
                    help="show only the last N timeline rows")
    args = ap.parse_args(argv)

    overrides = json.loads(args.config) if args.config else None
    keys = tuple(k for k in args.keys.split(",") if k)

    records = watchtower.read_journal(args.journal)
    kind = args.kind if args.kind != "auto" else detect_kind(records)
    if kind == "autopilot":
        return autopilot_report(args, records, overrides)
    if kind == "remediator":
        return remediator_report(args, records, overrides)
    if kind == "fleet":
        return fleet_report(args, records, overrides)
    result = watchtower.replay_journal(records, config=overrides)
    rows = build_timeline(records, result, keys)
    if args.limit:
        rows = rows[-args.limit:]

    if args.json:
        json.dump({"journal": args.journal,
                   "snapshots": result["snapshots"],
                   "config": result["config"],
                   "journaled_alerts": result["journaled_alerts"],
                   "replayed_alerts": result["alerts"],
                   "timeline": rows}, sys.stdout, default=str)
        print()
        return 0 if result["snapshots"] else 2

    print("journal: %s" % args.journal)
    print("snapshot records: %d, journaled alerts: %d, replayed alerts: %d"
          % (result["snapshots"], len(result["journaled_alerts"]),
             len(result["alerts"])))
    if not result["snapshots"]:
        print("no snapshot records: nothing to evaluate", file=sys.stderr)
        return 2
    t0 = min((r.get("time", 0.0) for r in records
              if r.get("kind") == "snapshot"), default=0.0)
    if result["alerts"]:
        print("\nreplayed alerts (rule engine re-run over the journal):")
        for a in result["alerts"]:
            print("  [t+%7.1fs] %-24s executor=%-6s %s"
                  % (a.get("time", 0.0) - t0, a.get("rule"),
                     a.get("executor"), a.get("message", "")))
    else:
        print("\nno alerts re-derived at these thresholds")
    live = {(a.get("rule"), str(a.get("executor")))
            for a in result["journaled_alerts"]}
    replayed = {(a.get("rule"), str(a.get("executor")))
                for a in result["alerts"]}
    only_live = sorted(live - replayed)
    only_replay = sorted(replayed - live)
    if only_live:
        print("journaled live but not re-derived (threshold overrides or "
              "sub-snapshot transients): %s" % only_live)
    if only_replay:
        print("re-derived but not journaled live: %s" % only_replay)
    print("\nper-node timeline:")
    print(render_table(rows, keys))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:   # |head closed our stdout mid-report
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
