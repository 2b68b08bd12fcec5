"""Pretty-printer for flight-recorder dumps (runtime/flightrec.py).

Usage:
    python -m gubernator_tpu_torch.cli.flightrec DUMP.json [...]
    python -m gubernator_tpu_torch.cli.flightrec --ring DUMP.json  # full ring
    python -m gubernator_tpu_torch.cli.flightrec flightrec-dumps/  # newest first

Reads the JSON snapshots the daemon writes on SLO breach / error storm /
SIGUSR2 and renders the headline (trigger, rolling percentiles vs the
target, loop lag) plus a per-kind ring digest, so an operator can read a
black box without jq."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List


def _fmt_ts(ts: float) -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))


def _digest_ring(ring: List[Dict]) -> List[str]:
    """Per-kind summary: count, size/latency spread, worst offenders."""
    by_kind: Dict[str, List[Dict]] = {}
    for rec in ring:
        by_kind.setdefault(rec.get("kind", "?"), []).append(rec)
    lines = []
    for kind in sorted(by_kind):
        recs = by_kind[kind]
        line = f"  {kind:<18} x{len(recs)}"
        ms = [r["step_ms"] for r in recs if "step_ms" in r]
        if ms:
            line += "  step_ms min/max %.3f/%.3f" % (min(ms), max(ms))
        sizes = [r["size"] for r in recs if "size" in r]
        if sizes:
            line += "  size min/max %d/%d" % (min(sizes), max(sizes))
        lags = [r["lag_ms"] for r in recs if "lag_ms" in r]
        if lags:
            line += "  lag_ms max %.1f" % max(lags)
        lines.append(line)
    return lines


def render(path: str, show_ring: bool = False) -> str:
    with open(path, encoding="utf-8") as f:
        snap = json.load(f)
    roll = snap.get("rolling", {})
    lag = snap.get("loop_lag_ms", {})
    out = [
        f"== {path}",
        "  reason=%s  pid=%s  at %s" % (
            snap.get("reason", "live"), snap.get("pid"),
            _fmt_ts(snap.get("now", 0)),
        ),
        "  rolling p50=%.3fms p99=%.3fms over %s sample(s) "
        "(target p99 < %sms)" % (
            roll.get("p50_ms", 0.0), roll.get("p99_ms", 0.0),
            roll.get("samples", 0), snap.get("slo_p99_ms"),
        ),
        "  errors_in_window=%s  breaches=%s  dumps=%s  "
        "loop_lag last=%.2fms max=%.2fms" % (
            roll.get("errors_in_window", 0), snap.get("breaches", 0),
            snap.get("dumps", 0), lag.get("last", 0.0),
            lag.get("max", 0.0),
        ),
    ]
    ring = snap.get("ring", [])
    out.append(f"  ring: {len(ring)} record(s)")
    out.extend(_digest_ring(ring))
    if show_ring:
        for rec in ring:
            fields = {
                k: v for k, v in rec.items() if k not in ("ts", "kind")
            }
            out.append(
                "    %s %-16s %s" % (
                    _fmt_ts(rec.get("ts", 0)), rec.get("kind", "?"),
                    json.dumps(fields, sort_keys=True),
                )
            )
    return "\n".join(out)


def _expand(paths: List[str]) -> List[str]:
    """Directories expand to their dumps, newest first."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            dumps = [
                os.path.join(p, n) for n in os.listdir(p)
                if n.startswith("flightrec-") and n.endswith(".json")
            ]
            out.extend(
                sorted(dumps, key=os.path.getmtime, reverse=True)
            )
        else:
            out.append(p)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gubernator_tpu_torch.cli.flightrec",
        description="Pretty-print flight-recorder dumps.",
    )
    ap.add_argument(
        "paths", nargs="+",
        help="dump files or directories of dumps (newest first)",
    )
    ap.add_argument(
        "--ring", action="store_true",
        help="print every ring record, not just the per-kind digest",
    )
    args = ap.parse_args(argv)
    files = _expand(args.paths)
    if not files:
        print("no flight-recorder dumps found", file=sys.stderr)
        return 1
    rc = 0
    for path in files:
        try:
            print(render(path, show_ring=args.ring))
        except (OSError, ValueError) as e:
            print(f"== {path}\n  unreadable: {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
