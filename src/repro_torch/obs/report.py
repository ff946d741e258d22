"""Health + profile dashboard: ``python -m repro_torch.obs.report``.

Renders the judgment layer's state as a terminal dashboard, from either a
**live server** (fetches one debug bundle over the existing tagged-value
wire — no extra protocol) or a **saved bundle** (the artifact
:func:`repro_torch.obs.debug_bundle` wrote), so a postmortem reads identically
to a live health check::

    python -m repro_torch.obs.report --port 7654            # live server
    python -m repro_torch.obs.report --bundle bundle.json   # saved artifact
    python -m repro_torch.obs.report --port 7654 --save bundle.json

Sections: overall verdict + reasons, the per-op SLO table (traffic, burn
rate, windowed quantiles vs objective), the engine profile table
(:func:`repro_torch.obs.profile.profile_report`), flight-recorder exemplars
(most recent per op, with their captured queue depth and counter deltas),
trace-ring accounting (including dropped-span counts), and the log tail.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from .profile import profile_report

__all__ = ["render_bundle", "main"]


def _fmt_ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.2f}"


def render_health(health: Optional[Dict[str, Any]]) -> List[str]:
    lines = []
    if not health:
        return ["health: unavailable (SLO tracker disabled or absent)"]
    lines.append(f"health: {health.get('status', '?').upper()}  "
                 f"(window {health.get('window_s', '?')}s)")
    for reason in health.get("reasons") or []:
        lines.append(f"  ! {reason}")
    return lines


def render_slo(report: Optional[Dict[str, Any]]) -> List[str]:
    lines = ["slo window"]
    ops = (report or {}).get("ops") or {}
    if not ops:
        lines.append("  (no completed requests in the window)")
        return lines
    w = max(len(op) for op in ops)
    lines.append(f"  {'op':<{w}}  {'n':>6}  {'bad':>5}  {'burn':>8}  "
                 f"{'p50ms':>9}  {'p99ms':>9}  {'objective':>12}")
    for op in sorted(ops):
        r = ops[op]
        bad = r.get("slow", 0) + r.get("errors", 0) + r.get("expired", 0)
        obj = r.get("objective") or {}
        lines.append(
            f"  {op:<{w}}  {r.get('n', 0):>6}  {bad:>5}  "
            f"{r.get('burn_rate', 0):>8.2f}  "
            f"{_fmt_ms(r.get('p50_ms')):>9}  "
            f"{_fmt_ms(r.get('p99_ms')):>9}  "
            f"{obj.get('latency_ms', 0):>10.0f}ms")
    return lines


def render_exemplars(exemplars: Optional[Dict[str, Any]],
                     per_op: int = 2) -> List[str]:
    lines = ["flight recorder"]
    if not exemplars:
        lines.append("  (no exemplars captured — nothing slow or failed)")
        return lines
    for op in sorted(exemplars):
        for ex in list(exemplars[op])[-per_op:]:
            why = ex.get("outcome")
            if why == "ok" and ex.get("slow"):
                why = "slow"
            lines.append(
                f"  {op}: {why}  latency={_fmt_ms(ex.get('latency_ms'))}ms"
                f"  queued={_fmt_ms(ex.get('queued_ms'))}ms"
                f"  engine={_fmt_ms(ex.get('engine_ms'))}ms"
                f"  depth={ex.get('queue_depth')}"
                f"  spans={len(ex.get('spans') or [])}"
                f"  trace={ex.get('trace')}")
            if ex.get("error"):
                lines.append(f"      error: {ex['error']}")
    return lines


def render_bundle(bundle: Dict[str, Any]) -> str:
    """The full dashboard for one debug bundle (live or loaded)."""
    lines: List[str] = []
    created = bundle.get("created_unix")
    lines.append(f"debug bundle v{bundle.get('version', '?')}  "
                 f"created_unix={created}")
    lines.extend(render_health(bundle.get("health")))
    lines.append("")
    lines.extend(render_slo(bundle.get("slo")))
    lines.append("")
    profile = bundle.get("profile")
    if profile is None and bundle.get("metrics"):
        profile = profile_report(bundle["metrics"])
    lines.append((profile or "engine profile\n  (unavailable)").rstrip())
    lines.append("")
    lines.extend(render_exemplars(bundle.get("exemplars")))
    tracer = bundle.get("tracer") or {}
    if tracer:
        lines.append("")
        lines.append(f"trace ring: buffered={tracer.get('buffered')}"
                     f"/{tracer.get('capacity')}  "
                     f"dropped={tracer.get('dropped')}")
    tail = bundle.get("log_tail") or []
    lines.append(f"log tail: {len(tail)} record(s)")
    for rec in tail[-5:]:
        lines.append(f"  [{rec.get('level')}] {rec.get('logger')}: "
                     f"{rec.get('message')}")
    return "\n".join(lines) + "\n"


def _fetch_live(host: str, port: int, save: Optional[str],
                device: Optional[str] = None) -> Dict[str, Any]:
    from ..serve.client import RemoteService
    svc = RemoteService(host=host, port=port, device=device)
    try:
        return svc.debug_bundle(path=save)
    finally:
        svc.close()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render the SLO health + engine profile dashboard "
                    "from a live server or a saved debug bundle.")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--port", type=int, help="live server port")
    src.add_argument("--bundle", help="path to a saved debug-bundle JSON")
    ap.add_argument("--host", default="127.0.0.1",
                    help="live server host (default 127.0.0.1)")
    ap.add_argument("--save", default=None,
                    help="with --port: also save the fetched bundle here")
    ap.add_argument("--device", default=None,
                    help="with --port: the client's device (default: the "
                         "card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    if args.bundle:
        with open(args.bundle) as f:
            bundle = json.load(f)
        if bundle.get("kind") != "repro-debug-bundle":
            print(f"error: {args.bundle} is not a repro debug bundle",
                  file=sys.stderr)
            return 2
    else:
        bundle = _fetch_live(args.host, args.port, args.save, args.device)
    sys.stdout.write(render_bundle(bundle))
    return 0


if __name__ == "__main__":
    sys.exit(main())
