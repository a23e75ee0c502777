"""Run-report diff and regression gate (counterpart of
kaminpar_tpu/telemetry/diff.py: pure dict code over two reports, so a
report of either package diffs against one of the other).

`python -m kaminpar_tpu_torch.telemetry.diff BASE.report.json CAND.report.json`
aligns two run reports (schema v1 through v5) by dotted scope path, by
progress series, and — for serving runs — by request id, prints the
wall / cut / convergence / serving deltas, and exits non-zero when the
candidate regresses past the configurable thresholds — the mechanical
answer to "are these two runs the same solver?" that the reference's
parseable timer output only enables by hand.

Gated (exit 1 on regression):
  * edge cut:        cand.result.cut  > base * (1 + --cut-threshold)
  * feasibility:     base feasible but cand infeasible
  * total wall:      cand wall > base * (1 + --wall-threshold), with an
                     absolute --min-wall-s floor so micro-run noise
                     cannot trip the gate
  * serving (both reports carry an enabled v4+ `serving` section):
      - served rate: cand served a smaller fraction of its batch than
        base (rate, not absolute count — batch sizes may differ)
      - cache hit rate: cand dropped more than --hit-rate-threshold
        (absolute) below base

Informational (printed, never gated):
  * per-scope wall deltas (scope_tree alignment, largest first)
  * compile vs execute split deltas (schema v2 `compile` section)
  * progress-series convergence deltas: iterations to converge and, for
    series carrying a `cut` stat, the final per-series cut
  * per-request verdict transitions (serving requests aligned by id)
  * roofline totals deltas (schema v5 `perf` section: bytes, hbm_util,
    pad waste)
  * quality attribution deltas (schema v7 `quality` section: per-level
    coarsening_locked / refinement_left movement and verdict flips)
  * comm-volume deltas (schema v12 `comm` section: bytes_total and
    per-phase traced collective payload movement)

Exit codes: 0 pass, 1 regression, 2 usage/IO error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

DEFAULT_WALL_THRESHOLD = 0.10
DEFAULT_CUT_THRESHOLD = 0.10
DEFAULT_MIN_WALL_S = 0.05
#: absolute serving cache hit-rate drop tolerated before the gate fires
DEFAULT_HIT_RATE_THRESHOLD = 0.10


def load_report(path: str) -> dict:
    with open(path) as f:
        report = json.load(f)
    if not isinstance(report, dict) or "schema_version" not in report:
        raise ValueError(f"{path}: not a run report (no schema_version)")
    return report


def total_wall_s(report: dict) -> Optional[float]:
    """Total partitioning wall: the CLI's measured seconds when present,
    else the scope tree's top-level elapsed sum."""
    run = report.get("run", {})
    for key in ("partition_seconds", "wall_seconds"):
        v = run.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    tree = report.get("scope_tree", {})
    if tree:
        return sum(
            float(node.get("elapsed_s", 0.0)) for node in tree.values()
        )
    return None


def flatten_scopes(tree: dict, prefix: str = "") -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, node in tree.items():
        path = f"{prefix}.{name}" if prefix else name
        out[path] = float(node.get("elapsed_s", 0.0))
        out.update(flatten_scopes(node.get("children", {}), path))
    return out


def _progress_key(entry: dict) -> Tuple:
    attrs = entry.get("attrs", {})
    return (
        entry.get("kind", ""),
        entry.get("path", ""),
        attrs.get("level"),
        attrs.get("round"),
    )


def align_progress(base: dict, cand: dict) -> List[Tuple[dict, dict]]:
    """Pair progress series by (kind, path, level, round), in order of
    appearance within each key (k-th occurrence pairs with k-th)."""
    def grouped(report):
        groups: Dict[Tuple, List[dict]] = {}
        for entry in report.get("progress", []) or []:
            groups.setdefault(_progress_key(entry), []).append(entry)
        return groups

    gb, gc = grouped(base), grouped(cand)
    pairs: List[Tuple[dict, dict]] = []
    for key, bs in gb.items():
        cs = gc.get(key, [])
        for b, c in zip(bs, cs):
            pairs.append((b, c))
    return pairs


def _final(series: dict, name: str) -> Optional[float]:
    vals = series.get("series", {}).get(name)
    if vals:
        return float(vals[-1])
    return None


def _pct(new: float, old: float) -> str:
    if old == 0:
        return "n/a" if new == 0 else "+inf"
    return f"{100.0 * (new - old) / abs(old):+.1f}%"


def diff_serving(
    base: dict,
    cand: dict,
    hit_rate_threshold: float = DEFAULT_HIT_RATE_THRESHOLD,
) -> Tuple[List[str], List[str]]:
    """Serving-section diff (schema v4+): align requests by id, report
    verdict transitions, gate served-rate and cache-hit-rate
    regressions.  Returns (lines, failures); both empty unless BOTH
    reports carry an enabled serving section — a single-shot run diffed
    against a serving run is a workload change, not a regression."""
    sb = base.get("serving") or {}
    sc = cand.get("serving") or {}
    lines: List[str] = []
    failures: List[str] = []
    if not (sb.get("enabled") and sc.get("enabled")):
        if sb.get("enabled") != sc.get("enabled"):
            lines.append(
                "serving: only "
                + ("base" if sb.get("enabled") else "cand")
                + " ran in serve mode (section not compared)"
            )
        return lines, failures

    counts_b = sb.get("counts") or {}
    counts_c = sc.get("counts") or {}
    served_b = int(counts_b.get("served", 0))
    served_c = int(counts_c.get("served", 0))
    total_b = sum(int(v) for v in counts_b.values())
    total_c = sum(int(v) for v in counts_c.values())
    lines.append(
        "serving: served {}/{} -> {}/{}, failed {} -> {}, "
        "rejected {} -> {}".format(
            served_b, total_b, served_c, total_c,
            counts_b.get("failed", 0), counts_c.get("failed", 0),
            counts_b.get("rejected", 0), counts_c.get("rejected", 0),
        )
    )
    # gate on the served *rate*, not the absolute count — base and cand
    # may come from different batch sizes, and a 12/12 candidate is no
    # regression against a 16/16 base
    if total_b > 0 and total_c > 0:
        rate_b = served_b / total_b
        rate_c = served_c / total_c
        if rate_c < rate_b - 1e-9:
            failures.append(
                "served rate regressed: "
                f"{served_b}/{total_b} -> {served_c}/{total_c}"
            )

    hr_b = (sb.get("cache") or {}).get("hit_rate")
    hr_c = (sc.get("cache") or {}).get("hit_rate")
    if hr_b is not None and hr_c is not None:
        lines.append(f"serving cache hit_rate: {hr_b} -> {hr_c}")
        if float(hr_c) < float(hr_b) - hit_rate_threshold:
            failures.append(
                f"serving cache hit rate regressed {hr_b} -> {hr_c} "
                f"(threshold -{hit_rate_threshold})"
            )

    # per-request alignment by id: verdict transitions are the triage
    # detail behind a served-count regression (informational — the
    # count gate above decides pass/fail)
    rb = {r.get("request_id"): r for r in sb.get("requests") or []}
    rc = {r.get("request_id"): r for r in sc.get("requests") or []}
    changed = [
        (rid, rb[rid].get("verdict"), rc[rid].get("verdict"))
        for rid in rb
        if rid in rc and rb[rid].get("verdict") != rc[rid].get("verdict")
    ]
    for rid, vb, vc in changed[:8]:
        lines.append(f"  request {rid}: {vb} -> {vc}")
    only_b = sorted(set(rb) - set(rc))
    only_c = sorted(set(rc) - set(rb))
    if only_b:
        lines.append(f"  requests only in base: {only_b[:5]}")
    if only_c:
        lines.append(f"  requests only in cand: {only_c[:5]}")

    # latency movement (informational): p95 of the caller-observed total
    def p95(s):
        return (
            ((s.get("latency") or {}).get("phases") or {})
            .get("total", {}).get("p95_ms")
        )

    pb, pc = p95(sb), p95(sc)
    if pb is not None and pc is not None:
        lines.append(f"serving p95 total: {pb}ms -> {pc}ms")
    return lines, failures


def diff_quality(base: dict, cand: dict) -> Tuple[List[str], List[str]]:
    """Quality-section diff (schema v7): align levels by level index,
    report per-level locked/left deltas and verdict flips, plus the
    headline fraction movement.  Informational — the cut gate above is
    the pass/fail signal; attribution tells you WHERE it moved.  Both
    reports must carry an enabled quality section (a pre-v7 baseline is
    a schema transition, not a regression)."""
    qb = base.get("quality") or {}
    qc = cand.get("quality") or {}
    lines: List[str] = []
    failures: List[str] = []
    if not (qb.get("enabled") and qc.get("enabled")):
        if qb.get("enabled") != qc.get("enabled"):
            lines.append(
                "quality: only "
                + ("base" if qb.get("enabled") else "cand")
                + " carries a quality section (not compared)"
            )
        return lines, failures

    tb = qb.get("totals") or {}
    tc = qc.get("totals") or {}
    lines.append(
        "quality: gap_mass {} -> {}, coarsening_locked_frac {} -> {}, "
        "refinement_left_frac {} -> {}".format(
            tb.get("gap_mass"), tc.get("gap_mass"),
            tb.get("coarsening_locked_frac"),
            tc.get("coarsening_locked_frac"),
            tb.get("refinement_left_frac"),
            tc.get("refinement_left_frac"),
        )
    )
    lb = {row.get("level"): row for row in qb.get("levels") or []}
    lc = {row.get("level"): row for row in qc.get("levels") or []}
    for level in sorted(set(lb) & set(lc)):
        rb_, rc_ = lb[level], lc[level]
        bits = []
        for key, label in (("coarsening_locked", "locked"),
                           ("refinement_left", "left")):
            vb, vc = rb_.get(key), rc_.get(key)
            if vb is not None and vc is not None and vb != vc:
                bits.append(f"{label} {vb} -> {vc}")
        vb, vc = rb_.get("verdict"), rc_.get("verdict")
        if vb is not None and vc is not None and vb != vc:
            bits.append(f"verdict {vb} -> {vc}")
        if bits:
            lines.append(f"  quality level {level}: " + ", ".join(bits))
    only_b = sorted(set(lb) - set(lc))
    only_c = sorted(set(lc) - set(lb))
    if only_b:
        lines.append(f"  quality levels only in base: {only_b[:5]}")
    if only_c:
        lines.append(f"  quality levels only in cand: {only_c[:5]}")
    return lines, failures


def diff_reports(
    base: dict,
    cand: dict,
    wall_threshold: float = DEFAULT_WALL_THRESHOLD,
    cut_threshold: float = DEFAULT_CUT_THRESHOLD,
    min_wall_s: float = DEFAULT_MIN_WALL_S,
    hit_rate_threshold: float = DEFAULT_HIT_RATE_THRESHOLD,
) -> Tuple[List[str], List[str]]:
    """Returns (report lines, gated failures); empty failures = pass."""
    lines: List[str] = []
    failures: List[str] = []

    # -- result: cut + feasibility (the gate's primary signal) -----------
    rb, rc = base.get("result", {}), cand.get("result", {})
    cut_b, cut_c = rb.get("cut"), rc.get("cut")
    if isinstance(cut_b, int) and isinstance(cut_c, int):
        lines.append(f"cut: {cut_b} -> {cut_c} ({_pct(cut_c, cut_b)})")
        if cut_c > cut_b * (1.0 + cut_threshold):
            failures.append(
                f"cut regressed {_pct(cut_c, cut_b)} "
                f"(threshold +{cut_threshold * 100:.0f}%)"
            )
    if rb.get("feasible") is True and rc.get("feasible") is False:
        failures.append("feasibility regressed: base feasible, cand not")

    # -- total wall ------------------------------------------------------
    # gate on EXECUTE wall when both reports meter compile time (schema
    # v2): raw wall embeds XLA compile whose run-to-run jitter exceeds
    # 10% on small runs, so gating it false-positives on identical code;
    # subtracting each report's own compile_s compares what the solver
    # actually did (and makes injected raw-wall regressions MORE
    # visible, since the compile constant cancels)
    wb, wc = total_wall_s(base), total_wall_s(cand)
    if wb is not None and wc is not None:
        lines.append(f"wall: {wb:.3f}s -> {wc:.3f}s ({_pct(wc, wb)})")
        cb = base.get("compile", {}).get("totals", {}).get("compile_s")
        cc = cand.get("compile", {}).get("totals", {}).get("compile_s")
        if cb is not None and cc is not None:
            wb_x = max(wb - float(cb), 0.0)
            wc_x = max(wc - float(cc), 0.0)
            lines.append(
                f"wall minus compile: {wb_x:.3f}s -> {wc_x:.3f}s "
                f"({_pct(wc_x, wb_x)}) [gated]"
            )
        else:
            wb_x, wc_x = wb, wc
        if wc_x > wb_x * (1.0 + wall_threshold) and (wc_x - wb_x) > min_wall_s:
            failures.append(
                f"execute wall regressed {_pct(wc_x, wb_x)} "
                f"(threshold +{wall_threshold * 100:.0f}%, "
                f"floor {min_wall_s}s)"
            )

    # -- per-scope walls (informational) ---------------------------------
    sb = flatten_scopes(base.get("scope_tree", {}))
    sc = flatten_scopes(cand.get("scope_tree", {}))
    deltas = [
        (abs(sc[p] - sb[p]), p, sb[p], sc[p])
        for p in sorted(set(sb) & set(sc))
        if max(sb[p], sc[p]) >= min_wall_s and sc[p] != sb[p]
    ]
    for _, path, b, c in sorted(deltas, reverse=True)[:8]:
        lines.append(f"  scope {path}: {b:.3f}s -> {c:.3f}s ({_pct(c, b)})")
    only_b, only_c = set(sb) - set(sc), set(sc) - set(sb)
    if only_b:
        lines.append(f"  scopes only in base: {sorted(only_b)[:5]}")
    if only_c:
        lines.append(f"  scopes only in cand: {sorted(only_c)[:5]}")

    # -- compile split (schema v2; informational) ------------------------
    tb = base.get("compile", {}).get("totals")
    tc = cand.get("compile", {}).get("totals")
    if tb and tc:
        lines.append(
            f"compile: {tb.get('compile_s', 0.0):.3f}s "
            f"({tb.get('compiles', 0)}x) -> "
            f"{tc.get('compile_s', 0.0):.3f}s ({tc.get('compiles', 0)}x); "
            f"persistent cache {tb.get('persistent_cache_hits', 0)}/"
            f"{tb.get('persistent_cache_misses', 0)} -> "
            f"{tc.get('persistent_cache_hits', 0)}/"
            f"{tc.get('persistent_cache_misses', 0)} hit/miss"
        )

    # -- progress convergence (schema v2; informational) -----------------
    pairs = align_progress(base, cand)
    for b, c in pairs:
        key = _progress_key(b)
        label = f"{key[0]}@{key[1] or '(top)'}"
        if key[2] is not None:
            label += f" level={key[2]}"
        if key[3] is not None:
            label += f" round={key[3]}"
        ib, ic = b.get("iterations", 0), c.get("iterations", 0)
        msg = f"  progress {label}: iters {ib} -> {ic}"
        fb, fc = _final(b, "cut"), _final(c, "cut")
        if fb is not None and fc is not None:
            msg += f", final cut {fb:.0f} -> {fc:.0f} ({_pct(fc, fb)})"
        mb, mc = _final(b, "moved"), _final(c, "moved")
        if mb is not None and mc is not None:
            msg += f", final moved {mb:.0f} -> {mc:.0f}"
        if ib != ic or (fb, mb) != (fc, mc):
            lines.append(msg)
    nb = len(base.get("progress", []) or [])
    nc = len(cand.get("progress", []) or [])
    if nb or nc:
        lines.append(
            f"progress series: {nb} base / {nc} cand, {len(pairs)} aligned"
        )

    # -- serving (schema v4+; gated on served rate + cache hit rate) -----
    s_lines, s_failures = diff_serving(
        base, cand, hit_rate_threshold=hit_rate_threshold
    )
    lines.extend(s_lines)
    failures.extend(s_failures)

    # -- quality attribution (schema v7; informational) ------------------
    q_lines, q_failures = diff_quality(base, cand)
    lines.extend(q_lines)
    failures.extend(q_failures)

    # -- perf roofline totals (schema v5; informational) -----------------
    pb = (base.get("perf") or {}).get("totals") or {}
    pc = (cand.get("perf") or {}).get("totals") or {}
    if pb and pc:
        parts = [
            f"perf: bytes {pb.get('bytes', 0):.3g} -> "
            f"{pc.get('bytes', 0):.3g}"
        ]
        for key in ("hbm_util", "pad_waste"):
            vb, vc = pb.get(key), pc.get(key)
            if vb is not None and vc is not None:
                parts.append(f"{key} {vb} -> {vc}")
        lines.append(", ".join(parts))

    # -- comm volume (schema v12; informational) -------------------------
    # trace-time per-phase collective payloads: a composition change
    # that doubles halo traffic shows up here before it shows up in
    # wall (COMM_CAVEAT: traced bytes per device, not link-level)
    cb_ = base.get("comm") or {}
    cc_ = cand.get("comm") or {}
    phb = cb_.get("phases") or {}
    phc = cc_.get("phases") or {}
    if phb or phc:
        lines.append(
            f"comm bytes_total: {cb_.get('bytes_total', 0)} -> "
            f"{cc_.get('bytes_total', 0)}"
        )
        for phase in sorted(set(phb) | set(phc)):
            vb = (phb.get(phase) or {}).get("bytes_total", 0)
            vc = (phc.get(phase) or {}).get("bytes_total", 0)
            if vb != vc:
                lines.append(f"  comm {phase}: {vb} -> {vc} bytes")
    return lines, failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="kaminpar_tpu_torch.telemetry.diff",
        description="diff two run reports; exit 1 on wall/cut regression",
    )
    ap.add_argument("base", help="baseline run report (--report-json)")
    ap.add_argument("cand", help="candidate run report")
    ap.add_argument(
        "--wall-threshold", type=float, default=DEFAULT_WALL_THRESHOLD,
        help="fractional total-wall regression tolerated (default 0.10)",
    )
    ap.add_argument(
        "--cut-threshold", type=float, default=DEFAULT_CUT_THRESHOLD,
        help="fractional edge-cut regression tolerated (default 0.10)",
    )
    ap.add_argument(
        "--min-wall-s", type=float, default=DEFAULT_MIN_WALL_S,
        help="absolute wall-delta floor below which the wall gate never "
        "fires (default 0.05 s)",
    )
    ap.add_argument(
        "--hit-rate-threshold", type=float,
        default=DEFAULT_HIT_RATE_THRESHOLD,
        help="absolute serving cache hit-rate drop tolerated before the "
        "serving gate fires (default 0.10; only applies when both "
        "reports ran in serve mode)",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="emit the verdict as one JSON line instead of text",
    )
    ap.add_argument("--quiet", action="store_true", help="verdict only")
    args = ap.parse_args(argv)

    try:
        base = load_report(args.base)
        cand = load_report(args.cand)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    lines, failures = diff_reports(
        base, cand,
        wall_threshold=args.wall_threshold,
        cut_threshold=args.cut_threshold,
        min_wall_s=args.min_wall_s,
        hit_rate_threshold=args.hit_rate_threshold,
    )
    if args.json:
        print(json.dumps({
            "base": args.base,
            "cand": args.cand,
            "pass": not failures,
            "failures": failures,
            "detail": lines,
        }))
    else:
        if not args.quiet:
            for line in lines:
                print(line)
        for f in failures:
            print(f"REGRESSION: {f}", file=sys.stderr)
        print(f"DIFF {'FAIL' if failures else 'OK'} "
              f"({len(failures)} regression(s))")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
