"""CLI: ``python -m repro_torch.core.analysis`` — audit the whole registry.

Walks the derived (kernel, backend) matrix, runs the seven static passes,
writes a ``repro_torch.analysis/v1`` JSON report (``--out``, default
``ANALYSIS_report_torch.json``) and exits nonzero iff a finding that is not
waived survives.  ``--smoke`` audits the smoke kernels at their default
points only.  Nothing is built or launched, so it runs on a host without a
card; the port's shards share one device, so there is no re-execution
under forced devices.
"""

from __future__ import annotations

import argparse

ARTIFACT = "ANALYSIS_report_torch.json"


def _print_summary(report) -> None:
    s = report["summary"]
    print(f"static analysis: {s['cells']} cells, {s['audited']} audited, "
          f"{s['findings']} finding(s), {s['waived']} waived, "
          f"{s['skips']} skip(s) [chip={report.get('chip')}, "
          f"device_count={report['device_count']}"
          f"{', smoke' if report['smoke'] else ''}]")
    drift = report.get("drift", {})
    if drift:
        cal = drift.get("calibration")
        cal_s = f"{cal:.3g}x" if cal is not None else "n/a"
        print(f"  perf model: {len(report.get('cost', {}))} cells costed, "
              f"drift joins {drift.get('joined', 0)}/"
              f"{drift.get('measurements', 0)} (calibration {cal_s}, band "
              f"{drift.get('band')}x)")
    for f in report["findings"]:
        print(f"  FINDING {f['kernel']}[{f['backend']}] {f['pass_name']}/"
              f"{f['code']}: {f['message']}")
    for f in report["waived"]:
        print(f"  waived  {f['kernel']}[{f['backend']}] {f['pass_name']}/"
              f"{f['code']}: {f['waive_reason']}")
    for s_ in report["skips"]:
        print(f"  skip    {s_['kernel']}[{s_['backend']}] "
              f"{s_['pass_name']}: {s_['reason']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analysis",
        description="static kernel auditor over the live registry")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke kernels, default points only")
    ap.add_argument("--out", default=ARTIFACT,
                    help=f"report path (default {ARTIFACT})")
    ap.add_argument("--tuning-cache", default=None,
                    help="tuning cache joined by the drift pass (default "
                         "$REPRO_TORCH_TUNING_CACHE or "
                         "~/.cache/repro_torch/tuning.json)")
    ap.add_argument("--telemetry", default=None,
                    help="telemetry JSONL trace whose "
                         "registry.time_backend.result events feed the "
                         "drift pass")
    ap.add_argument("--drift-band", type=float, default=None,
                    help="drift tolerance (x the calibrated median; "
                         "default 8)")
    args = ap.parse_args(argv)

    from repro_torch.core import analysis
    report = analysis.audit_registry(smoke=args.smoke,
                                     tuning_cache=args.tuning_cache,
                                     telemetry_trace=args.telemetry,
                                     drift_band=args.drift_band)
    analysis.write_report(report, args.out)
    _print_summary(report)
    raise SystemExit(1 if report["summary"]["findings"] else 0)


if __name__ == "__main__":
    main()
