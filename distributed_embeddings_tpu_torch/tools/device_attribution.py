"""Device-time attribution CLI: parse a `torch.profiler` capture, attribute
its device time to the span annotations that launched it, and print the
measured-against-projected reconciliation table.

Usage:

    python -m distributed_embeddings_tpu_torch.tools.device_attribution \\
        <logdir> [--snapshot metrics_snapshot.json] \\
        [--projections projections.json] [--tolerance 0.5] [--json]

`<logdir>` is the directory `utils.profiling.trace` captured into; the
newest ``plugins/profile/<run>/*.trace.json.gz`` under it is parsed.
``--snapshot`` (a registry snapshot, or a record carrying a
``metrics_snapshot``, e.g. `fit`'s history) pins the span windows to the
run's recorded ``span_seconds{span=}`` paths; without it a shape
fallback matches annotation-looking events. ``--projections`` is a flat
``{phase: projected_ms}`` JSON; each row settles or falsifies against
the measured per-span device time. Exit 0 unless parsing fails: the
table is evidence, not a gate.

The counterpart of the JAX package's ``tools/device_attribution.py``.
"""

import argparse
import json
import sys

from distributed_embeddings_tpu_torch.obs import attribution


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="attribute profiler device time to span annotations")
    p.add_argument("logdir", help="profiler capture directory")
    p.add_argument("--snapshot", default=None,
                   help="registry snapshot JSON whose span_seconds keys "
                        "pin the window set")
    p.add_argument("--projections", default=None,
                   help="{phase: projected_ms} JSON to reconcile against")
    p.add_argument("--tolerance", type=float, default=0.5,
                   help="relative tolerance for a projection to settle")
    p.add_argument("--json", action="store_true",
                   help="emit the attribution dict as one JSON line")
    args = p.parse_args(argv)

    span_paths = None
    if args.snapshot:
        with open(args.snapshot) as f:
            span_paths = attribution.span_paths_from_snapshot(json.load(f))
    try:
        att = attribution.attribute_logdir(args.logdir,
                                           span_paths=span_paths)
    except FileNotFoundError as e:
        print(f"device_attribution: {e}", file=sys.stderr)
        return 1
    if args.projections:
        with open(args.projections) as f:
            proj = json.load(f)
        att["reconciliation"] = attribution.reconciliation_table(
            att, proj, tolerance_frac=args.tolerance)
    if args.json:
        print(json.dumps(att))
        return 0

    total_ms = att["total_device_seconds"] * 1e3
    print(f"trace: {att['trace_file']}")
    print(f"device total: {total_ms:.3f} ms over "
          f"{att['device_op_count']} ops ({att['op_source']}); "
          f"{att['span_window_count']} span windows; "
          f"coverage {att['coverage_frac']:.1%}")
    width = max([len(s) for s in att["spans"]] + [14])
    for span, sec in sorted(att["spans"].items(), key=lambda kv: -kv[1]):
        print(f"  {span:<{width}}  {sec * 1e3:10.3f} ms"
              f"  {sec * 1e3 / max(total_ms, 1e-9):6.1%}")
    print(f"  {'(unattributed)':<{width}}  "
          f"{att['unattributed_seconds'] * 1e3:10.3f} ms")
    coll = att["collective"]
    if coll["device_seconds"]:
        print(f"collectives: {coll['device_seconds'] * 1e3:.3f} ms, "
              f"exposed {coll['exposed_seconds'] * 1e3:.3f} ms "
              f"(fraction {coll['exposed_fraction']})")
    else:
        print("collectives: 0 device operations")
    for row in att.get("reconciliation", []):
        print(f"  [{row['verdict']:>10}] {row['phase']}: projected "
              f"{row['projected_ms']} ms, measured {row['measured_ms']} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
