"""Batch entry point of the port:

    python -m delphi_tpu_torch.main --input data.csv --row-id tid \\
        --output /tmp/repaired.csv [--repair-data]

Reads a CSV (or a name already registered in the session catalog), runs
the repair pipeline on the port's device (``cuda``; the CPU with
``DELPHI_TORCH_DEVICE=cpu``), and writes the result CSV. ``--detect-only``
emits the error cells instead of repairs; ``--constraints`` adds a
ConstraintErrorDetector; ``--chunksize`` streams the CSV into an encoded
table without one whole pandas frame; ``--escalate`` (with
``--escalate-conf`` and ``--escalate-budget``) runs the escalation pass;
``--provenance-out`` writes the per-cell provenance ledger as JSONL.
``--metrics-out R`` writes the run report to R (per-phase device time with
``DELPHI_PROFILE_DIR``); ``--baseline-report B`` compares this run's
scorecards with B's, and with ``--drift-fail-over X`` the process exits
with code 3 when the max divergence exceeds X.
``--checkpoint-dir D`` keeps each phase's outputs in D, so a run that died
resumes at its last completed phase; ``--fault-plan PLAN`` injects faults
at the resilience plane's sites (an injected ``crash`` exits with code 23).
``--pipeline on|off|auto`` sets the training pipeline thread and
``--compile-cache-dir D`` the kernel library's build cache;
``--plan-report ROOT`` prints the launch-cost ledgers persisted under ROOT
as JSON and exits. With ``DELPHI_COORDINATOR`` set the process joins its
cluster first (``--collective-timeout-s`` bounds the join and every
collective); its default device mesh then shards the statistics, the
domain scoring and the models' rows over the processes, and
``DELPHI_SHARD=1`` with ``DELPHI_MESH=off`` splits the analysis phases
across them instead.

Incremental mode: ``--incremental --snapshot-dir D`` diffs the input
against the snapshot manifest in D, repairs only the delta and updates the
snapshot (the first run populates it). ``--stream N --snapshot-dir D``
ingests the input as N chained deltas against a durable per-stream cursor
in D; a killed run resumes at the last committed chunk, and the output
equals one batch run over the whole input. ``--fsck ROOT`` validates every
store file under ROOT, quarantines corrupt ones and prints a JSON summary
(exit code 4 when it found corruption, 0 otherwise;
``--fsck-report-only`` moves nothing).

``--metrics-port P`` serves live telemetry (``/metrics``, ``/healthz``,
``/report``) on port P for the batch run, with a stall watchdog and a
resource sampler (0 picks an ephemeral port, printed in the log).

Serving: ``--serve [--serve-port P] [--serve-cache-dir D]`` runs the
persistent repair service instead of a batch repair (``POST /repair`` with
a JSON table; SIGTERM drains it); ``--fleet N [--autoscale]`` runs N such
workers behind a router on ``--serve-port``
(:mod:`delphi_tpu_torch.observability.fleet`). ``--input``, ``--row-id``
and ``--output`` are required unless ``--serve``, ``--fleet`` or
``--gauntlet`` is given.

The gauntlet: ``--gauntlet [--gauntlet-rows N] [--gauntlet-seed S]
[--gauntlet-scenarios a,b] [--gauntlet-no-repairs]`` runs the generated
scenarios (:mod:`delphi_tpu_torch.gauntlet`) through the pipeline instead
of a batch repair, prints one line per scenario on stderr and one JSON
line on stdout, and writes the run report's ``gauntlet`` section with
``--metrics-out``. It exits with code 1 when a scenario errored, and with
code 3 when ``--baseline-report`` and ``--drift-fail-over`` trip the
per-scenario drift gate.
"""

import argparse
import json
import sys
from typing import List, Optional

import pandas as pd

from delphi_tpu_torch import delphi
from delphi_tpu_torch import observability as obs
from delphi_tpu_torch.errors import ConstraintErrorDetector, NullErrorDetector
from delphi_tpu_torch.observability.provenance import MEMORY_PATH
from delphi_tpu_torch.parallel.distributed import maybe_initialize_distributed
from delphi_tpu_torch.session import get_session


def _detectors(args) -> list:
    detectors = [NullErrorDetector()]
    if args.constraints:
        detectors.append(
            ConstraintErrorDetector(constraint_path=args.constraints))
    return detectors


def _stream_batch(args, session) -> int:
    """``--stream N``: drives the input through a local
    :class:`~delphi_tpu_torch.incremental.stream.StreamSession` as N
    chained deltas. Each chunk cites the previous commit's snapshot id as
    its parent; the durable cursor under ``--snapshot-dir`` makes a killed
    run resume at the last committed chunk (committed chunks acknowledge
    as duplicates). The output equals one batch run over the whole
    input."""
    import numpy as np

    from delphi_tpu_torch.incremental.stream import StreamSession

    df = pd.read_csv(args.input,
                     dtype=str if args.dtype == "str" else None)
    chunks = np.array_split(np.arange(len(df)), max(1, args.stream))
    detectors = _detectors(args)

    def run_fn(accumulated, snap_dir, seq):
        name = session.register(f"stream_input_{seq}", accumulated.copy())
        try:
            model = delphi.repair \
                .setTableName(name) \
                .setRowId(args.row_id) \
                .setErrorDetectors(detectors) \
                .setDiscreteThreshold(args.discrete_threshold) \
                .option("repair.incremental", "true") \
                .option("repair.snapshot.dir", snap_dir)
            if args.targets:
                model = model.setTargets(args.targets.split(","))
            out = model.run()
            return out, model._last_incremental
        finally:
            session.drop(name)

    sess = StreamSession("cli", args.snapshot_dir)
    parent = (sess.durable_cursor() or {}).get("snapshot_id")
    result = None
    for seq, idx in enumerate(chunks, start=1):
        delta = df.iloc[idx].reset_index(drop=True)
        status, body = sess.apply(seq, parent, delta, run_fn)
        if status != 200:
            print(f"stream chunk {seq}/{len(chunks)} failed "
                  f"({status}): {body.get('error')}", file=sys.stderr)
            return 1
        cursor = body.get("cursor") or {}
        parent = cursor.get("snapshot_id")
        result = body.get("frame_df", result)
        print(f"stream chunk {seq}/{len(chunks)} {body['status']}: "
              f"{cursor.get('rows_total', 0)} rows durable at cursor "
              f"seq {cursor.get('seq')}", file=sys.stderr)
    if result is None:
        print("stream produced no frame (all chunks were stale "
              "duplicates?)", file=sys.stderr)
        return 1
    result.to_csv(args.output, index=False)
    print(f"wrote {len(result)} rows to {args.output}", file=sys.stderr)
    return 0


def _run_gauntlet_cli(args) -> int:
    """``--gauntlet``: runs the scenario gauntlet and emits the v7 run
    report's ``gauntlet`` section. Exit 0 on success, 1 when any scenario
    errored, 3 when the per-scenario drift gate trips against
    ``--baseline-report``."""
    from delphi_tpu_torch.gauntlet.runner import (emit_gauntlet_metrics,
                                                  run_gauntlet)

    names = [n.strip() for n in args.gauntlet_scenarios.split(",")
             if n.strip()] or None
    report = run_gauntlet(
        names=names, rows=args.gauntlet_rows, seed=args.gauntlet_seed,
        repairs_enabled=not args.gauntlet_no_repairs,
        heartbeat=lambda msg: print(msg, file=sys.stderr))

    # Each scenario ran under its own recorder (so its scorecards came
    # from its own provenance ledger); the wrapper recorder opens AFTER
    # them to carry the aggregate gauntlet.* metrics and the run report.
    drift_result = None
    recorder = obs.start_recording(
        "batch.gauntlet",
        events_path=obs.events_path_for(args.metrics_out or None))
    try:
        if recorder is not None:
            emit_gauntlet_metrics(recorder.registry, report)
            recorder.gauntlet = report
        if args.baseline_report:
            from delphi_tpu_torch.observability import drift
            baseline = obs.load_run_report(args.baseline_report)
            drift_result = drift.evaluate_gauntlet(
                report, baseline, fail_over=args.drift_fail_over,
                registry=recorder.registry if recorder else None)
            if recorder is not None:
                recorder.drift = drift_result
    finally:
        if recorder is not None:
            obs.stop_recording(recorder)
            if args.metrics_out:
                obs.write_run_report(
                    obs.build_run_report(
                        recorder,
                        run={"mode": "gauntlet",
                             "scenarios": sorted(report["scenarios"])},
                        status="ok"),
                    args.metrics_out)

    for name, s in sorted(report["scenarios"].items()):
        d = s["downstream"]
        print(f"gauntlet {name}: f1={s['repair']['f1']} "
              f"({s['repair']['correct']}/{s['repair']['injected']} cells) "
              f"downstream[{d['metric']}] dirty={d['dirty']} "
              f"repaired={d['repaired']} clean={d['clean']} "
              f"gap_closed={d['gap_closed']}"
              + (f" ERROR={s['error']}" if s.get("error") else ""),
              file=sys.stderr)
    print(json.dumps({
        "mode": "gauntlet", "rows": report["rows"], "seed": report["seed"],
        "repairs_enabled": report["repairs_enabled"],
        "mean_f1": report["mean_f1"],
        "mean_gap_closed": report["mean_gap_closed"],
        "scenarios": {n: s["repair"]["f1"]
                      for n, s in report["scenarios"].items()},
        **({"drift": {k: drift_result[k] for k in
                      ("max_severity", "failed", "baseline_missing")}}
           if drift_result else {}),
    }))
    if drift_result is not None and drift_result.get("failed"):
        print(f"gauntlet drift gate FAILED (fail-over "
              f"{args.drift_fail_over})", file=sys.stderr)
        return 3
    errored = [n for n, s in report["scenarios"].items() if s.get("error")]
    if errored:
        print(f"gauntlet scenarios errored: {errored}", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="delphi_tpu_torch batch repair")
    parser.add_argument("--db", dest="db", type=str, default="",
                        help="database name of the input table")
    parser.add_argument("--input", dest="input", type=str, default=None,
                        help="CSV path or registered table name "
                             "(required unless --serve)")
    parser.add_argument("--row-id", dest="row_id", type=str, default=None,
                        help="row-id column (required unless --serve)")
    parser.add_argument("--output", dest="output", type=str, default=None,
                        help="output CSV path (required unless --serve)")
    parser.add_argument("--serve", dest="serve", action="store_true",
                        help="run the persistent repair service instead of "
                             "a batch repair: POST /repair with a JSON "
                             "table, concurrent sessions share the warm "
                             "table, model and plan caches, SIGTERM drains "
                             "gracefully")
    parser.add_argument("--serve-port", dest="serve_port", type=int,
                        default=8080,
                        help="service port for --serve and --fleet "
                             "(0 = ephemeral)")
    parser.add_argument("--serve-cache-dir", dest="serve_cache_dir",
                        type=str, default="",
                        help="warm-state directory for --serve (the kernel "
                             "library's build cache, plans, per-fingerprint "
                             "model checkpoints, phase checkpoints); a "
                             "stable path makes restarts warm. Equivalent "
                             "to DELPHI_SERVE_CACHE_DIR / "
                             "repair.serve.cache_dir")
    parser.add_argument("--fleet", dest="fleet", type=int, default=0,
                        help="run an elastic repair fleet instead of a "
                             "single service: spawn N repair workers "
                             "sharing the --serve-cache-dir warm state "
                             "behind a rendezvous-hashing router with "
                             "liveness-routed failover (POST /repair on "
                             "--serve-port). Equivalent to "
                             "DELPHI_FLEET_WORKERS / repair.fleet.workers")
    parser.add_argument("--autoscale", dest="autoscale",
                        action="store_true",
                        help="with --fleet: the queue-driven autoscaler "
                             "spawns and retires workers from sustained "
                             "queue-depth and stream-lag pressure, with "
                             "hysteresis and cooldown (the "
                             "DELPHI_AUTOSCALE_* settings). Equivalent to "
                             "DELPHI_AUTOSCALE=1")
    parser.add_argument("--targets", dest="targets", type=str, default="",
                        help="comma-separated target attributes")
    parser.add_argument("--constraints", dest="constraints", type=str,
                        default="", help="denial-constraint file path")
    parser.add_argument("--discrete-threshold", dest="discrete_threshold",
                        type=int, default=80)
    parser.add_argument("--detect-only", dest="detect_only",
                        action="store_true")
    parser.add_argument("--repair-data", dest="repair_data",
                        action="store_true",
                        help="write the fully repaired table instead of "
                             "updates")
    parser.add_argument("--chunksize", dest="chunksize", type=int, default=0,
                        help="stream the input CSV in chunks of this many "
                             "rows (0 = load at once); use for inputs too "
                             "large for one pandas frame")
    parser.add_argument("--dtype", dest="dtype", choices=["infer", "str"],
                        default="infer",
                        help="column typing: 'infer' keeps numeric columns "
                             "numeric (a column that mixes strings and "
                             "numbers across chunks fails loudly), 'str' "
                             "reads everything as strings")
    parser.add_argument("--escalate", dest="escalate", action="store_true",
                        help="confidence-routed escalation pass over the "
                             "cells the models are unsure about "
                             "(DELPHI_ESCALATE / repair.escalate)")
    parser.add_argument("--escalate-conf", dest="escalate_conf", type=float,
                        default=None,
                        help="confidence below which cells route to "
                             "escalation (default 0.5)")
    parser.add_argument("--escalate-budget", dest="escalate_budget",
                        type=int, default=None,
                        help="most cell x tier escalation attempts per run "
                             "(default 256)")
    parser.add_argument("--provenance-out", dest="provenance_out", type=str,
                        default="",
                        help="write the per-cell repair provenance ledger "
                             "here as JSONL (repair.provenance.path)")
    parser.add_argument("--incremental", dest="incremental",
                        action="store_true",
                        help="repair only what changed since the snapshot "
                             "in --snapshot-dir, reusing undrifted models "
                             "and prior decisions, then update it; falls "
                             "back to a full run when no usable snapshot "
                             "exists (DELPHI_INCREMENTAL / "
                             "repair.incremental)")
    parser.add_argument("--snapshot-dir", dest="snapshot_dir", type=str,
                        default="",
                        help="snapshot directory of --incremental and "
                             "--stream (DELPHI_SNAPSHOT_DIR / "
                             "repair.snapshot.dir)")
    parser.add_argument("--stream", dest="stream", type=int, default=0,
                        metavar="N",
                        help="ingest the input as N chained deltas against "
                             "the durable cursor under --snapshot-dir; the "
                             "output equals one batch run")
    parser.add_argument("--checkpoint-dir", dest="checkpoint_dir", type=str,
                        default="",
                        help="phase checkpoint directory: each phase's "
                             "outputs persist here, so a run that died "
                             "resumes at its last completed phase "
                             "(DELPHI_CHECKPOINT_DIR / "
                             "repair.checkpoint.dir)")
    parser.add_argument("--fault-plan", dest="fault_plan", type=str,
                        default="",
                        help="fault-injection plan, comma-separated "
                             "site:nth:kind entries (DELPHI_FAULT_PLAN / "
                             "repair.fault.plan)")
    parser.add_argument("--fsck", dest="fsck", type=str, default="",
                        metavar="ROOT",
                        help="validate every store file under ROOT, "
                             "quarantine corrupt ones, remove temporary "
                             "files, print per-store health as JSON and "
                             "exit (4 when corruption was found)")
    parser.add_argument("--fsck-report-only", dest="fsck_report_only",
                        action="store_true",
                        help="with --fsck: report without quarantining, "
                             "deleting or sweeping")
    parser.add_argument("--pipeline", dest="pipeline",
                        choices=["on", "off", "auto"], default="auto",
                        help="the pipeline thread of sequential training: "
                             "'auto' (default) turns it on for a run on "
                             "the card (DELPHI_PIPELINE / "
                             "repair.pipeline.enabled)")
    parser.add_argument("--compile-cache-dir", dest="compile_cache_dir",
                        type=str, default="",
                        help="directory of the kernel library's build "
                             "cache: a later run loads the library built "
                             "there instead of building it "
                             "(DELPHI_COMPILE_CACHE_DIR / "
                             "repair.compile.cache_dir)")
    parser.add_argument("--collective-timeout-s",
                        dest="collective_timeout_s", type=float,
                        default=None,
                        help="deadline of each cross-process collective in "
                             "seconds, the cluster join's too (0 disables "
                             "the watchdog; DELPHI_COLLECTIVE_TIMEOUT_S / "
                             "repair.collective.timeout_s)")
    parser.add_argument("--metrics-out", dest="metrics_out", type=str,
                        default="",
                        help="write the versioned run report (span tree, "
                             "metrics, per-phase device time with "
                             "DELPHI_PROFILE_DIR) here as JSON "
                             "(repair.metrics.path)")
    parser.add_argument("--metrics-port", dest="metrics_port", type=int,
                        default=None,
                        help="serve live telemetry (/metrics Prometheus "
                             "text, /healthz, /report) on this port for the "
                             "duration of the run, plus a stall watchdog "
                             "and resource sampler; 0 picks an ephemeral "
                             "port (printed in the log). Equivalent to "
                             "DELPHI_METRICS_PORT (repair.metrics.port)")
    parser.add_argument("--baseline-report", dest="baseline_report",
                        type=str, default="",
                        help="run report of a baseline run: compare this "
                             "run's per-attribute scorecards against it "
                             "(PSI / JS divergence; drift.* gauges)")
    parser.add_argument("--drift-fail-over", dest="drift_fail_over",
                        type=float, default=None,
                        help="with --baseline-report: exit 3 when the max "
                             "divergence exceeds this")
    parser.add_argument("--plan-report", dest="plan_report", type=str,
                        default="", metavar="ROOT",
                        help="print the launch-cost ledgers persisted "
                             "under ROOT (a plans directory, or a directory "
                             "holding one) as JSON and exit: buckets "
                             "ranked by pad-adjusted device milliseconds")
    parser.add_argument("--gauntlet", dest="gauntlet", action="store_true",
                        help="run the generated scenario gauntlet instead of "
                             "a batch repair: seeded synthetic workloads "
                             "with injected errors through the full "
                             "pipeline, scored per-cell (P/R/F1 vs injected "
                             "ground truth) and by downstream accuracy "
                             "(dirty vs repaired vs clean). Needs no "
                             "--input/--output and zero external testdata; "
                             "with --baseline-report, gates per-scenario "
                             "quality (exit 3 on --drift-fail-over trip). "
                             "See docs/source/gauntlet.rst")
    parser.add_argument("--gauntlet-rows", dest="gauntlet_rows", type=int,
                        default=None,
                        help="rows per gauntlet scenario (default 2000; "
                             "each scenario documents a 2k->100k scale "
                             "series). Equivalent to DELPHI_GAUNTLET_ROWS")
    parser.add_argument("--gauntlet-seed", dest="gauntlet_seed", type=int,
                        default=None,
                        help="gauntlet generation seed (default 0): the "
                             "same (scenario, rows, seed) triple is byte-"
                             "identical everywhere. Equivalent to "
                             "DELPHI_GAUNTLET_SEED")
    parser.add_argument("--gauntlet-scenarios", dest="gauntlet_scenarios",
                        type=str, default="",
                        help="comma-separated scenario names (default: the "
                             "full registry). Equivalent to "
                             "DELPHI_GAUNTLET_SCENARIOS")
    parser.add_argument("--gauntlet-no-repairs", dest="gauntlet_no_repairs",
                        action="store_true",
                        help="deliberate degradation self-test: score the "
                             "scenarios with repairs disabled, so a "
                             "--baseline-report gate against a healthy run "
                             "must trip")
    args = parser.parse_args(argv)

    if args.fsck:
        # files only: scan the root, print per-store health, exit 0 (clean)
        # or 4 (corruption found, now quarantined)
        from delphi_tpu_torch.parallel import store as dstore
        summary = dstore.fsck(args.fsck, repair=not args.fsck_report_only)
        print(json.dumps(summary, indent=2, sort_keys=True))
        return 4 if summary.get("corrupt") else 0
    if args.plan_report:
        # files only, like --fsck: rank the persisted ledgers' buckets
        from delphi_tpu_torch.observability.trace import plan_report
        print(json.dumps(plan_report(args.plan_report), indent=2,
                         sort_keys=True))
        return 0
    serving = args.serve or args.fleet > 0
    if not serving and not args.gauntlet \
            and not (args.input and args.row_id and args.output):
        parser.error("--input, --row-id and --output are required "
                     "(unless --serve)")

    session = get_session()
    # the settings belong to this invocation, not the session; a stream
    # and the serving plane take the fault plan only, as in the JAX package
    conf = {"repair.fault.plan": args.fault_plan,
            "repair.collective.timeout_s":
                "" if args.collective_timeout_s is None
                else str(args.collective_timeout_s)}
    if args.gauntlet:
        # the gauntlet joins no cluster and takes the live plane's port
        # only, as in the JAX package
        conf = {"repair.metrics.port":
                "" if args.metrics_port is None else str(args.metrics_port)}
    elif args.stream <= 0 and not serving:
        # the drift gate needs this run's scorecards, which come from the
        # provenance ledger; an in-memory ledger costs no file I/O
        provenance = args.provenance_out
        if not provenance and args.baseline_report \
                and not session.conf.get("repair.provenance.path"):
            provenance = MEMORY_PATH
        conf.update({"repair.checkpoint.dir": args.checkpoint_dir,
                     "repair.provenance.path": provenance,
                     "repair.metrics.path": args.metrics_out,
                     "repair.metrics.port":
                         "" if args.metrics_port is None
                         else str(args.metrics_port),
                     "repair.compile.cache_dir": args.compile_cache_dir,
                     "repair.pipeline.enabled":
                         "" if args.pipeline == "auto" else args.pipeline})
    prior = {k: session.conf.get(k) for k, v in conf.items() if v}
    session.conf.update((k, v) for k, v in conf.items() if v)
    try:
        if args.gauntlet:
            return _run_gauntlet_cli(args)
        # join the cluster (DELPHI_COORDINATOR) before any work, under the
        # collective deadline set above
        maybe_initialize_distributed()
        if args.fleet > 0:
            from delphi_tpu_torch.observability.fleet import run_fleet
            return run_fleet(port=args.serve_port, workers=args.fleet,
                             cache_dir=args.serve_cache_dir or None,
                             autoscale=args.autoscale or None)
        if args.serve:
            from delphi_tpu_torch.observability.serve import serve
            return serve(port=args.serve_port,
                         cache_dir=args.serve_cache_dir or None)
        if args.stream > 0:
            if not args.snapshot_dir:
                parser.error("--stream requires --snapshot-dir (the "
                             "stream's durable cursor + snapshot directory)")
            return _stream_batch(args, session)
        return _batch(args, session)
    finally:
        for k, v in prior.items():
            if v is None:
                session.conf.pop(k, None)
            else:
                session.conf[k] = v


def _batch(args, session) -> int:
    recorder = None
    if args.metrics_out or args.metrics_port is not None \
            or args.provenance_out or args.baseline_report:
        # the recorder opens here, before ingestion, so ingest.* metrics
        # land in the report (and the live server covers the whole batch
        # run); the nested run() records into the same tree and leaves
        # report writing to this entry point
        recorder = obs.start_recording(
            "batch.main",
            events_path=obs.events_path_for(args.metrics_out or None))
    dtype = str if args.dtype == "str" else None
    if args.input.endswith(".csv"):
        if args.chunksize > 0:
            from delphi_tpu_torch.ingest import read_csv_encoded
            table = read_csv_encoded(args.input, args.row_id,
                                     chunksize=args.chunksize, dtype=dtype)
            name = session.register("batch_input", table)
        else:
            name = session.register("batch_input",
                                    pd.read_csv(args.input, dtype=dtype))
    else:
        name = session.qualified_name(args.db, args.input)

    model = delphi.repair \
        .setTableName(name) \
        .setRowId(args.row_id) \
        .setErrorDetectors(_detectors(args)) \
        .setDiscreteThreshold(args.discrete_threshold)
    if args.targets:
        model = model.setTargets(args.targets.split(","))
    if args.incremental:
        model = model.option("repair.incremental", "true")
    if args.snapshot_dir:
        model = model.option("repair.snapshot.dir", args.snapshot_dir)
    if args.escalate:
        model = model.option("repair.escalate", "true")
    if args.escalate_conf is not None:
        model = model.option("repair.escalate.conf", str(args.escalate_conf))
    if args.escalate_budget is not None:
        model = model.option("repair.escalate.budget",
                             str(args.escalate_budget))
    status, error = "ok", None
    drift_result = None
    try:
        result = model.run(detect_errors_only=args.detect_only,
                           repair_data=args.repair_data)
    except BaseException as e:
        status, error = "error", f"{type(e).__name__}: {e}"
        raise
    finally:
        if recorder is not None:
            if args.baseline_report and status == "ok":
                # the drift gate before stop_recording: finalize freezes
                # this run's scorecards and the drift.* gauges land in the
                # registry the report snapshots
                from delphi_tpu_torch.observability import drift, provenance
                try:
                    provenance.finalize(recorder)
                    baseline = obs.load_run_report(args.baseline_report)
                    drift_result = drift.evaluate(
                        recorder.scorecards, baseline,
                        fail_over=args.drift_fail_over,
                        registry=recorder.registry)
                    recorder.drift = drift_result
                except Exception as e:
                    print(f"drift gate failed to evaluate: {e}",
                          file=sys.stderr)
            obs.stop_recording(recorder)
            if args.metrics_out:
                obs.write_run_report(
                    obs.build_run_report(
                        recorder,
                        run={"input": args.input, "output": args.output,
                             "status": status},
                        status=status, error=error),
                    args.metrics_out)
    result.to_csv(args.output, index=False)
    print(f"wrote {len(result)} rows to {args.output}", file=sys.stderr)
    if drift_result is not None:
        print("drift vs {}: max divergence {} (psi={}, js={})".format(
            args.baseline_report, drift_result["max_divergence"],
            drift_result["max_confidence_psi"],
            drift_result["max_repair_value_js"]), file=sys.stderr)
        if drift_result.get("failed"):
            print("drift gate FAILED (fail-over "
                  f"{args.drift_fail_over})", file=sys.stderr)
            return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
