"""Administrative interface (paper §IV), ported from ``repro.core.admin``:
start, stop and view the status of a BigDAWG setup.  Programmatic API +
a small CLI:

  PYTHONPATH=src python -m repro_torch.core.admin status
  ... admin streams      # live streaming demo
  ... admin rebalance    # shard-move demo
  ... admin joins        # event-time join demo
  ... admin serve        # front-door demo
  ... admin ml           # scored-stream demo

Every command builds its deployments on ``--device`` (the card by
default, which raises without one; ``--device cpu`` runs the kernels'
plain versions).  ``main(argv)`` runs a command in-process: ``trace``
puts the tracing switch and the query backend back as it found them.
The reference's status() schema and knobs are in docs/OPERATIONS.md;
the ``ml`` block has no ``jax_available``/``fallbacks`` here (the port
needs no jax).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.core import datamodel as dm
from repro_torch.core.api import BigDawg, default_deployment


def status(bd: BigDawg) -> Dict[str, Any]:
    """Deployment status: engines, islands, objects, monitor health.

    Monitor-sourced sections all render one ``Monitor.snapshot()`` —
    a deep copy taken under the Monitor lock — because the background
    MonitoringTask / StreamRuntime tick mutate the live dicts
    concurrently (iterating ``monitor.engine_ewma`` etc. directly from
    this thread races and can die mid-resize).  The same series are
    exported through ``repro_torch.obs.metrics`` (``admin metrics``)."""
    out: Dict[str, Any] = {"engines": {}, "islands": {}, "monitor": {}}
    for name, engine in bd.engines.items():
        objs = engine.list_objects()
        out["engines"][name] = {
            "kind": engine.kind,
            "objects": len(objs),
            "bytes": int(sum(
                dm.object_nbytes(engine.get(o)) for o in objs)),
            "ops_logged": len(engine.op_log),
            "ops_recorded": engine.ops_recorded,
            "op_log_limit": engine.OP_LOG_LIMIT,
        }
    for isl in bd.catalog.islands.values():
        out["islands"][isl.name] = [
            e.name for e in bd.catalog.engines_for_island(isl.name)]
    snap = bd.monitor.snapshot()
    out["monitor"] = {
        "engine_ewma_ms": {k: round(v * 1e3, 3)
                           for k, v in snap["engine_ewma"].items()},
        "stragglers": snap["stragglers"],
        "monitoring_task_running": bd.monitoring_task is not None,
    }
    cfg = bd.planner_config
    out["concurrency"] = {
        "executor_mode": cfg.executor.mode,
        "executor_max_workers": cfg.executor.max_workers,
        "plan_parallelism": cfg.plan_parallelism,
        "early_cancel": cfg.early_cancel,
        "early_cancel_margin": cfg.early_cancel_margin,
        "cost_model_cancels": bd.planner.cost_model_cancels,
    }
    # streaming island: per-stream ring-buffer health + standing queries
    out["streams"] = bd.streams.status()
    out["streams"]["monitor_ewma_ms"] = {
        k: round(v * 1e3, 3) for k, v in snap["stream_ewma"].items()}
    # event-time health: per-stream low watermark + late/pending rows
    # (the Monitor's copy, fed every tick — matches each stream's stats)
    out["streams"]["watermarks"] = snap["stream_watermarks"]
    # multi-producer ingest health: per-stream producer counts, seq
    # blocks reserved, in-flight rows and ordered-commit contention
    # (the Monitor's per-tick copy of stream.ingest_concurrency())
    out["streams"]["ingest_concurrency"] = snap["ingest_stats"]
    # compiled query path: active backend plus plan-compile/cache-hit/
    # fallback counters (the Monitor's per-tick copy of
    # repro_torch.stream.compile.stats())
    out["streams"]["query_backend"] = snap["jit_stats"]
    # durability: per-stream segment-log/checkpoint counters and the
    # last recover_stream outcome (fed per tick for durable streams)
    out["streams"]["durability"] = snap["durability_stats"]
    out["streams"]["recoveries"] = snap["recoveries"]
    # serving front door: tenants, subscriptions, shared queries,
    # admission rejects, delivered/dropped results, replicas (the
    # Monitor's copy of FrontDoor.stats(); empty without a front door)
    out["serve"] = snap["serve_stats"]
    # ml island: inference counters (models loaded, waves, windows
    # scored, params-cache hits) — the Monitor's per-tick copy of
    # repro_torch.stream.ml.stats(); empty until an ml engine ticks
    out["ml"] = snap["ml_stats"]
    out["plan_cache"] = dict(bd.planner.plan_cache.stats(),
                             capacity=cfg.cache_size,
                             max_age_seconds=cfg.cache_max_age_seconds)
    out["catalog"] = {t: len(getattr(bd.catalog, t))
                      for t in bd.catalog.TABLES}
    return out


def rebalance(bd: BigDawg, factor: float = 3.0) -> Dict[str, Any]:
    """The shard rebalance hook: for every sharded stream whose Monitor
    per-shard ingest/drop stats have gone lopsided (a shard's load >
    ``factor`` x the median shard's), move one shard off the busiest
    StreamEngine through the Migrator's live ``stream`` route.  Returns
    {"moves": [...], "skipped": [...]} — a lopsided stream is skipped
    when no move would even out the per-engine load (e.g. every engine
    already holds exactly one shard)."""
    moves, skipped = [], []
    for name in sorted(bd.streams._sharded_streams()):
        hot = bd.monitor.lopsided_shards(name, factor=factor)
        if not hot:
            continue
        try:
            moves.append(bd.streams.rebalance(name))
        except ValueError as exc:
            skipped.append({"stream": name, "hot_shards": hot,
                            "reason": str(exc)})
    return {"moves": moves, "skipped": skipped}


def start(bd: BigDawg, interval_seconds: float = 30.0) -> None:
    """Start the background MonitoringTask daemon (paper §V.E)."""
    task = bd.start_monitoring(interval_seconds)
    task.start()


def stop(bd: BigDawg) -> None:
    if bd.monitoring_task is not None:
        bd.monitoring_task.stop()
        bd.monitoring_task = None


def _demo_streams(bd: BigDawg, ticks: int) -> None:
    """The ``streams`` demo feed (shared by the trace/metrics
    commands): a standing cross-island window-average query over the
    synthetic MIMIC waveform stream, one execution per batch."""
    from repro_torch.data.mimic import stream_mimic_waveforms
    bd.register_continuous(
        "bdarray(aggregate(bdcast(bdstream(window("
        "mimic2v26.waveform_stream, 64)), w_arr,"
        " '<signal:double>[tick=0:63,64,0]', array), avg(signal)))",
        every_n_ticks=1, name="wave_avg")
    for _ in stream_mimic_waveforms(bd, batch_rows=64,
                                    num_batches=ticks):
        pass


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="BigDAWG admin interface")
    ap.add_argument("command",
                    choices=("status", "demo-status", "streams",
                             "rebalance", "joins", "trace", "metrics",
                             "recover", "serve", "ml"))
    ap.add_argument("--tenants", type=int, default=4,
                    help="synthetic tenants for the serve demo")
    ap.add_argument("--ticks", type=int, default=8,
                    help="feed batches for the streams/rebalance/trace/"
                         "metrics commands")
    ap.add_argument("--out", type=str, default="trace.json",
                    help="Chrome trace-event JSON output path for the "
                         "trace command (load in Perfetto)")
    ap.add_argument("--dir", type=str, default=None,
                    help="durability directory for the recover demo "
                         "(default: a fresh temp dir)")
    ap.add_argument("--shards", type=int, default=4,
                    help="shard count for the rebalance demo stream")
    ap.add_argument("--stream-engines", type=int, default=2,
                    help="StreamEngines for the rebalance demo")
    ap.add_argument("--executor-mode", choices=("concurrent", "serial"),
                    default="concurrent",
                    help="stage scheduler: overlapped DAG or serial")
    ap.add_argument("--executor-workers", type=int, default=4,
                    help="thread budget for concurrent stage execution")
    ap.add_argument("--plan-parallelism", type=int, default=4,
                    help="concurrent QEPs during training-mode exploration")
    ap.add_argument("--plan-cache-size", type=int, default=128,
                    help="signature-keyed plan cache LRU capacity")
    ap.add_argument("--device", type=str, default=None,
                    help="device of every deployment the command builds "
                         "(default: the GPU; 'cpu' runs the kernels' "
                         "plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.core.planner import PlannerConfig

    ap = _parser()
    args = ap.parse_args(argv)
    if args.command == "rebalance" and args.shards < 2:
        ap.error("rebalance demo needs --shards >= 2 (a single ring "
                 "has nothing to move)")
    cfg = PlannerConfig(
        plan_parallelism=args.plan_parallelism,
        cache_size=args.plan_cache_size,
        executor=ExecutorConfig(mode=args.executor_mode,
                                max_workers=args.executor_workers))

    def deployment() -> BigDawg:
        return default_deployment(device=args.device, planner_config=cfg)

    bd = deployment()
    if args.command == "demo-status":
        from repro_torch.data.mimic import load_mimic_demo
        load_mimic_demo(bd)
    elif args.command == "rebalance":
        # live-migration demo: a key-hashed sharded stream fed a skewed
        # key distribution goes lopsided; the rebalance hook moves a
        # shard off the hot StreamEngine while a standing query runs
        import numpy as np
        from repro_torch.stream.spec import Sharding, StreamSpec
        bd.register_stream("streamstore0", StreamSpec(
            "vitals.stream", ("patient", "hr"), capacity=4096,
            sharding=Sharding(shards=args.shards, shard_key="patient",
                              num_engines=args.stream_engines)))
        bd.register_continuous(
            "bdstream(aggregate(window(vitals.stream, 64), avg(hr)))",
            every_n_ticks=1, name="hr_avg")
        rng = np.random.default_rng(0)
        stream = bd.engines["streamstore0"].get("vitals.stream")
        for _ in range(args.ticks):
            # heavy hitter: ~85% of rows are one patient, hashing onto a
            # single shard — the classic skew that strands one engine hot
            patient = np.where(
                rng.random(256) < 0.85, 1.0,
                rng.integers(0, 4 * args.shards, 256).astype(float))
            stream.append({"patient": patient,
                           "hr": 75 + rng.standard_normal(256)})
            bd.streams.tick()
        before = {i: s["engine"] for i, s in
                  bd.monitor.shard_stats.get("vitals.stream",
                                             {}).items()}
        outcome = rebalance(bd)
        after = {i: s["engine"] for i, s in
                 stream.shard_stats().items()}
        st = status(bd)
        print(json.dumps({
            "shards_before": before, "rebalance": outcome,
            "shards_after": after,
            "standing_query": st["streams"]["queries"]["hr_avg"],
        }, indent=1))
        return
    elif args.command == "joins":
        # event-time demo: two jittered out-of-order MIMIC waveform
        # streams (ABP + ECG) with a standing cross-stream interval join
        # that ticks only when the low watermark advances
        from repro_torch.data.mimic import stream_mimic_paired_waveforms
        cq = bd.register_continuous(
            "bdstream(join(ewindow(mimic2v26.abp_stream, 16),"
            " ewindow(mimic2v26.ecg_stream, 16), on=ts, tol=0.5))",
            every_n_ticks=1, name="abp_ecg_join")
        last = None
        for info in stream_mimic_paired_waveforms(bd,
                                                  num_batches=args.ticks):
            last = info
        st = status(bd)
        joined = cq.last_value
        print(json.dumps({
            "feed_tail": last,
            "standing_join": st["streams"]["queries"]["abp_ecg_join"],
            "watermarks": st["streams"]["watermarks"],
            "joined_rows": (0 if joined is None
                            else len(joined.columns["dt"])),
        }, indent=1))
        return
    elif args.command == "streams":
        # live streaming island demo: feed the synthetic MIMIC waveform
        # stream, run a standing window-average query on every batch
        _demo_streams(bd, args.ticks)
        st = status(bd)
        print(json.dumps({"streams": st["streams"],
                          "plan_cache": st["plan_cache"]}, indent=1))
        return
    elif args.command == "trace":
        # run the streams demo with tracing on and export the span ring:
        # Chrome trace-event JSON (Perfetto-loadable) + text flamegraph.
        # The jit query backend runs unless the caller pinned one, so the
        # export carries compile-layer spans beside planner/executor,
        # stream tick and committer
        from repro_torch.obs import trace
        from repro_torch.stream import compile as qc
        pinned = os.environ.get(qc.BACKEND_ENV)
        os.environ[qc.BACKEND_ENV] = pinned or "jit"
        was_on = trace.set_enabled(True)
        try:
            trace.reset()
            _demo_streams(bd, args.ticks)
            recorded = trace.spans()
        finally:
            trace.set_enabled(was_on)
            if pinned is None:
                os.environ.pop(qc.BACKEND_ENV, None)
        n_events = trace.save_chrome_trace(args.out, recorded)
        print(trace.flamegraph(recorded))
        slow = trace.slow_ops()
        print(json.dumps({
            "out": args.out, "spans": n_events,
            "layers": sorted({r.name.split("/", 1)[0]
                              for r in recorded}),
            "slow_ops": slow[-5:],
            "slow_op_threshold_ms": trace.slow_op_threshold_ms(),
        }, indent=1))
        return
    elif args.command == "recover":
        # durability demo: feed a durable sharded stream (checkpoints on
        # tick cadence), "crash" by discarding the deployment, rebuild a
        # fresh one with recover_stream, and prove the recovered stream
        # is bit-identical — then replay(S) as a deterministic load gen
        import tempfile
        import numpy as np
        from repro_torch.stream.durability import fingerprint
        from repro_torch.stream.spec import Durability, Sharding, StreamSpec
        wal_dir = args.dir or tempfile.mkdtemp(prefix="bigdawg_wal_")
        stream = bd.register_stream("streamstore0", StreamSpec(
            "vitals.stream", ("patient", "hr"), capacity=4096,
            sharding=Sharding(shards=2),
            durability=Durability(wal_dir,
                                  checkpoint_every_rows=256)))
        rng = np.random.default_rng(0)
        for _ in range(args.ticks):
            stream.append({
                "patient": rng.integers(0, 8, 128).astype(float),
                "hr": 75 + rng.standard_normal(128)})
            bd.streams.tick()
        # a tail batch past the last checkpoint, so recovery actually
        # replays from the segment log rather than only restoring
        stream.append({"patient": rng.integers(0, 8, 64).astype(float),
                       "hr": 75 + rng.standard_normal(64)})
        before = fingerprint(stream)
        stream._durable.close()
        bd2 = deployment()                     # the "restart"
        recovered = bd2.recover_stream("streamstore0", wal_dir)
        identical = fingerprint(recovered) == before
        replay_stats = bd2.query(
            "bdstream(replay(vitals.stream))").value
        st = status(bd2)
        print(json.dumps({
            "dir": wal_dir, "identical": identical,
            "rows": recovered.total_appended,
            "durability": st["streams"]["durability"],
            "recovery": st["streams"]["recoveries"],
            "replay": {k: v[0] for k, v in
                       replay_stats.columns.items()},
        }, indent=1, default=float))
        recovered._durable.close()
        return
    elif args.command == "serve":
        # serving front-door demo: N synthetic tenants share one
        # standing window-average over a spec-registered stream; the
        # middle tenant also gets a private cadence-2 query.  Prints
        # the serve health block status() renders.
        import numpy as np
        from repro_torch.serve.engine import ServeConfig
        from repro_torch.serve.frontdoor import FrontDoor
        from repro_torch.stream.spec import StreamSpec
        door = FrontDoor(bd, ServeConfig(streams=(
            StreamSpec("vitals.stream", ("ts", "hr"),
                       capacity=4096),)),
            stream_engine="streamstore0",
            max_tenants=max(1, args.tenants))
        shared_q = ("bdstream(aggregate(window(vitals.stream, 64),"
                    " avg(hr)))")
        subs = []
        for i in range(max(1, args.tenants)):
            session = door.open_session(f"tenant{i}")
            subs.append(session.subscribe(shared_q))
            if i == args.tenants // 2:
                session.subscribe(
                    "bdstream(rate(vitals.stream))", every_n_ticks=2)
        rng = np.random.default_rng(0)
        stream = bd.engines["streamstore0"].get("vitals.stream")
        for t in range(args.ticks):
            stream.append({"ts": np.arange(64.) + 64 * t,
                           "hr": 75 + rng.standard_normal(64)})
            bd.streams.tick()
        delivered = [len(s.poll()) for s in subs]
        st = status(bd)
        print(json.dumps({
            "serve": st["serve"],
            "delivered_per_tenant": delivered,
            "standing_queries": sorted(st["streams"]["queries"]),
        }, indent=1))
        door.close()
        return
    elif args.command == "ml":
        # ml-island demo: standing anomaly scoring over the jittered
        # out-of-order ABP/ECG paired-waveform feed.  Every tenant
        # subscribes the same scored query through the front door, so
        # warm sharing collapses N tenants to one infer execution per
        # tick — and the wave scheduler batches the ABP + ECG standing
        # queries into a single wave per tick.  Scores are mean
        # next-token NLL under the registered model: windows the model
        # finds unlikely (rhythm breaks, jitter artifacts) score high.
        from repro_torch.data.mimic import stream_mimic_paired_waveforms
        from repro_torch.serve.engine import ServeConfig
        from repro_torch.serve.frontdoor import FrontDoor
        bd.register_model("lm")
        feed = stream_mimic_paired_waveforms(bd, num_batches=args.ticks)
        last = next(feed)                   # registers the two streams
        door = FrontDoor(bd, ServeConfig(),
                         stream_engine="streamstore0",
                         max_tenants=max(1, args.tenants))
        scored_abp = ("bdml(infer(ewindow(mimic2v26.abp_stream, 16.0),"
                      " models.lm, field=abp))")
        scored_ecg = ("bdml(infer(ewindow(mimic2v26.ecg_stream, 16.0),"
                      " models.lm, field=ecg))")
        subs = []
        for i in range(max(1, args.tenants)):
            session = door.open_session(f"tenant{i}")
            subs.append(session.subscribe(scored_abp))
            if i == 0:
                session.subscribe(scored_ecg)
        for last in feed:
            pass
        results = subs[0].poll()
        st = status(bd)
        print(json.dumps({
            "feed_tail": last,
            "ml": st["ml"],
            "serve": {k: st["serve"].get(k) for k in
                      ("tenants", "subscriptions", "shared_queries")},
            "delivered_to_tenant0": len(results),
            "abp_scores": [round(float(v.columns["score"][0]), 4)
                           for _, v in results],
            "standing_queries": sorted(st["streams"]["queries"]),
        }, indent=1))
        door.close()
        return
    elif args.command == "metrics":
        # run the streams demo, then dump the process-wide registry in
        # Prometheus text exposition format (what /metrics serves)
        from repro_torch.obs import metrics
        _demo_streams(bd, args.ticks)
        print(metrics.prometheus_text(), end="")
        return
    print(json.dumps(status(bd), indent=1))


if __name__ == "__main__":
    main()
