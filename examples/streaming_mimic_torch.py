"""Streaming island demo on the PyTorch port, twin of
``examples/streaming_mimic.py`` (paper §III; arXiv:1609.07548's S-Store
member): continuous MIMIC waveform ingest + standing queries over the
polystore.

Feeds the synthetic physiologic waveform into a ring-buffer stream batch
by batch; two standing BQL queries re-execute as data lands —

  wave_avg   every tick:    tumbling window -> binary cast into the array
                            island -> avg(signal)
  hr_table   every 4 ticks: sliding windows -> staged cast into the
                            relational island -> per-window max(hr)

The first tick of each query populates the signature plan cache; every
later tick skips plan enumeration (watch the cache_hits counter climb).

A second deployment then shards the same stream across two StreamEngines
(scatter appends, seq-ordered gathers — bit-identical results) and
live-migrates a shard between engines mid-standing-query.

  python examples/streaming_mimic_torch.py            # on the GPU
  python examples/streaming_mimic_torch.py --device cpu
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import admin                       # noqa: E402
from repro_torch.core.api import default_deployment      # noqa: E402
from repro_torch.data.mimic import stream_mimic_waveforms  # noqa: E402

WAVE_AVG = ("bdarray(aggregate(bdcast(bdstream(window("
            "mimic2v26.waveform_stream, 64)), w_arr,"
            " '<signal:double>[tick=0:63,64,0]', array), avg(signal)))")
HR_TABLE = ("bdrel(select max(hr) from bdcast(bdstream(window("
            "mimic2v26.waveform_stream, 64, 32)), w_tbl, '', relational))")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="streaming island demo")
    ap.add_argument("--device", default=None,
                    help="device of the deployments (default: the GPU)")
    args = ap.parse_args(argv)
    bd = default_deployment(device=args.device)
    bd.register_continuous(WAVE_AVG, every_n_ticks=1, name="wave_avg")
    bd.register_continuous(HR_TABLE, every_n_ticks=4, name="hr_table")

    print("-- feeding 24 waveform batches (64 rows each) --")
    for info in stream_mimic_waveforms(bd, batch_rows=64, num_batches=24,
                                       capacity=1024):
        ran = ", ".join(f"{n}{'*' if hit else ''}" for n, hit in
                        info["ran"]) or "-"
        print(f"   batch {info['batch']:2d}  rows={info['rows']:4d}"
              f"  dropped={info['dropped']}  ran: {ran}   (*=cache hit)")

    print("\n-- standing query state --")
    for name, cq in bd.streams.queries.items():
        m = cq.metrics()
        print(f"   {name}: {m['executions']} executions,"
              f" {m['cache_hits']} plan-cache hits,"
              f" p50 {m['p50_latency_ms']} ms")

    print("\n-- streams status (admin §IV) --")
    print(json.dumps(admin.status(bd)["streams"], indent=1))

    print("\n-- plan cache --")
    print(json.dumps(admin.status(bd)["plan_cache"], indent=1))

    # -- sharded scale-out: same stream, 4 shards over 2 StreamEngines ----
    print("\n-- sharded streaming (4 shards / 2 engines) --")
    bds = default_deployment(device=args.device)
    # prime the stream with one complete 64-window before registering
    # the standing query, so every tick below has a window to aggregate
    for info in stream_mimic_waveforms(bds, batch_rows=32, num_batches=2,
                                       capacity=1024, shards=4,
                                       num_engines=2):
        pass
    # pure-streaming aggregate: takes the rolling fast path (per-shard
    # partials + per-window memo).  Batches are half a window, so every
    # other tick re-reads the same window index — a memo hit.
    bds.register_continuous(
        "bdstream(aggregate(window(mimic2v26.waveform_stream, 64),"
        " avg(signal)))", every_n_ticks=1, name="wave_avg")
    for info in stream_mimic_waveforms(bds, batch_rows=32,
                                       num_batches=22, capacity=1024):
        pass
    sharded = bds.engines["streamstore0"].get("mimic2v26.waveform_stream")
    print("   shard placement:", sharded.shard_engines())
    agg_total = sharded.agg_computes + sharded.agg_cache_hits
    print(f"   rolling-agg cache hits: {sharded.agg_cache_hits}"
          f"/{agg_total}")
    move = bds.rebalance_stream("mimic2v26.waveform_stream", shard=0,
                                to_engine="streamstore1")
    print("   live shard move:", move)
    for info in stream_mimic_waveforms(bds, batch_rows=64, num_batches=4,
                                       capacity=1024):
        pass
    cq = bds.streams.queries["wave_avg"]
    print(f"   standing query after move: {cq.executions} executions,"
          f" {cq.errors} errors (continuity preserved)")


if __name__ == "__main__":
    main()
