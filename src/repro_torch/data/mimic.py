"""Synthetic MIMIC-II-style dataset (paper §IV), ported from
``repro.data.mimic``: patient history into the relational engine, the
physiologic waveform into the array engine, free-form text into the KV
engine — the default placement of the v0.1 release scripts — and the
live waveform feeds of the streaming island.

``mimic_demo_arrays`` draws from numpy's ``default_rng`` in the same order
as the reference, and narrows to the dtypes ``jnp.asarray`` gives, so both
packages hold identical data; it also serves as the host-side truth that
query results are checked against.  The stream feeds draw from numpy in
the reference's order too, so a seed gives the same rows in both
packages.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch._dtypes import canonical_numpy
from repro_torch.core import datamodel as dm
from repro_torch.core.api import BigDawg


def mimic_demo_arrays(*, num_patients: int = 256, num_orders: int = 1024,
                      wave_len: int = 4096, num_logs: int = 64,
                      seed: int = 0) -> Dict[str, Any]:
    """The demo's data as canonical numpy arrays (and the log strings)."""
    rng = np.random.default_rng(seed)
    c = canonical_numpy
    d_patients = {
        "subject_id": c(np.arange(num_patients)),
        "sex": c(rng.integers(0, 2, num_patients)),            # 0=F,1=M
        "dob_year": c(rng.integers(1930, 2000, num_patients)),
        "hospital_expire_flg": c(rng.integers(0, 2, num_patients)),
    }
    poe_order = {
        "poe_id": c(np.arange(num_orders)),
        "subject_id": c(rng.integers(0, num_patients, num_orders)),
        "icustay_id": c(rng.integers(0, 512, num_orders)),
        "dose": c(rng.uniform(0.5, 50.0, num_orders)),
    }
    t = np.arange(wave_len, dtype=np.float64)
    signal = (np.sin(2 * np.pi * t / 360.0)[None, :]
              * rng.uniform(0.5, 2.0, (8, 1))
              + 0.05 * rng.standard_normal((8, wave_len)))
    myarray = c(rng.standard_normal(256))
    keys, values = [], []
    for i in range(num_logs):
        keys.append((f"r_{i:04d}", "note", "text"))
        values.append(f"synthetic clinical note {i}: pt stable, "
                      f"hr={int(rng.integers(50, 120))}")
    return {"d_patients": d_patients, "poe_order": poe_order,
            "signal": c(signal), "myarray": myarray,
            "logs": (keys, values)}


def load_mimic_demo(bd: BigDawg, *, num_patients: int = 256,
                    num_orders: int = 1024, wave_len: int = 4096,
                    num_logs: int = 64, seed: int = 0) -> None:
    """Register the demo objects in ``bd``, their tensors on ``bd.device``."""
    data = mimic_demo_arrays(num_patients=num_patients,
                             num_orders=num_orders, wave_len=wave_len,
                             num_logs=num_logs, seed=seed)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(bd.device)

    # -- patient history -> relational engine (hoststore0) -------------------
    d_patients = dm.Table({n: dev(v) for n, v in data["d_patients"].items()})
    bd.register_object("hoststore0", "mimic2v26.d_patients", d_patients,
                       fields=tuple(d_patients.fields))
    poe_order = dm.Table({n: dev(v) for n, v in data["poe_order"].items()})
    bd.register_object("hoststore0", "mimic2v26.poe_order", poe_order,
                       fields=tuple(poe_order.fields))
    # replicate onto the second relational engine (paper ships mimic2_copy)
    bd.register_object("hoststore1", "mimic2v26.poe_order", poe_order,
                       fields=tuple(poe_order.fields))

    # -- physiologic waveforms -> array engine (densehbm0) -------------------
    waveform = dm.ArrayObject(attrs={"signal": dev(data["signal"])},
                              dim_names=("lead", "tick"))
    bd.register_object("densehbm0", "mimic2v26.waveform", waveform,
                       fields=("signal",))
    myarray = dm.ArrayObject(attrs={"val": dev(data["myarray"])},
                             dim_names=("dim1",))
    bd.register_object("densehbm0", "myarray", myarray, fields=("val",))

    # -- free-form text -> KV engine (kvstore0) ------------------------------
    keys, values = data["logs"]
    bd.register_object("kvstore0", "mimic_logs", dm.KVTable(keys, values),
                       fields=("row", "colfam", "colqual", "value"))


def stream_mimic_waveforms(bd: BigDawg, *, batch_rows: int = 64,
                           num_batches: int = 32, capacity: int = 8192,
                           seed: int = 0,
                           name: str = "mimic2v26.waveform_stream",
                           engine_name: str = "streamstore0",
                           tick: bool = True, shards: int = 1,
                           shard_key: str = None,
                           num_engines: int = None) -> Iterator[Dict]:
    """Live MIMIC waveform feed: appends synthetic physiologic batches to
    a ring-buffer stream on the streaming island, one batch per
    iteration, advancing the continuous-query runtime after each.

    The signal is the same deterministic sine+noise family as
    ``load_mimic_demo``'s batch waveform, phased by the stream's global
    sequence number so a resumed feed continues the waveform seamlessly.
    With ``shards > 1`` the stream is hash-partitioned across multiple
    StreamEngines (scatter appends, seq-ordered gathers — results stay
    bit-identical to the unsharded feed).  Yields a per-batch dict with
    append counts and the standing-query responses that ran on that tick.
    """
    rng = np.random.default_rng(seed)
    engine = bd.engines[engine_name]
    if not engine.has(name):
        bd.register_stream(engine_name, name, ("signal", "hr"), capacity,
                           shards=shards, shard_key=shard_key,
                           num_engines=num_engines)
    stream = engine.get(name)
    for b in range(num_batches):
        t = stream.total_appended + np.arange(batch_rows,
                                              dtype=np.float64)
        signal = (np.sin(2 * np.pi * t / 360.0)
                  + 0.05 * rng.standard_normal(batch_rows))
        hr = 75.0 + 10.0 * np.sin(2 * np.pi * t / 3600.0) \
            + rng.standard_normal(batch_rows)
        counts = stream.append({"signal": signal, "hr": hr})
        ran = bd.streams.tick() if tick else []
        yield {"batch": b, **counts,
               "ran": [(cq_name, resp.plan_cache_hit)
                       for cq_name, resp in ran]}


def stream_mimic_paired_waveforms(bd: BigDawg, *, batch_rows: int = 48,
                                  num_batches: int = 24,
                                  capacity: int = 8192, seed: int = 0,
                                  jitter: float = 2.0,
                                  max_delay: float = 6.0,
                                  shards: int = 2,
                                  abp_name: str = "mimic2v26.abp_stream",
                                  ecg_name: str = "mimic2v26.ecg_stream",
                                  engine_name: str = "streamstore0",
                                  tick: bool = True) -> Iterator[Dict]:
    """Jittered two-stream MIMIC waveform feed — the cross-stream
    event-time workload (paper §III: correlating ABP and ECG alarms).

    Two event-time streams, ``abp`` (arterial blood pressure) and
    ``ecg``, share one ``ts`` axis at 1 row/tick with the ECG phase-
    shifted by 0.25.  Delivery is *out of order*: each batch's rows are
    shuffled by a bounded network jitter (arrival order = order of
    ``ts + U(-jitter, jitter)``), so insertion buffers and watermarks do
    real work, while ``jitter < max_delay / 2`` guarantees no row is
    ever late — the streams reconstruct the exact in-order signal.
    Yields a per-batch dict with append counts, both watermarks, and the
    standing queries that ran on that tick; after the final batch both
    streams are flushed (punctuation) and one more tick runs so standing
    joins see the last closed window.
    """
    assert jitter >= 0 and max_delay > 2 * jitter, (jitter, max_delay)
    rng = np.random.default_rng(seed)
    engine = bd.engines[engine_name]
    streams = {}
    for sname, phase in ((abp_name, 0.0), (ecg_name, 0.25)):
        if not engine.has(sname):
            field = "abp" if sname == abp_name else "ecg"
            bd.register_stream(engine_name, sname, ("ts", field),
                               capacity, shards=shards,
                               ts_field="ts", max_delay=max_delay)
        streams[sname] = engine.get(sname)

    def _emit(b: int, ran) -> Dict:
        return {"batch": b,
                "watermarks": {n: s.watermark
                               for n, s in streams.items()},
                "late": {n: s.total_late for n, s in streams.items()},
                "ran": [(cq_name, resp.plan_cache_hit)
                        for cq_name, resp in ran]}

    base = 0.0
    for b in range(num_batches):
        t = base + np.arange(batch_rows, dtype=np.float64)
        base += batch_rows
        order = np.argsort(t + rng.uniform(-jitter, jitter, batch_rows))
        abp_ts = t[order]
        abp = (90.0 + 12.0 * np.sin(2 * np.pi * t / 360.0)
               + 0.5 * rng.standard_normal(batch_rows))[order]
        counts_abp = streams[abp_name].append({"ts": abp_ts,
                                               "abp": abp})
        order = np.argsort(t + rng.uniform(-jitter, jitter, batch_rows))
        ecg_ts = (t + 0.25)[order]
        ecg = (np.sin(2 * np.pi * t / 6.0)
               + 0.1 * rng.standard_normal(batch_rows))[order]
        counts_ecg = streams[ecg_name].append({"ts": ecg_ts,
                                               "ecg": ecg})
        ran = bd.streams.tick() if tick else []
        yield {**_emit(b, ran), "appended": {
            abp_name: counts_abp["appended"],
            ecg_name: counts_ecg["appended"]}}
    # punctuation: close the tail windows and let standing joins see them
    for s in streams.values():
        s.flush()
    ran = bd.streams.tick() if tick else []
    yield _emit(num_batches, ran)
