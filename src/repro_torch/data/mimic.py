"""Synthetic MIMIC-II-style dataset (paper §IV), ported from
``repro.data.mimic``: patient history into the relational engine, the
physiologic waveform into the array engine, free-form text into the KV
engine — the default placement of the v0.1 release scripts.

``mimic_demo_arrays`` draws from numpy's ``default_rng`` in the same order
as the reference, and narrows to the dtypes ``jnp.asarray`` gives, so both
packages hold identical data; it also serves as the host-side truth that
query results are checked against.
"""
from __future__ import annotations

from typing import Any, Dict

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
