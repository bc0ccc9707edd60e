"""One clinical analyst's dashboard: the example queries of the BigDAWG
v0.1 paper's §VI, issued back to back (a closed loop of one client).

The paper gives the queries, not their proportions: the weights of the
workload's ``mix`` are assumed.  The mix is a cycle: each cycle holds
every kind as many times as its weight, in an order drawn from the seed,
and each query's constants (a limit, a sex, a threshold, a key range, a
waveform record) are drawn from the seed too.  So every seed asks the
same kinds in the same proportions, in another order and with other
constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Query:
    kind: str
    bql: str                  # "" for the quant route (a Migrator call)
    const: Dict[str, int]


def _one(kind: str, rng, sizes: Dict[str, int]) -> Query:
    n_logs = int(sizes["num_notes"])
    if kind == "rel_limit":
        n = int(rng.integers(1, 65))
        return Query(kind, "bdrel(select * from mimic2v26.d_patients "
                     f"limit {n})", {"n": n})
    if kind == "rel_count":
        s = int(rng.integers(0, 2))
        return Query(kind, "bdrel(select count(*) from mimic2v26.d_patients"
                     f" where sex = {s})", {"sex": s})
    if kind == "rel_group_avg":
        return Query(kind, "bdrel(select sex, avg(dob_year) from "
                     "mimic2v26.d_patients group by sex)", {})
    if kind == "array_filter":
        c = int(rng.integers(0, int(sizes["myarray_cells"]) - 1))
        return Query(kind, f"bdarray(filter(myarray, dim1>{c}))", {"c": c})
    if kind == "array_avg":
        r = int(rng.integers(0, int(sizes["waveform_records"])))
        return Query(kind, f"bdarray(aggregate({record_name(r)}, "
                     "avg(signal)))", {"r": r})
    if kind == "text_range":
        a = int(rng.integers(0, n_logs - 1))
        b = int(rng.integers(a, min(n_logs, a + 64)))
        return Query(kind, "bdtext({ 'op' : 'range', 'table' : "
                     f"'mimic_logs', 'range' : {{ 'start' : ['r_{a:07d}',"
                     f"'',''], 'end' : ['r_{b:07d}','',''] }} }})",
                     {"a": a, "b": b})
    if kind == "catalog":
        return Query(kind, "bdcatalog(select name, connection_properties "
                     "from engines)", {})
    if kind == "cast_rel_to_array":
        return Query(kind, "bdarray(scan(bdcast(bdrel(select poe_id, "
                     "subject_id from mimic2v26.poe_order), poe_order_copy,"
                     " '<subject_id:int32>[poe_id=0:*,10000000,0]', "
                     "array)))", {})
    if kind == "quant_route":
        r = int(rng.integers(0, int(sizes["waveform_records"])))
        return Query(kind, "", {"r": r})
    raise ValueError(f"unknown query kind {kind!r}")


def record_name(r: int) -> str:
    """The array object that holds waveform record ``r``."""
    return f"mimic2v26.waveform_r{r:04d}"


def make(params: dict, seed: int, sizes: Dict[str, int]
         ) -> Iterator[Query]:
    """The analyst's queries over tables of ``sizes``, without end."""
    rng = np.random.default_rng(seed % (2 ** 63))
    cycle = [k for k, w in params["mix"].items() for _ in range(int(w))]
    while True:
        for i in rng.permutation(len(cycle)):
            yield _one(cycle[i], rng, sizes)
