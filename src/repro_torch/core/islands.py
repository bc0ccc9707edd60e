"""Islands (paper §III), ported from ``repro.core.islands``: data model
+ operations + candidate engines.  An island provides location
independence among its engines; the engine-native escape hatch
(semantic completeness) is ``Engine.get``/``put`` plus each engine's
own methods.

Beyond the v0.1 release's three islands, this reproduction adds the
``streaming`` island the architecture papers call for (arXiv:1609.07548,
arXiv:1602.08791: S-Store as a polystore member): bounded ring-buffer
streams whose window views materialize as relational/array objects —
see ``repro_torch.stream``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

from repro_torch.core import datamodel as dm


@dataclasses.dataclass(frozen=True)
class Island:
    name: str
    data_model: str
    operations: Tuple[str, ...]
    # a type, or a tuple of types (isinstance-compatible)
    result_type: Union[type, Tuple[type, ...]]


ISLANDS = {
    "relational": Island(
        name="relational", data_model="tables of tuples",
        operations=("select", "project", "filter", "join", "aggregate",
                    "group", "sort", "limit", "distinct"),
        result_type=dm.Table),
    "array": Island(
        name="array", data_model="multi-dimensional arrays",
        operations=("scan", "filter", "project", "aggregate", "cross_join",
                    "redimension", "sort"),
        result_type=dm.ArrayObject),
    "text": Island(
        name="text", data_model="sorted key-value rows",
        operations=("scan", "range"),
        result_type=list),
    "streaming": Island(
        name="streaming", data_model="append-only bounded row streams",
        operations=("append", "window", "ewindow", "join", "aggregate",
                    "rate", "snapshot", "watermark", "flush"),
        # windows materialize as arrays; snapshots/rates/joins as tables
        result_type=(dm.ArrayObject, dm.Table)),
    "ml": Island(
        name="ml", data_model="model-scored stream windows",
        operations=("infer",),
        # per-window score rows
        result_type=dm.Table),
}


def validate_result(island_name: str, value) -> bool:
    island = ISLANDS[island_name]
    return isinstance(value, island.result_type)
