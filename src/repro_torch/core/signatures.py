"""Query signatures (paper §V.E): a structural fingerprint of a BQL query
used by the Monitor to match new queries against benchmarked ones
(``getClosestSignature``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

import numpy as np

from repro_torch.core import bql

_OP_WORDS = ("select", "filter", "join", "cross_join", "project", "aggregate",
             "redimension", "sort", "scan", "range", "group", "order",
             "limit", "count", "sum", "avg", "min", "max", "where",
             "distinct",
             # streaming island (repro.stream.shim)
             "append", "window", "rate", "snapshot",
             # event-time streaming ops (watermarked windows + joins)
             "ewindow", "watermark", "flush")


@dataclasses.dataclass(frozen=True)
class Signature:
    islands: Tuple[str, ...]            # islands touched (sorted, with dups)
    ops: Tuple[Tuple[str, int], ...]    # (op keyword, count), sorted
    objects: Tuple[str, ...]            # referenced object names (sorted)
    num_casts: int
    depth: int

    def key(self) -> str:
        return (f"{'/'.join(self.islands)}|"
                f"{','.join(f'{o}:{c}' for o, c in self.ops)}|"
                f"{','.join(self.objects)}|c{self.num_casts}|d{self.depth}")

    def features(self) -> np.ndarray:
        vec = np.zeros(len(_OP_WORDS) + 3, dtype=np.float64)
        counts = dict(self.ops)
        for i, w in enumerate(_OP_WORDS):
            vec[i] = counts.get(w, 0)
        vec[-3] = len(self.islands)
        vec[-2] = self.num_casts
        vec[-1] = self.depth
        return vec

    def distance(self, other: "Signature") -> float:
        d = float(np.linalg.norm(self.features() - other.features()))
        # object overlap matters: disjoint tables are a weaker match
        a, b = set(self.objects), set(other.objects)
        union = a | b
        jaccard = (len(a & b) / len(union)) if union else 1.0
        return d + 4.0 * (1.0 - jaccard)


def _island_ops(node: bql.IslandQueryNode) -> Dict[str, int]:
    text = node.query.lower()
    counts: Dict[str, int] = {}
    for w in _OP_WORDS:
        n = len(re.findall(rf"\b{w}\b", text))
        if n:
            counts[w] = n
    return counts


_NAME_RE = re.compile(r"\b([a-zA-Z_][\w\.]*)\b")
_KEYWORDS = set(_OP_WORDS) | {
    "from", "as", "by", "asc", "desc", "and", "or", "op", "table", "start",
    "end", "true", "false",
    # join kwargs (join(W1, W2, on=ts, tol=0.5)) are not object refs
    "on", "tol"}


def _referenced_objects(node: bql.IslandQueryNode, engines_have=None
                        ) -> Tuple[str, ...]:
    cast_names = {c.dest_name for c in node.casts}
    names = set()
    for m in _NAME_RE.finditer(node.query):
        tok = m.group(1)
        if tok.lower() in _KEYWORDS or tok in cast_names:
            continue
        if "." in tok or (engines_have and engines_have(tok)):
            names.add(tok)
    return tuple(sorted(names))


def of_query(root) -> Signature:
    """Build a signature from a parsed BQL plan tree."""
    if isinstance(root, bql.CatalogQueryNode):
        return Signature(("catalog",), (("select", 1),), (), 0, 1)
    islands, objects = [], set()
    ops: Dict[str, int] = {}
    num_casts, depth = 0, 0

    def visit(node: bql.IslandQueryNode, d: int):
        nonlocal num_casts, depth
        depth = max(depth, d)
        islands.append(node.island)
        for k, v in _island_ops(node).items():
            ops[k] = ops.get(k, 0) + v
        objects.update(_referenced_objects(node))
        for cast in node.casts:
            num_casts += 1
            visit(cast.child, d + 1)

    visit(root, 1)
    return Signature(tuple(sorted(islands)),
                     tuple(sorted(ops.items())),
                     tuple(sorted(objects)), num_casts, depth)
