"""Shims (paper §III), ported from ``repro.core.shims``: translate island-level queries into engine-native
execution.  One shim per (island, engine-kind); since every engine here
speaks the island's data model natively after ``coerce``, the shim's job is
to *parse and execute* the island language over the engine's stored objects:

  relational island — SQL subset (SELECT/WHERE/JOIN/GROUP BY/ORDER BY/LIMIT)
  array island      — AFL subset (scan/filter/project/aggregate/cross_join/
                      redimension/sort)
  text island       — JSON op spec ({'op': 'scan'|'range', 'table': ...})
  streaming island  — functional ops over ring-buffer streams (append/
                      window/aggregate/rate/snapshot),
                      repro_torch.stream.shim
  ml island         — not ported yet (ROADMAP.md "ML slice")
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.core import datamodel as dm
from repro_torch.core.engines import Engine

_OPS = {
    ">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b,
    "!=": lambda a, b: a != b, "=": lambda a, b: a == b,
    ">": lambda a, b: a > b, "<": lambda a, b: a < b,
}


def _parse_value(tok: str):
    tok = tok.strip().strip("'\"")
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            return tok


# ---------------------------------------------------------------------------
# Relational island: SQL subset
# ---------------------------------------------------------------------------
_SQL_RE = re.compile(
    r"^\s*select\s+(?P<distinct>distinct\s+)?(?P<cols>.+?)\s+from\s+"
    r"(?P<from>.+?)"
    r"(?:\s+where\s+(?P<where>.+?))?"
    r"(?:\s+group\s+by\s+(?P<group>[\w\.]+))?"
    r"(?:\s+order\s+by\s+(?P<order>[\w\.]+)(?:\s+(?P<dir>asc|desc))?)?"
    r"(?:\s+limit\s+(?P<limit>\d+))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL)

_AGG_RE = re.compile(r"^(count|sum|avg|min|max)\(\s*(\*|[\w\.]+)\s*\)$",
                     re.IGNORECASE)


def _strip_prefix(col: str, table: dm.Table) -> str:
    if col in table.columns:
        return col
    if "." in col:
        tail = col.split(".")[-1]
        if tail in table.columns:
            return tail
    # qualified names like mimic2v26.d_patients.sex
    for c in table.columns:
        if col.endswith("." + c) or c.endswith("." + col):
            return c
    return col


def execute_relational(engine: Engine, sql: str) -> dm.Table:
    m = _SQL_RE.match(sql)
    if not m:
        raise ValueError(f"unsupported relational query: {sql!r}")

    # FROM: one table, or comma-separated pair (implicit join via WHERE)
    from_items = [t.strip() for t in m.group("from").split(",")]
    names, aliases = [], {}
    for item in from_items:
        parts = re.split(r"\s+as\s+|\s+", item.strip(), flags=re.IGNORECASE)
        names.append(parts[0])
        if len(parts) > 1:
            aliases[parts[-1]] = parts[0]
    table = engine.get(names[0])

    where = m.group("where")
    join_cond: Optional[Tuple[str, str]] = None
    filters: List[Tuple[str, str, Any]] = []
    if where:
        for clause in re.split(r"\s+and\s+", where, flags=re.IGNORECASE):
            clause = clause.strip()
            for op in ("<=", ">=", "!=", "=", "<", ">"):
                if op in clause:
                    lhs, rhs = clause.split(op, 1)
                    lhs, rhs = lhs.strip(), rhs.strip()
                    rhs_val = _parse_value(rhs)
                    if (len(names) > 1 and isinstance(rhs_val, str)
                            and re.match(r"^[\w\.]+$", rhs)):
                        join_cond = (lhs, rhs)
                    else:
                        filters.append((lhs, op, rhs_val))
                    break

    if len(names) > 1:
        right = engine.get(names[1])
        if join_cond is None:
            raise ValueError("two-table FROM requires a join predicate")
        lcol = _strip_prefix(join_cond[0], table)
        rcol = _strip_prefix(join_cond[1], right)
        if lcol not in table.columns:
            lcol, rcol = rcol, lcol
        table = table.join(right, lcol, rcol)

    for col, op, val in filters:
        c = _strip_prefix(col, table)
        mask = _OPS[op](table.columns[c], val)
        table = table.filter(mask)

    group = m.group("group")
    cols_spec = [c.strip() for c in _split_cols(m.group("cols"))]
    if group:
        gcol = _strip_prefix(group, table)
        for c in cols_spec:
            agg = _AGG_RE.match(c)
            if agg:
                fn, target = agg.group(1).lower(), agg.group(2)
                target = gcol if target == "*" else _strip_prefix(target,
                                                                  table)
                table = table.group_agg(gcol, fn, target)
                break
    elif len(cols_spec) == 1 and _AGG_RE.match(cols_spec[0]):
        agg = _AGG_RE.match(cols_spec[0])
        fn, target = agg.group(1).lower(), agg.group(2)
        if target == "*":
            target = table.fields[0]
        else:
            target = _strip_prefix(target, table)
        v = table.columns[target]
        out = {"count": lambda: torch.tensor([v.shape[0]],
                                             dtype=torch.int32,
                                             device=v.device),
               "sum": lambda: dm._sum(v)[None],
               "avg": lambda: (v if v.is_floating_point()
                               else v.to(torch.float32)).mean()[None],
               "min": lambda: v.min()[None],
               "max": lambda: v.max()[None]}[fn]()
        table = dm.Table({f"{fn}_{target}": out})
    elif cols_spec != ["*"]:
        table = table.project([_strip_prefix(c, table) for c in cols_spec])

    order = m.group("order")
    if order:
        table = table.sort_by(_strip_prefix(order, table),
                              descending=(m.group("dir") or "").lower()
                              == "desc")
    if m.group("distinct"):
        # distinct over the first column (sufficient for the subset)
        first = table.fields[0]
        _, idx = np.unique(_dtypes.to_numpy(table.columns[first]),
                           return_index=True)
        keep = torch.from_numpy(np.sort(idx))
        table = dm.Table({n: v[keep.to(v.device)]
                          for n, v in table.columns.items()})
    limit = m.group("limit")
    if limit:
        table = table.limit(int(limit))
    return table


def _split_cols(spec: str) -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in spec:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p.strip() for p in parts]


# ---------------------------------------------------------------------------
# Array island: AFL subset
# ---------------------------------------------------------------------------
def execute_afl(engine: Engine, afl: str) -> dm.ArrayObject:
    afl = afl.strip()
    m = re.match(r"^(\w+)\s*\(", afl)
    if not m:
        # bare array name
        return engine.get(afl)
    fn = m.group(1).lower()
    body = afl[m.end() - 1:]
    inner, _ = _balanced(body)
    args = _split_args(inner)

    if fn == "scan":
        return execute_afl(engine, args[0])
    if fn == "filter":
        arr = execute_afl(engine, args[0])
        return arr.filter(lambda a: _afl_condition(a, args[1]))
    if fn == "project":
        arr = execute_afl(engine, args[0])
        return arr.project([a.strip() for a in args[1:]])
    if fn == "aggregate":
        arr = execute_afl(engine, args[0])
        agg = _AGG_RE.match(args[1].strip())
        if not agg:
            raise ValueError(f"bad aggregate: {args[1]!r}")
        target = agg.group(2)
        if target == "*":
            target = next(iter(arr.attrs))
        return arr.aggregate(agg.group(1).lower(), target)
    if fn == "cross_join":
        a = execute_afl(engine, args[0])
        b = execute_afl(engine, args[1])
        return a.cross_join(b)
    if fn == "redimension":
        arr = execute_afl(engine, args[0])
        shape, dims = _parse_scidb_schema(args[1])
        total = int(np.prod(arr.shape))
        want = int(np.prod(shape))
        assert total == want, f"redimension {arr.shape} -> {shape}"
        return arr.redimension(tuple(shape), tuple(dims))
    if fn == "sort":
        arr = execute_afl(engine, args[0])
        attr = args[1].strip() if len(args) > 1 else next(iter(arr.attrs))
        return arr.sort(attr)
    raise ValueError(f"unsupported AFL operator: {fn}")


def _balanced(s: str) -> Tuple[str, int]:
    depth = 0
    for j, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return s[1:j], j + 1
    raise ValueError(f"unbalanced AFL: {s!r}")


def _split_args(s: str) -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([<{":
            depth += 1
        elif ch in ")]>}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur).strip())
    return parts


def _afl_condition(arr: dm.ArrayObject, cond: str):
    for op in ("<=", ">=", "!=", "=", "<", ">"):
        if op in cond:
            lhs, rhs = cond.split(op, 1)
            lhs = lhs.strip()
            val = _parse_value(rhs)
            if lhs in arr.attrs:
                field = arr.attrs[lhs]
            elif lhs in arr.dim_names:
                field = arr.dim_grid(lhs)
            else:
                raise ValueError(f"unknown attr/dim {lhs!r}")
            return _OPS[op](field, val)
    raise ValueError(f"bad AFL condition: {cond!r}")


def _parse_scidb_schema(schema: str) -> Tuple[List[int], List[str]]:
    """'<a:int32>[i=0:99,100,0, j=0:9,10,0]' -> ([100, 10], ['i','j']).

    Comma-separated parts without '=' are the SciDB chunk size / overlap of
    the preceding dimension and are ignored for shape purposes.
    """
    dims_part = schema[schema.index("["):].strip("[] \t\n")
    shape, names = [], []
    for d in _split_args(dims_part):
        d = d.strip()
        if "=" not in d:
            continue                      # chunk size / overlap
        m = re.match(r"^(\w+)\s*=\s*(-?\d+):(\*|-?\d+)", d)
        if not m:
            raise ValueError(f"bad dim spec {d!r}")
        names.append(m.group(1))
        lo = int(m.group(2))
        hi = m.group(3)
        if hi == "*":
            shape.append(-1)
        else:
            shape.append(int(hi) - lo + 1)
    return shape, names


# ---------------------------------------------------------------------------
# Text island: JSON op spec
# ---------------------------------------------------------------------------
def execute_text(engine: Engine, spec: str):
    payload = json.loads(spec.replace("'", '"'))
    table: dm.KVTable = engine.get(payload["table"])
    op = payload["op"]
    if op == "scan":
        return table.scan()
    if op == "range":
        rng = payload["range"]
        return table.range(tuple(rng["start"]), tuple(rng["end"]))
    raise ValueError(f"unsupported text op: {op}")


def execute(island: str, engine: Engine, query: str):
    if island == "relational":
        return execute_relational(engine, query)
    if island == "array":
        return execute_afl(engine, query)
    if island == "text":
        return execute_text(engine, query)
    if island == "streaming":
        from repro_torch.stream.shim import execute_stream
        return execute_stream(engine, query)
    if island == "ml":
        raise NotImplementedError(
            "the ml island is not ported yet: ROADMAP.md \"ML slice\"")
    raise ValueError(f"unknown island {island}")
