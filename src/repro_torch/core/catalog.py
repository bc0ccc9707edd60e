"""The BigDAWG Catalog (paper §V.A): metadata about engines, databases,
objects, shims and casts.  The Planner, Migrator and Executor all rely on
the Catalog for "awareness" of the polystore components.

The paper backs the catalog with a PostgreSQL instance; here it is an
in-process columnar store with JSON persistence — same five tables, same
fields (Fig. 4), queryable through ``bdcatalog(...)`` with a SQL subset.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class EngineRow:
    eid: int
    name: str
    host: str
    port: int
    connection_properties: str


@dataclasses.dataclass
class DatabaseRow:
    dbid: int
    engine_id: int
    name: str
    userid: str = "repro"
    password: str = "test"


@dataclasses.dataclass
class ObjectRow:
    oid: int
    name: str
    fields: str              # comma-separated field names
    logical_db: int
    physical_db: int


@dataclasses.dataclass
class ShimRow:
    shim_id: int
    island_id: int
    engine_id: int
    access_method: str = "N/A"


@dataclasses.dataclass
class CastRow:
    cast_id: int
    src_eid: int
    dst_eid: int
    method: str              # binary | staged | quant


@dataclasses.dataclass
class IslandRow:
    iid: int
    name: str                # relational | array | text


class Catalog:
    """Thread-safe in-process catalog with the paper's table schema."""

    TABLES = ("engines", "databases", "objects", "shims", "casts", "islands")

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.engines: Dict[int, EngineRow] = {}
        self.databases: Dict[int, DatabaseRow] = {}
        self.objects: Dict[int, ObjectRow] = {}
        self.shims: Dict[int, ShimRow] = {}
        self.casts: Dict[int, CastRow] = {}
        self.islands: Dict[int, IslandRow] = {}
        self._next_id = {t: 0 for t in self.TABLES}

    def _nid(self, table: str) -> int:
        nid = self._next_id[table]
        self._next_id[table] += 1
        return nid

    # -- writers ------------------------------------------------------------
    def add_island(self, name: str) -> IslandRow:
        with self._lock:
            row = IslandRow(self._nid("islands"), name)
            self.islands[row.iid] = row
            return row

    def add_engine(self, name: str, host: str = "local", port: int = 0,
                   connection_properties: str = "") -> EngineRow:
        with self._lock:
            row = EngineRow(self._nid("engines"), name, host, port,
                            connection_properties)
            self.engines[row.eid] = row
            return row

    def add_database(self, engine_id: int, name: str) -> DatabaseRow:
        with self._lock:
            row = DatabaseRow(self._nid("databases"), engine_id, name)
            self.databases[row.dbid] = row
            return row

    def add_object(self, name: str, fields: Sequence[str], logical_db: int,
                   physical_db: int) -> ObjectRow:
        with self._lock:
            row = ObjectRow(self._nid("objects"), name, ",".join(fields),
                            logical_db, physical_db)
            self.objects[row.oid] = row
            return row

    def add_shim(self, island_id: int, engine_id: int,
                 access_method: str = "N/A") -> ShimRow:
        with self._lock:
            row = ShimRow(self._nid("shims"), island_id, engine_id,
                          access_method)
            self.shims[row.shim_id] = row
            return row

    def add_cast(self, src_eid: int, dst_eid: int, method: str) -> CastRow:
        with self._lock:
            row = CastRow(self._nid("casts"), src_eid, dst_eid, method)
            self.casts[row.cast_id] = row
            return row

    def relocate_object(self, obj_name: str,
                        engine_name: str) -> ObjectRow:
        """Re-home an object's logical/physical database onto another
        engine's database (live stream-shard migration keeps the catalog
        truthful about where each shard's ring buffer lives)."""
        with self._lock:
            obj = self.object_by_name(obj_name)
            if obj is None:
                raise ValueError(f"unknown catalog object {obj_name!r}")
            engine = self.engine_by_name(engine_name)
            if engine is None:
                raise ValueError(f"unknown catalog engine {engine_name!r}")
            db = next((d for d in self.databases.values()
                       if d.engine_id == engine.eid), None)
            if db is None:
                raise ValueError(f"engine {engine_name!r} has no database")
            obj.logical_db = db.dbid
            obj.physical_db = db.dbid
            return obj

    # -- readers ------------------------------------------------------------
    def engine_by_name(self, name: str) -> Optional[EngineRow]:
        for row in self.engines.values():
            if row.name == name:
                return row
        return None

    def island_by_name(self, name: str) -> Optional[IslandRow]:
        for row in self.islands.values():
            if row.name == name:
                return row
        return None

    def database_by_name(self, name: str) -> Optional[DatabaseRow]:
        for row in self.databases.values():
            if row.name == name:
                return row
        return None

    def object_by_name(self, name: str) -> Optional[ObjectRow]:
        for row in self.objects.values():
            if row.name == name:
                return row
        return None

    def engines_for_island(self, island_name: str) -> List[EngineRow]:
        isl = self.island_by_name(island_name)
        if isl is None:
            return []
        eids = [s.engine_id for s in self.shims.values()
                if s.island_id == isl.iid]
        return [self.engines[e] for e in eids if e in self.engines]

    def engine_for_object(self, obj_name: str) -> Optional[EngineRow]:
        obj = self.object_by_name(obj_name)
        if obj is None:
            return None
        db = self.databases.get(obj.physical_db)
        if db is None:
            return None
        return self.engines.get(db.engine_id)

    def casts_between(self, src_eid: int, dst_eid: int) -> List[CastRow]:
        return [c for c in self.casts.values()
                if c.src_eid == src_eid and c.dst_eid == dst_eid]

    # -- bdcatalog(...) SQL subset -------------------------------------------
    _SELECT_RE = re.compile(
        r"^\s*select\s+(?P<cols>\*|[\w,\s]+)\s+from\s+(?P<table>\w+)"
        r"(?:\s+where\s+(?P<col>\w+)\s*=\s*'?(?P<val>[\w\.\-]+)'?)?\s*;?\s*$",
        re.IGNORECASE)

    def query(self, sql: str) -> List[Dict[str, Any]]:
        m = self._SELECT_RE.match(sql)
        if not m:
            raise ValueError(f"unsupported catalog query: {sql!r}")
        table = m.group("table").lower()
        if table not in self.TABLES:
            raise ValueError(f"unknown catalog table: {table}")
        rows = [dataclasses.asdict(r) for r in getattr(self, table).values()]
        col, val = m.group("col"), m.group("val")
        if col:
            def _match(r):
                got = r.get(col.lower())
                return str(got) == val
            rows = [r for r in rows if _match(r)]
        cols = m.group("cols").strip()
        if cols != "*":
            names = [c.strip() for c in cols.split(",")]
            rows = [{n: r[n] for n in names} for r in rows]
        return rows

    # -- persistence ----------------------------------------------------------
    def to_json(self) -> str:
        payload = {t: [dataclasses.asdict(r)
                       for r in getattr(self, t).values()]
                   for t in self.TABLES}
        payload["_next_id"] = self._next_id
        return json.dumps(payload, indent=1)

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)          # atomic promote

    @classmethod
    def load(cls, path: str) -> "Catalog":
        with open(path) as f:
            payload = json.load(f)
        cat = cls()
        ctors = {"engines": EngineRow, "databases": DatabaseRow,
                 "objects": ObjectRow, "shims": ShimRow, "casts": CastRow,
                 "islands": IslandRow}
        keyfields = {"engines": "eid", "databases": "dbid", "objects": "oid",
                     "shims": "shim_id", "casts": "cast_id",
                     "islands": "iid"}
        for t, ctor in ctors.items():
            for rowdict in payload.get(t, []):
                row = ctor(**rowdict)
                getattr(cat, t)[getattr(row, keyfields[t])] = row
        cat._next_id = payload.get("_next_id", cat._next_id)
        return cat
