"""Declarative stream specs, ported from ``repro.stream.spec``: the
registration surface of the streaming island as data, not a 13-kwarg
call.

A :class:`StreamSpec` groups the registration knobs into three
orthogonal sub-configs — :class:`Sharding`, :class:`EventTime`,
:class:`Durability` — and is the *primary* registration form:

    from repro_torch.stream.spec import StreamSpec, Sharding, EventTime
    spec = StreamSpec("icu.abp", ("ts", "abp"), capacity=512,
                      sharding=Sharding(shards=2),
                      event_time=EventTime("ts", max_delay=4.0))
    stream = bd.register_stream("streamstore0", spec)

The legacy kwargs form survives as a thin shim that builds the same
spec (and emits ``DeprecationWarning``).  Specs are frozen and
hashable, and round-trip through the durability manifest form
(``manifest_extras`` / ``from_manifest``): ``BigDawg.recover_stream``
rebuilds the spec a durable stream was registered with from its
directory's ``meta.json``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

#: the legacy ``register_stream`` keyword surface, frozen: growth
#: happens on the sub-configs below, not on the kwargs form.
LEGACY_KWARGS = ("capacity", "shards", "shard_key", "num_engines",
                 "rolling", "block_rows", "ts_field", "max_delay",
                 "idle_timeout", "durability", "checkpoint_every_rows",
                 "dead_letter")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Hash-partition the stream into ``shards`` ring buffers spread
    over ``num_engines`` StreamEngines (default: one engine per shard).
    ``shard_key`` hashes rows by a field's value instead of round-robin
    seq blocks of ``block_rows``."""
    shards: int = 2
    shard_key: Optional[str] = None
    num_engines: Optional[int] = None
    block_rows: int = 64

    def __post_init__(self) -> None:
        if self.shards < 2:
            raise ValueError(
                f"Sharding needs shards >= 2, got {self.shards} "
                "(omit the sharding config for a single ring)")
        if self.block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, "
                             f"got {self.block_rows}")
        # None means "one engine per shard"; normalize so value
        # semantics (equality, manifest round-trips) see one spelling
        if self.num_engines is None:
            object.__setattr__(self, "num_engines", self.shards)
        if not 1 <= self.num_engines <= self.shards:
            raise ValueError(
                f"num_engines must be in [1, shards={self.shards}], "
                f"got {self.num_engines}")


@dataclasses.dataclass(frozen=True)
class EventTime:
    """Declare ``ts_field`` as the event-time axis: out-of-order ingest
    bounded by ``max_delay``, watermarks, ``ewindow``/``join`` ops.
    ``idle_timeout`` is automatic punctuation; ``dead_letter`` diverts
    late rows into a queryable ``{name}.__late`` stream."""
    ts_field: str
    max_delay: float = 0.0
    idle_timeout: Optional[float] = None
    dead_letter: bool = False

    def __post_init__(self) -> None:
        if not self.ts_field:
            raise ValueError("EventTime needs a ts_field")
        if self.max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, "
                             f"got {self.max_delay}")
        if self.idle_timeout is not None and self.idle_timeout <= 0:
            raise ValueError(f"idle_timeout must be > 0, "
                             f"got {self.idle_timeout}")


@dataclasses.dataclass(frozen=True)
class Durability:
    """Crash-safety: a write-behind segment log under ``directory``,
    checkpoints every ``checkpoint_every_rows`` logged rows (``None`` =
    explicit only), last ``keep`` checkpoints retained."""
    directory: str
    checkpoint_every_rows: Optional[int] = None
    keep: int = 3

    def __post_init__(self) -> None:
        if not self.directory:
            raise ValueError("Durability needs a directory")
        if (self.checkpoint_every_rows is not None
                and self.checkpoint_every_rows < 1):
            raise ValueError(f"checkpoint_every_rows must be >= 1, "
                             f"got {self.checkpoint_every_rows}")
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Everything ``register_stream`` needs, as one frozen value."""
    name: str
    fields: Tuple[str, ...]
    capacity: int = 4096
    rolling: bool = True
    sharding: Optional[Sharding] = None
    event_time: Optional[EventTime] = None
    durability: Optional[Durability] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "fields", tuple(self.fields))
        if not self.name:
            raise ValueError("StreamSpec needs a name")
        if not self.fields:
            raise ValueError(f"stream {self.name!r} needs fields")
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, "
                             f"got {self.capacity}")
        if self.event_time is not None \
                and self.event_time.ts_field not in self.fields:
            raise ValueError(
                f"ts_field {self.event_time.ts_field!r} is not one of "
                f"the stream's fields {self.fields}")
        if self.sharding is not None \
                and self.sharding.shard_key is not None \
                and self.sharding.shard_key not in self.fields:
            raise ValueError(
                f"shard_key {self.sharding.shard_key!r} is not one of "
                f"the stream's fields {self.fields}")

    # -- convenience accessors (the spec path in api.py reads these) ---------
    @property
    def shards(self) -> int:
        return self.sharding.shards if self.sharding else 1

    @property
    def ts_field(self) -> Optional[str]:
        return self.event_time.ts_field if self.event_time else None

    # -- legacy kwargs <-> spec ----------------------------------------------
    @classmethod
    def from_kwargs(cls, name: str, fields, *, capacity: int = 4096,
                    shards: int = 1, shard_key: Optional[str] = None,
                    num_engines: Optional[int] = None,
                    rolling: bool = True, block_rows: int = 64,
                    ts_field: Optional[str] = None,
                    max_delay: float = 0.0,
                    idle_timeout: Optional[float] = None,
                    durability: Optional[str] = None,
                    checkpoint_every_rows: Optional[int] = None,
                    dead_letter: bool = False) -> "StreamSpec":
        """The legacy 13-kwarg surface, folded into a spec (what the
        deprecation shim calls)."""
        sharding = None
        if shards > 1:
            sharding = Sharding(shards=shards, shard_key=shard_key,
                                num_engines=num_engines,
                                block_rows=block_rows)
        event_time = None
        if ts_field is not None:
            event_time = EventTime(ts_field, max_delay=max_delay,
                                   idle_timeout=idle_timeout,
                                   dead_letter=dead_letter)
        elif dead_letter:
            raise ValueError(
                "dead_letter diverts late event-time rows; it needs "
                "ts_field (EventTime) to ever receive one")
        durable = None
        if durability is not None:
            durable = Durability(
                durability, checkpoint_every_rows=checkpoint_every_rows)
        return cls(name, tuple(fields), capacity=capacity,
                   rolling=rolling, sharding=sharding,
                   event_time=event_time, durability=durable)

    def to_kwargs(self) -> Dict[str, Any]:
        """The legacy keyword dict this spec is equivalent to (used by
        the spec<->kwargs equivalence tests; a spec whose ``keep``
        deviates from the attach default has no kwargs spelling)."""
        if self.durability is not None and self.durability.keep != 3:
            raise ValueError(
                "the legacy kwargs form cannot express Durability.keep "
                f"!= 3 (got {self.durability.keep})")
        out: Dict[str, Any] = {"capacity": self.capacity,
                               "rolling": self.rolling}
        if self.sharding is not None:
            out.update(shards=self.sharding.shards,
                       shard_key=self.sharding.shard_key,
                       num_engines=self.sharding.num_engines,
                       block_rows=self.sharding.block_rows)
        if self.event_time is not None:
            out.update(ts_field=self.event_time.ts_field,
                       max_delay=self.event_time.max_delay,
                       idle_timeout=self.event_time.idle_timeout,
                       dead_letter=self.event_time.dead_letter)
        if self.durability is not None:
            out.update(durability=self.durability.directory,
                       checkpoint_every_rows=self.durability
                       .checkpoint_every_rows)
        return out

    # -- durability manifest (meta.json) round-trip ---------------------------
    def manifest_extras(self) -> Dict[str, Any]:
        """Spec-derived keys the durability layer folds into its
        ``meta.json`` (on top of the runtime facts — engines, shard
        capacities — only the live stream knows)."""
        return {"capacity": self.capacity, "keep": self.keep_or_default()}

    def keep_or_default(self) -> int:
        return self.durability.keep if self.durability else 3

    @classmethod
    def from_manifest(cls, meta: Dict[str, Any],
                      directory: Optional[str] = None) -> "StreamSpec":
        """Rebuild the registration spec from a durability directory's
        ``meta.json`` — what ``recover_stream`` returns, so recovery
        never requires the caller to restate registration kwargs.

        ``directory`` overrides the manifest's durability directory
        (the manifest never records it: the directory is where the
        manifest *lives*, and the tree may have been copied)."""
        sharding = None
        if meta["kind"] == "sharded":
            engines = meta["engines"]
            sharding = Sharding(shards=len(engines),
                                shard_key=meta.get("shard_key"),
                                num_engines=len(set(engines)),
                                block_rows=meta.get("block_rows", 64))
            capacity = meta.get("capacity",
                                sum(meta["shard_capacities"]))
            rolling = meta.get("rolling", True)
        else:
            capacity = meta["capacity"]
            rolling = meta.get("rolling", True)
        event_time = None
        if meta.get("ts_field") is not None:
            event_time = EventTime(meta["ts_field"],
                                   max_delay=meta.get("max_delay", 0.0),
                                   idle_timeout=meta.get("idle_timeout"),
                                   dead_letter=bool(
                                       meta.get("dead_letter", False)))
        durable = None
        if directory is not None:
            durable = Durability(
                directory,
                checkpoint_every_rows=meta.get("checkpoint_every_rows"),
                keep=meta.get("keep", 3))
        return cls(meta["name"], tuple(meta["fields"]),
                   capacity=capacity, rolling=rolling,
                   sharding=sharding, event_time=event_time,
                   durability=durable)
