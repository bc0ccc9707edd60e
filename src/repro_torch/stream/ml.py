"""ML inference island (``bdml``), ported from ``repro.stream.ml``: score
stream windows through the model registry.

The island has one operation:

  infer(window(S, n), models.M[, field=f])    -> dm.Table
  infer(ewindow(S, span), models.M[, field=f])
  infer(W, models.M[, field=f])               (W: a window view already
                                              on this engine, e.g.
                                              bdcast-delivered)

Each window's chosen field is quantized into token ids (deterministic
per-window min/max binning over the float64 row values, on the host) and
run through ``registry.forward`` on the model's reduced config; the
score is the mean next-token NLL in float32.  The result is a relational
Table with one row per window (``window``/``rows``/``score``).

Bit-identity contract, as the reference's:

  * ``infer`` over a gathered window ≡ a direct ``registry.forward`` of
    the port on the same rows, on the same device, **bitwise**: the
    island runs exactly that forward (eagerly) and the NLL after it;
  * sharded ≡ unsharded: window gathers are bit-identical across shard
    layouts, params come from a fixed seed cached per (arch, seed,
    device), and every window executes at the same canonical ``(1,
    rows)`` batch shape.

The params are drawn from ``torch.Generator().manual_seed(seed)`` (on the
host, then moved to the engine's device), not from ``jax.random``: the
port's scores are its own, and a parity test carries the reference's
params across to compare them.

Execution rides the serve tier's wave model (``TickWaveScheduler``): all
standing ``infer`` queries that run within one StreamRuntime tick join a
single wave.  ``StreamRuntime.tick`` mirrors ``stats()`` into
``Monitor.observe_ml``.  Errors about not-yet-complete windows propagate
as ``StreamException`` (transient: standing queries and cached plans
survive them).
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import datamodel as dm
from repro_torch.core.engines import Engine
from repro_torch.models import registry
from repro_torch.obs import metrics, trace
from repro_torch.serve.engine import TickWaveScheduler
from repro_torch.sharding import logical as _logical
from repro_torch.stream.engine import (SEQ_FIELD, ShardedStream, Stream,
                                       StreamEngine, StreamException)


class MLException(StreamException):
    """ml-island failure; subclasses the streaming island's transient
    marker so standing queries and cached plans survive it."""


# registry architectures behind the island's short model aliases (there
# is no pure-mamba arch in the pool; jamba is the mamba-hybrid)
ALIASES = {"lm": "qwen2-1.5b", "moe": "olmoe-1b-7b",
           "rwkv6": "rwkv6-7b", "mamba": "jamba-v0.1-52b"}


def resolve_arch(name: str) -> str:
    if name in ALIASES:
        return ALIASES[name]
    if name in registry.ARCH_NAMES:
        return name
    raise MLException(
        f"unknown model {name!r}: aliases {sorted(ALIASES)} or a "
        f"registry arch name")


@dataclasses.dataclass
class MLModel:
    """Catalog handle for a registered model.  Dotted ``name`` on
    purpose: the Planner's signature extractor treats dotted tokens as
    referenced objects, which is what pins infer reads to this handle's
    home engine."""
    name: str                      # catalog object name, e.g. models.moe
    arch: str                      # registry architecture
    seed: int = 0                  # seed of the cached params
    home_engine: str = "mlhost0"

    def nbytes(self) -> int:
        return 0                   # the handle itself holds no tensors


class MLEngine(Engine):
    """Model-serving engine of the ml island.  Stores ``MLModel`` handles
    (plus any bdcast-delivered window views); keeps back-references to
    the deployment so ``infer`` can resolve inline window expressions
    against the stream's home StreamEngine and join the current tick's
    wave.  Its models run on its ``device``."""
    kind = "mlserve"
    islands: Tuple[str, ...] = ("ml",)

    def __init__(self, name: str, runtime=None, engines=None,
                 device=None) -> None:
        super().__init__(name, device)
        self.runtime = runtime            # StreamRuntime (tick counter)
        self.deployment_engines = engines  # name -> Engine


@dataclasses.dataclass
class _Loaded:
    cfg: Any
    params: Any


_LOADED: Dict[Tuple[str, int, str], _Loaded] = {}
_WAVE = TickWaveScheduler()
_STATS: Dict[str, int] = {
    "models_loaded": 0, "params_cache_hits": 0, "infer_executions": 0,
    "windows_scored": 0}


def stats() -> Dict[str, Any]:
    """Process-wide ml-island counters (the Monitor's ``ml`` block)."""
    return {**_STATS, "waves": _WAVE.waves,
            "wave_submissions": _WAVE.submissions}


def load_model(arch: str, seed: int, device) -> _Loaded:
    """The per-(arch, seed, device) params cache.  Params are drawn from
    a fixed seed, so every deployment that registers the same model
    scores with bit-identical weights."""
    device = torch.device(device)
    key = (arch, seed, str(device))
    if key in _LOADED:
        _STATS["params_cache_hits"] += 1
        return _LOADED[key]
    cfg = registry.get_config(arch, reduced=True)
    params = _logical.init_params(torch.Generator().manual_seed(seed),
                                  registry.param_specs(cfg), device)
    loaded = _Loaded(cfg=cfg, params=params)
    _LOADED[key] = loaded
    _STATS["models_loaded"] += 1
    metrics.gauge("repro_ml_models_loaded",
                  "(arch, seed, device) entries in the params cache").set(
        len(_LOADED))
    return loaded


def quantize(values: np.ndarray, vocab: int) -> np.ndarray:
    """Deterministic per-window tokenization: min/max binning of the
    float64 row values into ``vocab`` ids, on the host, bit for bit the
    reference's.  A pure function of the row values alone."""
    v = np.asarray(values, np.float64).reshape(-1)
    lo, hi = float(v.min()), float(v.max())
    if hi <= lo:
        return np.zeros(v.shape[0], np.int32)
    ids = np.floor((v - lo) / (hi - lo) * (vocab - 1))
    return np.minimum(ids, vocab - 1).astype(np.int32)


def score_tokens(loaded: _Loaded, tokens: np.ndarray) -> torch.Tensor:
    """Mean next-token NLL of one window's token ids, float32, as a 0-d
    tensor on the params' device: ``registry.forward`` at the canonical
    (1, rows) shape, then the NLL from its logits."""
    if tokens.shape[0] < 2:
        raise MLException(
            f"window too short to score: {tokens.shape[0]} row(s), "
            f"need >= 2")
    device = loaded.params["embed"]["embedding"].device
    toks = torch.from_numpy(tokens[None, :].astype(np.int32)).to(device)
    logits, _ = registry.forward(loaded.params, {"tokens": toks},
                                 loaded.cfg)
    logp = torch.log_softmax(logits[0, :-1].float(), -1)
    nll = -logp.gather(-1, toks[0, 1:, None].long())[..., 0]
    return nll.mean()


# ---------------------------------------------------------------------------
# the shim: infer(<window expr | name>, <model>[, field=...])
# ---------------------------------------------------------------------------
_WINDOW_EXPR_RE = re.compile(r"^(window|ewindow)\s*\(\s*([\w\.]+)\s*,",
                             re.IGNORECASE)
_KWARG_RE = re.compile(r"^(\w+)\s*=\s*(.+)$")


def _find_stream_engine(engines: Dict[str, Engine],
                        name: str) -> Optional[StreamEngine]:
    for ename in sorted(engines):
        e = engines[ename]
        if (isinstance(e, StreamEngine) and e.has(name)
                and isinstance(e.get(name), (Stream, ShardedStream))):
            return e
    return None


def _window_values(engine: MLEngine, expr: str,
                   field: Optional[str]) -> Tuple[List[np.ndarray], int]:
    """Evaluate the window argument to a list of per-window float64 row
    vectors (1 for tumbling/ewindow views, N for sliding 2-D views)."""
    m = _WINDOW_EXPR_RE.match(expr)
    if m:
        sname = m.group(2)
        engines = engine.deployment_engines or {}
        home = _find_stream_engine(engines, sname)
        if home is None:
            raise MLException(f"stream {sname!r} not found on any "
                              f"StreamEngine")
        from repro_torch.stream.shim import execute_stream
        view = execute_stream(home, expr)
        ts_field = getattr(home.get(sname), "ts_field", None)
    elif engine.has(expr):
        view = engine.get(expr)
        ts_field = None
    else:
        raise MLException(
            f"infer needs a window(...)/ewindow(...) expression or a "
            f"window object on {engine.name}; got {expr!r}")
    if not isinstance(view, dm.ArrayObject):
        raise MLException(f"infer scores window views (ArrayObject), "
                          f"got {type(view).__name__}")
    if field is None:
        skip = {ts_field, "ts", SEQ_FIELD, "seq"}
        field = next((a for a in view.attrs if a not in skip),
                     next(iter(view.attrs)))
    if field not in view.attrs:
        raise MLException(f"window has no field {field!r} "
                          f"(have {list(view.attrs)})")
    vals = view.attrs[field].cpu().numpy().astype(np.float64)
    if vals.ndim == 1:
        return [vals], 1
    # sliding windows: dims ("window", "tick") — one score per row
    return [vals[i] for i in range(vals.shape[0])], vals.shape[0]


def _wave_key(engine: MLEngine) -> Tuple[int, int]:
    """All infer executions between two ticks of the same deployment
    share one wave; the tick counter advances before standing queries
    run, so every standing query due on a tick lands in that tick's
    wave."""
    rt = engine.runtime
    return (id(rt), rt.ticks if rt is not None else 0)


def execute_ml(engine: Engine, query: str) -> dm.Table:
    q = query.strip()
    m = re.match(r"^(\w+)\s*\(", q)
    if not m or m.group(1).lower() != "infer":
        raise ValueError(f"unsupported ml op: {q!r}")
    if not isinstance(engine, MLEngine):
        raise MLException(f"ml island queries need an MLEngine, "
                          f"got {engine.name} ({engine.kind})")
    from repro_torch.stream.shim import _balanced, _split_args
    inner, _ = _balanced(q[m.end() - 1:])
    args = _split_args(inner)
    if len(args) < 2:
        raise MLException(f"infer needs (window, model), got {q!r}")
    kwargs: Dict[str, str] = {}
    pos = []
    for a in args:
        kw = _KWARG_RE.match(a)
        if kw and kw.group(1).lower() == "field":
            kwargs["field"] = kw.group(2).strip().strip("'\"")
        else:
            pos.append(a)
    window_expr, model_name = pos[0], pos[1].strip()
    if not engine.has(model_name):
        raise MLException(f"model {model_name!r} is not registered on "
                          f"{engine.name} (bd.register_model)")
    handle = engine.get(model_name)
    if not isinstance(handle, MLModel):
        raise MLException(f"{model_name!r} is not an MLModel handle")

    def run() -> dm.Table:
        loaded = load_model(handle.arch, handle.seed, engine.device)
        windows, n = _window_values(engine, window_expr, kwargs.get("field"))
        scores = []
        for i, vals in enumerate(windows):
            t0 = time.perf_counter()
            with trace.span("ml/score", model=handle.arch, window=i,
                            rows=int(vals.shape[0])):
                toks = quantize(vals, loaded.cfg.vocab_size)
                scores.append(score_tokens(loaded, toks))
            metrics.histogram("repro_ml_score_seconds",
                              "per-window forward + NLL time",
                              model=handle.arch).observe(
                time.perf_counter() - t0)
        _STATS["windows_scored"] += n
        metrics.counter("repro_ml_windows_scored_total",
                        "windows scored").inc(n)
        dev = engine.device
        return dm.Table({
            "window": torch.arange(n, dtype=torch.int32, device=dev),
            "rows": torch.tensor([w.shape[0] for w in windows],
                                 dtype=torch.int32, device=dev),
            "score": torch.stack(scores).float()})

    _STATS["infer_executions"] += 1
    metrics.counter("repro_ml_infer_total",
                    "infer executions (standing + ad hoc)").inc()
    return _WAVE.submit(_wave_key(engine), run)
