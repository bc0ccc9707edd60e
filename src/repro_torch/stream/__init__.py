"""Streaming island (paper §III; arXiv:1609.07548 §"S-Store"), ported
from ``repro.stream``:

  engine.py     — ``Stream`` (append-only bounded ring buffer) and
                  ``StreamEngine`` (S-Store analog, Catalog-registered)
  shim.py       — the streaming island language (append / window /
                  aggregate / rate / snapshot), windows materialized as
                  ``dm.ArrayObject`` / ``dm.Table`` on the engine's device
  compile.py    — the compiled standing-query backend
                  (``REPRO_QUERY_BACKEND=jit``): torch ops on the card and
                  the ``kernels.stream`` CUDA kernels
  continuous.py — standing queries: ``register_continuous`` parses a BQL
                  query once and re-executes it per tick through the
                  Planner's signature plan cache + concurrent Executor
"""
from repro_torch.stream.continuous import ContinuousQuery, StreamRuntime
from repro_torch.stream.engine import Stream, StreamEngine

__all__ = ["ContinuousQuery", "Stream", "StreamEngine", "StreamRuntime"]
