"""Serving engine, ported from ``repro.serve.engine``: prefill + greedy
decode against the KV cache, with a wave-based (iteration-level) batching
scheduler and the optional int8 KV-page codec.

Decode slots are position-aligned within a wave (one cache cursor;
the recurrent families' states have no cursor and take the same steps);
requests are left-padded into waves by the scheduler, as the reference
pads them.  A session runs on the card unless the caller asks for the CPU
(``device="cpu"``), where the kernels' plain versions stand in for
them.  ``ServeConfig.streams`` declares the streams the serving front
door (``frontdoor.py``) provisions when it opens.  The reference's
``quantize_kv_between_waves`` knob, which nothing reads, is left out.
"""
from __future__ import annotations

import atexit
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import _device, _tree
from repro_torch.models import lm, registry
from repro_torch.models.config import ModelConfig
from repro_torch.obs import metrics, trace
from repro_torch.stream.spec import StreamSpec

def place_params(params: Any, device) -> Any:
    """The parameter tree on ``device``, with every leaf the model casts
    to the compute dtype at each use (projections, biases, the embedding, the
    FFN) cast once now and the subtrees the model reads in float32
    (``lm.FLOAT32_LEAVES``: the norms, RWKV6's decay, bonus and group
    norm, Mamba's decay and dt/B/C norms, the MoE router) left as they are:
    the model's ``.to(dtype)`` then passes the cast leaves through, so
    the results are bit for bit those of casting at each use."""
    if isinstance(params, dict):
        return {k: (_tree.tree_map(lambda t: t.to(device), v)
                    if k in lm.FLOAT32_LEAVES else place_params(v, device))
                for k, v in params.items()}
    return params.to(device=device, dtype=lm.COMPUTE_DTYPE)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    cache_len: int = 256
    max_new_tokens: int = 32
    # waves in flight at once; each wave owns its KV cache, so waves are
    # independent; >1 overlaps host-side scheduling with device compute
    max_parallel_waves: int = 1
    # serve a Prometheus /metrics endpoint on this port (None = don't)
    metrics_port: Optional[int] = None
    # polystore streams this serving tier provisions at startup — the
    # same declarative StreamSpec values register_stream/recover_stream
    # speak (the FrontDoor registers each when it opens; specs are
    # frozen, so the whole config stays hashable)
    streams: Tuple[StreamSpec, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "streams", tuple(self.streams))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray
    prefill_seconds: float
    decode_seconds: float


class ServeSession:
    """One wave: batched prefill then lock-step greedy decode.

    ``params`` is the model's parameter tree (float32, as
    ``init_params`` or ``convert.params_from_numpy`` give it); the
    session moves it to ``device`` and casts the leaves the model reads
    in the compute dtype once, here.  ``last_logits`` holds the float32
    logits of the last step of the last wave run (the prefill's when no
    decode step ran)."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 device=None) -> None:
        self.cfg = cfg
        self.scfg = scfg
        self.device = _device.resolve(device, "ServeSession")
        self.params = place_params(params, self.device)
        self.last_logits: Optional[torch.Tensor] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def frontend_batch(self, prompts: np.ndarray) -> Dict[str, Any]:
        """The model's batch for left-padded ``prompts`` (B, P): their
        tokens and the stub frontend's inputs, zero prefix embeddings
        for a vision arch and for an audio one zero frame embeddings,
        one frame per ``src_ratio`` prompt positions."""
        b, plen = prompts.shape
        batch: Dict[str, Any] = {
            "tokens": torch.from_numpy(prompts).to(self.device)}
        if self.cfg.frontend == "vision":
            batch["prefix_embeds"] = torch.zeros(
                (b, self.cfg.num_prefix_embeds, self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        if self.cfg.frontend == "audio":
            batch["frame_embeds"] = torch.zeros(
                (b, max(1, plen // self.cfg.src_ratio), self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        return batch

    def prefill(self, prompts: np.ndarray):
        """Prefill a fresh cache with left-padded ``prompts`` (B, P).
        Returns (last-token logits, cache, extras, first decode
        position)."""
        b, plen = prompts.shape
        cache = registry.init_cache(self.cfg, b, self.scfg.cache_len,
                                    self.device)
        logits, cache, extras = registry.prefill(
            self.params, self.frontend_batch(prompts), cache, self.cfg)
        pos0 = plen + (self.cfg.num_prefix_embeds
                       if self.cfg.frontend == "vision" else 0)
        return logits, cache, extras, pos0

    def decode(self, tokens: np.ndarray, cache, pos: int, extras):
        """One greedy step: ``tokens`` (B,) at position ``pos``; the cache
        is written in place, and ``extras`` (prefill's, e.g. an enc-dec
        arch's encoder memory) go with the tokens.  Returns (logits,
        cache)."""
        tok = torch.from_numpy(tokens.astype(np.int32)[:, None]).to(
            self.device)
        return registry.decode_step(self.params, {"tokens": tok, **extras},
                                    cache, pos, self.cfg)

    def run_wave(self, requests: List[Request]) -> List[Completion]:
        with trace.span("serve/wave", batch=len(requests)) as sp:
            completions = self._run_wave(requests)
            sp.set(prefill_s=round(completions[0].prefill_seconds, 6),
                   decode_s=round(completions[0].decode_seconds, 6))
        metrics.counter("repro_serve_waves_total",
                        "decode waves executed").inc()
        metrics.histogram("repro_serve_prefill_seconds",
                          "batched prefill time per wave").observe(
            completions[0].prefill_seconds)
        metrics.histogram("repro_serve_decode_seconds",
                          "lock-step decode time per wave").observe(
            completions[0].decode_seconds)
        return completions

    def _run_wave(self, requests: List[Request]) -> List[Completion]:
        b = len(requests)
        plen = max(len(r.prompt) for r in requests)
        prompts = np.zeros((b, plen), np.int32)
        for i, r in enumerate(requests):
            prompts[i, -len(r.prompt):] = r.prompt      # left-pad
        self._sync()
        t0 = time.perf_counter()
        logits, cache, extras, pos0 = self.prefill(prompts)
        outs = [_greedy(logits)]                        # waits for the card
        prefill_s = time.perf_counter() - t0

        max_new = min(self.scfg.max_new_tokens,
                      self.scfg.cache_len - pos0 - 1,
                      max(r.max_new_tokens for r in requests))
        t1 = time.perf_counter()
        for i in range(max_new - 1):
            logits, cache = self.decode(outs[-1], cache, pos0 + i, extras)
            outs.append(_greedy(logits))
        decode_s = time.perf_counter() - t1
        self.last_logits = logits[:, -1]

        toks = np.stack(outs, axis=1)                    # (B, max_new)
        return [Completion(r.rid, toks[i, :r.max_new_tokens],
                           prefill_s, decode_s)
                for i, r in enumerate(requests)]


def _greedy(logits: torch.Tensor) -> np.ndarray:
    """Greedy tokens of the last position, on the host (argmax takes the
    first of tied maxima, as np.argmax does)."""
    return logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()


class TickWaveScheduler:
    """Incremental wave scheduler for standing-query work.

    ``Scheduler`` below packs a FIFO of requests into waves up front;
    streaming work arrives one standing ``infer`` query at a time within
    a StreamRuntime tick.  This variant opens a wave on the first
    submission carrying a new key (the tick number) and accounts every
    later same-key submission to the open wave, so N concurrent standing
    queries cost one wave per tick.  Work still executes per submission
    at its canonical shape: a wave batches scheduling and observability,
    never the GEMM shapes, so results stay bitwise independent of what
    else shares the wave.
    """

    def __init__(self, span_name: str = "ml/wave") -> None:
        self.span_name = span_name
        self.waves = 0                 # waves opened (lifetime)
        self.submissions = 0           # work items (lifetime)
        self.current_batch = 0         # items in the open wave
        self._key: Optional[Any] = None

    def submit(self, key, fn):
        """Run ``fn`` inside the wave for ``key``, opening one if the key
        is new.  Returns ``fn()``'s result; exceptions propagate after the
        submission is accounted (the wave survives)."""
        if key != self._key:
            self._key = key
            self.waves += 1
            self.current_batch = 0
            metrics.counter("repro_ml_waves_total",
                            "standing-infer waves opened").inc()
        self.current_batch += 1
        self.submissions += 1
        with trace.span(self.span_name, wave=self.waves,
                        batch=self.current_batch):
            return fn()

    def stats(self) -> Dict[str, int]:
        return {"waves": self.waves, "submissions": self.submissions,
                "current_batch": self.current_batch}


class Scheduler:
    """Wave scheduler: FIFO queue packed into max_batch waves.

    With ``max_parallel_waves > 1`` waves run overlapped on a thread pool
    (each wave has its own KV cache).  Completions are collected in
    submission order either way, so output ordering is deterministic."""

    def __init__(self, session: ServeSession) -> None:
        self.session = session
        self.queue: List[Request] = []
        self.completed: List[Completion] = []
        self._metrics_server = None
        self._closed = False
        port = session.scfg.metrics_port
        if port is not None:
            self._metrics_server = metrics.start_http_server(port)
            # tear the listener down at interpreter exit even when the
            # caller forgets close()
            atexit.register(self.close)

    def submit(self, request: Request) -> None:
        self.queue.append(request)

    def run(self) -> List[Completion]:
        waves = []
        while self.queue:
            waves.append(self.queue[: self.session.scfg.max_batch])
            self.queue = self.queue[self.session.scfg.max_batch:]
        parallel = max(1, self.session.scfg.max_parallel_waves)
        with trace.span("serve/schedule", waves=len(waves),
                        parallel=parallel):
            if parallel == 1 or len(waves) <= 1:
                for wave in waves:
                    self.completed.extend(self.session.run_wave(wave))
            else:
                from concurrent.futures import ThreadPoolExecutor
                run_wave = trace.bind(self.session.run_wave)
                with ThreadPoolExecutor(max_workers=parallel) as pool:
                    for done in pool.map(run_wave, waves):
                        self.completed.extend(done)
        return self.completed

    def close(self) -> None:
        """Shut down the /metrics endpoint.  Idempotent (a double shutdown
        of a ThreadingHTTPServer deadlocks)."""
        if self._closed:
            return
        self._closed = True
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()
            self._metrics_server = None
            atexit.unregister(self.close)
