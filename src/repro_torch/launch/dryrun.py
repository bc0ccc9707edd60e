"""The production-mesh dry run, ported from ``repro.launch.dryrun``: one
train, prefill or decode step of an (arch x shape) cell, traced as rank 0
of the 256-device (16 x 16) or 512-device (2 x 16 x 16) mesh, with the
reference's JSON line of memory, FLOPs, bytes and collectives.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape decode_32k [--multi-pod] [--no-cost-probe] [--device cpu]

The counterpart of XLA's lower + compile on forced host devices is the
step run on *fake tensors* (``FakeTensorMode``: shapes and dtypes, no
storage) wrapped as DTensors on a ``DeviceMesh`` over a fake process
group of the mesh's size (``launch.mesh.fake_world``), with this rank 0's
shard shapes.  The fake group's collectives move no data: the values are
meaningless, and the shapes, placements, bytes, FLOPs and collectives
are what counts, as in the reference.

Two traces a cell, as the reference lowers twice:
  1. placement proof: the step with memory-fitting microbatches, with
     donation as the reference has it (the train state; the cache, which
     the port writes in place) -> the ``memory`` numbers;
  2. cost probe: the same step with ``microbatches=1`` -> FLOPs, bytes
     and collectives.  The port has no while-loop to unroll (its layers
     are a Python loop), so ``scan_layers=False`` changes nothing.

How each number is reckoned:
  * ``argument_bytes``: the bytes of rank 0's shard of every input
    (params or train state, batch, cache; decode's int32 ``pos`` counts
    4, as it does in the reference), exactly;
  * ``output_bytes``: rank 0's shard of every output, exactly;
    ``alias_bytes``: the donated inputs the outputs reuse;
  * ``temp_bytes``: an *estimate*, the peak of the live bytes of the
    tensors the step creates on rank 0 (storages, views not counted),
    less the outputs;
  * ``flops_per_device``: rank 0's *local* ops, counted beneath the
    DTensor dispatch with ``torch.utils.flop_counter``'s formulas: matrix
    products (mm, addmm, bmm, baddbmm), convolutions and the attention
    kernels; elementwise work is not counted (XLA's count includes it,
    so the two packages' FLOPs are not held equal), plus
    ``seq_scan_correction`` as in the reference;
  * ``bytes_per_device``: the bytes each local op reads and writes
    (inputs and outputs; views and metadata ops move none);
  * ``collectives``: each collective the step issues (``CommDebugMode``
    beneath DTensor), its output bytes and group size, priced by
    ``wire_bytes`` with the reference's ring conventions.  The
    reference's parsing of HLO text has no counterpart.
  * ``compile_seconds`` and ``probe_compile_seconds`` are the seconds the
    two traces took (there is no compile).

``run_cell(..., execute=True)`` also runs rank 0's local step for real on
the mesh's device (seeded, finite inputs; collectives that move nothing)
and adds ``peak_bytes`` (``torch.cuda.max_memory_allocated``) and
``step_ms`` (CUDA events): local compute only.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import weakref
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import _device, _tree
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     mesh_num_devices)
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import logical as L
from repro_torch.train.step import TrainConfig, make_train_step

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")

# the functional collectives DTensor issues, by the reference's HLO names
_FUNCOL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that move no bytes: views and metadata
_NO_TRAFFIC = frozenset({
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "slice", "select", "unsqueeze", "squeeze", "as_strided",
    "alias", "detach", "unbind", "split", "split_with_sizes", "chunk",
    "narrow", "view_as_real", "view_as_complex", "lift_fresh",
    "empty", "empty_like", "empty_strided", "wait_tensor",
})

MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm")


def wire_bytes(records) -> dict:
    """Per-device wire-byte estimates from (op, output bytes, group size)
    records, with the reference's conventions for a group of size g:
      all-gather / all-to-all: out_bytes * (g-1)/g
      reduce-scatter:          out_bytes * (g-1)        (operand ~= g*out)
      all-reduce:              2 * out_bytes * (g-1)/g  (RS + AG)
      collective-permute:      out_bytes
    """
    stats = {op: {"count": 0, "bytes": 0.0} for op in _COLL_OPS}
    for op, out_bytes, g in records:
        if g <= 1 and op != "collective-permute":
            continue
        if op == "all-reduce":
            wire = 2.0 * out_bytes * (g - 1) / g
        elif op == "reduce-scatter":
            wire = float(out_bytes) * (g - 1)
        elif op == "collective-permute":
            wire = float(out_bytes)
        else:
            wire = float(out_bytes) * (g - 1) / g
        stats[op]["count"] += 1
        stats[op]["bytes"] += wire
    stats["total_bytes"] = sum(
        v["bytes"] for k, v in stats.items() if isinstance(v, dict))
    return stats


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in _tree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """The tensor holding rank 0's shard (the same object every call)."""
    return t._local_tensor if L.is_dtensor(t) else t


def _group_size(args, kwargs) -> int:
    name = kwargs.get("group_name", args[-1] if args else None)
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _recorder():
    """A ``CommDebugMode`` that also keeps, beneath the DTensor dispatch,
    each collective's (op, output bytes, group size), each local op's
    FLOPs and bytes, and the live bytes of the tensors the step makes."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import flop_registry

    class Recorder(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.colls: List[Tuple[str, int, int]] = []
            self.flops = 0
            self.matmul_flops = 0
            self.bytes = 0
            self.live = 0
            self.peak = 0
            self._ids = set()
            self._propagating = 0

        def __enter__(self):
            # DTensor's sharding propagation runs each op once on global
            # shapes to learn its output's; those runs are not rank 0's
            # work, and are told apart by this flag
            from torch.distributed.tensor import DTensor
            prop = DTensor._op_dispatcher.sharding_propagator
            inner = type(prop)._propagate_tensor_meta_non_cached

            def flagged(*args, **kwargs):
                self._propagating += 1
                try:
                    return inner(prop, *args, **kwargs)
                finally:
                    self._propagating -= 1

            prop._propagate_tensor_meta_non_cached = flagged
            self._prop = prop
            return super().__enter__()

        def __exit__(self, *exc):
            del self._prop._propagate_tensor_meta_non_cached
            return super().__exit__(*exc)

        def _free(self, key, n):
            self._ids.discard(key)
            self.live -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or self._propagating:
                return out
            outs = [o for o in _tree.tree_leaves(out)
                    if isinstance(o, torch.Tensor)]
            if not outs:
                return out
            kwargs = kwargs or {}
            name = func._overloadpacket.__name__
            if name in _FUNCOL:
                self.colls.append((_FUNCOL[name],
                                   sum(_nbytes(o) for o in outs),
                                   _group_size(args, kwargs)))
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                n = formula(*args, **kwargs, out_val=out)
                self.flops += n
                if name in MATMUL_OPS:
                    self.matmul_flops += n
            if name not in _NO_TRAFFIC and name not in _FUNCOL:
                ins = [a for a in _tree.tree_leaves(list(args))
                       if isinstance(a, torch.Tensor)]
                self.bytes += sum(_nbytes(t) for t in ins + outs)
            for o in outs:
                if o._base is not None or id(o) in self._ids:
                    continue
                self._ids.add(id(o))
                n = _nbytes(o)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(o, self._free, id(o), n)
            return out

    return Recorder()


def microbatches_for(cfg, shape, mesh, n_params: int) -> int:
    sizes = L.mesh_shape(mesh)
    per_dev = shape.global_batch // (sizes["data"] * sizes.get("pod", 1))
    if per_dev <= 1:
        return 1
    if n_params > 2e10:
        return per_dev                    # 1 sequence per device per ubatch
    if n_params > 2e9:
        return max(1, per_dev // 4)
    return 1


def active_params(cfg, specs) -> tuple:
    """(n_total, n_active): routed-expert params scaled by top_k/E."""
    n_total, n_active = 0, 0.0
    for path, leaf in _tree.tree_flatten_with_path(specs)[0]:
        n = leaf.num_params()
        n_total += n
        keys = "/".join(p for p in path if isinstance(p, str))
        is_routed = (L.EXPERT in leaf.axes and "router" not in keys)
        if is_routed and cfg.num_experts:
            n_active += n * cfg.top_k / cfg.num_experts
        else:
            n_active += n
    return n_total, int(n_active)


def seq_scan_correction(cfg, tokens: int, devices: int, kind: str) -> float:
    """Analytic per-device FLOPs for the in-time-scan SSM cores, as the
    reference adds them (its cost model counts a loop body once; the
    port's counter sees no matrix product in the plain scans).  Decode
    cells run the scan with length 1, so no correction applies."""
    if kind == "decode" or cfg.ssm_kind == "":
        return 0.0
    plan = cfg.layer_plan()
    n_blocks = cfg.num_scanned()
    fl = 0.0
    for mixer, _ in plan * n_blocks:
        if mixer == "rwkv6":
            fl += tokens * 7.0 * cfg.d_model * cfg.rwkv_head_dim
        elif mixer == "mamba":
            di = cfg.ssm_expand * cfg.d_model
            fl += tokens * 8.0 * di * cfg.ssm_state
    if kind == "train":
        fl *= 3.0        # bwd ~= 2x fwd
    return fl / devices


def cell_config(arch: str, *, remat=None, capacity_factor=None,
                scan_layers: bool = True, vocab_pad_to=None,
                kv_cache_dtype=None, shard_ctx_train=None,
                moe_cap_shard=None, moe_dropless: bool = False):
    """The cell's config: the capacity-clipped MoE dispatch (the design
    the cost probes are about), and the flags' overrides."""
    overrides: Dict[str, Any] = {"moe_dropless": moe_dropless}
    if remat is not None:
        overrides["remat"] = remat
    if capacity_factor is not None:
        overrides["capacity_factor"] = capacity_factor
    if not scan_layers:
        overrides["scan_layers"] = False
    if vocab_pad_to is not None:
        overrides["vocab_pad_to"] = vocab_pad_to
    if kv_cache_dtype is not None:
        overrides["kv_cache_dtype"] = kv_cache_dtype
    if shard_ctx_train is not None:
        overrides["shard_ctx_train"] = shard_ctx_train
    if moe_cap_shard is not None:
        overrides["moe_cap_shard"] = moe_cap_shard
    return registry.get_config(arch, **overrides)


@dataclasses.dataclass
class Built:
    """A cell's step, its inputs' plan and the inputs' donation."""
    cfg: Any
    kind: str
    rules: Any
    structs: Tuple            # (meta structs tree, partitions tree) pairs
    donated: Tuple[bool, ...]
    run: Any                  # run(*inputs) -> outputs
    meta: Dict[str, Any]


def build_step(arch: str, shape_name: str, mesh, *,
               seq_parallel=None, shard_kv_seq=None, microbatches=None,
               donate: bool = True, **cfg_kw) -> Built:
    """The counterpart of the reference's ``build_lowered``: the step
    function of the cell and the plan of its inputs."""
    cfg = cell_config(arch, **cfg_kw)
    shape = SHAPES[shape_name]
    rules = S.pick_rules(cfg, mesh, seq_parallel=seq_parallel,
                         shard_kv_seq=shard_kv_seq)
    specs = registry.param_specs(cfg)
    n_total, n_active = active_params(cfg, specs)
    meta = {"n_params": n_total, "n_active": n_active}

    if shape.kind == "train":
        mb = microbatches if microbatches is not None \
            else microbatches_for(cfg, shape, mesh, n_total)
        tcfg = TrainConfig(optimizer=AdamWConfig(), microbatches=mb)
        step = make_train_step(cfg, tcfg, rules)
        structs = (S.train_state_specs(cfg, mesh, rules),
                   S.batch_specs(cfg, shape, mesh))
        return Built(cfg, "train", rules, structs, (donate, False),
                     lambda state, batch: step(state, batch),
                     {**meta, "microbatches": mb})
    _, p_structs, p_shards = S.param_structs_and_shardings(
        cfg, mesh, rules, dtype=torch.bfloat16)
    cache = S.cache_structs_and_shardings(cfg, shape, mesh, rules)
    if shape.kind == "prefill":
        b_structs, b_shards = S.batch_specs(cfg, shape, mesh)
        b_structs.pop("labels"), b_shards.pop("labels")

        def prefill_step(params, batch, cache):
            logits, new_cache, _ = registry.prefill(params, batch, cache,
                                                    cfg, rules)
            return logits, new_cache

        return Built(cfg, "prefill", rules,
                     ((p_structs, p_shards), (b_structs, b_shards), cache),
                     (False, False, donate), prefill_step, meta)

    def serve_step(params, batch, cache):
        # pos 0: the write lands in rank 0's shard of a sequence-sharded
        # cache, so rank 0's step holds the write
        return registry.decode_step(params, batch, cache, 0, cfg, rules)

    return Built(cfg, "decode", rules,
                 ((p_structs, p_shards),
                  S.decode_batch_specs(cfg, shape, mesh), cache),
                 (False, False, donate), serve_step, meta)


def _place(structs, parts, mesh, make):
    """A tree of DTensors: each leaf's rank-0 shard made by
    ``make(local shape, dtype, leaf index)``."""
    from torch.distributed.tensor import DTensor
    flat, treedef = _tree.tree_flatten(structs)
    flat_p = _tree.tree_leaves(parts)
    out = []
    for i, (s, p) in enumerate(zip(flat, flat_p)):
        local = make(L.shard_shape(s.shape, p, mesh), s.dtype, i)
        out.append(DTensor.from_local(local, mesh, L.placements(p, mesh),
                                      run_check=False))
    return _tree.tree_unflatten(treedef, out)


def _argument_bytes(built: Built, mesh) -> int:
    n = 4 if built.kind == "decode" else 0          # decode's int32 pos
    for structs, parts in built.structs:
        for s, p in zip(_tree.tree_leaves(structs), _tree.tree_leaves(parts)):
            shape = L.shard_shape(s.shape, p, mesh)
            k = 1
            for d in shape:
                k *= d
            n += k * s.element_size()
    return n


def _trace(built: Built, mesh, make) -> Dict[str, Any]:
    """Run the step once on inputs made by ``make`` under the recorder."""
    inputs = [_place(st, pt, mesh, make) for st, pt in built.structs]
    rec = _recorder()
    grad = built.kind == "train"
    with torch.set_grad_enabled(grad), rec:
        outputs = built.run(*inputs)
    in_ids = {id(_local(t)) for t in _tensors(inputs)}
    out_local = [_local(t) for t in _tensors(outputs)]
    output_bytes = sum(_nbytes(t) for t in out_local)
    alias = 0
    for donated, tree in zip(built.donated, inputs):
        if not donated:
            continue
        if built.kind == "train":     # the new state takes the old's place
            alias += sum(_nbytes(_local(t)) for t in _tensors(tree))
        else:                         # the cache, written in place
            alias += sum(_nbytes(_local(t)) for t in _tensors(tree)
                         if id(_local(t)) in {id(o) for o in out_local})
    fresh = sum(_nbytes(t) for t in out_local if id(t) not in in_ids)
    return {"inputs": inputs, "outputs": outputs, "rec": rec,
            "output_bytes": output_bytes, "alias_bytes": alias,
            "temp_bytes": max(0, rec.peak - fresh)}


def _fake_maker(mode):
    def make(shape, dtype, i):
        with mode:
            return torch.empty(shape, dtype=dtype)
    return make


@contextlib.contextmanager
def _index_math_outside_fake():
    """DTensor's redistribute planner finds a strided shard's size and
    offsets by indexing a small ``arange`` (``_StridedShard.
    local_shard_size_and_offset``), which a fake tensor cannot give up as
    Python ints; that bookkeeping runs on real tensors, the step's ops
    stay fake."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    inner = getattr(cls, "local_shard_size_and_offset", None)
    if inner is None:
        yield
        return

    def outside(self, *args, **kwargs):
        with unset_fake_temporarily():
            return inner(self, *args, **kwargs)

    cls.local_shard_size_and_offset = outside
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = inner


def _traced(built: Built, mesh, device) -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with torch.device(device), _index_math_outside_fake(), mode:
        return _trace(built, mesh, _fake_maker(mode))


def _real_maker(device, seed: int, vocab: int):
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(shape, dtype, i):
        if dtype in (torch.int32, torch.int64):
            return torch.randint(0, vocab, shape, generator=gen,
                                 device=device, dtype=dtype)
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen,
                                 device=device, dtype=dtype)
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (0.02 * x).to(dtype)
    return make


def _memory(dev) -> Tuple[int, int]:
    """(bytes asked of the caching allocator, bytes of the blocks it
    gave) now on ``dev``."""
    stats = torch.cuda.memory_stats(dev)
    return (stats.get("requested_bytes.all.current", 0),
            torch.cuda.memory_allocated(dev))


def execute_step(built: Built, mesh, device, *,
                 seed: int = 0) -> Dict[str, Any]:
    """Rank 0's local step for real on ``device``: inputs drawn from
    ``seed`` (tokens in the vocab, weights and caches small and finite),
    collectives that move nothing.  Returns the bytes the inputs took
    (asked of the allocator, and in its blocks), the run recorded and
    profiled, then the peak memory and the time of one more run."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    make = _real_maker(dev, seed, built.cfg.vocab_size)
    sync()
    before = _memory(dev) if cuda else (0, 0)
    inputs = [_place(st, pt, mesh, make) for st, pt in built.structs]
    sync()
    after = _memory(dev) if cuda else (0, 0)
    grad = built.kind == "train"
    rec = _recorder()
    with rec:
        prof_flops = profiled_matmul_flops(built, inputs)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if cuda:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        with torch.set_grad_enabled(grad):
            built.run(*inputs)
        t1.record()
        sync()
        step_ms = t0.elapsed_time(t1)
    else:
        start = time.perf_counter()
        with torch.set_grad_enabled(grad):
            built.run(*inputs)
        step_ms = (time.perf_counter() - start) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    return {"rec": rec, "requested_bytes": after[0] - before[0],
            "block_bytes": after[1] - before[1],
            "n_inputs": len(_tensors(inputs)), "peak_bytes": peak,
            "step_ms": step_ms,
            "profiler_matmul_flops": prof_flops}


def profiled_matmul_flops(built: Built, inputs) -> float:
    """The matrix products' FLOPs as ``torch.profiler`` counts them
    (``with_flops=True``) in one run of the step on ``inputs``: the
    innermost events of mm, addmm, bmm and baddbmm (a DTensor op's event
    holds its local op's; the local one is counted)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    names = {f"aten::{n}" for n in MATMUL_OPS}
    with profile(activities=acts, with_flops=True) as prof:
        with torch.set_grad_enabled(built.kind == "train"):
            built.run(*inputs)

    def holds_matmul(evt) -> bool:       # a local product beneath it
        return any(c.name in names or holds_matmul(c)
                   for c in evt.cpu_children)

    return float(sum(evt.flops or 0 for evt in prof.events()
                     if evt.name in names and not holds_matmul(evt)))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cost_probe: bool = True, device=None, execute: bool = False,
             **kw) -> dict:
    """Two traces a cell (placement proof, cost probe; the multi-pod pass
    runs only the first), and with ``execute`` rank 0's step run for
    real on ``device`` (the GPU unless the caller names one)."""
    device = _device.resolve(device, "run_cell")
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    cell = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "kind": shape.kind}
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {**cell, "status": "skipped", "reason": reason}

    t0 = time.time()
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    try:
        built = build_step(arch, shape_name, mesh, **kw)
        traced = _traced(built, mesh, device)
    except Exception as exc:                               # noqa: BLE001
        return {**cell, "status": "error",
                "error": f"{type(exc).__name__}: {exc}"[:500]}
    trace_s = time.time() - t0
    devices = mesh_num_devices(mesh)
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    out = {
        **cell, "status": "ok", "compile_seconds": round(trace_s, 1),
        "devices": devices,
        "tokens": tokens,
        **built.meta,
        "memory": {
            "argument_bytes": _argument_bytes(built, mesh),
            "output_bytes": traced["output_bytes"],
            "temp_bytes": traced["temp_bytes"],
            "alias_bytes": traced["alias_bytes"],
        },
    }
    if cost_probe:
        t1 = time.time()
        try:
            probe = traced      # the same step when it has 1 microbatch
            if built.meta.get("microbatches", 1) != 1:
                probe_kw = dict(kw)
                probe_kw["microbatches"] = 1
                probe_kw["scan_layers"] = False
                probe = _traced(
                    build_step(arch, shape_name, mesh, **probe_kw),
                    mesh, device)
            rec = probe["rec"]
            corr = seq_scan_correction(built.cfg, tokens, devices,
                                       shape.kind)
            out.update({
                "probe_compile_seconds": round(time.time() - t1, 1),
                "flops_per_device": rec.flops + corr,
                "matmul_flops_per_device": rec.matmul_flops,
                "seq_scan_flops_correction": corr,
                "bytes_per_device": float(rec.bytes),
                "collectives": wire_bytes(rec.colls),
            })
        except Exception as exc:                           # noqa: BLE001
            out["probe_error"] = f"{type(exc).__name__}: {exc}"[:300]
    if execute:
        ran = execute_step(built, mesh, device)
        out["executed"] = {
            "peak_bytes": ran["peak_bytes"],
            "step_ms": ran["step_ms"],
            "requested_argument_bytes": ran["requested_bytes"],
            "block_argument_bytes": ran["block_bytes"],
            "argument_tensors": ran["n_inputs"],
            "collective_counts": _counts(ran["rec"].colls),
            "traced_collective_counts": _counts(traced["rec"].colls),
            "matmul_flops": ran["rec"].matmul_flops,
            "traced_matmul_flops": traced["rec"].matmul_flops,
            "profiler_matmul_flops": ran["profiler_matmul_flops"],
            "note": "rank 0's local compute; collectives move nothing",
        }
    return out


def _counts(colls) -> Dict[str, int]:
    out = {op: 0 for op in _COLL_OPS}
    for op, _, _ in colls:
        out[op] += 1
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", required=True, choices=registry.ARCH_NAMES)
    ap.add_argument("--shape", required=True, choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seq-parallel", type=int, default=None)
    ap.add_argument("--shard-kv-seq", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", type=str, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--no-cost-probe", action="store_true")
    ap.add_argument("--vocab-pad", type=int, default=None)
    ap.add_argument("--kv-cache-dtype", type=str, default=None,
                    choices=("bf16", "int8"))
    ap.add_argument("--shard-ctx-train", type=int, default=None)
    ap.add_argument("--moe-cap-shard", type=int, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="the mesh's device type (default cuda)")
    args = ap.parse_args()

    kw: Dict[str, Any] = {}
    if args.seq_parallel is not None:
        kw["seq_parallel"] = bool(args.seq_parallel)
    if args.shard_kv_seq is not None:
        kw["shard_kv_seq"] = bool(args.shard_kv_seq)
    if args.microbatches is not None:
        kw["microbatches"] = args.microbatches
    if args.remat is not None:
        kw["remat"] = args.remat
    if args.capacity_factor is not None:
        kw["capacity_factor"] = args.capacity_factor
    if args.no_donate:
        kw["donate"] = False
    if args.vocab_pad is not None:
        kw["vocab_pad_to"] = args.vocab_pad
    if args.kv_cache_dtype is not None:
        kw["kv_cache_dtype"] = args.kv_cache_dtype
    if args.shard_ctx_train is not None:
        kw["shard_ctx_train"] = bool(args.shard_ctx_train)
    if args.moe_cap_shard is not None:
        kw["moe_cap_shard"] = bool(args.moe_cap_shard)

    result = run_cell(args.arch, args.shape, args.multi_pod,
                      cost_probe=not args.no_cost_probe, device=args.device,
                      **kw)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if result["status"] == "error":
        sys.exit(1)


if __name__ == "__main__":
    main()
