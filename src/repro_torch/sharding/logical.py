"""Logical-axis sharding, ported from ``repro.sharding.logical``: every
parameter and activation is labelled with logical axis names, and a rules
table maps each logical name onto mesh axes.  Model code never names a
mesh axis, only logical roles.

The counterparts of the reference's JAX objects:

* a ``jax.sharding.Mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
  with the same axis names (``launch.mesh``);
* a ``NamedSharding``'s partition spec is a *partition*: a tuple with one
  entry per tensor dim, a mesh axis name, a tuple of them, or None, as
  ``sharding_for`` gives it; ``placements`` turns it into the DTensor
  placements on a mesh (``Shard(dim)`` or ``Replicate()`` per mesh dim);
* ``with_sharding_constraint`` is ``DTensor.redistribute``
  (``constrain``), a no-op on a plain tensor.

Where one tensor dim rides several mesh axes, e.g. ``("pod", "data")``,
each of them is a ``Shard`` of that dim, and the tensor is split in the
order of the mesh's dims, outermost first: the order JAX gives a tuple of
axes written, as the rules write them, in mesh order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch import _tree

# ---------------------------------------------------------------------------
# Canonical logical axis names used throughout the model zoo.
# ---------------------------------------------------------------------------
BATCH = "batch"            # global batch             -> (pod, data)
SEQ = "seq"                # sequence (activations)   -> None (or sp)
RESID = "resid_seq"        # block-boundary residual  -> model under SP
KV_SEQ = "kv_seq"          # KV-cache sequence        -> model iff heads don't divide
EMBED = "embed"            # d_model (PARAMS)         -> data (FSDP)
ACT_EMBED = "act_embed"    # d_model (ACTIVATIONS)    -> None (gathered)
HEADS = "heads"            # q heads                  -> model (TP)
KV_HEADS = "kv_heads"      # kv heads                 -> model iff divisible
HEAD_DIM = "head_dim"      # per-head dim             -> None
MLP = "mlp"                # ffn hidden               -> model (TP)
VOCAB = "vocab"            # vocab rows               -> model (TP)
EXPERT = "expert"          # MoE experts              -> model (EP)
CAPACITY = "capacity"      # MoE per-expert capacity  -> None
LAYER = "layer"            # stacked layer axis       -> None (never sharded)
STATE = "state"            # SSM state dim            -> None
CONV = "conv"              # conv kernel width        -> None

Target = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """A partition: one entry per tensor dim (a mesh axis, a tuple of
    them, or None).  A tree of them keeps each whole as a leaf, as
    ``jax.tree`` keeps a ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis -> mesh axis (or tuple of mesh axes, or None).

    Carries the mesh so that ``constrain`` can place tensors directly."""

    rules: Tuple[Tuple[str, Target], ...]
    mesh: Optional[Any] = dataclasses.field(default=None, compare=False)

    def mesh_axes(self, logical: Optional[str]) -> Target:
        if logical is None:
            return None
        for name, target in self.rules:
            if name == logical:
                return target
        return None

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpecSpec:
        return P(*(self.mesh_axes(ax) for ax in logical_axes))

    def replace(self, **updates) -> "AxisRules":
        new = dict(self.rules)
        new.update(updates)
        return AxisRules(tuple(new.items()), mesh=self.mesh)


def default_rules(mesh, *, shard_kv_seq: bool = False,
                  seq_parallel: bool = False) -> AxisRules:
    """Production rules for the (pod?, data, model) mesh.

    ``batch``/``embed`` ride the (pod,)data axes (DP + FSDP); head/mlp/
    vocab/expert dims ride model (TP/EP).  When an arch's kv heads don't
    divide the model axis, the KV cache is sequence-sharded instead
    (``shard_kv_seq``).  ``seq_parallel`` shards the block-boundary
    residual stream over model (sequence parallelism expressed purely as
    a placement of the residual)."""
    if "pod" in mesh.mesh_dim_names:
        batch_axes: Target = ("pod", "data")
    else:
        batch_axes = "data"
    return AxisRules(
        (
            (BATCH, batch_axes),
            (SEQ, None),
            (RESID, "model" if seq_parallel else None),
            (ACT_EMBED, None),
        ) + _default_tail(shard_kv_seq), mesh=mesh)


def _default_tail(shard_kv_seq: bool):
    return (
            (KV_SEQ, "model" if shard_kv_seq else None),
            (EMBED, "data"),
            (HEADS, "model"),
            (KV_HEADS, "model" if not shard_kv_seq else None),
            (HEAD_DIM, None),
            (MLP, "model"),
            (VOCAB, "model"),
            (EXPERT, "model"),
            (CAPACITY, "data"),       # dispatch slots ride the FSDP axis
            (LAYER, None),
            (STATE, None),
            (CONV, None),
    )


def single_device_rules() -> AxisRules:
    """Rules that map everything to None."""
    return AxisRules(tuple((name, None) for name in (
        BATCH, SEQ, RESID, KV_SEQ, EMBED, ACT_EMBED, HEADS, KV_HEADS,
        HEAD_DIM, MLP, VOCAB, EXPERT, CAPACITY, LAYER, STATE, CONV)))


# ---------------------------------------------------------------------------
# ParamSpec: declarative parameter description (shape, dtype, logical axes,
# initializer).  Model code builds trees of these; the launcher turns them
# into real tensors (init) or meta-tensor structs (dry run).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape, dtype, logical axes and initializer of one parameter."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"      # normal | zeros | ones | embed_normal
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")

    def struct(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

    def num_params(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def spec_tree_structs(spec_tree) -> Any:
    return _tree.tree_map(lambda s: s.struct(), spec_tree)


def spec_tree_axes(spec_tree) -> Any:
    return _tree.tree_map(lambda s: s.axes, spec_tree)


def _partition(shape: Sequence[int], logical_axes, sizes: Dict[str, int],
               rules: AxisRules) -> PartitionSpecSpec:
    """Each dim's mesh axes, None where they do not divide it."""
    parts = []
    for dim, ax in zip(shape, logical_axes):
        target = rules.mesh_axes(ax)
        if target is None:
            parts.append(None)
            continue
        axes = target if isinstance(target, tuple) else (target,)
        size = 1
        for a in axes:
            size *= sizes[a]
        parts.append(target if dim % size == 0 else None)
    return P(*parts)


def sharding_for(spec: ParamSpec, mesh, rules: AxisRules) -> PartitionSpecSpec:
    """The partition of a spec, dropping axes that don't divide evenly
    (e.g. 12 q-heads on a 16-wide model axis fall back to replicated)."""
    return _partition(spec.shape, spec.axes, mesh_shape(mesh), rules)


def placements(partition: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of a partition on ``mesh``: for each mesh
    dim in order, ``Shard`` of the tensor dim that rides it, else
    ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for dim, target in enumerate(partition):
        if target is None:
            continue
        for a in (target if isinstance(target, tuple) else (target,)):
            owner[a] = dim
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


def shard_shape(shape: Sequence[int], partition: PartitionSpec,
                mesh) -> Tuple[int, ...]:
    """One device's shape of a tensor of ``shape`` under ``partition``."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, target in zip(shape, partition):
        for a in (() if target is None else
                  target if isinstance(target, tuple) else (target,)):
            dim //= sizes[a]
        out.append(dim)
    return tuple(out)


def spec_tree_shardings(spec_tree, mesh, rules: AxisRules):
    return _tree.tree_map(lambda s: sharding_for(s, mesh, rules), spec_tree)


def count_params(spec_tree) -> int:
    return sum(leaf.num_params() for leaf in _tree.tree_leaves(spec_tree))


def _init_one(generator: torch.Generator, spec: ParamSpec,
              device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.init_scale / max(1.0, float(fan_in)) ** 0.5
    elif spec.init == "embed_normal":
        scale = spec.init_scale * 0.02
    else:
        raise ValueError(f"unknown init {spec.init}")
    z = torch.randn(spec.shape, generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (scale * z).to(device=device, dtype=spec.dtype)


def init_params(generator: torch.Generator, spec_tree, device) -> Any:
    """Materialize a ParamSpec tree into tensors on ``device``, drawing
    each leaf in turn (``jax.tree`` order) from ``generator``.  The
    draws are torch's, not ``jax.random``'s: the same seed gives other
    numbers than the JAX package, so parity tests carry the JAX
    package's parameters across (``models.convert``)."""
    leaves, treedef = _tree.tree_flatten(spec_tree)
    return _tree.tree_unflatten(
        treedef, [_init_one(generator, s, device) for s in leaves])


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    # a plain tensor's type is never DTensor; the import is deferred so
    # that the single-device path never loads torch.distributed.tensor
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, rules: Optional[AxisRules],
              logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Redistribute ``x`` to the placement its logical axes map to; a
    no-op when ``rules`` is None or ``x`` is a plain tensor.

    Axes whose dimension does not divide the mapped mesh-axis size fall
    back to replicated (the policy of ``sharding_for``)."""
    if rules is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    part = _partition(x.shape, logical_axes, mesh_shape(mesh), rules)
    return _Constrain.apply(x, placements(part, mesh))


def _placed(x, target):
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(x.device_mesh, target)


class _Constrain(torch.autograd.Function):
    """The placement of a tensor and of its gradient: as the transpose
    of ``with_sharding_constraint`` constrains the cotangent to the same
    sharding, the gradient is redistributed to the same placement (a
    gradient left as DTensor's backward rules place it can come back
    whole along the batch, and every rank would then carry the whole
    batch's backward)."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.target = target
        y = _placed(x, target)
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        return _placed(g, ctx.target), None


def _whole_along(x, dims):
    from torch.distributed.tensor import Partial, Replicate, Shard
    target = [Replicate() if (isinstance(p, Shard) and p.dim in dims)
              or isinstance(p, Partial) else p for p in x.placements]
    if target == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return _whole_along(x, dims)

    @staticmethod
    def backward(ctx, g):
        return _whole_along(g, ctx.dims), None


def unshard(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` whole along ``dims`` (its other placements kept), and so its
    gradient: what a DTensor needs around a reshape that splits or merges
    one of those dims with factors the mesh does not divide.  A plain
    tensor passes through."""
    if not is_dtensor(x):
        return x
    return _Unshard.apply(x, frozenset(d % x.ndim for d in dims))


class _GradWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole_along(g, ctx.dims), None


def _shard_size(x, dim: int) -> int:
    """How many ways ``x`` is sharded along ``dim``."""
    from torch.distributed.tensor import Shard
    m = 1
    for mdim, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            m *= x.device_mesh.size(mdim)
    return m


def split_dim(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x`` reshaped with ``dim`` split into ``sizes``.

    A DTensor keeps its shards along ``dim`` on the first factor when
    they divide it; otherwise ``dim`` is made whole first.  Where the
    whole mesh does not divide the first factor, the gradient is made
    whole along the factors (the backward's merge refuses a factor split
    unevenly)."""
    dim %= x.ndim
    new = list(x.shape[:dim]) + list(sizes) + list(x.shape[dim + 1:])
    if not is_dtensor(x):
        return x.reshape(new)
    factors = frozenset(range(dim, dim + len(sizes)))
    if sizes[0] % _shard_size(x, dim):
        return unshard(unshard(x, dim).reshape(new), *factors)
    out = x.reshape(new)
    if sizes[0] % x.device_mesh.size():
        out = _GradWhole.apply(out, factors)
    return out


def merge_dims(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x`` reshaped with dims ``start`` .. ``end`` (inclusive) merged.
    For a DTensor whose first merged dim the whole mesh does not divide,
    the gradient is made whole along the merged dim (the backward splits
    it again)."""
    start, end = start % x.ndim, end % x.ndim
    n = 1
    for d in x.shape[start:end + 1]:
        n *= d
    out = x.reshape(*x.shape[:start], n, *x.shape[end + 1:])
    if is_dtensor(x) and x.shape[start] % x.device_mesh.size():
        out = _GradWhole.apply(out, frozenset({start}))
    return out


class _PartialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, pl):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.pl = mesh, pl
        return DTensor.from_local(local, mesh, pl, run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate
        whole = [Replicate() if isinstance(p, Partial) else p
                 for p in ctx.pl]
        return _placed(g, whole).to_local(), None, None


def partial_sum(local: torch.Tensor, mesh, pl) -> torch.Tensor:
    """Each rank's ``local`` as its term of a DTensor placed ``pl``
    (``Partial`` on the mesh dims it is summed over).  Backward, every
    rank's term takes the whole gradient of the sum (a plain
    ``from_local`` would hand each a share of it)."""
    return _PartialSum.apply(local, mesh, tuple(pl))


def local_device(x: torch.Tensor) -> torch.device:
    """Where ``x``'s values live (a DTensor's: its local shard's)."""
    return x.to_local().device if is_dtensor(x) else x.device


def replicated_like(t: torch.Tensor, x) -> torch.Tensor:
    """A constant the model makes (positions, masks, rope tables, zero
    states) as ``x`` holds its values: replicated on ``x``'s mesh when
    ``x`` is a DTensor, else ``t`` itself (as is a DTensor ``t``)."""
    if not is_dtensor(x) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _span(length: int, pl, mesh, dim: int) -> Tuple[int, int]:
    off, size = 0, length
    coord = mesh.get_coordinate()
    from torch.distributed.tensor import Shard
    for mdim, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            step = -(-size // mesh.size(mdim))      # torch.chunk's size
            lo = min(coord[mdim] * step, size)
            off, size = off + lo, min(step, size - lo)
    return off, size


def shard_span(x: torch.Tensor, dim: int) -> Tuple[int, int]:
    """(offset, size) of this rank's shard of the DTensor ``x`` along
    ``dim``.  Mesh dims that shard one tensor dim split it in mesh order:
    the first splits the whole, the next each of its parts (the order
    ``placements`` gives and DTensor follows)."""
    return _span(x.shape[dim], x.placements, x.device_mesh, dim % x.ndim)


def distribute(t: torch.Tensor, partition: PartitionSpec, mesh) -> torch.Tensor:
    """A whole tensor, the same on every rank, cut to this rank's shard
    of ``partition`` on ``mesh`` (no collective)."""
    from torch.distributed.tensor import DTensor
    pl = placements(partition, mesh)
    local = t
    for dim in range(t.ndim):
        off, size = _span(t.shape[dim], pl, mesh, dim)
        local = local.narrow(dim, off, size)
    return DTensor.from_local(local.clone(), mesh, pl, run_check=False)


def local_call(fn, args: Sequence[Tuple[Optional[torch.Tensor], Any]],
               out_axes: Sequence[Any], rules: Optional[AxisRules]):
    """``fn`` over each rank's own shards, for a computation that is
    independent along the sharded axes (a recurrence per batch row and
    head, an in-place write per cache shard) or that every rank runs
    whole (axes None: replicated).

    ``args`` are (tensor, logical axes) pairs; ``out_axes`` the logical
    axes of each of ``fn``'s outputs.  With no DTensor among the
    arguments this is ``fn(*tensors)``.  Otherwise each argument is
    placed by its axes (a logical axis that does not divide, or that any
    argument cannot shard, is replicated for all of them), ``fn`` runs
    on the local tensors, and each output becomes a DTensor placed by its
    axes (``local_map``, its arguments' gradients placed as they are,
    except a partial sum where noted below).  Without ``rules``
    everything is replicated."""
    tensors = [t for t, _ in args]
    ref = next((t for t in tensors if is_dtensor(t)), None)
    if ref is None:
        return fn(*tensors)
    mesh = ref.device_mesh
    sizes = mesh_shape(mesh)
    use = {}        # logical axis -> target, None once any dim refuses it
    for t, axes in args:
        if t is None or axes is None or rules is None:
            continue
        for dim, ax in zip(t.shape, axes):
            part = _partition((dim,), (ax,), sizes, rules)[0]
            use[ax] = part if use.get(ax, part) == part else None

    def place(axes, ndim):
        if axes is None or rules is None:
            return placements(P(*([None] * ndim)), mesh)
        return placements(P(*(use.get(ax) for ax in axes)), mesh)

    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    present = [i for i, (t, _) in enumerate(args) if t is not None]
    placed = [place(args[i][1], args[i][0].ndim) for i in present]
    split = {m for pl in placed for m, p in enumerate(pl)
             if isinstance(p, Shard)}
    # an argument whole along a mesh dim that splits the others gets
    # from each rank the gradient of that rank's part: a partial sum
    grad_pl = [tuple(Partial() if m in split and not isinstance(p, Shard)
                     else p for m, p in enumerate(pl)) for pl in placed]

    single = []

    def body(*xs):
        full = [None] * len(args)
        for i, x in zip(present, xs):
            full[i] = x
        outs = fn(*full)
        single.append(not isinstance(outs, tuple))
        return (outs,) if single[0] else outs

    outs = local_map(
        body, out_placements=tuple(place(axes, 0) for axes in out_axes),
        in_placements=tuple(placed), in_grad_placements=tuple(grad_pl),
        device_mesh=mesh, redistribute_inputs=True,
    )(*(replicated_like(args[i][0], ref) for i in present))
    return outs[0] if single[0] else outs
