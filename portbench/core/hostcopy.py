"""Results of the system under test copied to the host: a result counts
as delivered once its values are in host memory.

A large result on the card is copied into page-locked host memory from
torch's caching host allocator, as a client library that receives bulk
results would: a copy into fresh pageable memory pays the host's page
faults on every call, which a host shared with other machines serves at
a speed that moves from run to run."""
from __future__ import annotations

from typing import Any

import numpy as np

PINNED_BYTES = 1 << 20        # results from 1 MiB up go through pinned memory


def to_host(value: Any) -> Any:
    """The port's result objects (Table, ArrayObject, tensors, and lists
    or dicts of them) as plain dicts of numpy arrays."""
    import torch
    from repro_torch.core import datamodel as dm
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            value = value.float()
        if value.is_cuda and value.numel() * value.element_size() \
                >= PINNED_BYTES:
            buf = torch.empty(value.shape, dtype=value.dtype,
                              pin_memory=True)
            buf.copy_(value)
            return buf.numpy()
        return value.cpu().numpy()
    if isinstance(value, dm.Table):
        return {"columns": {k: to_host(v) for k, v in value.columns.items()}}
    if isinstance(value, dm.ArrayObject):
        return {"attrs": {k: to_host(v) for k, v in value.attrs.items()},
                "dims": tuple(value.dim_names),
                "valid": None if value.valid is None
                else to_host(value.valid)}
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_host(v) for v in value]
    return value


def keep(value: Any) -> Any:
    """A result from ``to_host`` in memory of its own, so that the pinned
    buffers go back to the allocator's cache for the next result (done
    after the result's time is taken)."""
    if isinstance(value, np.ndarray):
        return np.array(value, copy=True)
    if isinstance(value, dict):
        return {k: keep(v) for k, v in value.items()}
    if isinstance(value, list):
        return [keep(v) for v in value]
    return value
