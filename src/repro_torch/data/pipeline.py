"""Synthetic token data pipeline, served through the relational island,
ported from ``repro.data.pipeline``.

A training batch is a relational-island object: batches are materialized
as Tables in a HostStore engine, cast to the array island by the
Migrator, and consumed by the train step.  ``TokenDataset`` is numpy,
deterministic in (seed, step, host) and bitwise the reference's, so
multi-host loaders shard without coordination and a restart after a
failure replays the exact batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import _device, _dtypes
from repro_torch.core import datamodel as dm
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 4096
    global_batch: int = 256
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


class TokenDataset:
    """Deterministic synthetic LM token stream (zipf-ish unigram draws)."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig) -> None:
        if dcfg.global_batch % dcfg.num_hosts:
            raise ValueError(f"global batch {dcfg.global_batch} does not "
                             f"split over {dcfg.num_hosts} hosts")
        self.cfg = cfg
        self.dcfg = dcfg
        self.local_batch = dcfg.global_batch // dcfg.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.dcfg.seed, step, self.dcfg.host_id))
        st = registry.text_len(self.cfg, self.dcfg.seq_len)
        # zipf-flavoured unigram distribution, clipped to vocab
        raw = rng.zipf(1.3, size=(self.local_batch, st + 1))
        toks = (raw % self.cfg.vocab_size).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend == "vision":
            out["prefix_embeds"] = rng.standard_normal(
                (self.local_batch, self.cfg.num_prefix_embeds,
                 self.cfg.d_model)).astype(np.float32)
        if self.cfg.frontend == "audio":
            out["frame_embeds"] = rng.standard_normal(
                (self.local_batch, max(1, self.dcfg.seq_len
                                       // self.cfg.src_ratio),
                 self.cfg.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def batch_as_table(batch: Dict[str, np.ndarray], device=None) -> dm.Table:
    """Flatten a token batch into a relational-island Table object whose
    columns lie on ``device`` (the GPU unless the caller names one)."""
    device = _device.resolve(device, "batch_as_table")
    toks = np.asarray(batch["tokens"])
    b, s = toks.shape
    return dm.Table({
        "sample": _dtypes.as_tensor(np.repeat(np.arange(b), s), device),
        "position": _dtypes.as_tensor(np.tile(np.arange(s), b), device),
        "token": _dtypes.as_tensor(toks.reshape(-1), device),
        "label": _dtypes.as_tensor(
            np.asarray(batch["labels"]).reshape(-1), device),
    })


def table_as_batch(table, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """Accepts a Table or its array-island cast (ArrayObject); int32
    tensors on the object's device."""
    fields = table.columns if isinstance(table, dm.Table) else table.attrs
    return {
        "tokens": fields["token"].reshape(batch, seq).to(torch.int32),
        "labels": fields["label"].reshape(batch, seq).to(torch.int32),
    }
