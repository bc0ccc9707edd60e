"""The plain reference of the paper's §VI queries and of the quant route,
in NumPy (and plain PyTorch for a waveform record's mean) over the tables
the benchmark generated: each query's answer in the shape a result takes
once on the host (``core.hostcopy.to_host``), and the judgement of a
result against it.  It imports nothing of the system under test.

Exact answers are compared bit for bit (values and dtypes); a mean is
judged by its distance from the float64 mean of the float32 inputs, over
their mean magnitude, against the cell's limit.

``data`` holds the tables as host arrays and ``record(r)``, which gives
waveform record ``r`` as a float32 tensor (on the card in a card run).
``lowered`` rounds every input to bfloat16, the precision below the
configuration's float32: the control that the comparison has to fail.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

INV127 = np.float32(1.0) / np.float32(127.0)
QUANT_BLOCK, QUANT_ROWS = 128, 8


def quant_pages(x: np.ndarray) -> Dict[str, np.ndarray]:
    """Blockwise int8 pages of ``x`` (flattened, zero-padded to whole
    tiles of QUANT_ROWS x 128): one float32 scale per 128 values, ``absmax
    * (1/127 in float32)``, and ``round_half_even(x / scale)`` clamped to
    +-127, each step in float32."""
    flat = np.asarray(x, np.float32).reshape(-1)
    pad = (-flat.size) % (QUANT_ROWS * QUANT_BLOCK)
    x2d = np.concatenate([flat, np.zeros(pad, np.float32)]).reshape(
        -1, QUANT_BLOCK)
    absmax = np.abs(x2d).max(axis=1, keepdims=True)
    scale = np.where(absmax > 0, absmax * INV127, np.float32(1.0)).astype(
        np.float32)
    q = np.clip(np.rint(x2d / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale}


def lower(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (kept in float64)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float64)).to(
        torch.bfloat16).to(torch.float64).numpy()


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8),
        np.ascontiguousarray(b).view(np.uint8)))


def lowered(data: Dict[str, Any]) -> Dict[str, Any]:
    """The generated tables with every number rounded to bfloat16, the
    precision below the configuration's float32 (the control's input)."""
    def low(a: np.ndarray) -> np.ndarray:
        return lower(a.astype(np.float64)).astype(a.dtype)
    record = data["record"]
    out = dict(data)
    out["d_patients"] = {k: low(v) for k, v in data["d_patients"].items()}
    out["poe_order"] = {k: low(v) for k, v in data["poe_order"].items()}
    out["myarray"] = low(data["myarray"])
    out["record"] = lambda r: record(r).to(torch.bfloat16).float()
    return out


def record_mean(rec: torch.Tensor) -> Tuple[float, float]:
    """(mean, mean magnitude) of a record's float32 values, in float64."""
    x = rec.to(torch.float64)
    return float(x.mean()), float(x.abs().mean()) or 1.0


def answer(q, data: Dict[str, Any], engines: List[Tuple[str, str]]) -> Any:
    """The reference's answer to query ``q`` over ``data``."""
    pat, poe = data["d_patients"], data["poe_order"]
    c = q.const
    if q.kind == "rel_limit":
        return {"columns": {k: v[:c["n"]] for k, v in pat.items()}}
    if q.kind == "rel_count":
        return {"columns": {"count_subject_id": np.array(
            [int(np.sum(pat["sex"] == c["sex"]))], np.int32)}}
    if q.kind == "rel_group_avg":
        keys = np.unique(pat["sex"]).astype(np.int32)
        groups = [pat["dob_year"][pat["sex"] == s].astype(np.float64)
                  for s in keys]
        return {"columns": {"sex": keys, "avg_dob_year": np.array(
            [g.mean() for g in groups])},
            "scale": [float(np.abs(g).mean()) or 1.0 for g in groups]}
    if q.kind == "array_filter":
        return {"attrs": {"val": data["myarray"]},
                "valid": np.arange(data["myarray"].shape[0]) > c["c"]}
    if q.kind == "array_avg":
        mean, scale = record_mean(data["record"](c["r"]))
        return {"attrs": {"avg_signal": np.array([mean])},
                "scale": [scale]}
    if q.kind == "text_range":
        keys, values = data["logs"]
        return [[list(k), v] for k, v in zip(keys[c["a"]:c["b"] + 1],
                                             values[c["a"]:c["b"] + 1])]
    if q.kind == "catalog":
        return [{"name": n, "connection_properties": k} for n, k in engines]
    if q.kind == "cast_rel_to_array":
        order = np.argsort(poe["poe_id"], kind="stable")
        return {"attrs": {"subject_id": poe["subject_id"][order]},
                "dims": ("poe_id",)}
    if q.kind == "quant_route":
        rec = data["record"](c["r"]).cpu().numpy()
        return {"signal": quant_pages(rec)}
    raise ValueError(q.kind)


def judge(q, got: Any, want: Any) -> Tuple[bool, float]:
    """(exact parts equal, relative error of a mean) of result ``got``
    against the reference's ``want``: a mean's distance from the exact
    one over the mean magnitude of its inputs."""
    try:
        if q.kind in ("rel_limit", "rel_count"):
            g, w = got["columns"], want["columns"]
            return list(g) == list(w) and all(
                same_bits(g[k], w[k]) for k in w), 0.0
        if q.kind == "rel_group_avg":
            g, w = got["columns"], want["columns"]
            if not same_bits(g["sex"], w["sex"]):
                return False, 0.0
            return True, max(
                abs(float(gv) - float(wv)) / sc for gv, wv, sc in zip(
                    g["avg_dob_year"], w["avg_dob_year"], want["scale"]))
        if q.kind == "array_filter":
            valid = got["valid"]
            if valid is None:
                valid = np.ones_like(want["valid"])
            return (same_bits(got["attrs"]["val"], want["attrs"]["val"])
                    and np.array_equal(valid, want["valid"])), 0.0
        if q.kind == "array_avg":
            return True, abs(float(got["attrs"]["avg_signal"][0]) - float(
                want["attrs"]["avg_signal"][0])) / want["scale"][0]
        if q.kind in ("text_range", "catalog"):
            return got == want, 0.0
        if q.kind == "cast_rel_to_array":
            g = np.asarray(got["attrs"]["subject_id"])
            return (tuple(got["dims"]) == want["dims"] and g.shape ==
                    want["attrs"]["subject_id"].shape and np.array_equal(
                        g.astype(np.float64),
                        want["attrs"]["subject_id"].astype(np.float64))
                    ), 0.0
        if q.kind == "quant_route":
            g, w = got["signal"], want["signal"]
            return same_bits(g["q"], w["q"]) and same_bits(
                g["scale"], w["scale"]), 0.0
    except (KeyError, TypeError, IndexError, ValueError):
        return False, 0.0
    raise ValueError(q.kind)
