"""The MIMIC II tables of the BigDAWG v0.1 deployment (paper §IV), drawn
from the run's seed on the device: patient history (``d_patients``,
``poe_order``, every column of the source's tables) for the relational
island, the bedside waveform store (one array of 8 signals a record) and
the release's demo array for the array island, free-text notes for the
key-value island.  Integers are int32 and reals float32, as the port
holds them; text and date columns are int32 codes.

Each part has a generator of its own, so that the check can draw the
waveform store again, alone, once the system under test has freed it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np

# (name, low, high) of the int32 columns drawn uniformly; dates are
# minutes, text columns dictionary codes
POE_INTS: List[Tuple[str, int, int]] = [
    ("hadm_id", 100000, 200000), ("icustay_id", 0, 40000),
    ("start_dt", 0, 1 << 24), ("stop_dt", 0, 1 << 24),
    ("enter_dt", 0, 1 << 24), ("medication", 0, 4096),
    ("procedure_type", 0, 8), ("status", 0, 4), ("route", 0, 32),
    ("frequency", 0, 64), ("dispense_sched", 0, 64), ("iv_fluid", 0, 256),
    ("infusion_type", 0, 8), ("sliding_scale", 0, 2),
    ("duration_intvl", 0, 8), ("expiration_unit", 0, 8),
    ("expiration_dt", 0, 1 << 24), ("label_instr", 0, 65536),
    ("additional_instr", 0, 65536), ("md_add_instr", 0, 65536),
    ("rnurse_add_instr", 0, 65536)]
POE_REALS: List[Tuple[str, float, float]] = [
    ("iv_rate", 0.0, 500.0), ("doses_per_24hrs", 0.0, 24.0),
    ("duration", 0.0, 30.0), ("expiration_val", 0.0, 100.0)]
PATIENT_INTS = [("sex", 0, 2), ("dob_year", 1930, 2000),
                ("hospital_expire_flg", 0, 2), ("dod_year", 2001, 2009)]
PERIOD = 360                 # samples a beat of the synthetic waveform
NOISE = 0.05
PART_STORE, PART_TABLES = 1, 2


def _generator(seed: int, part: int, device):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) % (1 << 60)) * 4 + part)
    return g


def _ints(g, specs, n: int, device) -> Dict[str, Any]:
    """Columns of int32 drawn uniformly in [low, high), in one call."""
    import torch
    raw = torch.randint(0, 1 << 31, (len(specs), n), generator=g,
                        device=device, dtype=torch.int64)
    lo = torch.tensor([s[1] for s in specs], device=device)[:, None]
    span = torch.tensor([s[2] - s[1] for s in specs], device=device)[:, None]
    mat = (raw % span + lo).to(torch.int32)
    return {s[0]: mat[i] for i, s in enumerate(specs)}


def _reals(g, specs, n: int, device) -> Dict[str, Any]:
    import torch
    mat = torch.rand((len(specs), n), generator=g, device=device)
    lo = torch.tensor([s[1] for s in specs], device=device)[:, None]
    span = torch.tensor([s[2] - s[1] for s in specs], device=device)[:, None]
    mat = mat * span + lo
    return {s[0]: mat[i] for i, s in enumerate(specs)}


def store(sizes: Dict[str, int], seed: int, device):
    """The waveform store, (records, leads, samples) float32: each record's
    signals a sine of period PERIOD at an amplitude of its own, plus
    Gaussian noise.  Drawn in chunks under 2**31 values a call."""
    import torch
    recs, leads = int(sizes["waveform_records"]), int(sizes["wave_leads"])
    samples = int(sizes["record_samples"])
    g = _generator(seed, PART_STORE, device)
    amp = torch.rand((recs, leads, 1), generator=g, device=device) \
        * 1.5 + 0.5
    t = torch.arange(samples, dtype=torch.float64, device=device)
    base = torch.sin(2 * math.pi * (t % PERIOD) / PERIOD).float()
    out = torch.empty((recs, leads, samples), device=device)
    step = max(1, ((1 << 31) - 1) // (leads * samples))
    for i in range(0, recs, step):
        chunk = out[i:i + step]
        chunk.normal_(generator=g).mul_(NOISE)
        chunk.addcmul_(base, amp[i:i + step])
    return out


def make(sizes: Dict[str, int], seed: int, device) -> Dict[str, Any]:
    """Every table of the deployment on ``device`` (the notes on the
    host, where the key-value engine keeps them)."""
    import torch
    n_pat, n_ord = int(sizes["num_patients"]), int(sizes["num_orders"])
    g = _generator(seed, PART_TABLES, device)
    pat = _ints(g, PATIENT_INTS, n_pat, device)
    pat["dod_year"] = torch.where(pat["hospital_expire_flg"] == 1,
                                  pat["dod_year"], 0)
    d_patients = {"subject_id": torch.arange(n_pat, dtype=torch.int32,
                                             device=device), **pat}
    d_patients = {k: d_patients[k] for k in
                  ("subject_id", "sex", "dob_year", "dod_year",
                   "hospital_expire_flg")}
    ints = _ints(g, [("subject_id", 0, n_pat)] + POE_INTS, n_ord, device)
    reals = _reals(g, POE_REALS, n_ord, device)
    poe_order = {"poe_id": torch.arange(n_ord, dtype=torch.int32,
                                        device=device), **ints, **reals}
    myarray = torch.randn(int(sizes["myarray_cells"]), generator=g,
                          device=device)
    n_notes = int(sizes["num_notes"])
    rng = np.random.default_rng(int(seed) % (1 << 63))
    hr = rng.integers(50, 120, n_notes).tolist()
    keys = [(f"r_{i:07d}", "note", "text") for i in range(n_notes)]
    values = [f"synthetic clinical note {i}: pt stable, hr={h}"
              for i, h in enumerate(hr)]
    return {"d_patients": d_patients, "poe_order": poe_order,
            "myarray": myarray, "logs": (keys, values),
            "store": store(sizes, seed, device)}
