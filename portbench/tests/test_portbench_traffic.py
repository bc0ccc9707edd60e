"""The traffic generators: the same seed gives the same traffic, another
seed the same sizes in another order, within the stated ranges."""
import itertools

import torch

from helpers import BENCH
from portbench.core.manifest import load_module


def _gen(name):
    return load_module(BENCH / "traffic" / f"{name}.py", "generator")


MIX = {"mix": {"rel_limit": 1, "rel_count": 1, "rel_group_avg": 1,
               "array_filter": 1, "array_avg": 1, "text_range": 1,
               "catalog": 1, "cast_rel_to_array": 1, "quant_route": 1}}
SIZES = dict(num_patients=64, num_orders=256, num_notes=64,
             waveform_records=3, record_samples=512, wave_leads=8,
             myarray_cells=256)


def test_analyst_mix_is_deterministic_and_balanced():
    g = _gen("icu_analyst")
    a = list(itertools.islice(g.make(MIX, 99, SIZES), 90))
    b = list(itertools.islice(g.make(MIX, 99, SIZES), 90))
    assert a == b
    kinds = [q.kind for q in a]
    for k in MIX["mix"]:
        assert kinds.count(k) == 10
    for q in a:
        if q.kind == "rel_limit":
            assert 1 <= q.const["n"] <= 64
        if q.kind == "text_range":
            assert 0 <= q.const["a"] <= q.const["b"] < 64
            assert f"'r_{q.const['a']:07d}'" in q.bql
        if q.kind == "array_filter":
            assert 0 <= q.const["c"] < 255
        if q.kind in ("array_avg", "quant_route"):
            assert 0 <= q.const["r"] < 3
        if q.kind == "array_avg":
            assert g.record_name(q.const["r"]) in q.bql
    assert {q.const["r"] for q in a if "r" in q.const} == {0, 1, 2}
    c = list(itertools.islice(g.make(MIX, 2 ** 33 + 100, SIZES), 90))
    assert sorted(q.kind for q in c) == sorted(kinds) and c != a


def test_tables_are_deterministic_with_the_schema():
    import json
    g = _gen("mimic_tables")
    cfg = json.loads((BENCH / "configs" / "icu-mimic2.json").read_text())
    a, b = g.make(SIZES, 7, "cpu"), g.make(SIZES, 7, "cpu")
    for part in ("d_patients", "poe_order"):
        assert set(a[part]) == set(cfg["schema"][part])
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
            assert v.dtype in (torch.int32, torch.float32)
            assert v.shape == (SIZES["num_patients"] if part == "d_patients"
                               else SIZES["num_orders"],)
    pat = a["d_patients"]
    assert pat["dob_year"].min() >= 1930 and pat["dob_year"].max() < 2000
    assert torch.equal(pat["dod_year"] > 0, pat["hospital_expire_flg"] == 1)
    assert a["poe_order"]["subject_id"].max() < 64
    assert a["store"].shape == (3, 8, 512)
    assert a["store"].dtype == torch.float32
    assert torch.equal(a["store"], b["store"])
    assert torch.equal(g.store(SIZES, 7, "cpu"), a["store"])
    assert not torch.equal(g.store(SIZES, 8, "cpu"), a["store"])
    assert not torch.equal(a["store"][0], a["store"][1])
    assert a["logs"] == b["logs"] and len(a["logs"][0]) == 64
    assert a["logs"][0][5] == ("r_0000005", "note", "text")


def test_store_amplitudes_lie_in_the_stated_range():
    # each record's signals: a sine at an amplitude in [0.5, 2) plus
    # noise of standard deviation 0.05
    g = _gen("mimic_tables")
    store = g.store(SIZES, 11, "cpu")
    peak = store.abs().amax(dim=2)
    assert bool((peak > 0.5).all()) and bool((peak < 2.5).all())
    assert 0.03 < float((store[0, 0, 1:] - store[0, 0, :-1]).std()) < 0.2
