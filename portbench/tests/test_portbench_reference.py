"""The plain references against small cases worked by hand."""
import numpy as np
import torch

from portbench.reference import queries as qref


def test_lower_rounds_to_bfloat16():
    x = np.array([1.0, 1.0 + 2 ** -9, 1930.0, 75.3])
    assert qref.lower(x).tolist() == [1.0, 1.0, 1928.0, 75.5]


def test_quant_pages():
    x = np.zeros(1024, np.float32)
    x[:4] = [127.0, -63.5, 0.25, 1.0]
    p = qref.quant_pages(x)
    assert p["q"].shape == (8, 128) and p["scale"].shape == (8, 1)
    assert p["scale"][0, 0] == np.float32(127.0) * qref.INV127
    assert p["q"][0, :4].tolist() == [127, -64, 0, 1]
    assert p["scale"][1, 0] == 1.0 and not p["q"][1:].any()


def test_same_bits_tells_dtypes_and_signed_zeros_apart():
    a = np.array([0.0, 1.0], np.float32)
    assert qref.same_bits(a, a.copy())
    assert not qref.same_bits(a, a.astype(np.float64))
    assert not qref.same_bits(a, np.array([-0.0, 1.0], np.float32))


def test_record_mean_and_its_scale():
    rec = torch.tensor([[1.0, -3.0], [2.0, 4.0]])
    assert qref.record_mean(rec) == (1.0, 2.5)


class _Q:
    def __init__(self, kind, **const):
        self.kind, self.const = kind, const


def test_answers_over_records_and_the_lowered_control():
    rec = torch.tensor([[[1.0 + 2 ** -9, 3.0]], [[-2.0, 0.5]]])
    data = {"record": lambda r: rec[r], "d_patients": {}, "poe_order": {},
            "myarray": np.zeros(4, np.float32)}
    want = qref.answer(_Q("array_avg", r=0), data, [])
    assert want["attrs"]["avg_signal"][0] == (1.0 + 2 ** -9 + 3.0) / 2
    low = qref.answer(_Q("array_avg", r=0), qref.lowered(data), [])
    assert low["attrs"]["avg_signal"][0] == 2.0
    pages = qref.answer(_Q("quant_route", r=1), data, [])["signal"]
    assert pages["q"][0, :2].tolist() == [-127, 32]
    ok, err = qref.judge(_Q("array_avg", r=0), low, want)
    assert ok and err > 1e-4
