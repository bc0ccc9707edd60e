#!/usr/bin/env python3
"""Time variants of the port's two scan kernels on the card.

    PYTHONPATH=src python3 scan_variants.py

Each variant is the kernel's source with some of its lines replaced
(``VARIANTS``), built with the port's nvcc flags as a library of its own
under ``build/`` and run through the kernel's own wrapper: first through
``chip_smoke.scan_parity`` (every parity case of the smoke, at the
smoke's tolerances), whose verdict is printed rather than raised, then
timed at the serve shapes as ``chip_smoke.py`` times the kernels (CUDA
events over a CUDA graph of launches on input sets that rotate past the
L2).  The unchanged kernels are timed in the same run as the baseline.
A variant marked diagnostic computes another function (it drops a term
or the exponent): its time shows what that part of the kernel costs.
Prints one JSON line per variant, then the card's name and power limit.
Needs a CUDA device and nvcc.
"""
import contextlib
import io
import json
import pathlib
import subprocess
import sys
from unittest import mock

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan as mk  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk  # noqa: E402

EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
# name: (wrapper module, [(text, replacement)], diagnostic)
VARIANTS = {
    "mamba_scan": (mk, [], False),
    "mamba_scan exp2 as an FMA": (mk, [
        (EX2, "y = fmaf(x, 0.5f, 1.0f);")], True),
    "rwkv6_scan": (wk, [], False),
    "rwkv6_scan 1xTF32": (wk, [
        ("  mma_tf32(d, al, h0, h1);\n  mma_tf32(d, ah, l0, l1);\n", "")],
        False),
    "rwkv6_scan no P levels on the tensor cores": (wk, [(
        "for (int lv = warp; lv < L::kLevels; lv += kThreads / 32) {",
        "for (int lv = warp; lv < 0; lv += kThreads / 32) {")], True),
}


def build(name: str, module, subs):
    """The variant's library, loaded and typed by the wrapper's ``load``,
    and ptxas's registers and spills for it."""
    source = module.SOURCES[0]
    text = source.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} is not in {source.name}")
        text = text.replace(old, new)
    lib_name = "variant_" + "".join(c if c.isalnum() else "_" for c in name)
    path = _build.BUILD_DIR / "variants" / f"{lib_name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    lib = module.load(lib_name, (path,))
    ptxas = [ln.strip() for ln in _build.BUILD_LOGS.get(
        lib_name, "").splitlines() if "registers" in ln or "spill" in ln]
    return lib, ptxas


def parity() -> dict:
    """chip_smoke.scan_parity's verdict: its cases' count, or the first
    case that left its tolerance."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cs.scan_parity()
        return {"passes": True,
                "cases": len(out.getvalue().splitlines())}
    except AssertionError as e:
        return {"passes": False,
                "cases_passed": len(out.getvalue().splitlines()),
                "first_failure": str(e)}


def times(module) -> dict:
    if module is mk:
        out = {}
        for label, shape, dtype, sets in (
                ("bf16", cs.SCAN_SHAPE, torch.bfloat16, 2),
                ("f32", cs.SCAN_SHAPE, torch.float32, 2),
                ("bf16 S=1", (8, 1, 8192, 16), torch.bfloat16, 8)):
            xs = [cs._scan_inputs(*shape, dtype, 120 + i)
                  for i in range(sets)]
            out[label] = cs._graph_ms([lambda x=x: mk.selective_scan_3d(*x)
                                       for x in xs])
            del xs
        return out
    out = {}
    for label, shape, sets in (("f32", cs.WKV_SHAPE, 2),
                               ("f32 S=1", (8, 1, 64, 64), 8)):
        xs = [cs._wkv_inputs(*shape, "full_width", 110 + i)
              for i in range(sets)]
        out[label] = cs._graph_ms([lambda x=x: wk.wkv6_4d(*x) for x in xs])
        del xs
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_variants.py needs a CUDA device", file=sys.stderr)
        return 1
    cs.build()
    for name, (module, subs, diagnostic) in VARIANTS.items():
        lib, ptxas = build(name, module, subs)
        with mock.patch.object(module, "load", lambda lib=lib: lib):
            row = {"variant": name, "diagnostic": diagnostic,
                   "substitutions": subs, "ptxas": ptxas,
                   "parity": parity(), "ms": times(module)}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
