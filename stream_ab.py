#!/usr/bin/env python3
"""Time the port's two streaming kernels against other versions of them,
in turns, on the card.

    PYTHONPATH=src python3 stream_ab.py DIR [DIR ...]

Each DIR is the root of another version of
``src/repro_torch/kernels/stream/`` (its ``stream.py`` and
``csrc/stream.cu``): ``git archive`` of an earlier commit, or a copy
with ``stream.cu`` edited, unpacked under ``build/`` so that a copy of
the checkout carries it.  Its own wrapper builds its own source.  For
each DIR both kernels' results are held bit for bit to this checkout's
(which ``chip_smoke.py`` holds to their plain versions) on every timed
input, and both versions are timed as ``chip_smoke.py`` times the
kernels (CUDA events over a CUDA graph of launches on inputs that rotate
past the L2, at its ``MINMAX_TIMED`` and ``JOIN_TIMED`` shapes) in
turns: DIR, this, this, DIR.  A version that computes another function
(an edit that skips a phase, to time it) is timed all the same and
reported with ``same_bits`` false.  Prints one JSON line for this
checkout (ptxas, launch floor), one per DIR (ptxas of its build, bits,
times), then the card's name and power limit.  Needs a CUDA device and
nvcc.
"""
import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stream import ops  # noqa: E402
from repro_torch.kernels.stream import stream as sk  # noqa: E402


def kernels(module) -> dict:
    """A version's window_minmax (max) and join_bounds, called as the
    main path calls them."""
    return {"window_minmax": lambda x: module.window_minmax_2d(x, True),
            "join_bounds": lambda lt, rs: module.join_bounds_1d(
                lt, rs, 0.5, ops.steps(rs.numel()))}


def inputs() -> list:
    """(kernel, label, argument sets, reps) at every timed shape."""
    out = [("window_minmax", f"window_minmax {w}x{size}",
            [(x,) for x in cs.minmax_inputs(w, size, copies)], reps)
           for w, size, copies, reps in cs.MINMAX_TIMED]
    out += [("join_bounds", f"join_bounds {n}^2 {order}",
             cs.join_inputs(order, n), 20) for order, n in cs.JOIN_TIMED]
    return out


def same_bits(a: dict, b: dict, data: list) -> dict:
    out = {}
    for kernel, label, sets, _ in data:
        same = True
        for args in sets:
            x, y = a[kernel](*args), b[kernel](*args)
            if kernel == "window_minmax":
                same = same and cs._same_bits(x, y)
            else:
                same = same and all(torch.equal(p, q) for p, q in zip(x, y))
        out[label] = same
    return out


def times(fns: dict, data: list) -> dict:
    return {label: cs._graph_ms([lambda a=args: fns[kernel](*a)
                                 for args in sets], reps)
            for kernel, label, sets, reps in data}


def version(root: pathlib.Path, index: int):
    """The streaming kernels' wrapper of the version at ``root``, built
    from its own source, and ptxas's report of that build."""
    path = root / "src/repro_torch/kernels/stream/stream.py"
    name = f"stream_ab_{index}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module          # dataclasses look their module up
    spec.loader.exec_module(module)
    _build.BUILD_LOGS.pop("stream", None)
    module.load()
    return module, cs._ptxas("stream")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+", type=pathlib.Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_ab.py needs a CUDA device", file=sys.stderr)
        return 1
    sk.load()
    this = kernels(sk)
    print(json.dumps({"version": "this", "ptxas": cs._ptxas("stream"),
                      "launch_floor_ms": cs._graph_ms(
                          [lambda: sk.empty_launch(torch.device("cuda"))],
                          reps=100)}), flush=True)
    data = inputs()
    for i, root in enumerate(args.dirs):
        module, ptxas = version(root.resolve(), i)
        other = kernels(module)
        row = {"version": str(root), "ptxas": ptxas,
               "same_bits": same_bits(other, this, data), "ms": []}
        for label, fns in (("other", other), ("this", this),
                           ("this", this), ("other", other)):
            row["ms"].append({"kernels": label, **times(fns, data)})
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
