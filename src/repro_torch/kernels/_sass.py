"""Count the machine instructions of the port's CUDA kernels.

    PYTHONPATH=src python3 -m repro_torch.kernels._sass SOURCE.cu
        [SOURCE.cu ...] [--sass-dir DIR]

Builds each source with the port's own nvcc flags
(``repro_torch.kernels._build.NVCC_FLAGS``) into a temporary library,
disassembles it with ``cuobjdump -sass`` and prints one JSON line per
kernel: its opcode counts over the whole function and over its hot loop
(a backward branch and the instructions it jumps back over): of the
loops that hold the most MUFU.EX2, and of those the most HMMA, the
smallest (the largest where a kernel has neither); with the loop's
instructions per MUFU.EX2.  With ``--sass-dir`` each library's
disassembly is written there too.  ``analyse`` reads a disassembly
(``chip_smoke.py`` gives it the libraries it built).  Needs the CUDA
toolkit (nvcc and cuobjdump); the card itself is not used.
"""
import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.kernels import _build

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_LABEL = re.compile(r"^\s*\.L_x_(\d+):")


def _functions(sass: str):
    """(name, [(address, opcode, operands)], {label: address}) per kernel."""
    out, name, insns, labels = [], None, [], {}
    pending = []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                out.append((name, insns, labels))
            name, insns, labels, pending = m.group(1), [], {}, []
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m and name:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    if name:
        out.append((name, insns, labels))
    return out


def _loops(insns, labels):
    """(start, end) address ranges of the backward branches (a target is
    an address, as cuobjdump prints it, or a label, as nvdisasm does)."""
    loops = []
    for addr, op, rest in insns:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"\.L_x_(\d+)", rest)
        if m:
            target = labels.get(m.group(1))
        else:
            hexes = re.findall(r"0x([0-9a-f]+)", rest)
            target = int(hexes[-1], 16) if hexes else None
        if target is not None and target < addr:      # not a self-loop
            loops.append((target, addr))
    return loops


def _counts(insns, lo=None, hi=None):
    c = collections.Counter(op for addr, op, _ in insns
                            if lo is None or lo <= addr <= hi)
    return dict(sorted(c.items(), key=lambda kv: -kv[1]))


def analyse(sass: str) -> list:
    rows = []
    for name, insns, labels in _functions(sass):
        loops = _loops(insns, labels)
        def key(span):
            body = _counts(insns, *span)
            hmma = sum(n for op, n in body.items() if op.startswith("HMMA"))
            ex2 = body.get("MUFU.EX2", 0)
            size = span[1] - span[0]
            return (ex2, hmma, -size if ex2 or hmma else size)
        hot = max(loops, key=key) if loops else None
        body = _counts(insns, *hot) if hot else {}
        n = sum(body.values())
        ex2 = body.get("MUFU.EX2", 0)
        rows.append({"kernel": name, "instructions": len(insns),
                     "function": _counts(insns),
                     "hot_loop": {"instructions": n, "opcodes": body,
                                  "MUFU.EX2": ex2,
                                  "instructions_per_ex2":
                                      n / ex2 if ex2 else None}})
    return rows


def disassemble(library: str) -> str:
    """``cuobjdump -sass`` of a built library."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", library], check=True,
                          capture_output=True, text=True).stdout


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--sass-dir")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(args.sources):
            lib = os.path.join(tmp, f"lib{i}.so")
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                            src], check=True, capture_output=True)
            sass = disassemble(lib)
            if args.sass_dir:
                Path(args.sass_dir).mkdir(parents=True, exist_ok=True)
                Path(args.sass_dir, f"{Path(src).stem}-{i}.sass").write_text(
                    sass)
            for row in analyse(sass):
                print(json.dumps({"source": src, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
