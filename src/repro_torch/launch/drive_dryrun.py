"""Sweep driver, ported from ``repro.launch.drive_dryrun``: runs the
port's dry run for every (arch x shape x mesh) cell in a subprocess (each
cell its own fake process group), appending JSONL results.

  PYTHONPATH=src python -m repro_torch.launch.drive_dryrun \
      --out experiments/dryrun_results.jsonl [--multi-pod-only] [...] \
      [--device cpu]

Single-pod cells run the cost probe (roofline terms); multi-pod cells run
the placement proof only (sharding coherence across the pod axis).
``--device`` is passed to every cell (the mesh's device type; the GPU
unless it names another).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# NOTE: this driver imports no torch: each child starts its own world.
ARCH_NAMES = (
    "olmoe-1b-7b", "deepseek-moe-16b", "command-r-plus-104b",
    "command-r-35b", "deepseek-coder-33b", "qwen2-1.5b", "internvl2-2b",
    "seamless-m4t-medium", "rwkv6-7b", "jamba-v0.1-52b")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def existing_keys(path: str) -> set:
    keys = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    keys.add((r["arch"], r["shape"], r["mesh"]))
                except (json.JSONDecodeError, KeyError):
                    continue
    return keys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_results.jsonl")
    ap.add_argument("--timeout", type=int, default=1500)
    ap.add_argument("--archs", nargs="*", default=list(ARCH_NAMES))
    ap.add_argument("--shapes", nargs="*", default=list(SHAPE_NAMES))
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type for every cell")
    args = ap.parse_args()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = existing_keys(args.out) if args.resume else set()

    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    total = 0
    for multi_pod in meshes:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        for arch in args.archs:
            for shape in args.shapes:
                if (arch, shape, mesh_name) in done:
                    print(f"skip (done): {arch} {shape} {mesh_name}",
                          flush=True)
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", args.out]
                if args.device:
                    cmd += ["--device", args.device]
                if multi_pod:
                    cmd += ["--multi-pod", "--no-cost-probe"]
                t0 = time.time()
                print(f"[{time.strftime('%H:%M:%S')}] {arch} {shape} "
                      f"{mesh_name} ...", flush=True)
                try:
                    proc = subprocess.run(
                        cmd, capture_output=True, text=True,
                        timeout=args.timeout)
                    tail = (proc.stdout.strip().splitlines() or [""])[-1]
                    status = "?"
                    try:
                        status = json.loads(tail).get("status", "?")
                    except json.JSONDecodeError:
                        status = f"crash rc={proc.returncode}"
                        with open(args.out, "a") as f:
                            f.write(json.dumps({
                                "arch": arch, "shape": shape,
                                "mesh": mesh_name, "status": "crash",
                                "error": proc.stderr[-400:]}) + "\n")
                    print(f"    -> {status} ({time.time()-t0:.0f}s)",
                          flush=True)
                except subprocess.TimeoutExpired:
                    print(f"    -> TIMEOUT ({args.timeout}s)", flush=True)
                    with open(args.out, "a") as f:
                        f.write(json.dumps({
                            "arch": arch, "shape": shape,
                            "mesh": mesh_name,
                            "status": "timeout"}) + "\n")
                total += 1
    print(f"swept {total} cells -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
