"""Hill-climb driver, ported from ``repro.launch.hillclimb``: runs the
planned dry-run variants of the three selected cells through the port's
dry run, logging each (hypothesis, flags, roofline terms) to
experiments/perf_log.jsonl.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--only A,B,C] \
      [--device cpu] [--out experiments/perf_log.jsonl]

``--device`` is passed to every run (the mesh's device type; the GPU
unless it names another); ``--out`` moves the log.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

OUT = "experiments/perf_log.jsonl"

# (cell_id, iteration, hypothesis, arch, shape, extra dryrun flags)
PLAN = [
    # --- Cell A: deepseek-coder-33b x train_4k (worst roofline fraction) --
    ("A", 0, "baseline (heads 56 % 16 != 0 -> attention replicated on "
     "model axis; reference attention materializes S^2 scores)",
     "deepseek-coder-33b", "train_4k", []),
    ("A", 1, "context-parallel attention: shard k/v sequence over model "
     "axis in training -> score memory & compute /16",
     "deepseek-coder-33b", "train_4k", ["--shard-ctx-train", "1"]),
    ("A", 2, "A1 + remat=none: remove the +2ND recompute from the probe "
     "(memory_analysis shows the activation cost of turning remat off)",
     "deepseek-coder-33b", "train_4k",
     ["--shard-ctx-train", "1", "--remat", "none"]),
    ("A", 3, "A1 + seq-parallel residuals off (isolate SP contribution "
     "to collectives)", "deepseek-coder-33b", "train_4k",
     ["--shard-ctx-train", "1", "--seq-parallel", "0"]),

    # --- Cell B: seamless-m4t-medium x train_4k (most collective-bound) --
    ("B", 0, "baseline (vocab 256206 % 16 != 0 -> unembed replicated, "
     "full-logits all-reduce)", "seamless-m4t-medium", "train_4k", []),
    ("B", 1, "pad vocab to 256256 (%16==0) -> logits vocab-sharded, "
     "all-reduce of (B,S,V) disappears", "seamless-m4t-medium",
     "train_4k", ["--vocab-pad", "128"]),
    ("B", 2, "B1 + context-parallel attention (kv=16 divides, but "
     "encoder is not causal -> check effect)", "seamless-m4t-medium",
     "train_4k", ["--vocab-pad", "128", "--shard-ctx-train", "1"]),
    ("B", 3, "B1 + seq-parallel residuals on (small model: check SP "
     "overhead vs saving)", "seamless-m4t-medium", "train_4k",
     ["--vocab-pad", "128", "--seq-parallel", "1"]),

    # --- Cell C: command-r-plus-104b x decode_32k (paper-technique) ------
    ("C", 0, "baseline (bf16 KV pages; memory-bound: params + 2x cache "
     "read per token; DUS accounting inflates measured bytes)",
     "command-r-plus-104b", "decode_32k", []),
    ("C", 1, "int8 KV pages via the quant cast (paper's binary re-coding "
     "migration applied to the serving cache) -> cache bytes /2",
     "command-r-plus-104b", "decode_32k", ["--kv-cache-dtype", "int8"]),
    ("C", 2, "C1 + no donation (check aliasing contribution to the "
     "memory picture)", "command-r-plus-104b", "decode_32k",
     ["--kv-cache-dtype", "int8", "--no-donate"]),
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=str, default=None)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    cells = args.only.split(",") if args.only else None

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for cell, it, hypothesis, arch, shape, flags in PLAN:
        if cells and cell not in cells:
            continue
        print(f"[{time.strftime('%H:%M:%S')}] {cell}{it}: {arch} {shape} "
              f"{' '.join(flags)}", flush=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape] + flags
        if args.device:
            cmd += ["--device", args.device]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=args.timeout)
        tail = (proc.stdout.strip().splitlines() or ["{}"])[-1]
        try:
            rec = json.loads(tail)
        except json.JSONDecodeError:
            rec = {"status": "crash", "error": proc.stderr[-400:]}
        rec.update({"cell": cell, "iteration": it,
                    "hypothesis": hypothesis, "flags": flags,
                    "wall_seconds": round(time.time() - t0, 1)})
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"    -> {rec.get('status')} ({rec['wall_seconds']}s)",
              flush=True)


if __name__ == "__main__":
    main()

# Post-A1 fix (the reference's §Perf A4): the k/v constraint alone was ignored by SPMD
# propagation (A1 == A0); the constraint must pin the score matrices
# themselves (models/attention.py gqa_attend ctx_sharded).  A4 re-runs A1's
# flags against the fixed implementation.
PLAN_A4 = [
    ("A", 4, "FIX + retry of A1: pin scores/probs KV_SEQ-sharded inside "
     "gqa_attend (debug-forward of refuted A1: SPMD all-gathered k and "
     "replicated S^2 scores unless the scores themselves are constrained)",
     "deepseek-coder-33b", "train_4k", ["--shard-ctx-train", "1"]),
    ("B", 4, "same fix applied to qwen2-class replication (12 heads % 16)",
     "qwen2-1.5b", "train_4k", ["--shard-ctx-train", "1"]),
]

# Final optimized variants against the v2 (constraints-active) baseline:
# run AFTER the v2 sweep; iteration=5 rows feed render_report's final table.
PLAN_V2_OPT = [
    ("A", 5, "v2-optimized: context-parallel scores (fixed constraint)",
     "deepseek-coder-33b", "train_4k", ["--shard-ctx-train", "1"]),
    ("B", 5, "v2-optimized: vocab padded to 256256 (VOCAB->model shards)",
     "seamless-m4t-medium", "train_4k", ["--vocab-pad", "128"]),
    ("C", 5, "v2-optimized: int8 KV pages (quant cast on KVStore pages)",
     "command-r-plus-104b", "decode_32k", ["--kv-cache-dtype", "int8"]),
]
