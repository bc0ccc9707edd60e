"""End-to-end training on the PyTorch port (twin of
``examples/train_lm.py``): train a ~100M-parameter qwen2-family model with
the full substrate: the deterministic token pipeline through the
polystore (HostStore -> Migrator -> DenseHBM), AdamW with a cosine
schedule, microbatch accumulation, checkpoint/restart with failure
injection, and the trained state registered in the polystore.

  python examples/train_lm_torch.py --steps 300            # on the GPU
  python examples/train_lm_torch.py --device cpu --steps 8 # smoke
"""
import argparse
import dataclasses
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch                                                 # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core.api import default_deployment          # noqa: E402
from repro_torch.core.migrator import MigrationParams        # noqa: E402
from repro_torch.core.tensorstore import (PlacementPolicy,   # noqa: E402
                                          TensorPolystore)
from repro_torch.data.pipeline import (DataConfig,           # noqa: E402
                                       TokenDataset, batch_as_table,
                                       table_as_batch)
from repro_torch.models import registry                      # noqa: E402
from repro_torch.optim.adamw import AdamWConfig              # noqa: E402
from repro_torch.runtime.fault import (FailureInjector,      # noqa: E402
                                       run_with_recovery)
from repro_torch.sharding import logical as L                # noqa: E402
from repro_torch.train.step import (TrainConfig,             # noqa: E402
                                    init_train_state, make_train_step)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=registry.ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=512,
                    help="width of the ~100M trainable variant")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the GPU)")
    args = ap.parse_args(argv)

    bd = default_deployment(device=args.device)
    device = bd.device
    # ~100M-param trainable variant of the chosen family
    cfg = registry.get_config(args.arch, reduced=True)
    cfg = dataclasses.replace(
        cfg, d_model=args.d_model, num_layers=args.layers,
        num_heads=max(4, args.d_model // 128),
        num_kv_heads=max(2, args.d_model // 256),
        head_dim=min(128, args.d_model // 4),
        d_ff=args.d_model * 4, vocab_size=32768)
    n = L.count_params(registry.param_specs(cfg))
    print(f"arch={cfg.name} variant: {n/1e6:.1f}M params on {device}")

    tcfg = TrainConfig(optimizer=AdamWConfig(
        learning_rate=3e-4, warmup_steps=20, total_steps=args.steps),
        microbatches=2)
    train_step = make_train_step(cfg, tcfg)
    ds = TokenDataset(cfg, DataConfig(seq_len=args.seq_len,
                                      global_batch=args.batch))
    tmp = tempfile.TemporaryDirectory(prefix="train_lm_ckpt_")
    ckpt = CheckpointManager(args.ckpt_dir or tmp.name, keep=2)
    store = TensorPolystore(bd, PlacementPolicy(moments="resident"))
    host, dense = bd.engines["hoststore0"], bd.engines["densehbm0"]

    def init():
        return init_train_state(
            cfg, torch.Generator(device=device).manual_seed(0), device)

    log = {"t0": time.time()}

    def step_fn(state, i):
        # the batch goes through the polystore: a relational Table in the
        # HostStore, cast to the array island on the device
        host.put("train_batch", batch_as_table(ds.batch_at(i), device))
        bd.migrator.migrate(host, "train_batch", dense, "train_batch_dev",
                            MigrationParams(method="binary"))
        batch = table_as_batch(dense.get("train_batch_dev"), args.batch,
                               args.seq_len)
        state, metrics = train_step(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            dt = time.time() - log["t0"]
            toks = args.batch * args.seq_len
            print(f"step {i:4d}  loss={float(metrics['loss']):.4f}"
                  f"  gnorm={float(metrics['grad_norm']):.2f}"
                  f"  lr={float(metrics['lr']):.2e}"
                  f"  ({toks/max(dt,1e-9):,.0f} tok/s)", flush=True)
            log["t0"] = time.time()
        return state

    injector = None
    if args.inject_failure_at is not None:
        injector = FailureInjector({args.inject_failure_at: 0})

    report = run_with_recovery(
        init_state=init, step_fn=step_fn, ckpt=ckpt, num_steps=args.steps,
        checkpoint_every=25, injector=injector)
    print(f"done: {report.steps_run} steps,"
          f" {report.failures_recovered} failures recovered"
          f" (restarts at {report.restarts})")

    final, step = ckpt.restore(init())
    store.register_train_state(cfg.name, final)
    rows = bd.query("bdcatalog(select name from objects)").value
    print(f"polystore objects: {[r['name'] for r in rows]}")
    tmp.cleanup()


if __name__ == "__main__":
    main()
