"""Serving driver on the PyTorch port (twin of ``examples/serve_lm.py``):
wave-batched prefill + decode, with the final KV cache's pages stored
(optionally int8-quantized) in the polystore's KVStore engine.

  python examples/serve_lm_torch.py --requests 6 --int8-kv   # on the GPU
  python examples/serve_lm_torch.py --device cpu             # on the CPU
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np                                           # noqa: E402

from repro_torch.core.api import default_deployment          # noqa: E402
from repro_torch.core.tensorstore import (PlacementPolicy,   # noqa: E402
                                          TensorPolystore)
from repro_torch.models import registry                      # noqa: E402
from repro_torch.serve.engine import (Request, Scheduler,    # noqa: E402
                                      ServeConfig, ServeSession)
from repro_torch.train.step import init_train_state          # noqa: E402


def main(argv=None, params=None) -> None:
    """``params``: the model's parameter tree to serve (float32); drawn
    from seed 0 when None."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=registry.ARCH_NAMES)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the GPU)")
    args = ap.parse_args(argv)

    bd = default_deployment(device=args.device)
    device = bd.device
    cfg = registry.get_config(args.arch, reduced=True)
    if params is None:
        params = init_train_state(cfg, device=device)["params"]
    scfg = ServeConfig(max_batch=4, cache_len=64,
                       max_new_tokens=args.max_new)
    sess = ServeSession(cfg, params, scfg, device=device)
    sched = Scheduler(sess)

    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        plen = int(rng.integers(4, 12))
        sched.submit(Request(rid, rng.integers(
            0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=args.max_new))
    t0 = time.time()
    done = sched.run()
    wall = time.time() - t0
    total_new = sum(len(c.tokens) for c in done)
    for c in sorted(done, key=lambda c: c.rid):
        print(f"req {c.rid}: {c.tokens.tolist()}"
              f"  (prefill {c.prefill_seconds*1e3:.0f} ms,"
              f" decode {c.decode_seconds*1e3:.0f} ms)")
    print(f"{len(done)} requests, {total_new} tokens,"
          f" {total_new/wall:.1f} tok/s")

    # park the final KV cache in the polystore (int8 pages if requested)
    store = TensorPolystore(bd, PlacementPolicy(
        kv_codec="int8" if args.int8_kv else "raw"))
    cache = registry.init_cache(cfg, scfg.max_batch, scfg.cache_len, device)
    store.register_kv_cache(cfg.name, cache)
    print(f"kv cache registered in KVStore engine"
          f" (codec={'int8' if args.int8_kv else 'raw'}):",
          bd.engines["kvstore0"].list_objects())


if __name__ == "__main__":
    main()
