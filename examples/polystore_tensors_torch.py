"""Model state as polystore objects on the PyTorch port (twin of
``examples/polystore_tensors.py``): parameters, optimizer moments and KV
caches with engine placement policies, moved only through Migrator
casts, including the int8 quant cast, and a BQL look at the resulting
catalog.

  python examples/polystore_tensors_torch.py                # on the GPU
  python examples/polystore_tensors_torch.py --device cpu   # on the CPU
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch                                                 # noqa: E402

from repro_torch import _tree                                # noqa: E402
from repro_torch.core.api import default_deployment          # noqa: E402
from repro_torch.core.tensorstore import (PlacementPolicy,   # noqa: E402
                                          TensorPolystore)
from repro_torch.models import registry                      # noqa: E402
from repro_torch.optim import adamw                          # noqa: E402
from repro_torch.train.step import init_train_state          # noqa: E402


def main(argv=None, params=None) -> None:
    """``params``: the model's parameter tree (float32); drawn from seed
    0 when None."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device to hold the state on (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = registry.get_config("olmoe-1b-7b", reduced=True)
    device = default_deployment(device=args.device).device
    if params is None:
        state = init_train_state(cfg, device=device)
    else:
        state = {"params": params, "opt": adamw.init_state(params)}
    state["opt"]["v"] = _tree.tree_map(
        lambda p: torch.abs(p.float()) * 0.02, state["params"])

    for moments in ("resident", "offload", "compressed"):
        bd = default_deployment(device=device)
        store = TensorPolystore(bd, PlacementPolicy(moments=moments))
        store.register_train_state(cfg.name, state)
        back = store.fetch_train_state(cfg.name)
        v0 = _tree.tree_leaves(state["opt"]["v"])[0]
        v1 = _tree.tree_leaves(back["opt"]["v"])[0]
        err = float((v0.to(v1.device) - v1).abs().max())
        engine = {"resident": "densehbm0", "offload": "hoststore0",
                  "compressed": "kvstore0"}[moments]
        stored = bd.engines[engine].list_objects()
        print(f"policy={moments:10s} -> moments engine={engine:10s} "
              f"roundtrip_err={err:.2e} objects={stored[:2]}...")

    print("\ncatalog view of the last deployment:")
    for row in bd.query("bdcatalog(select name, physical_db"
                        " from objects)").value:
        print("  ", row)


if __name__ == "__main__":
    main()
