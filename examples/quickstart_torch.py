"""Quickstart on the PyTorch port (twin of ``examples/quickstart.py``):
stand up the BigDAWG-style polystore, load the synthetic MIMIC-II demo,
and run the paper's §VI example queries.

  python examples/quickstart_torch.py                 # on the GPU
  python examples/quickstart_torch.py --device cpu
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.api import default_deployment      # noqa: E402
from repro_torch.data.mimic import load_mimic_demo       # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of the deployment (default: the GPU)")
    args = ap.parse_args(argv)
    bd = default_deployment(device=args.device)
    load_mimic_demo(bd)
    print("engines:", ", ".join(sorted(bd.engines)))

    print("\n-- relational island (paper §VI-b) --")
    r = bd.query("bdrel(select * from mimic2v26.d_patients limit 4)")
    for i in range(r.value.num_rows):
        print("  ", {k: int(v[i]) for k, v in r.value.columns.items()})

    print("\n-- array island (paper §VI-c) --")
    r = bd.query("bdarray(filter(myarray, dim1>150))")
    print(f"   {int(r.value.mask().sum())} cells pass the filter")

    print("\n-- text island (paper §VI-d) --")
    r = bd.query("bdtext({ 'op' : 'range', 'table' : 'mimic_logs',"
                 " 'range' : { 'start' : ['r_0001','',''],"
                 " 'end' : ['r_0015','',''] } })")
    print(f"   {len(r.value)} rows;  first: {r.value[0]}")

    print("\n-- inter-island cast (paper §VI-e) --")
    q = ("bdarray(scan(bdcast(bdrel(select poe_id, subject_id from"
         " mimic2v26.poe_order), poe_order_copy,"
         " '<subject_id:int32>[poe_id=0:*,10000000,0]', array)))")
    r = bd.query(q, training=True)
    print(f"   considered {r.plans_considered} plans; best: {r.qep_id}")
    for name, s in r.stages:
        print(f"   {name:36s} {s*1e3:8.2f} ms")

    print("\n-- catalog (paper §V.A) --")
    r = bd.query("bdcatalog(select name, connection_properties"
                 " from engines)")
    for row in r.value:
        print("  ", row)


if __name__ == "__main__":
    main()
