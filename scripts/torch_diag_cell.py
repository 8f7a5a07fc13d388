"""Per-op diagnosis of one dry-run cell: the top collectives by link bytes
and the top tight-HBM-byte ops by aten op and calling line. Twin of
``scripts/diag_cell.py``.

    PYTHONPATH=src python scripts/torch_diag_cell.py --arch qwen2-1.5b \
        --shape train_4k --profile sp [--machine gpu-superpod] \
        [--override n_layers=2]

The cell is traced once on a fake world of the machine's size
(``launch.dryrun._trace``): the collective recorder gives each
collective's op, mesh axis, group size and result bytes; the op-cost
recorder (``launch/op_cost.py``, with call sites) each local op's tight
bytes. The totals are also given in seconds at the machine's own
capacities (``MachineSpec.link_bw``, and the slowest leaf's ``hbm_bw``).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import configs                            # noqa: E402
from repro_torch.core import machine as machine_lib        # noqa: E402
from repro_torch.launch import mesh as mesh_lib            # noqa: E402
from repro_torch.launch import op_cost                     # noqa: E402
from repro_torch.launch.collectives import _link_bytes     # noqa: E402
from repro_torch.launch.dryrun import _trace               # noqa: E402


def collective_rows(records):
    """``[(link bytes, count, op, axis, group size, result bytes)]`` of a
    collective recorder's records, one row per distinct (op, axis, group
    size, result bytes), largest link bytes first."""
    rows = {}
    for r in records:
        s = int(r["groups"].shape[1])
        key = (r["op"], r["axis"], s, int(r["bytes"]))
        link, _ = _link_bytes(r["op"], r["bytes"], s)
        total, n = rows.get(key, (0.0, 0))
        rows[key] = (total + link, n + 1)
    return sorted(((v[0], v[1]) + k for k, v in rows.items()), reverse=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--profile", default="2d")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--machine", default=None,
                    help="machine-model preset (overrides --multi-pod)")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=")
        overrides[k] = int(v)

    spec = (machine_lib.resolve(args.machine)
            or mesh_lib.production_machine(args.multi_pod))
    arch = configs.get(args.arch)
    with mesh_lib.fake_world(spec.n_devices):
        mesh = mesh_lib.make_machine_mesh(spec)
        _, cost, rec = _trace(arch, arch.shapes[args.shape], mesh, overrides,
                              profile=args.profile,
                              cost=op_cost.OpCostRecorder(call_sites=True))
    link_bw = spec.link_bw
    hbm_bw = float(spec.hbm_bw.min())

    rows = collective_rows(rec.records)
    print(f"\n== top collectives (link bytes, {spec.name}) ==")
    for link, n, op, axis, s, nbytes in rows[: args.top]:
        print(f"{link:.2e} x{n:<5d} {op:<15} {axis or '-':<12} gs={s:<4d} "
              f"result {nbytes:.2e} B")
    coll = sum(r[0] for r in rows)
    print(f"total coll: {coll:.3e} -> {coll / link_bw:.3g}s "
          f"at {link_bw:.3g} B/s")

    print("\n== top HBM bytes (tight set), by aten op and call site ==")
    for (name, site), row in cost.top_sites("bytes_tight", args.top):
        if not row["bytes_tight"]:
            break
        print(f"{row['bytes_tight']:.2e} x{int(row['count']):<5d} "
              f"{name:<22} {site}")
    tight = cost.totals["bytes_tight"]
    print(f"total tight: {tight:.3e} -> {tight / hbm_bw:.3g}s "
          f"at {hbm_bw:.3g} B/s")
    if cost.unclassified:
        print(f"unclassified ops (bytes only): {cost.unclassified}")


if __name__ == "__main__":
    main()
