"""Beyond-paper study on the PyTorch port: price a real training step's
collective traffic on the paper's three fabrics, bound it on the H100, and
pick collective schedules with the WiMCS cost model.

Reads the port's dry-run rows (``python -m repro_torch.launch.dryrun
--json PATH``) when ``--json`` names them, else dry-runs one cell live on
a fake process group of 512 ranks (``--arch``, ``train_4k``, the 16 x 16
pod; nothing is allocated on the device): the bridge between the paper's
evaluation axes (energy / latency / bandwidth) and modern ML workloads.

``--collectives`` also prints each cell's collective sequence grouped by
op, group size and rank stride (calls, payload and wire bytes a device).

Run:  PYTHONPATH=src python examples/torch_interconnect_study.py \
          [--json rows.json] [--arch granite-8b] [--device cpu] \
          [--collectives]
"""
import argparse
import json

from repro_torch.interconnect.fabric import report_all
from repro_torch.interconnect.scheduler import choose_schedule


def live_rows(arch: str, device) -> list:
    """One dry-run cell, ``arch`` x ``train_4k`` on the 16 x 16 pod."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun, mesh
    mesh.init_fake(512)
    try:
        (name, m), = dryrun.make_meshes("pod1", device)
        row = dryrun.run_cell(get_config(arch), SHAPES["train_4k"], m, name,
                              device=device, seq_shard_decode=True)
    finally:
        mesh.shutdown()
    if row["status"] != "OK":
        raise SystemExit(f"{arch}: {row['status']}\n"
                         f"{row.get('traceback', '')}")
    return [row]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None,
                    help="the dry run's rows (its --json output)")
    ap.add_argument("--arch", default="granite-8b",
                    help="the cell to dry-run when no --json is given")
    ap.add_argument("--device", default=None,
                    help="the meshes' device type (default: the card)")
    ap.add_argument("--collectives", action="store_true",
                    help="print each cell's collectives by op and group")
    args = ap.parse_args(argv)

    if args.json:
        with open(args.json) as f:
            rows = [r for r in json.load(f)
                    if r.get("status") == "OK" and r["shape"] == "train_4k"
                    and r["mesh"].startswith("pod1")]
    else:
        rows = live_rows(args.arch, args.device)

    print(f"{'arch':24s} {'wire GB/dev':>12s} {'ICI mJ':>10s} "
          f"{'DCN mJ':>10s} {'wireless mJ':>12s} {'H100 tc ms':>11s} "
          f"{'tm ms':>9s} {'tx ms':>9s} {'bound':>11s}")
    for r in rows:
        reps = {rep.fabric: rep for rep in
                report_all(r["coll_bytes_per_dev"], 256)}
        print(f"{r['arch']:24s} {r['coll_bytes_per_dev'] / 1e9:12.1f} "
              f"{reps['ici_wireline'].energy_mj:10.1f} "
              f"{reps['dcn_serial'].energy_mj:10.1f} "
              f"{reps['wireless_inpackage'].energy_mj:12.1f} "
              f"{r['t_compute_ms']:11.2f} {r['t_memory_ms']:9.2f} "
              f"{r['t_collective_ms']:9.2f} {r['bottleneck']:>11s}")

    if args.collectives:
        for r in rows:
            print(f"\n{r['arch']} collectives: op, group size, stride: "
                  "calls, payload GB, wire GB a device")
            for key, (n, payload, wire) in sorted(
                    r.get("calls_by_group", {}).items(),
                    key=lambda kv: -kv[1][2]):
                print(f"  {key:40s} {n:6d} {payload / 1e9:10.3f} "
                      f"{wire / 1e9:10.3f}")

    print("\nSchedule the WiMCS cost model picks for a 1 GB gradient "
          "all-reduce:")
    for g_fast, g_slow in [(16, 1), (256, 1), (256, 2)]:
        print(f"  {g_fast}x{g_slow}: {choose_schedule(1e9, g_fast, g_slow)}")
    print("\nThe hierarchical (WI-per-cluster) schedule wins once a slow pod "
          "axis exists: the paper's topology insight on a fleet of pods.")


if __name__ == "__main__":
    main()
