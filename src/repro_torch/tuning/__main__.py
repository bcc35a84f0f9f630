"""CLI: ``python -m repro_torch.tuning [--quick] [--shards] [--out PATH] [--device DEV]``.

Runs :func:`repro_torch.tuning.calibrate` on the card (or the device named)
and writes the resulting TuningTable JSON.  ``--default`` writes the
shipped table instead: it was made on an H100 with
``python -m repro_torch.tuning --default --n 65536 --m 8388608``.
"""
from __future__ import annotations

import argparse
import time

from .measure import calibrate
from .table import _DEFAULT_PATH


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning", description=__doc__.splitlines()[0]
    )
    ap.add_argument("--quick", action="store_true", help="small grids, no tile sweep")
    ap.add_argument("--out", default="tuning_table.json", help="output path")
    ap.add_argument("--n", type=int, default=2048, help="calibration |V|")
    ap.add_argument("--m", type=int, default=16384, help="calibration |E| drawn")
    ap.add_argument("--reps", type=int, default=3, help="timing repetitions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--shards", action="store_true",
                    help="include the shard-count sweep (distinct devices only)")
    ap.add_argument(
        "--default",
        action="store_true",
        help=f"write to the shipped table path ({_DEFAULT_PATH})",
    )
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    table = calibrate(
        n=args.n, m=args.m, quick=args.quick, seed=args.seed, reps=args.reps,
        device=args.device, shards=args.shards,
    )
    table.to_dict()["created"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    out = _DEFAULT_PATH if args.default else args.out
    table.save(out)
    secs = time.perf_counter() - t0

    print(f"calibrated in {secs:.1f}s on {table.host_key} -> {out}")
    for backend in table.backends():
        d = table.decide(backend)
        print(
            f"  {backend}: crossover d*={d.crossover_density:.4g} "
            f"(dense_frac={d.dense_frac:.3g}), chunk_blocks={d.chunk_blocks}, "
            f"auto_sparse={d.auto_sparse}, auto_sparse_batched={d.auto_sparse_batched}, "
            f"batched_flavor_crossover={d.batched_flavor_crossover}, "
            f"max_batch={d.max_batch}, tile_blocks={d.tile_blocks}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
