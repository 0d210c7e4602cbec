"""BASELINE config 5: skewed distributed pipeline + scaling efficiency.

filter → shuffle hash join → groupby over Zipf-skewed keys, hash-
partitioned across a 1-D device mesh (the pipeline of chip_smoke.py's
distributed phase). Measures the SAME per-shard workload at n_dev=1 and
n_dev=N, reporting rows/s at each plus scaling efficiency
= rate_N / (N * rate_1) (BASELINE target: >= 0.70), for the plain and
the salted join. The exchange is pipelined (num_batches=2).

Usage: python benchmarks/dist_bench.py [rows_per_shard] [n_devices]
           [--rehearse-cpu]

Runs on the GPUs by default. --rehearse-cpu runs on virtual CPU devices
instead, to check the code path; its output says "cpu" and times nothing
a user would run. Prints ONE JSON line.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REPS = 5


def bench_at(n_dev: int, rows_per_shard: int, variant: str):
    import jax

    from chip_smoke import dist_data, dist_pipeline
    from libgdf_tpu import Table
    from libgdf_tpu import parallel as par

    mesh = par.make_mesh(n_dev)
    n = rows_per_shard * n_dev
    k, v, dk, dw = dist_data(n, 100_000, seed=0)
    sf = par.distribute(Table.from_dict({"k": k, "v": v}), mesh)
    sd = par.distribute(Table.from_dict({"k": dk, "w": dw}), mesh)
    hist, _ = par.detect_skew(mesh, sf, ["k"], num_bins=max(n_dev, 2))
    skew_ratio = float(hist.max() / max(hist.mean(), 1.0))

    pipeline = dist_pipeline(mesh, sf, sd, variant)
    out = jax.block_until_ready(pipeline(sf, sd))  # compile + warm
    total = int(out.total_rows())
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(pipeline(sf, sd))
        runs.append(time.perf_counter() - t0)
    dt = float(np.median(runs))
    return dict(rows=n, secs=dt, rows_per_s=n / dt, groups_out=total,
                skew_max_over_mean=skew_ratio)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("rows_per_shard", type=int, nargs="?",
                    default=5_000_000)
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="virtual CPU devices: checks the path, times "
                         "nothing")
    args = ap.parse_args()

    import jax
    if args.rehearse_cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.n_devices)
    d = jax.devices()[0]
    if d.platform == "cpu" and not args.rehearse_cpu:
        sys.exit("dist_bench: no GPU found (use --rehearse-cpu to check "
                 "the path on virtual CPU devices)")
    from libgdf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    n_dev = min(args.n_devices, len(jax.devices()))
    out = {"metric": "dist_pipeline_zipf", "unit": "rows/s",
           "device": {"platform": d.platform, "kind": d.device_kind,
                      "count": n_dev}}
    for variant in ("plain", "salted"):
        r1 = bench_at(1, args.rows_per_shard, variant)
        rN = (bench_at(n_dev, args.rows_per_shard, variant)
              if n_dev > 1 else r1)
        out[variant] = {
            **rN, "rows_per_s_1dev": r1["rows_per_s"],
            "scaling_efficiency": rN["rows_per_s"] / (n_dev
                                                      * r1["rows_per_s"]),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
