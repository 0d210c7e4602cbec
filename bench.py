"""Benchmark runner — BASELINE.json single-card configs.

Runs each cell once per process, in turn, and prints one JSON line per
cell: rows/s, seconds (median of timed runs, each ended by
`block_until_ready`), compile seconds (set-up), and the cell's rate
against its target, memory-bandwidth roofline / 1.3 (BASELINE.md), where
the roofline moves the cell's minimal input+output bytes per row at the
card's published memory bandwidth. The last line is the geometric mean
of the four headline cells. Every line names the device. Refuses to run
on a CPU; a device missing from PEAK_BYTES_PER_S is an error.

Usage: python bench.py [cell ...]     (default: every cell)
"""
import json
import sys
import time

import numpy as np

# Published memory bandwidth per device_kind (NVIDIA H100 data sheet,
# SXM part: 80 GB of HBM3 at 3.35 TB/s).
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

REPS = 10

# name -> (roofline min bytes/row, rows)
CONFIGS = {
    "filter_1M": (9, 1_000_000),
    "orderby_50M": (24, 50_000_000),
    "join_10Mx1M": (16, 10_000_000),
    "groupby_10M": (24, 10_000_000),
}

# BASELINE config 3 also mandates the LEFT join and the duplicate-key
# (many-to-many, general-path) join at 10M x 1M. They are measured every
# run but kept out of the headline geomean. Neither uses the
# assume_unique_build hint: both compile the runtime lax.cond dual-path
# join — the shape most users hit.
EXTRA_CONFIGS = {
    "leftjoin_10Mx1M": (16, 10_000_000),
    "join_dup_10Mx1M": (16, 10_000_000),
}


def peak_bytes_per_s(device_kind: str) -> float:
    """The device's published memory bandwidth; unknown devices raise."""
    try:
        return PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind "
            f"{device_kind!r}; add it to bench.PEAK_BYTES_PER_S") from None


def _time(fn, *args):
    """(median steady seconds, compile+first-run seconds)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - t0)
    return float(np.median(runs)), compile_s


def run_cell(name, n):
    """Build one cell's data and jitted step; return (secs, compile_s)."""
    import jax
    import jax.numpy as jnp

    from libgdf_tpu import Table, ops

    rng = np.random.default_rng(0)

    if name == "filter_1M":
        a = jnp.asarray(rng.integers(0, 1000, n).astype(np.int32))
        nullm = jnp.asarray(rng.random(n) < 0.1)

        @jax.jit
        def run(a, nullm):
            t = Table.from_dict({"a": a}, nulls={"a": nullm})
            stencil = ops.compare_scalar(t["a"], 500, "lt")
            out = ops.filter_table(t, stencil)
            return out["a"].data, out.num_rows

        return _time(run, a, nullm)

    if name == "groupby_10M":
        k = jnp.asarray(rng.integers(0, 100_000, n).astype(np.int64))
        v = jnp.asarray(rng.standard_normal(n).astype(np.float32))

        @jax.jit
        def run(k, v):
            t = Table.from_dict({"k": k, "v": v})
            out = ops.groupby(t, ["k"], [("v", "sum", "s"),
                                         ("v", "count", "n"),
                                         ("v", "avg", "m")])
            return out["s"].data, out.num_rows

        return _time(run, k, v)

    if name in ("join_10Mx1M", "leftjoin_10Mx1M", "join_dup_10Mx1M"):
        nb = 1_000_000
        # join_dup: every build key appears `mult` times, so each matched
        # probe row emits `mult` output rows through the general
        # many-to-many path; rows/s counts PROBE rows.
        mult = 4 if name == "join_dup_10Mx1M" else 1
        ndistinct = nb // mult
        pk = jnp.asarray(rng.integers(0, ndistinct, n).astype(np.int32))
        pnull = jnp.asarray(rng.random(n) < 0.05)
        bk = jnp.asarray(np.repeat(
            rng.permutation(ndistinct), mult).astype(np.int32))
        bv = jnp.asarray(rng.standard_normal(nb).astype(np.float32))
        # join_10Mx1M: the build side is a key permutation (PK-FK), so it
        # uses the verified planner hint (the count poisons to -1 if the
        # hint is violated). leftjoin: one row per live probe row.
        fn, kw = {
            "join_10Mx1M": (ops.inner_join, dict(
                out_capacity=n, assume_unique_build=True)),
            "leftjoin_10Mx1M": (ops.left_join, dict(out_capacity=n)),
            "join_dup_10Mx1M": (ops.inner_join,
                                dict(out_capacity=n * mult)),
        }[name]

        @jax.jit
        def run(pk, pnull, bk, bv):
            left = Table.from_dict({"k": pk}, nulls={"k": pnull})
            right = Table.from_dict({"k": bk, "w": bv})
            return fn(left, right, ["k"], ["k"], **kw)

        return _time(run, pk, pnull, bk, bv)

    if name == "orderby_50M":
        k1 = jnp.asarray(rng.integers(0, 1 << 40, n).astype(np.int64))
        k2 = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        k2null = jnp.asarray(rng.random(n) < 0.02)

        @jax.jit
        def run(k1, k2, k2null):
            t = Table.from_dict({"a": k1, "b": k2}, nulls={"b": k2null})
            return ops.order_by(t, ["a", "b"], ascending=[False, False],
                                nulls_last=True)

        return _time(run, k1, k2, k2null)

    raise SystemExit(f"unknown cell {name}")


def main(argv):
    import jax

    from libgdf_tpu.utils.compile_cache import enable_compile_cache

    d = jax.devices()[0]
    if d.platform == "cpu":
        sys.exit("bench.py: refuses to run on a CPU")
    device = {"platform": d.platform, "kind": d.device_kind,
              "count": len(jax.devices())}
    peak = peak_bytes_per_s(d.device_kind)
    enable_compile_cache()

    cells = {**CONFIGS, **EXTRA_CONFIGS}
    names = argv or list(cells)
    results = {}
    for name in names:
        bpr, n = cells[name]
        secs, compile_s = run_cell(name, n)
        target = peak / bpr / 1.3
        results[name] = dict(cell=name, rows=n, secs=secs,
                             rows_per_s=n / secs, compile_s=compile_s,
                             min_bytes_per_row=bpr,
                             target_rows_per_s=target,
                             vs_target=n / secs / target, device=device)
        print(json.dumps(results[name]), flush=True)

    if all(name in results for name in CONFIGS):
        rates = [results[n]["rows_per_s"] for n in CONFIGS]
        ratios = [results[n]["vs_target"] for n in CONFIGS]
        print(json.dumps({
            "metric": "single_chip_operator_geomean",
            "value": float(np.exp(np.mean(np.log(rates)))),
            "unit": "rows/s",
            "vs_baseline": float(np.exp(np.mean(np.log(ratios)))),
            "device": device,
        }))


if __name__ == "__main__":
    main(sys.argv[1:])
