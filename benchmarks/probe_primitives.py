"""Time the XLA primitives the engine is built from, on the card.

Copy, scans, sorts, gathers, scatters and the two plain forms of stream
compaction, each at sizes past the H100's 50 MB L2. Every line names
the device and gives the median of timed runs, each ended by
`block_until_ready`, with the bytes the primitive must move over the
time. Refuses to run on a CPU.

Usage: python benchmarks/probe_primitives.py
"""
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPS = 10


def timeit(fn, *args):
    out = jax.block_until_ready(fn(*args))  # compile + warm
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - t0)
    del out
    return float(np.median(runs))


def report(device, name, n, dt, nbytes):
    print(json.dumps({
        "probe": name, "n": n, "median_s": dt,
        "GB_per_s": nbytes / dt / 1e9, "Grows_per_s": n / dt / 1e9,
        "device": device}), flush=True)


def main():
    d = jax.devices()[0]
    if d.platform == "cpu":
        sys.exit("probe_primitives: refuses to run on a CPU")
    device = {"platform": d.platform, "kind": d.device_kind,
              "count": len(jax.devices())}
    rng = np.random.default_rng(0)
    big = [1 << 24, 1 << 26]

    for n in big:
        x = jnp.asarray(rng.integers(0, 1 << 30, n).astype(np.int32))
        report(device, "copy_add1_i32", n,
               timeit(jax.jit(lambda x: x + 1), x), 2 * 4 * n)

    for n in big:
        for dt_ in (np.int32, np.int64, np.float64):
            x = jnp.asarray(rng.integers(0, 4, n).astype(dt_))
            report(device, f"cumsum_{np.dtype(dt_).name}", n,
                   timeit(jax.jit(jnp.cumsum), x),
                   2 * np.dtype(dt_).itemsize * n)
        f = jnp.asarray(rng.random(n) < 0.01)
        v = jnp.asarray(rng.standard_normal(n).astype(np.float32))

        def seg_sum(f, v):
            def comb(a, b):
                return a[0] | b[0], jnp.where(b[0], b[1], a[1] + b[1])
            return jax.lax.associative_scan(comb, (f, v))[1]
        report(device, "seg_scan_sum_f32", n, timeit(jax.jit(seg_sum), f, v),
               2 * 4 * n + n)

    for n in big:
        k64 = jnp.asarray(rng.integers(0, 1 << 62, n).astype(np.uint64))
        report(device, "sort_u64_1op", n,
               timeit(jax.jit(lambda k: jax.lax.sort(k)), k64), 2 * 8 * n)
        k32 = jnp.asarray(rng.integers(0, 1 << 30, n).astype(np.int32))
        report(device, "sort_i32_kv", n,
               timeit(jax.jit(lambda k: jax.lax.sort((k, k), num_keys=1)),
                      k32), 4 * 4 * n)
        report(device, "sort_u64_2op", n,
               timeit(jax.jit(lambda a, b: jax.lax.sort(
                   (a, b), num_keys=2, is_stable=False)), k64, k64),
               4 * 8 * n)

    for n in big:
        x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        idx = jnp.asarray(rng.integers(0, n, n).astype(np.int32))
        take = jax.jit(lambda x, i: jnp.take(x, i))
        report(device, "gather_random_f32", n, timeit(take, x, idx),
               3 * 4 * n)
        report(device, "gather_sorted_f32", n,
               timeit(take, x, jnp.sort(idx)), 3 * 4 * n)
        perm = jnp.asarray(rng.permutation(n).astype(np.int32))
        scat = jax.jit(lambda x, i: jnp.zeros_like(x).at[i].set(
            x, unique_indices=True))
        report(device, "scatter_perm_f32", n, timeit(scat, x, perm),
               3 * 4 * n)
        seg = jnp.asarray(rng.integers(0, 100_000, n).astype(np.int32))
        sadd = jax.jit(lambda x, s: jnp.zeros((100_000,), x.dtype).at[
            s].add(x))
        report(device, "scatter_add_100k_f32", n, timeit(sadd, x, seg),
               2 * 4 * n)

    # stream compaction of 3 int32 payloads: the fused 1-byte-key payload
    # sort against a prefix sum of `keep` and a dropping scatter
    for n in big:
        cols = [jnp.asarray(rng.integers(0, 1 << 30, n).astype(np.int32))
                for _ in range(3)]
        keep = jnp.asarray(rng.random(n) < 0.5)

        def by_sort(keep, *cols):
            drop = jnp.logical_not(keep).astype(jnp.uint8)
            return jax.lax.sort((drop,) + cols, num_keys=1)[1:]

        def by_scatter(keep, *cols):
            pos = jnp.cumsum(keep, dtype=jnp.int32) - 1
            dst = jnp.where(keep, pos, n)
            return [jnp.zeros_like(c).at[dst].set(c, mode="drop")
                    for c in cols]
        nbytes = n + 2 * 3 * 4 * n
        report(device, "compact3_by_sort", n,
               timeit(jax.jit(by_sort), keep, *cols), nbytes)
        report(device, "compact3_by_scatter", n,
               timeit(jax.jit(by_scatter), keep, *cols), nbytes)


if __name__ == "__main__":
    main()
