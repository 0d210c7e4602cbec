#!/usr/bin/env python3
"""Smoke test of the engine on the card, at the sizes its users run.

Each phase builds its data from `--seed` with numpy, runs one jitted
step through the public `ops` API, times it, and compares the result
with a plain numpy reference (no pandas). Each phase prints one JSON
line: rows, compile seconds (set-up), steady seconds (median of timed
runs, each ended by `block_until_ready`), every check with its largest
difference, its tolerance and the reason for it (for a bound that
varies by element, `tol` is the bound where the difference comes closest
to it), the step's `compiled.memory_analysis()` and the device's
`peak_bytes_in_use` so far in the process. An earlier line is the card's name and power limit from
nvidia-smi; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Usage:
    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --devices 4   # four cards: the distributed
                                       # pipeline and its reference only

It exits non-zero, before printing any result, when JAX finds no GPU,
and exits non-zero after the phase lines when any check fails.

Tolerances. Integers, counts, keys, row indices, minima and maxima must
match exactly. A float32 sum is taken by XLA as a tree-shaped scan, in
another order than the float64 reference; a tree of depth d bounds its
error by (d + 1) * 2^-24 * sum(|x|) over the summed values, and the
engine's scans have d <= 2 * ceil(log2 n). The engine has no matrix
product (hashing's "matmul" is a boolean sum), so TF32 never applies.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from libgdf_tpu import Column, Table, ops
from libgdf_tpu import parallel as par
from libgdf_tpu.utils.compile_cache import enable_compile_cache

REPS = 5
F32_EPS = 2.0 ** -24


# ---------------------------------------------------------------------------
# Measurement and checks
# ---------------------------------------------------------------------------


def _memory_analysis(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: int(getattr(ma, k)) for k in dir(ma)
            if k.endswith("_in_bytes")}


def _peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _measure(step, args, reps):
    """Compile `step` for `args`, run it once, then time `reps` runs.
    Returns (outputs as numpy, timing fields)."""
    t0 = time.perf_counter()
    compiled = jax.jit(step).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        runs.append(time.perf_counter() - t0)
    fields = {"compile_s": compile_s,
              "steady_s": float(np.median(runs)) if runs else None,
              "steady_s_runs": runs,
              "memory_analysis": _memory_analysis(compiled),
              "peak_bytes_in_use": _peak_bytes()}
    return jax.tree_util.tree_map(np.asarray, out), fields


def _exact(label, got, exp, reason="integers, keys and indices"):
    got, exp = np.asarray(got), np.asarray(exp)
    if got.shape != exp.shape:
        return {"check": label, "ok": False, "max_diff": None, "tol": 0,
                "reason": f"shape {got.shape} != {exp.shape}"}
    if got.size == 0:
        diff = 0.0
    elif got.dtype == bool or exp.dtype == bool:
        diff = float(np.count_nonzero(got != exp))
    else:
        diff = float(np.max(np.abs(got.astype(np.float64)
                                   - exp.astype(np.float64))))
    return {"check": label, "ok": bool(np.array_equal(got, exp)),
            "max_diff": diff, "tol": 0, "reason": reason}


def _bounded(label, got, exp, tol, reason):
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    if got.shape != exp.shape:
        return {"check": label, "ok": False, "max_diff": None,
                "tol": None, "reason": f"shape {got.shape} != {exp.shape}"}
    tol = np.broadcast_to(np.asarray(tol, np.float64), exp.shape)
    diff = np.abs(got - exp)
    ok = bool(np.all(np.isfinite(got)) and np.all(diff <= tol))
    worst = int(np.argmax(diff / np.maximum(tol, 1e-300))) if diff.size else 0
    return {"check": label, "ok": ok,
            "max_diff": float(diff.max()) if diff.size else 0.0,
            "tol": float(tol[worst]) if diff.size else 0.0,
            "reason": reason}


def _line(phase, rows, fields, checks):
    return {"phase": phase, "rows": rows,
            "ok": all(c["ok"] for c in checks), **fields,
            "checks": checks}


def _tree_depth(n):
    return 2 * max(1, math.ceil(math.log2(max(n, 2))))


# ---------------------------------------------------------------------------
# Single-card phases
# ---------------------------------------------------------------------------


def phase_filter(n, seed=0, reps=REPS):
    """int32 column with 10% nulls: `compare_scalar` then `filter_table`."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1000, n).astype(np.int32)
    null = rng.random(n) < 0.1

    def step(a, null):
        t = Table.from_dict({"a": a}, nulls={"a": null})
        out = ops.filter_table(t, ops.compare_scalar(t["a"], 500, "lt"))
        return out["a"].data, out["a"].valid, out.num_rows

    (data, valid, count), fields = _measure(
        step, (jnp.asarray(a), jnp.asarray(null)), reps)
    keep = (a < 500) & ~null
    count = int(count)
    return _line("filter", n, fields, [
        _exact("count", count, int(keep.sum())),
        _exact("values", data[:count], a[keep]),
        _exact("valid", valid[:count], np.ones(count, bool)),
    ])


def _pair_codes(left, right, nb):
    """One int64 per (left, right) index pair, -1 allowed on either side."""
    return ((np.asarray(left, np.int64) + 1) * (nb + 1)
            + np.asarray(right, np.int64) + 1)


def _join_unique_data(n, nb, seed):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, nb, n).astype(np.int32)
    pnull = rng.random(n) < 0.05
    bk = rng.permutation(nb).astype(np.int32)
    bv = rng.standard_normal(nb).astype(np.float32)
    return pk, pnull, bk, bv


def _join_dup_data(n, nb, seed, mult=4):
    """Each build key `mult` times. Probe keys cover [0, nd); build keys
    cover [nd/10, nd + nd/10): a tenth of each side finds no match."""
    rng = np.random.default_rng(seed)
    nd = nb // mult
    off = nd // 10
    pk = rng.integers(0, nd, n).astype(np.int32)
    pnull = rng.random(n) < 0.05
    bk = np.repeat(rng.permutation(nd) + off, mult).astype(np.int32)
    bv = rng.standard_normal(nb).astype(np.float32)
    return pk, pnull, bk, bv, off


def _run_join(kind, pk, pnull, bk, bv, cap, reps, **kw):
    fn = {"inner": ops.inner_join, "left": ops.left_join,
          "full": ops.full_join}[kind]

    def step(pk, pnull, bk, bv):
        left = Table.from_dict({"k": pk}, nulls={"k": pnull})
        right = Table.from_dict({"k": bk, "w": bv})
        return fn(left, right, ["k"], ["k"], out_capacity=cap, **kw)

    args = tuple(jnp.asarray(x) for x in (pk, pnull, bk, bv))
    (li, ri, count), fields = _measure(step, args, reps)
    count = int(count)
    return li, ri, count, fields


def _join_checks(li, ri, count, exp_l, exp_r, nb):
    got = np.sort(_pair_codes(li[:count], ri[:count], nb))
    exp = np.sort(_pair_codes(exp_l, exp_r, nb))
    return [_exact("count", count, exp.size), _exact("pairs", got, exp)]


def phase_join_inner(n, nb, seed=0, reps=REPS):
    """Probe keys (5% null) against a unique build side, with the
    verified `assume_unique_build` hint."""
    pk, pnull, bk, bv = _join_unique_data(n, nb, seed)
    li, ri, count, fields = _run_join("inner", pk, pnull, bk, bv, n, reps,
                                      assume_unique_build=True)
    inv = np.empty(nb, np.int64)
    inv[bk] = np.arange(nb)
    exp_l = np.flatnonzero(~pnull)
    return _line("join_inner", n, fields, _join_checks(
        li, ri, count, exp_l, inv[pk[exp_l]], nb))


def phase_join_left(n, nb, seed=0, reps=REPS):
    """The same data, `left_join` with no hint: the runtime `lax.cond`
    between the unique and the many-to-many path is in the program."""
    pk, pnull, bk, bv = _join_unique_data(n, nb, seed)
    li, ri, count, fields = _run_join("left", pk, pnull, bk, bv, n, reps)
    inv = np.empty(nb, np.int64)
    inv[bk] = np.arange(nb)
    exp_r = np.where(pnull, -1, inv[pk])
    return _line("join_left", n, fields, _join_checks(
        li, ri, count, np.arange(n), exp_r, nb))


def _dup_matches(pk, pnull, bk, off, mult=4):
    """(left, right) pairs of the inner many-to-many join."""
    nd = bk.size // mult
    rows_by_key = np.argsort(bk, kind="stable").reshape(nd, mult)
    lm = np.flatnonzero(~pnull & (pk >= off))
    return np.repeat(lm, mult), rows_by_key[pk[lm] - off].reshape(-1)


def phase_join_dup(n, nb, seed=0, reps=REPS):
    """Each build key four times: the general many-to-many path, with
    an output capacity of 4 rows per probe row."""
    pk, pnull, bk, bv, off = _join_dup_data(n, nb, seed)
    li, ri, count, fields = _run_join("inner", pk, pnull, bk, bv, 4 * n,
                                      reps)
    exp_l, exp_r = _dup_matches(pk, pnull, bk, off)
    return _line("join_dup", n, fields, _join_checks(
        li, ri, count, exp_l, exp_r, nb))


def phase_join_full(n, nb, seed=0, reps=REPS):
    """The many-to-many data, `how="full"`: unmatched probe rows and
    unmatched build rows (found by the reverse cummin) are emitted too."""
    pk, pnull, bk, bv, off = _join_dup_data(n, nb, seed)
    li, ri, count, fields = _run_join("full", pk, pnull, bk, bv, 4 * n,
                                      reps)
    ml, mr = _dup_matches(pk, pnull, bk, off)
    lonely_l = np.flatnonzero(pnull | (pk < off))
    present = np.zeros(int(bk.max()) + 1, bool)
    present[pk[~pnull]] = True
    lonely_r = np.flatnonzero(~present[bk])
    exp_l = np.concatenate([ml, lonely_l, np.full(lonely_r.size, -1)])
    exp_r = np.concatenate([mr, np.full(lonely_l.size, -1), lonely_r])
    return _line("join_full", n, fields, _join_checks(
        li, ri, count, exp_l, exp_r, nb))


def phase_groupby(n, ngroups, seed=0, reps=REPS):
    """int64 keys, float32 values: sum, count, avg, min and max."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, ngroups, n).astype(np.int64)
    v = rng.standard_normal(n).astype(np.float32)
    aggs = [("v", "sum", "s"), ("v", "count", "c"), ("v", "avg", "m"),
            ("v", "min", "lo"), ("v", "max", "hi")]

    def step(k, v):
        out = ops.groupby(Table.from_dict({"k": k, "v": v}), ["k"], aggs)
        return (out["k"].data, out["s"].data, out["c"].data,
                out["m"].data, out["lo"].data, out["hi"].data,
                out.num_rows)

    outs, fields = _measure(step, (jnp.asarray(k), jnp.asarray(v)), reps)
    g = int(outs[-1])
    order = np.argsort(outs[0][:g])
    gk, gs, gc, gm, glo, ghi = (x[:g][order] for x in outs[:-1])

    srt = np.argsort(k, kind="stable")
    ks, vs = k[srt], v[srt]
    keys, starts, counts = np.unique(ks, return_index=True,
                                     return_counts=True)
    sums = np.add.reduceat(vs.astype(np.float64), starts)
    abs_sums = np.add.reduceat(np.abs(vs.astype(np.float64)), starts)
    tol = (_tree_depth(n) + 1) * F32_EPS * abs_sums
    reason = ("float32 tree-order sum: (2*ceil(log2 n) + 1) * 2^-24 * "
              "sum|v| per group")
    return _line("groupby", n, fields, [
        _exact("groups", g, keys.size),
        _exact("keys", gk, keys),
        _exact("count", gc, counts),
        _exact("min", glo, np.minimum.reduceat(vs, starts),
               "min of stored float32 values"),
        _exact("max", ghi, np.maximum.reduceat(vs, starts),
               "max of stored float32 values"),
        _bounded("sum", gs, sums, tol, reason),
        _bounded("avg", gm, sums / counts,
                 tol / counts + 2.0 ** -50 * np.abs(sums / counts),
                 reason + ", over the exact count"),
    ])


def phase_orderby(n, seed=0, reps=REPS):
    """(int64 in [0, 2^40), float32 with 2% nulls), both descending, nulls
    last. Ties are allowed, so the sorted key columns are compared, not
    the permutation."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 40, n).astype(np.int64)
    b = rng.standard_normal(n).astype(np.float32)
    bnull = rng.random(n) < 0.02

    def step(a, b, bnull):
        t = Table.from_dict({"a": a, "b": b}, nulls={"b": bnull})
        return ops.order_by(t, ["a", "b"], ascending=[False, False],
                            nulls_last=True)

    perm, fields = _measure(
        step, (jnp.asarray(a), jnp.asarray(b), jnp.asarray(bnull)), reps)
    seen = np.zeros(n, bool)
    seen[perm] = True
    bz = np.where(bnull, np.float32(0), b)
    ref = np.lexsort((np.where(bnull, np.inf, -b.astype(np.float64)), -a))
    return _line("orderby", n, fields, [
        _exact("is_permutation", seen, np.ones(n, bool)),
        _exact("a", a[perm], a[ref]),
        _exact("b_null", bnull[perm], bnull[ref]),
        _exact("b", bz[perm], bz[ref], "sorted float32 values"),
    ])


def phase_window(n, nparts, preceding=10, seed=0, reps=REPS):
    """A ROWS-frame sum over `preceding` rows per partition, in the
    order of a second column, and the exact 64-bit prefix sum."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, nparts, n).astype(np.int32)
    o = rng.permutation(n).astype(np.int32)
    # Values on a 2^-10 grid below 2^13: every float64 partial sum is
    # exact in any order, so the window sums must match exactly.
    vi = np.clip(np.round(rng.standard_normal(n) * 1024),
                 -(1 << 22), 1 << 22).astype(np.int64)
    v = (vi / 1024.0).astype(np.float32)
    x = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)

    def step(p, o, v, x):
        t = Table.from_dict({"p": p, "o": o, "v": v})
        w = ops.window_function(t, "v", "sum", preceding=preceding,
                                partition_by=["p"], order_by=["o"])
        cs = ops.prefixsum(Column.from_array(x))
        return w.data, w.valid, cs.data

    (wsum, wvalid, cs), fields = _measure(
        step, tuple(jnp.asarray(y) for y in (p, o, v, x)), reps)

    order = np.lexsort((o, p))
    ps = p[order]
    idx = np.arange(n)
    starts = np.concatenate([[True], ps[1:] != ps[:-1]])
    first = np.maximum.accumulate(np.where(starts, idx, 0))
    lo = np.maximum(first, idx - (preceding - 1))
    csum = np.concatenate([[0], np.cumsum(vi[order])])
    ref = np.empty(n, np.float64)
    ref[order] = (csum[idx + 1] - csum[lo]) / 1024.0
    return _line("window", n, fields, [
        _exact("rows_sum", wsum, ref,
               "values on a 2^-10 grid: float64 sums are exact"),
        _exact("rows_sum_valid", wvalid, np.ones(n, bool)),
        _exact("cumsum_int64", cs, np.cumsum(x)),
    ])


def single_card_phases(seed):
    """Every single-card phase at the sizes the smoke runs."""
    n, nb = 10_000_000, 1_000_000
    yield phase_filter(n, seed)
    yield phase_join_inner(n, nb, seed)
    yield phase_join_left(n, nb, seed)
    yield phase_join_dup(n, nb, seed)
    yield phase_join_full(n, nb, seed)
    yield phase_groupby(n, 100_000, seed)
    yield phase_window(n, 100_000, seed=seed)
    yield phase_orderby(50_000_000, seed)


# ---------------------------------------------------------------------------
# The distributed pipeline
# ---------------------------------------------------------------------------


def dist_data(n, ndim, seed):
    """Zipf(1.3)-skewed fact keys, uniform unique dimension keys."""
    rng = np.random.default_rng(seed)
    k = rng.zipf(1.3, n).astype(np.int64) % ndim
    v = rng.standard_normal(n).astype(np.float32)
    dk = np.arange(ndim, dtype=np.int64)
    dw = rng.random(ndim).astype(np.float32)
    return k, v, dk, dw


DIST_AGGS = [("v", "sum", "s"), ("v", "count", "c")]


def _dist_filter(local):
    return ops.filter_table(local, ops.compare_scalar(local["v"], -1.0,
                                                      "gt"))


def dist_pipeline(mesh, sf, sd, variant, num_batches=2):
    """filter -> shuffle join -> groupby over the mesh. Exchange and
    output capacities are sized eagerly (exactly, so no row can be
    dropped); returns the jitted pipeline over (sf, sd)."""
    rows_per_shard = sf.capacity // mesh.size
    if variant == "salted":
        plan = par.plan_salted_join(
            mesh, par.map_shards(mesh, _dist_filter, sf), sd, ["k"], ["k"],
            how="inner", threshold=3.0)

        def front(sf, sd):
            filtered = par.map_shards(mesh, _dist_filter, sf)
            return par.dist_join_salted(mesh, filtered, sd, ["k"], ["k"],
                                        plan=plan)
    else:
        slot_join = par.exact_slot_capacity(
            mesh, [(sf, ["k"]), (sd, ["k"])], num_batches=num_batches)

        def front(sf, sd):
            filtered = par.map_shards(mesh, _dist_filter, sf)
            return par.dist_join(
                mesh, filtered, sd, ["k"], ["k"], how="inner",
                slot_capacity=slot_join,
                out_capacity_per_shard=4 * rows_per_shard,
                num_batches=num_batches)

    # The groupby exchange's input is the join output: size its slots
    # from one eager run of the join.
    slot_gb = par.exact_groupby_slot_capacity(
        mesh, front(sf, sd), ["k"], DIST_AGGS, num_batches=num_batches)

    @jax.jit
    def pipeline(sf, sd):
        return par.dist_groupby(mesh, front(sf, sd), ["k"], DIST_AGGS,
                                slot_capacity=slot_gb,
                                num_batches=num_batches)
    return pipeline


def phase_dist(n_dev, rows_per_shard, ndim=100_000, seed=0, reps=REPS):
    """The Zipf pipeline, plain and salted, on `n_dev` devices. Group
    sums and counts are checked against numpy and against each other."""
    mesh = par.make_mesh(n_dev)
    n = rows_per_shard * n_dev
    k, v, dk, dw = dist_data(n, ndim, seed)
    sf = par.distribute(Table.from_dict({"k": k, "v": v}), mesh)
    sd = par.distribute(Table.from_dict({"k": dk, "w": dw}), mesh)

    keep = v > -1.0
    counts = np.bincount(k[keep], minlength=ndim)
    sums = np.bincount(k[keep], weights=v[keep].astype(np.float64),
                       minlength=ndim)
    abs_sums = np.bincount(k[keep], weights=np.abs(v[keep]).astype(
        np.float64), minlength=ndim)
    present = np.flatnonzero(counts)
    # per-shard pre-aggregation, then the merge after the exchange: two
    # tree scans in sequence
    tol = (2 * _tree_depth(n) + 1) * F32_EPS * abs_sums[present]
    reason = ("float32 sums through two tree-order scans (pre-aggregation "
              "and merge): (4*ceil(log2 n) + 1) * 2^-24 * sum|v| per group")

    lines, results = [], {}
    for variant in ("plain", "salted"):
        pipeline = dist_pipeline(mesh, sf, sd, variant)
        out, fields = _measure(pipeline, (sf, sd), reps)
        host = par.collect(out)
        gk = np.asarray(host["k"].data)
        order = np.argsort(gk)
        gk, gs, gc = (gk[order], np.asarray(host["s"].data)[order],
                      np.asarray(host["c"].data)[order])
        results[variant] = (gs, gc)
        lines.append(_line(f"dist_{variant}", n, {"devices": n_dev,
                                                  **fields}, [
            _exact("keys", gk, present),
            _exact("count", gc, counts[present]),
            _bounded("sum", gs, sums[present], tol, reason),
        ]))
    (ps, pc), (ss, sc) = results["plain"], results["salted"]
    if ps.shape == ss.shape:
        lines.append(_line("dist_plain_vs_salted", n, {"devices": n_dev}, [
            _exact("count", pc, sc),
            _bounded("sum", ps, ss, 2 * tol, "both sides' bounds added"),
        ]))
    else:
        lines.append(_line("dist_plain_vs_salted", n, {"devices": n_dev}, [
            _exact("groups", ps.size, ss.size)]))
    return lines


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def card_info() -> str:
    """nvidia-smi's name and power limit of each card, read by a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the distributed pipeline, on four "
                         "cards")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    if len(devices) < args.devices:
        print(f"chip_smoke: needs {args.devices} GPUs, JAX found "
              f"{len(devices)}", file=sys.stderr)
        return 2
    enable_compile_cache()
    print(card_info(), flush=True)

    if args.devices == 1:
        lines = single_card_phases(args.seed)
    else:
        lines = phase_dist(args.devices, 5_000_000, seed=args.seed)
    failed = []
    for line in lines:
        print(json.dumps(line), flush=True)
        if not line["ok"]:
            failed.append(line["phase"])
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
