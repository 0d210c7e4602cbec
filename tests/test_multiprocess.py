"""Real multi-process execution: 2 jax.distributed processes x 4 CPU
devices, one mesh spanning both, dist_groupby validated per-process
(tests/mp_worker.py). This is the multi-host path (init_distributed →
global mesh → collectives over processes) that a multi-host run takes —
SURVEY.md §4 prescribes exactly this CPU simulation."""
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dist_groupby():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i}: OK" in out, out[-1500:]
