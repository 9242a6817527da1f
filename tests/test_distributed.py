"""Two-process jax.distributed smoke test on CPU: process-sharded read
scoring combined with process_allgather equals the single-process score
(SURVEY.md section 4(e))."""
import os
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys, json
os.environ["JAX_PLATFORMS"] = "cpu"
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
import jax
jax.distributed.initialize(coordinator_address="localhost:" + port,
                           num_processes=nproc, process_id=pid)
sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/tests")
import numpy as np
from gaml_tpu.parallel.distributed import combine_partials, reads_for_process

# deterministic world on every process
rng = np.random.default_rng(42)
n_reads = 40
log_probs = rng.normal(-20.0, 3.0, n_reads)
mine = reads_for_process(n_reads, pid, nproc)
local_sum = float(log_probs[mine].sum())
local_zero = int((log_probs[mine] < -24).sum())
g_sum, g_zero, g_count = combine_partials(local_sum, local_zero, len(mine))
if pid == 0:
    print(json.dumps({"sum": g_sum, "zero": g_zero, "count": g_count}),
          flush=True)
"""


def _run_pair(tmp_path):
    import socket

    with socket.socket() as s:  # pick a free port to avoid collisions
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        if p.returncode != 0:
            return None, err.decode()[-2000:]
        outs.append(out.decode())
    lines = [l for l in outs[0].splitlines() if l.startswith("{")]
    if not lines:
        return None, "no JSON line from process 0"
    return lines[-1], ""


def test_two_process_allgather(tmp_path):
    import json

    # the port can be re-grabbed between probe and bind on a busy
    # machine; retry the rendezvous a few times before failing
    line = err = None
    for _ in range(3):
        line, err = _run_pair(tmp_path)
        if line is not None:
            break
    assert line is not None, err
    result = json.loads(line)
    rng = np.random.default_rng(42)
    log_probs = rng.normal(-20.0, 3.0, 40)
    assert result["count"] == 40
    assert result["zero"] == int((log_probs < -24).sum())
    # combine goes through device arrays: float32 unless jax x64 is enabled
    assert result["sum"] == pytest.approx(float(log_probs.sum()), rel=1e-5)
