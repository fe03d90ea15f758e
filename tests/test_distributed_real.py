"""REAL multi-process jax.distributed on the CPU backend: two OS
processes form a process group over a TCP coordination service
(parallel/distributed.initialize), build the global 8-device mesh
(4 virtual CPU devices per process), and run a cross-process psum
through shard_map.

This is the strongest multi-host evidence this single-machine
environment can produce: the actual coordination service, the actual
process-group handshake, and an actual collective spanning two
processes — not mocks.  On GPU hosts the identical code path runs
with NCCL transports (the reference has no networking at all;
SURVEY.md §2 marks multi-host as new capability).
"""

import pytest

import os
import socket
import subprocess
import sys


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_group_psum():
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "distributed_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=root,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=220)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{err}"
    got = sorted(line for rc, out, _ in outs
                 for line in out.splitlines() if line.startswith("DIST-OK"))
    # 8 global devices -> psum == 0+1+...+7 == 28; process 0 is primary.
    assert got == ["DIST-OK 0 28.0 True", "DIST-OK 1 28.0 False"], got
