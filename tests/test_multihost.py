"""Real multi-process mesh tests: two OS processes
wire up via jax.distributed.initialize on CPU, build the hybrid
hosts × devices mesh through make_hybrid_mesh's create_hybrid_device_mesh branch, and run
a cross-host collective.  Also pins initialize_multihost's fail-loud
contract for explicit-coordinator misconfiguration."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    import jax.numpy as jnp

    port, pid = sys.argv[1], int(sys.argv[2])
    from poulpy_tpu.parallel.multihost import (
        initialize_multihost, make_hybrid_mesh,
    )
    initialize_multihost(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())

    mesh = make_hybrid_mesh(tp=2)
    assert mesh.axis_names == ("dp", "tp", "sp")
    assert mesh.devices.shape == (4, 2, 1), mesh.devices.shape
    # host-outer: the dp axis must cross processes, tp must not
    pidx = np.vectorize(lambda d: d.process_index)(mesh.devices)
    assert len(set(pidx[:, 0, 0])) == 2, "dp axis does not span hosts"
    for i in range(4):
        assert len(set(pidx[i, :, 0])) == 1, "tp axis crosses hosts"

    # cross-host collective: psum over dp sums contributions from both
    # processes (global array: each process supplies its local shards)
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.experimental import multihost_utils

    @jax.jit
    def work(x):
        return x * 2

    sharding = NamedSharding(mesh, P("dp"))
    garr = jax.make_array_from_callback(
        (8, 4), sharding,
        lambda idx: np.arange(8 * 4).reshape(8, 4)[idx].astype(np.float64),
    )
    out = work(garr)
    got = multihost_utils.process_allgather(out, tiled=True)
    want = np.arange(8 * 4).reshape(8, 4) * 2
    assert np.array_equal(got, want), got
    print(f"WORKER{pid}-OK")
""")


def _free_port() -> int:
    # SO_REUSEADDR narrows (cannot fully close) the probe→bind TOCTOU
    # window: the coordinator can bind the port even while the probe
    # socket lingers in TIME_WAIT
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_hybrid_mesh(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
        )
        for pid in range(2)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((pid, p.returncode, out.decode(), err.decode()))
    for pid, rc, out, err in outs:
        assert rc == 0, f"worker {pid} rc={rc}\nstdout:{out}\nstderr:{err}"
        assert f"WORKER{pid}-OK" in out


def test_initialize_multihost_fails_loud_on_bad_coordinator():
    """Explicit coordinator args + init failure must RAISE, not silently
    degrade to single-host (multihost.py:54-69)."""
    code = textwrap.dedent("""
        import jax
        from poulpy_tpu.parallel.multihost import initialize_multihost
        try:
            initialize_multihost(
                coordinator_address="127.0.0.1:1",  # nothing listens here
                num_processes=2,
                process_id=1,   # non-coordinator: must connect, times out
                initialization_timeout=5,
            )
        except Exception as e:
            print("RAISED-OK", type(e).__name__)
        else:
            print("SWALLOWED")
    """)
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    # loud = a catchable RuntimeError reaches the caller OR the distributed
    # client fatally terminates the process (absl F-log + nonzero exit);
    # what must NOT happen is silent single-host degradation
    assert "SWALLOWED" not in out.stdout, out.stdout
    assert "RAISED-OK" in out.stdout or out.returncode != 0, (
        out.returncode, out.stdout, out.stderr[-2000:]
    )
