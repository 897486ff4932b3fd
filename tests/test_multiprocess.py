"""Real multi-process multi-host validation.

Spawns 2 CPU processes (2 virtual devices each) under jax.distributed with
gloo collectives and checks:
  - topology + cache-meta process_allgather
  - put_local (make_array_from_process_local_data) + psum + all_to_all over
    the global 2x2-device mesh
  - data-parallel host-pipeline training whose per-step losses match the
    single-process 4-device run EXACTLY

The reference demonstrates 4 nodes x 4 GPUs via SLURM (4GB_script.sh:4-8);
this is the same topology contract executed in CI.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "mp_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(mode, n_procs=2, local_devices=2, timeout=300, attempts=2):
    # _free_port() is bind-then-close: another process can steal the port
    # before the coordinator binds it (observed as a rare rendezvous
    # failure under concurrent load) — retry once with a fresh port.
    last = None
    for _ in range(attempts):
        port = _free_port()
        coord = f"127.0.0.1:{port}"
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            f" --xla_force_host_platform_device_count="
                            f"{local_devices}").strip()
        env.pop("JAX_PLATFORMS", None)
        procs = [subprocess.Popen(
            [sys.executable, WORKER, mode, coord, str(n_procs), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True) for pid in range(n_procs)]
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append((p.returncode, out, err))
        if all(rc == 0 for rc, _, _ in outs):
            return [o for _, o, _ in outs]
        last = outs
    for rc, out, err in last:
        assert rc == 0, f"worker failed rc={rc}\nstdout:\n{out}\nstderr:\n{err}"
    return [o for _, o, _ in last]


def _grep(out, tag):
    for line in out.splitlines():
        if line.startswith(tag + " "):
            return line[len(tag) + 1:]
    raise AssertionError(f"no {tag} line in:\n{out}")


def test_two_process_collectives():
    outs = _spawn("collectives")
    for pid, out in enumerate(outs):
        n_hosts, host_id, local = map(int, _grep(out, "TOPOLOGY").split())
        assert (n_hosts, host_id, local) == (2, pid, 2)
        # meta exchange: both hosts see both hosts' counters
        meta = eval(_grep(out, "META"))
        assert meta == [[0, 1, 2, 3], [10, 11, 12, 13]]
        # psum over 4 global devices of per-host-distinct data
        want = sum((np.arange(2 * 4).reshape(2, 4) + 100 * h).sum()
                   for h in range(2))
        assert float(_grep(out, "PSUM").split()[0]) == float(want)
    # all_to_all: device g ends with column g of the 4x4 value matrix
    for pid, out in enumerate(outs):
        m = re.match(r"\[(.*)\] \[(.*)\]", _grep(out, "A2A"))
        idxs = [int(v) for v in m.group(1).split(",")]
        vals = [int(v) for v in m.group(2).split(",")]
        assert idxs == [2 * pid, 2 * pid + 1]
        # value sent from global device s to device d is 100*host(s)+lrank(s)
        src_vals = [0, 1, 100, 101]
        assert vals == src_vals + src_vals  # each of our 2 devices got all 4


def test_two_process_training_matches_single_process():
    outs = _spawn("train")
    losses_mp = [float(v) for v in _grep(outs[0], "LOSSES").split()]
    losses_mp_b = [float(v) for v in _grep(outs[1], "LOSSES").split()]
    np.testing.assert_allclose(losses_mp, losses_mp_b, rtol=0, atol=0)

    # single process, 4 virtual devices, same global config
    outs1 = _spawn("train", n_procs=1, local_devices=4)
    losses_sp = [float(v) for v in _grep(outs1[0], "LOSSES").split()]
    assert len(losses_mp) == 4
    np.testing.assert_allclose(losses_mp, losses_sp, rtol=1e-6, atol=1e-7)
    assert np.isfinite(losses_mp).all()


@pytest.mark.parametrize("mode", ["resident", "residenttopo"])
def test_two_process_resident_pipeline(mode):
    """The flagship pipeline across 2 real processes:
    staged fused windows under capacity pressure on the global 2x2-device
    mesh — bitmap probes, replicated stage upload, owner-partitioned
    admission — plus one cross-process node_color refresh cycle exchanging
    real cache color counters. Losses must match (a) across the two
    processes bit-for-bit and (b) the single-process 4-device run."""
    outs = _spawn(mode, timeout=600)
    l_a = [float(v) for v in _grep(outs[0], "RLOSSES").split()]
    l_b = [float(v) for v in _grep(outs[1], "RLOSSES").split()]
    np.testing.assert_allclose(l_a, l_b, rtol=0, atol=0)
    assert np.isfinite(l_a).all() and len(l_a) == 6
    # both processes computed the identical exchanged meta
    assert _grep(outs[0], "RMETA") == _grep(outs[1], "RMETA")
    for out in outs:
        hits, misses, staged = map(int, _grep(out, "RSTATS").split())
        assert misses > 0      # pressure: the stage served rows
        assert staged > 0      # ...through the staged path

    # single process, 4 virtual devices, same global mesh + assignment
    outs1 = _spawn(mode, n_procs=1, local_devices=4, timeout=600)
    l_sp = [float(v) for v in _grep(outs1[0], "RLOSSES").split()]
    np.testing.assert_allclose(l_a, l_sp, rtol=1e-6, atol=1e-7)


def test_two_process_sharded_cache():
    """ShardedFeatureCache across 2 processes: prewarm partitions by owner,
    the exchange fetch returns exact rows on every process's devices, the
    replicated miss protocol fills owners, and a refetch fully hits."""
    outs = _spawn("cache")
    for out in outs:
        ok, *_ = _grep(out, "CACHEOK").split()
        assert ok == "1", out
        hits, misses = map(int, _grep(out, "CACHESTATS").split())
        assert misses > 0           # odd ids were not prewarmed
        assert hits > 0
        ok2, h2, m2 = _grep(out, "CACHEOK2").split()
        assert ok2 == "1", out
        assert int(m2) == 0, out    # second pass: misses were admitted
        assert int(h2) > 0


def test_two_process_node_local_cache():
    """node_local mode across 2 real processes: rows
    fetched by host 0 serve host 0's whole device group but never cross to
    host 1; outputs stay exact via the host fallback; global hit/miss
    accounting is process-topology independent."""
    outs = _spawn("nodelocal")
    for out in outs:
        assert _grep(out, "NLOK") == "1", out
        h, m, L = map(int, _grep(out, "NLSTATS").split())
        assert L == 2
        assert h == L * 16          # group 0: every slot hits
        assert m == L * 16          # group 1: every slot misses

    # the same global mesh as ONE process (group_size still 2) must
    # account identically
    outs1 = _spawn("nodelocal", n_procs=1, local_devices=4)
    h1, m1, _ = map(int, _grep(outs1[0], "NLSTATS").split())
    assert (h1, m1) == (2 * 16, 2 * 16)
