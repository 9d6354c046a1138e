"""Multi-host helpers (parallel/multihost.py) on the single-process
virtual mesh: init() no-ops, the media-plane batch assembly shards over
'data', and the control-plane broadcast round-trips."""

import numpy as np


def test_init_single_host_noop():
    from retrocapture_tpu.parallel import multihost

    # no coordinator configured -> single-host path, never raises
    assert multihost.is_distributed() is False


def test_global_frame_batch_shards_over_data():
    import jax

    from retrocapture_tpu.parallel import multihost
    from retrocapture_tpu.parallel.mesh import DATA_AXIS, make_mesh

    mesh = make_mesh(4, 2, devices=jax.devices()[:8])
    frames = (np.random.default_rng(0).random((8, 16, 24, 3)) * 255).astype(
        np.uint8
    )
    out = multihost.global_frame_batch(frames, mesh)
    assert out.shape == frames.shape
    spec = out.sharding.spec
    assert spec[0] == DATA_AXIS
    np.testing.assert_array_equal(np.asarray(out), frames)


def test_broadcast_meta_single_host():
    from retrocapture_tpu.parallel import multihost

    meta = {"preset": "crt/crt-mattias.glslp", "parameters": {"CURVATURE": 0.3}}
    assert multihost.broadcast_meta(meta) == meta


def test_two_process_distributed_branches():
    """Run the REAL distributed branches at process_count()==2: two
    subprocesses join over a localhost coordinator (4 virtual CPU devices
    each, 8 global), assemble a global frame batch whose shards stay
    host-local, reduce it in one SPMD program, and broadcast the control
    snapshot from process 0 to process 1 — the `/raw` + `/meta` loop of
    streaming/HTTPServer.cpp + RemoteMetaSync.cpp collapsed onto the
    runtime."""
    import json
    import pathlib
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    worker = pathlib.Path(__file__).with_name("_multihost_worker.py")
    env = {
        k: v
        for k, v in __import__("os").environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coordinator, str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-2000:]
        # Gloo prints connection chatter to stdout around the JSON line.
        jline = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        outs.append(json.loads(jline))

    meta = {"preset": "crt/crt-mattias.glslp", "parameters": {"CURVATURE": 0.3}}
    total_expected = outs[0]["local_sum"] + outs[1]["local_sum"]
    for r in outs:
        assert r["n_global_devices"] == 8
        assert r["global_batch"] == 8  # 4 local frames x 2 processes
        assert r["spec0"] == r["data_axis"]
        assert r["shards_local"] is True  # media plane stayed host-local
        assert r["local_rows_sum"] == 4  # each host addresses only its 4
        assert abs(r["total"] - total_expected) < 1.0  # one SPMD program
        assert r["meta"] == meta  # process 1 received the snapshot


def test_init_without_coordinator_is_single_host(monkeypatch):
    """No coordinator configured: init() joins nothing and says so (the
    explicit-coordinator path is the only way to go distributed)."""
    from retrocapture_tpu.parallel import multihost

    for var in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.init() is False
