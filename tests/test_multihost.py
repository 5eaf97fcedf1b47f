"""Multi-host distribution tests (capability ref: device_network.cpp
NetworkDevice/DeviceServer, replaced by jax.distributed + sample-range
chunking; see parallel/multihost.py).

The 2-process test spawns two REAL python processes that join one
jax.distributed group over localhost, render disjoint sample ranges of
the same scene, combine both ways (in-job all-gather and chunk-file
merge), and must reproduce the single-process render bit-near-exactly
(the ranges partition the identical sample sequence)."""

import json
import os
import subprocess
import sys

import numpy as np

from raytracingproject_tpu.parallel import multihost as mh


class TestInitialize:
    def test_local_device_ids_pass_through(self, monkeypatch):
        """Processes sharing a machine each own one card."""
        import jax
        seen = {}
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: seen.update(kw))
        monkeypatch.setattr(mh.initialize, "_done", False, raising=False)
        mh.initialize("localhost:1234", 4, 2, local_device_ids=[2])
        assert seen == {"coordinator_address": "localhost:1234",
                        "num_processes": 4, "process_id": 2,
                        "local_device_ids": [2]}


class TestSampleRanges:
    def test_partition_covers_all_samples(self):
        for total in (1, 7, 64, 129):
            for nproc in (1, 2, 3, 8):
                ranges = [mh.host_sample_range(total, nproc, i)
                          for i in range(nproc)]
                # contiguous, disjoint, complete
                pos = 0
                for start, count in ranges:
                    assert start == pos
                    pos += count
                assert pos == total


_WORKER = r"""
import sys, os, json
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
out_dir = sys.argv[2]
from raytracingproject_tpu.parallel import multihost as mh
mh.initialize(coordinator_address="localhost:{port}", num_processes=2,
              process_id=pid)
import numpy as np
from raytracingproject_tpu.app import examples
from raytracingproject_tpu.session import SessionParams
scene = examples.cornell_box(12, 12, spp=8)
sess = mh.MultiHostSession(scene, SessionParams(samples=8))
sess.render()
img = sess.gather_image()
np.save(os.path.join(out_dir, f"gathered_{{pid}}.npy"), img)
sess.write_chunk(out_dir)
sess.barrier("chunks_written")
if pid == 0:
    sess.merge_chunks(out_dir, os.path.join(out_dir, "merged.npz"))
print("WORKER_OK", pid, flush=True)
"""


class TestTwoProcess:
    def test_two_process_render_matches_single(self, tmp_path):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        script = tmp_path / "worker.py"
        script.write_text(_WORKER.format(repo=repo, port=19847))
        env = dict(os.environ)
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(i), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=repo, env=env, text=True) for i in range(2)]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
            assert f"WORKER_OK {i}" in out

        # single-process reference
        from raytracingproject_tpu.app import examples
        from raytracingproject_tpu.session import Session, SessionParams
        scene = examples.cornell_box(12, 12, spp=8)
        ref = Session(scene, SessionParams(samples=8))
        ref.reset()
        img_ref = np.asarray(ref.render())

        # (a) in-job all-gather path: both hosts hold the full frame
        g0 = np.load(tmp_path / "gathered_0.npy")
        g1 = np.load(tmp_path / "gathered_1.npy")
        np.testing.assert_allclose(g0, g1, atol=1e-6)
        np.testing.assert_allclose(g0[..., :3], img_ref[..., :3],
                                   atol=1e-5)

        # (b) chunk-merge path
        from raytracingproject_tpu.session import merge as mg
        rgba = mg.merged_display(str(tmp_path / "merged.npz"))
        # merged buffer is stored top-down (write_output flips)
        np.testing.assert_allclose(rgba[::-1][..., :3],
                                   img_ref[..., :3], atol=1e-5)


class TestChunkQueue:
    def test_queue_hands_out_all_chunks_once(self):
        srv = mh.ChunkQueueServer(32, chunk_samples=4)
        try:
            got = []
            while True:
                r = mh._queue_rpc(srv.address, {"op": "acquire",
                                                "worker": 0})
                if r.get("done"):
                    break
                got.append((r["start"], r["count"]))
                mh._queue_rpc(srv.address, {"op": "release",
                                            "start": r["start"],
                                            "count": r["count"],
                                            "ok": True, "worker": 0})
            assert sorted(got) == [(s, 4) for s in range(0, 32, 4)]
            assert srv.finished
        finally:
            srv.close()

    def test_failed_chunk_requeues(self):
        srv = mh.ChunkQueueServer(8, chunk_samples=4)
        try:
            r1 = mh._queue_rpc(srv.address, {"op": "acquire", "worker": 0})
            mh._queue_rpc(srv.address, {"op": "release",
                                        "start": r1["start"],
                                        "count": r1["count"],
                                        "ok": False, "worker": 0})
            seen = set()
            while True:
                r = mh._queue_rpc(srv.address, {"op": "acquire",
                                                "worker": 1})
                if r.get("done"):
                    break
                seen.add((r["start"], r["count"]))
                mh._queue_rpc(srv.address, {"op": "release",
                                            "start": r["start"],
                                            "count": r["count"],
                                            "ok": True, "worker": 1})
            assert (r1["start"], r1["count"]) in seen
        finally:
            srv.close()

    def test_expired_lease_requeues(self):
        srv = mh.ChunkQueueServer(4, chunk_samples=4, lease_timeout=0.05)
        try:
            r1 = mh._queue_rpc(srv.address, {"op": "acquire", "worker": 0})
            assert "start" in r1
            import time as _t
            _t.sleep(0.1)  # worker 0 "dies" holding the lease
            r2 = mh._queue_rpc(srv.address, {"op": "acquire", "worker": 1})
            assert r2.get("start") == r1["start"]
        finally:
            srv.close()


_DYN_WORKER = r"""
import sys, os, time, json
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
out_dir = sys.argv[2]
addr_file = os.path.join(out_dir, "queue_addr")
from raytracingproject_tpu.parallel import multihost as mh
from raytracingproject_tpu.app import examples
from raytracingproject_tpu.session import SessionParams
scene = examples.cornell_box(12, 12, spp=32)
params = SessionParams(samples=32)
if pid == 0:
    srv = mh.ChunkQueueServer(32, chunk_samples=4, lease_timeout=120.0)
    with open(addr_file + ".tmp", "w") as f:
        f.write(srv.address)
    os.rename(addr_file + ".tmp", addr_file)
else:
    for _ in range(600):
        if os.path.exists(addr_file):
            break
        time.sleep(0.1)
with open(addr_file) as f:
    addr = f.read().strip()
# worker 1 is the artificial straggler: +3 s per chunk (must dominate
# the per-chunk render+dispatch cost even on a contended 1-core host)
slow = (lambda s, c: time.sleep(3.0)) if pid == 1 else None
w = mh.DynamicMultiHostSession(scene, params, addr,
                               os.path.join(out_dir, "chunks"),
                               worker_id=pid)
# warm the compile cache OUTSIDE the queue so the straggler handicap,
# not compile-time skew, decides the chunk assignment (render_range
# keeps the compiled kernels for every queue chunk after this)
w.session.render_range(0, 4)
done = w.run(on_chunk=slow)
if pid == 0:
    # wait until the straggler releases its last chunk, then merge
    for _ in range(600):
        st = mh._queue_rpc(addr, {{"op": "status"}})
        if st["remaining"] <= 0:
            break
        time.sleep(0.1)
    print("ASSIGN", json.dumps(st["assignments"]), flush=True)
    mh.MultiHostSession.merge_chunks(os.path.join(out_dir, "chunks"),
                                     os.path.join(out_dir, "merged.npz"))
    srv.close()
print("DYN_OK", pid, len(done), flush=True)
"""


class TestTwoProcessDynamic:
    def test_straggler_rebalances(self, tmp_path):
        """One worker 2.5 s/chunk slower: the queue must shift chunks to
        the fast worker (the static split's wall is set by the slow
        host) and the merge must still equal the
        single-process render."""
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        script = tmp_path / "dyn_worker.py"
        script.write_text(_DYN_WORKER.format(repo=repo))
        env = dict(os.environ)
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(i), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=repo, env=env, text=True) for i in range(2)]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
            assert f"DYN_OK {i}" in out

        assign = json.loads(outs[0].split("ASSIGN", 1)[1].splitlines()[0])
        fast = assign.get("0", 0)
        slow = assign.get("1", 0)
        assert fast + slow == 8
        # load balancing: the fast worker must absorb the majority
        # (static split would pin 4/4 and the wall to the straggler)
        assert fast > slow, assign

        from raytracingproject_tpu.app import examples
        from raytracingproject_tpu.session import Session, SessionParams
        from raytracingproject_tpu.session import merge as mg
        scene = examples.cornell_box(12, 12, spp=32)
        ref = Session(scene, SessionParams(samples=32))
        ref.reset()
        img_ref = np.asarray(ref.render())
        rgba = mg.merged_display(str(tmp_path / "merged.npz"))
        np.testing.assert_allclose(rgba[::-1][..., :3],
                                   img_ref[..., :3], atol=1e-5)
