"""Multi-host distribution (capability ref: device/device_network.{h,cpp}
NetworkDevice TCP RPC + DeviceServer + app/cycles_server.cpp:31, and the
resumable-chunk partitioning of blender_python.cpp:871-947 — redesigned
on jax.distributed).

The reference scales across machines with a boost::asio RPC that
mirrors every Device virtual over TCP and steals tiles back through the
master's TileManager. Here the transport is JAX's own: hosts join ONE
jax.distributed process group (coordinator service + collectives); each
host (or each process, one per GPU) renders a
disjoint SAMPLE RANGE of the whole frame — the reference's own
multi-process partitioning — and partial accumulation buffers combine
either

  (a) in-job: `gather_image` all-gathers the per-host buffer sums and
      adds them (every host ends with the full frame), or
  (b) offline: each host writes a multilayer chunk file and host 0
      merges pass-aware via session/merge.py — exactly the reference's
      standalone merger workflow (render/merge.cpp).

Elastic behavior: a lost host costs only its sample range — the merge
accepts any subset of chunks (fewer samples, never a corrupt frame),
unlike an RPC mesh where a dead peer wedges the tile scheduler.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

import numpy as np


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """Join the process group (idempotent). Outside a cluster scheduler
    that JAX detects, pass the coordinator ("localhost:<port>" on one
    machine), the process count and this process's id. Processes that
    share a machine each take their own GPU through local_device_ids
    (e.g. [process_id]); without it every process would open, and
    reserve memory on, every card of the machine."""
    import jax
    if getattr(initialize, "_done", False):
        return
    # NOTE: must run before ANY backend touch (jax.devices() etc.), so
    # no jax.process_count() guard here — double-init raises and is
    # translated into a no-op below.
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = [int(i) for i in local_device_ids]
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise
    initialize._done = True


def host_sample_range(total_samples, num_hosts, host_id):
    """Split samples into contiguous near-equal ranges (ref:
    TileManager range_start_sample/range_num_samples semantics)."""
    base = total_samples // num_hosts
    extra = total_samples % num_hosts
    start = host_id * base + min(host_id, extra)
    count = base + (1 if host_id < extra else 0)
    return start, count


class MultiHostSession:
    """Drives one host's share of a render and combines results.

    scene/params describe the FULL render (params.samples = total
    samples across all hosts); the local Session gets this host's
    sample range."""

    def __init__(self, scene, params, process_id=None,
                 num_processes=None):
        import jax
        from raytracingproject_tpu.session import Session, SessionParams
        self.process_id = (jax.process_index() if process_id is None
                           else int(process_id))
        self.num_processes = (jax.process_count()
                              if num_processes is None
                              else int(num_processes))
        start, count = host_sample_range(
            int(params.samples), self.num_processes, self.process_id)
        self.range_start, self.range_count = start, count
        local = SessionParams(**{**vars(params),
                                 "range_start_sample": start,
                                 "range_num_samples": count})
        self.session = Session(scene, local)
        self.total_samples = int(params.samples)

    def render(self):
        self.session.reset()
        self.session.render()
        return self.session

    def gather_image(self, exposure=1.0):
        """In-job combine: all-gather per-host buffer sums over the
        process group and add (every host returns the full-frame
        display RGBA). Requires jax.distributed to be initialized."""
        from jax.experimental import multihost_utils
        buf = self.session.buffers.buffer
        all_bufs = np.asarray(
            multihost_utils.process_allgather(buf, tiled=False))
        total = all_bufs.sum(0)
        n = max(self.total_samples, 1)
        rgb = total[..., 0:3] * (exposure / n)
        a = np.clip(total[..., 3:4] / n, 0.0, 1.0)
        return np.concatenate([rgb, a], -1)

    def write_chunk(self, out_dir):
        """Offline combine, step 1: write this host's multilayer chunk
        (ref: resumable chunk files)."""
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"chunk_{self.range_start:06d}"
            f"_{self.range_count:04d}.npz")
        return self.session.write_output(path)

    @staticmethod
    def merge_chunks(out_dir, output_path):
        """Offline combine, step 2 (host 0): pass-aware merge of every
        chunk in out_dir (ref: render/merge.cpp ImageMerger)."""
        from raytracingproject_tpu.session import merge as mg
        paths = sorted(
            os.path.join(out_dir, p) for p in os.listdir(out_dir)
            if p.startswith("chunk_") and p.endswith(".npz"))
        if not paths:
            raise ValueError(f"no chunk files in {out_dir}")
        return mg.merge_files(paths, output_path)

    def barrier(self, tag="render_done"):
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(tag)


# ---------------------------------------------------------------------------
# Dynamic work distribution: the static ranges
# above give every host 1/N of the samples regardless of speed — a 2x
# slower host halves the fleet's effective rate. Here host 0 runs a
# sample-chunk QUEUE and hands chunks out as workers finish (capability
# ref: device_network.cpp:231-266 acquire_tile reverse RPC +
# render/tile.cpp tile acquire/release — matched, not translated: the
# control plane is a stdlib TCP line protocol, while jax.distributed /
# the chunk-file merge stay the data plane). Leases expire and re-queue,
# so a dead worker costs only latency, never its chunks (beyond the
# reference, whose scheduler wedges on a lost peer).
# ---------------------------------------------------------------------------


class ChunkQueueServer:
    """Host 0's sample-chunk queue. Protocol: one JSON line per
    connection — {"op": "acquire", "worker": id} ->
    {"start": s, "count": c} | {"wait": true} | {"done": true};
    {"op": "release", "start": s, "count": c, "ok": bool};
    {"op": "status"} -> {"remaining": chunks_not_yet_released}."""

    def __init__(self, total_samples, chunk_samples=16, host="127.0.0.1",
                 port=0, lease_timeout=300.0):
        self._pending = [(s, min(chunk_samples, total_samples - s))
                         for s in range(0, int(total_samples),
                                        int(chunk_samples))]
        self._pending.reverse()  # pop() serves in ascending order
        self._leases = {}        # (start, count) -> (deadline, worker)
        self._released = 0
        self._total_chunks = len(self._pending)
        self._assignments = {}   # worker -> chunks completed
        self._lease_timeout = float(lease_timeout)
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.address = "%s:%d" % self._sock.getsockname()[:2]
        self._closing = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # -- queue logic ------------------------------------------------------
    def _handle(self, req):
        with self._lock:
            now = time.time()
            # straggler/death recovery: expired leases re-queue
            for key, (deadline, _w) in list(self._leases.items()):
                if now > deadline:
                    del self._leases[key]
                    self._pending.append(key)
            op = req.get("op")
            if op == "acquire":
                if self._pending:
                    key = self._pending.pop()
                    self._leases[key] = (now + self._lease_timeout,
                                         req.get("worker", -1))
                    return {"start": key[0], "count": key[1]}
                if self._leases:
                    return {"wait": True}   # work may re-queue on expiry
                return {"done": True}
            if op == "release":
                key = (int(req["start"]), int(req["count"]))
                self._leases.pop(key, None)
                if req.get("ok", True):
                    self._released += 1
                    w = req.get("worker", -1)
                    self._assignments[w] = self._assignments.get(w, 0) + 1
                else:
                    self._pending.append(key)
                return {"ack": True}
            if op == "status":
                return {"remaining": self._total_chunks - self._released,
                        "assignments": {str(k): v for k, v
                                        in self._assignments.items()}}
            return {"error": f"unknown op {op!r}"}

    @property
    def finished(self):
        with self._lock:
            return self._released >= self._total_chunks

    # -- transport --------------------------------------------------------
    def _serve(self):
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                with conn:
                    data = conn.makefile("r").readline()
                    if not data:
                        continue
                    resp = self._handle(json.loads(data))
                    conn.sendall((json.dumps(resp) + "\n").encode())
            except Exception:   # a malformed client must not kill the
                pass            # queue (ref: server survives peer loss)

    def close(self):
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass


def _queue_rpc(address, req, timeout=30.0):
    host, port = address.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        return json.loads(s.makefile("r").readline())


class DynamicMultiHostSession:
    """Worker loop for the dynamic queue: acquire a sample chunk, render
    it with the resumable-chunk machinery (range_start/range_num on a
    single reusable Session), write the chunk file, release, repeat.
    The merge path is unchanged (MultiHostSession.merge_chunks)."""

    def __init__(self, scene, params, queue_address, out_dir,
                 worker_id=0):
        from raytracingproject_tpu.session import Session, SessionParams
        self.queue_address = queue_address
        self.out_dir = out_dir
        self.worker_id = int(worker_id)
        self.total_samples = int(params.samples)
        self._params = params
        self.session = Session(scene, SessionParams(**vars(params)))
        self.chunks_rendered = []

    def run(self, poll_interval=0.2, on_chunk=None):
        os.makedirs(self.out_dir, exist_ok=True)
        while True:
            try:
                r = _queue_rpc(self.queue_address,
                               {"op": "acquire", "worker": self.worker_id})
            except OSError:
                # the master closes the queue once every chunk is
                # released — a vanished server after successful work IS
                # the done signal (a worker must never crash on master
                # exit; ref: the merge tolerates any chunk subset)
                return self.chunks_rendered
            if r.get("done"):
                return self.chunks_rendered
            if r.get("wait"):
                time.sleep(poll_interval)
                continue
            start, count = int(r["start"]), int(r["count"])
            err = None
            try:
                # render_range reuses the synced scene + compiled
                # kernels: after the first chunk, a chunk is pure
                # device time
                self.session.render_range(start, count)
                path = os.path.join(
                    self.out_dir, f"chunk_{start:06d}_{count:04d}.npz")
                self.session.write_output(path)
                if on_chunk is not None:
                    on_chunk(start, count)
            except Exception as e:     # failed chunk re-queues for the
                err = e                 # surviving workers
            try:
                _queue_rpc(self.queue_address,
                           {"op": "release", "start": start,
                            "count": count, "ok": err is None,
                            "worker": self.worker_id})
            except OSError:
                if err is None:
                    # chunk file is written; a lost release only costs
                    # the master's lease-expiry wait
                    return self.chunks_rendered + [(start, count)]
            if err is not None:
                raise err
            self.chunks_rendered.append((start, count))
