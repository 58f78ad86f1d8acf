"""Fixed-shape batched serving (counterpart of facialmmt_tpu/serving.py):
EmotionServer, the AsyncBatchServer front end and benchmark_load.

Variable-size requests are padded on the host into one static pack:
  * up to `max_batch` utterances per call;
  * up to `face_capacity` face crops of 160x160x3 uint8, packed contiguously;
  * missing modalities zero-masked.
The pipeline's weights go to the device once, in `dtype` (bf16 by default);
each call copies the pack over, runs the eval transform and the pipeline, and
returns softmax probability rows.  The eval-time gumbel draw is sampled from
a torch.Generator on the device, seeded from runtime.seed, unless
runtime.deterministic_gumbel is set.

With a `mesh_plan` (parallel/mesh.py) the server is SPMD: every rank
constructs it and calls `predict` with the same requests, builds the same
pack and keeps its rows of each leading axis (utterances and faces split
apart, as in JAX); tensor-parallel layers run on their model group, the
FER distributions and text features are gathered inside the pipeline, and
the probability rows of all ranks are gathered, so every rank returns the
full answers.

AsyncBatchServer packs concurrent requests into those static shapes on one
packer thread, optionally routing each pack to the smallest of several
servers (buckets) that fits it; benchmark_load drives it with Poisson
arrivals.  Over mesh servers of several ranks every rank constructs the
front: the main rank packs and broadcasts each pack, the others run what it
sends (AsyncBatchServer's docstring).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np
import torch

from facialmmt_tpu_torch.config import FacialMMTConfig
from facialmmt_tpu_torch.data.image_pipeline import meld_face_eval_transform
from facialmmt_tpu_torch.data.meld import FaceCapacityError
from facialmmt_tpu_torch.models.pipeline import build_pipeline
from facialmmt_tpu_torch.ops.kernels import resolve_device, to_device_async
from facialmmt_tpu_torch.parallel import comm
from facialmmt_tpu_torch.utils import observability as obs

FACE_SHAPE = (160, 160, 3)
# a front over several ranks: the main sends an IDLE header after this long
# without a header; a follower whose main is gone raises after
# parallel/comm.py::HOST_TIMEOUT_S without one
KEEPALIVE_S = 60.0


class EmotionServer:
    def __init__(self, cfg: FacialMMTConfig, state_dict=None,
                 max_batch: int = 8, face_capacity: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 transfer_dtype=np.float16, device="cuda", mesh_plan=None):
        """`state_dict`: the pipeline's weights under the reference names
        (checkpoint/from_jax.py builds one from JAX variables); None draws
        random weights from runtime.seed.  `transfer_dtype` is the host wire
        format of the padded audio/vision features, restored to fp32 on the
        device.  `device` defaults to the card; without a CUDA device the
        constructor raises (pass "cpu" to serve on the CPU).  `mesh_plan`
        (parallel/mesh.py::build_mesh): serve SPMD over its dp x tp ranks
        (module docstring; `device` is this rank's); max_batch and
        face_capacity must divide dp.  The server warms up with one
        all-padding pack."""
        self.cfg = cfg
        self.max_batch = max_batch
        self.face_capacity = face_capacity
        self.dtype = dtype
        self.transfer_dtype = transfer_dtype
        self.device = resolve_device(device)
        self.mesh_plan = mesh_plan
        self._front_thread = None   # an open multi-rank front's thread
        model = build_pipeline(cfg, self.device, state_dict)
        if mesh_plan is not None:
            from facialmmt_tpu_torch.parallel.mesh import shard_model_

            dp = mesh_plan.dp
            assert max_batch % dp == 0 and face_capacity % dp == 0, (
                f"max_batch ({max_batch}) and face_capacity "
                f"({face_capacity}) must divide dp ({dp})")
            shard_model_(model, mesh_plan)
        self.model = model.to(dtype).eval()
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.runtime.seed)
        self.predict_raw(self._zero_batch(),
                         np.zeros((face_capacity,) + FACE_SHAPE, np.uint8))

    def _zero_batch(self) -> Dict[str, np.ndarray]:
        d = self.cfg.data
        b = self.max_batch
        return {
            "dia_input_ids": np.full((b, d.max_seq_length), 1, np.int32),
            "dia_input_mask": np.zeros((b, d.max_seq_length), np.int32),
            "dia_sep_mask": np.zeros((b, d.max_seq_length), np.int32),
            "dia_idx": np.zeros(b, np.int32),
            "utt_in_dia_idx": np.zeros(b, np.int32),
            "audio_inputs": np.zeros((b, d.audio_utt_max_len,
                                      d.audio_feat_dim), self.transfer_dtype),
            "audio_mask": np.zeros((b, d.audio_utt_max_len), np.int32),
            "vision_feats": np.zeros((b, d.vision_utt_max_len,
                                      d.vision_feat_dim), self.transfer_dtype),
            "n_faces": np.zeros(b, np.int32),
            "face_utt_id": np.full(self.face_capacity, -1, np.int32),
            "face_pos": np.zeros(self.face_capacity, np.int32),
        }

    @torch.no_grad()
    def predict_device(self, batch: Dict[str, np.ndarray],
                       faces_raw: np.ndarray) -> torch.Tensor:
        """Run one pack; returns the (max_batch, num_labels) probability rows
        on the device without waiting for them: the copies and kernels are
        queued on the current stream behind the pack before, so the caller
        can build the next pack while this one computes (AsyncBatchServer's
        pipeline depends on this).  The host blocks only where the card's
        launch queue is full, which a full-width pack's device operations
        outnumber.  Under a mesh plan with dp > 1 only this rank's rows go
        to the device, and the rows of every rank come back.  While an
        AsyncBatchServer over several ranks is open over this server, only
        its thread may call (two threads running collectives on the mesh's
        groups deadlock): any other raises RuntimeError."""
        owner = self._front_thread
        if owner is not None and threading.current_thread() is not owner:
            raise RuntimeError(
                "an AsyncBatchServer over this mesh server is open and its "
                "thread runs every collective of the mesh; submit to the "
                "front, or close it first")
        with obs.trace_span("fmmt.serve.dispatch"):
            plan = self.mesh_plan
            split = plan is not None and plan.dp > 1
            with obs.trace_span("fmmt.serve.stage"):
                if split:
                    from facialmmt_tpu_torch.parallel.mesh import shard_batch

                    batch, faces_raw = shard_batch(plan, (batch, faces_raw))
                full = {k: to_device_async(torch.from_numpy(np.asarray(v)),
                                           self.device)
                        for k, v in batch.items()}
                full["audio_inputs"] = full["audio_inputs"].float()
                full["vision_feats"] = full["vision_feats"].float()
                faces = to_device_async(
                    torch.from_numpy(np.asarray(faces_raw)), self.device)
                full["faces"] = meld_face_eval_transform(
                    faces.float(), self.cfg.data.swin_img_size).to(self.dtype)
            with plan.data_shard() if split else contextlib.nullcontext():
                logits = self.model(full, generator=self.generator)
            probs = torch.softmax(logits.float(), dim=-1)
            if not split:
                return probs
            return comm.all_gather_cat(probs, plan.data_group)

    def predict_raw(self, batch: Dict[str, np.ndarray],
                    faces_raw: np.ndarray) -> np.ndarray:
        """One fixed-shape inference; (max_batch, num_labels) rows."""
        return self.predict_device(batch, faces_raw).cpu().numpy()

    def predict(self, requests) -> list:
        """requests: list (<= max_batch) of dicts with optional keys
        {'audio' (La, da), 'vision' (Lv, dv), 'faces' (n, 160, 160, 3),
         'input_ids', 'sep_mask', 'utt_in_dia_idx'}.
        Returns one probability vector per request."""
        batch, faces_raw = self.build_pack(requests)
        probs = self.predict_raw(batch, faces_raw)
        return [probs[j] for j in range(len(requests))]

    def build_pack(self, requests):
        """Pad <= max_batch requests into the static shapes; over-long text,
        audio and vision are truncated, too many faces raise
        FaceCapacityError.  Returns (batch dict, faces_raw)."""
        with obs.trace_span("fmmt.serve.build_pack"):
            if len(requests) > self.max_batch:
                raise ValueError(f"{len(requests)} requests > max_batch "
                                 f"{self.max_batch}")
            batch = self._zero_batch()
            faces_raw = np.zeros((self.face_capacity,) + FACE_SHAPE, np.uint8)
            cursor = 0
            for j, req in enumerate(requests):
                if "input_ids" in req:
                    max_len = batch["dia_input_ids"].shape[1]
                    ids = np.asarray(req["input_ids"])[:max_len]
                    batch["dia_input_ids"][j, :len(ids)] = ids
                    batch["dia_input_mask"][j, :len(ids)] = 1
                    sep = np.asarray(req.get("sep_mask", []))[:max_len]
                    batch["dia_sep_mask"][j, :len(sep)] = sep
                    batch["utt_in_dia_idx"][j] = req.get("utt_in_dia_idx", 0)
                batch["dia_idx"][j] = j
                if "audio" in req:
                    a = np.asarray(req["audio"])
                    la = min(a.shape[0], batch["audio_inputs"].shape[1])
                    batch["audio_inputs"][j, :la] = a[:la]
                    batch["audio_mask"][j, :la] = 1
                if "vision" in req:
                    v = np.asarray(req["vision"])
                    lv = min(v.shape[0], batch["vision_feats"].shape[1])
                    batch["vision_feats"][j, :lv] = v[:lv]
                faces = req.get("faces")
                if faces is not None:
                    take = self.face_take(faces)
                    if cursor + take > self.face_capacity:
                        raise FaceCapacityError(cursor + take,
                                                self.face_capacity, "serving")
                    faces_raw[cursor:cursor + take] = np.asarray(
                        faces[:take], np.uint8)
                    batch["face_utt_id"][cursor:cursor + take] = j
                    batch["face_pos"][cursor:cursor + take] = np.arange(
                        take, dtype=np.int32)
                    cursor += take
                    batch["n_faces"][j] = take
            return batch, faces_raw

    def face_take(self, faces) -> int:
        """How many of a request's face crops enter the pack (the reference's
        per-utterance cap, utils/dataset.py:278-279)."""
        return min(len(faces), self.cfg.data.vision_utt_max_len)

    def benchmark_latency(self, iters: int = 20) -> Dict[str, float]:
        """Host-clock latency of `iters` all-padding packs, each ending in a
        copy of the result to the host."""
        batch = self._zero_batch()
        faces = np.zeros((self.face_capacity,) + FACE_SHAPE, np.uint8)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self.predict_raw(batch, faces)
            times.append(time.perf_counter() - t0)
        arr = np.asarray(times) * 1000
        return {"p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99)),
                "mean_ms": float(arr.mean())}


def _start_readback(probs):
    """(rows, done) for a dispatched pack.  A CUDA tensor's copy to the host
    is queued right behind the pack, into page-locked memory, with an event
    after it: the packer waits for that event alone.  A `.cpu()` issued when
    the pack is resolved would be queued behind every pack dispatched since
    on the same stream and wait for them too, which serializes the pipeline.
    The event goes on the stream of the rows' own card, where the copy is
    queued, whatever the calling thread's current device is.  Anything else
    (a CPU tensor, an array-like whose `__array__` waits) is returned as it
    is, with no event."""
    if getattr(probs, "is_cuda", False):
        rows = probs.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(probs.device))
        return rows, done
    return probs, None


def _on_device(server):
    """The context a front's thread runs under: the server's card as the
    thread's current device (each host thread has its own, cuda:0 unless
    set), so the streams the pack uses are that card's."""
    dev = getattr(server, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _front_plan(servers):
    """The mesh plan of several ranks the servers run under, or None (no
    plan, or one rank: the front is one process's)."""
    plans = [getattr(s, "mesh_plan", None) for s in servers]
    multi = [p for p in plans if p is not None and p.dp * p.tp > 1]
    if not multi:
        return None
    plan = multi[0]
    if len(multi) < len(plans) or any(
            (p.dp, p.tp, p.rank) != (plan.dp, plan.tp, plan.rank)
            for p in multi):
        raise ValueError("the buckets of a front over several ranks run on "
                         "one mesh plan")
    if not plan.member:
        raise ValueError(f"rank {plan.rank} is outside the {plan.dp} x "
                         f"{plan.tp} mesh and takes no part in its front")
    if plan.host_group is None:
        raise ValueError("a front over several ranks needs the plan's host "
                         "group: make the plan with build_mesh")
    return plan


def _pack_arrays(batch, faces_raw):
    """A pack's arrays in the order its broadcast sends them."""
    return [batch[k] for k in sorted(batch)] + [faces_raw]


class AsyncBatchServer:
    """Concurrent front end for EmotionServer: a request queue and a packer
    thread (counterpart of facialmmt_tpu/serving.py's AsyncBatchServer).

    The packer drains up to max_batch queued requests (within the packed-face
    capacity) into ONE fixed-shape inference, waiting at most
    `batch_deadline_ms` from the first pending request before it dispatches
    a partial pack.

    `server` may also be a SEQUENCE of EmotionServers with the same weights
    (a bucket ROUTER): each pack dispatches on the smallest bucket it fits,
    so light load rides the small bucket's latency and saturated load the
    big bucket's throughput.  Under the 'backlog' boundary policy a pack
    grows past a bucket boundary only when the waiting backlog can fill the
    larger bucket (see `_run`); 'greedy' always fills toward the largest.
    `pack_sizes` and `bucket_choices` record each pack's fill and its
    (max_batch, face_capacity).

    With the span recorder enabled (utils/observability.py) each request
    submitted gets an id, and the packer adds the rows `fmmt.serve.idle`
    (waiting for a pack's first request), `fmmt.serve.fill` (the first
    request taken until the pack closes; value: its requests) and, as the
    pack closes, one `fmmt.serve.queued` row a request (submit() until
    then; key: the request id, value: the pack id).  A pack's id is its
    index in `bucket_choices`, the key of its `fmmt.serve.build_pack`,
    `.dispatch` and `.readback` rows and of the spans opened inside them.

    submit() returns a concurrent.futures.Future resolving to the request's
    probability vector.  One packer thread owns every device call, so device
    calls are serialized, and up to `pipeline_depth` packs are in flight
    before the packer waits for the oldest one's rows.  The thread runs with
    the server's card as its current device.

    Over EmotionServers with a mesh plan of several ranks (SPMD: every rank
    must run the same packs on the same bucket in the same order), every
    member rank constructs the front with the same arguments and the same
    servers in the same order; the broadcasts go over the plan's gloo group
    of the mesh's ranks (MeshPlan.host_group).  The main rank
    (`plan.is_main`) packs as above and, before it dispatches a pack,
    broadcasts a header (PACK, bucket, requests) and the pack's arrays; a
    pack whose build_pack fails, or a single request whose faces exceed
    every bucket, fails on the main alone and is sent nowhere.  Every other
    rank (a follower) runs a thread that receives headers and runs each
    pack on the same bucket, dropping its rows: its `pack_sizes` /
    `bucket_choices` are the main's less the packs that failed there.
    submit() on a follower returns a failed future.  While idle, the main
    sends an IDLE header every KEEPALIVE_S; close() on the main drains the
    packs in flight and sends STOP, close() on a follower returns once STOP
    has arrived.  While the front is open a direct call on one of its
    servers raises (EmotionServer.predict_device).  `broadcast_ms` holds
    the main's host time of each pack's broadcast, `keepalives` the IDLE
    headers sent or received, `pack_errors` what a follower's packs raised.
    """

    def __init__(self, server, batch_deadline_ms: float = 5.0,
                 pipeline_depth: int = 2, boundary_policy: str = "backlog"):
        servers = (list(server) if isinstance(server, (list, tuple))
                   else [server])
        # smallest-first: the router picks the FIRST bucket that fits a pack
        self.servers = sorted(
            servers, key=lambda s: (s.max_batch, s.face_capacity))
        # the largest bucket bounds the packer's drain loop
        self.server = self.servers[-1]
        self.deadline = batch_deadline_ms / 1000.0
        # with depth 2 the NEXT pack's host padding and staging overlap the
        # CURRENT pack's device compute
        self.pipeline_depth = max(1, pipeline_depth)
        if boundary_policy not in ("backlog", "greedy"):
            raise ValueError(f"boundary_policy {boundary_policy!r}: expected "
                             f"'backlog' or 'greedy'")
        self.boundary_policy = boundary_policy
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._ids = itertools.count()   # request ids, while recording
        self._holdover = collections.deque()  # didn't fit the last pack
        self._stop = threading.Event()
        self.pack_sizes: list = []
        self.bucket_choices: list = []
        self.broadcast_ms: list = []
        self.keepalives = 0
        self.pack_errors: list = []
        self._error: Optional[BaseException] = None
        self.plan = _front_plan(self.servers)
        self._group = None
        loop = self._run
        if self.plan is not None:
            self._group = self.plan.host_group
            self._last_header = time.perf_counter()
            loop = self._run if self.plan.is_main else self._follow
        self._thread = threading.Thread(target=self._serve, args=(loop,),
                                        daemon=True)
        if self.plan is not None:
            if any(s._front_thread is not None for s in self.servers):
                raise RuntimeError("another AsyncBatchServer is open over "
                                   "one of these mesh servers")
            for s in self.servers:
                s._front_thread = self._thread
        self._thread.start()

    def _serve(self, loop):
        try:
            with _on_device(self.server):
                loop()
        except Exception as e:  # a collective of the front's group failed
            self._error = e
            self._stop.set()
            self._fail_queued()
        finally:
            if self.plan is not None:
                for s in self.servers:
                    s._front_thread = None

    def submit(self, request: Dict[str, Any]) -> Future:
        fut: Future = Future()
        if self.plan is not None and not self.plan.is_main:
            fut.set_exception(RuntimeError(
                f"rank {self.plan.rank} follows the main rank 0 of its mesh: "
                f"submit requests there"))
            return fut
        if self._stop.is_set():
            fut.set_exception(RuntimeError("AsyncBatchServer is closed"))
            return fut
        t = obs.stamp()
        self._q.put((request, fut, None if t is None
                     else (next(self._ids), t)))
        # close() may have drained between the check above and the put: a
        # submit racing past its final sweep must not return a future nobody
        # will resolve
        if self._stop.is_set():
            self._fail_queued()
        return fut

    def _fail_queued(self):
        while True:
            try:
                fut = self._q.get_nowait()[1]
            except queue_mod.Empty:
                return
            if not fut.done():
                fut.set_exception(RuntimeError("AsyncBatchServer is closed"))

    def close(self):
        """Stop the packer.  In-flight packs resolve normally; requests still
        queued (or submitted after close) fail with RuntimeError rather than
        stranding their futures until the caller's timeout.  Over several
        ranks the main then sends STOP, and a follower waits for it; a
        failure of the front's thread is raised here."""
        self._stop.set()
        self._thread.join(timeout=5.0 if self.plan is None else None)
        self._fail_queued()
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def share(self, obj):
        """The main rank's `obj` on every rank of the front's mesh (one
        process: `obj`).  Every rank calls it, after close()."""
        if self._group is None:
            return obj
        return comm.broadcast_object(obj, self._group)

    def _send(self, op, index=0, n=0):
        comm.broadcast_header((op, index, n), self._group)
        self._last_header = time.perf_counter()

    def _dispatch(self, server, batch, faces_raw, n):
        """Queue one pack on `server`; over several ranks, broadcast it to
        the followers first."""
        if self._group is not None:
            t0 = time.perf_counter()
            self._send(comm.PACK, self.servers.index(server), n)
            comm.broadcast_arrays(_pack_arrays(batch, faces_raw), self._group)
            self.broadcast_ms.append((time.perf_counter() - t0) * 1000)
        return server.predict_device(batch, faces_raw)

    def _follow(self):
        """A follower's loop: run each pack the main sends until STOP."""
        while True:
            op, index, n = comm.broadcast_header(None, self._group)
            if op == comm.STOP:
                return
            if op == comm.IDLE:
                self.keepalives += 1
                continue
            server = self.servers[index]
            batch = server._zero_batch()
            faces_raw = np.zeros((server.face_capacity,) + FACE_SHAPE,
                                 np.uint8)
            comm.broadcast_arrays(_pack_arrays(batch, faces_raw), self._group)
            self.pack_sizes.append(n)
            self.bucket_choices.append((server.max_batch,
                                        server.face_capacity))
            try:
                server.predict_device(batch, faces_raw)
            except Exception as e:  # it failed on the main too: go on
                self.pack_errors.append(e)

    def _faces_of(self, request) -> int:
        faces = request.get("faces")
        if faces is None:
            return 0
        return self.server.face_take(faces)

    def _bucket_for(self, n: int, faces: int):
        """Smallest bucket fitting a pack of `n` requests / `faces` face
        slots; None when even the largest does not fit."""
        return next((s for s in self.servers
                     if n <= s.max_batch and faces <= s.face_capacity), None)

    def _next_item(self, timeout):
        if self._holdover:
            return self._holdover.popleft()
        try:
            return self._q.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def _resolve(self, pack, readback):
        with obs.trace_span("fmmt.serve.readback"):
            rows, done = readback
            try:
                if done is not None:
                    done.synchronize()  # this pack's rows are on the host
                probs = (rows.numpy() if isinstance(rows, torch.Tensor)
                         else np.asarray(rows))
            except Exception as e:  # surface to every waiting caller
                for _, fut, _ in pack:
                    fut.set_exception(e)
                return
            for j, (_, fut, _) in enumerate(pack):
                fut.set_result(probs[j])

    def _resolve_oldest(self, inflight):
        pack, readback, pid = inflight.popleft()
        with obs.keyed(pid):
            self._resolve(pack, readback)

    def _run(self):
        inflight = collections.deque()  # (pack, readback, pack id)
        while not self._stop.is_set():
            with obs.trace_span("fmmt.serve.idle"):
                first = self._next_item(timeout=0.05)
            if first is None:
                while inflight:  # idle: drain the pipeline
                    self._resolve_oldest(inflight)
                if (self._group is not None and time.perf_counter()
                        - self._last_header >= KEEPALIVE_S):
                    self._send(comm.IDLE)
                    self.keepalives += 1
                continue
            filling = obs.stamp()
            pack, faces = [first], self._faces_of(first[0])
            t0 = time.perf_counter()
            while len(pack) < self.server.max_batch:
                left = self.deadline - (time.perf_counter() - t0)
                if left <= 0:
                    break
                item = self._next_item(timeout=left)
                if item is None:
                    break
                need = self._faces_of(item[0])
                if faces + need > self.server.face_capacity:
                    self._holdover.append(item)  # leads the next pack
                    break
                b_cur = self._bucket_for(len(pack), faces)
                b_new = self._bucket_for(len(pack) + 1, faces + need)
                if (self.boundary_policy == "backlog"
                        and b_cur is not None and b_new is not b_cur):
                    # bucket boundary: the larger bucket only earns its step
                    # time dispatched (nearly) full, so escalate only when
                    # the backlog can fill it; otherwise dispatch the smaller
                    # bucket now and let this item lead the next pack.  Fill
                    # is counted in request slots only.
                    backlog = self._q.qsize() + len(self._holdover)
                    if backlog < b_new.max_batch - len(pack) - 1:
                        self._holdover.append(item)
                        break
                pack.append(item)
                faces += need
            self.pack_sizes.append(len(pack))
            chosen = self._bucket_for(len(pack), faces)
            pid = None if chosen is None else len(self.bucket_choices)
            _closed(pack, pid, filling)
            if chosen is None:
                # only a SINGLE request whose faces exceed every bucket's
                # buffer gets here (the drain loop bounds multi-request packs
                # by the largest bucket): fail that request and keep serving,
                # since a raise would kill the packer thread
                for _, fut, _ in pack:
                    fut.set_exception(FaceCapacityError(
                        faces, self.server.face_capacity, "serving"))
                continue
            self.bucket_choices.append((chosen.max_batch,
                                        chosen.face_capacity))
            try:
                with obs.keyed(pid):
                    batch, faces_raw = chosen.build_pack(
                        [item[0] for item in pack])
                    readback = _start_readback(
                        self._dispatch(chosen, batch, faces_raw, len(pack)))
            except Exception as e:  # surface to every waiting caller
                for _, fut, _ in pack:
                    fut.set_exception(e)
                continue
            inflight.append((pack, readback, pid))
            # keep the pipe full only under back-pressure: with nothing
            # queued, resolve now so light-load latency matches a serial
            # packer
            while (len(inflight) >= self.pipeline_depth or
                   (inflight and self._q.empty() and not self._holdover)):
                self._resolve_oldest(inflight)
        while inflight:
            self._resolve_oldest(inflight)
        if self._group is not None:
            self._send(comm.STOP)
        # fail, don't strand, anything still queued at close()
        leftovers = list(self._holdover)
        self._holdover.clear()
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue_mod.Empty:
                break
        for item in leftovers:
            item[1].set_exception(RuntimeError("AsyncBatchServer closed with "
                                               "the request still queued"))


def _closed(pack, pid, filling):
    """The recorder's rows of a pack that has closed (AsyncBatchServer's
    docstring); nothing unless it records."""
    closed = obs.stamp()
    obs.add_row("fmmt.serve.fill", filling, closed, key=pid, value=len(pack))
    for _, _, mark in pack:
        if mark is not None:
            obs.add_row("fmmt.serve.queued", mark[1], closed, key=mark[0],
                        value=pid)


def default_load_request(cfg: FacialMMTConfig) -> Dict[str, np.ndarray]:
    """benchmark_load's request: 16 tokens, full-length audio and vision
    features and 8 face crops, all zeros."""
    d = cfg.data
    return {
        "input_ids": np.ones(16, np.int32),
        "audio": np.zeros((d.audio_utt_max_len, d.audio_feat_dim),
                          np.float32),
        "vision": np.zeros((d.vision_utt_max_len, d.vision_feat_dim),
                           np.float32),
        "faces": np.zeros((8,) + FACE_SHAPE, np.uint8),
    }


def benchmark_load(server, rate_utt_per_s: float, duration_s: float = 10.0,
                   seed: int = 0, batch_deadline_ms: float = 5.0,
                   make_request=None,
                   boundary_policy: str = "backlog") -> Dict[str, Any]:
    """Drive an AsyncBatchServer over `server` (one EmotionServer or a
    sequence: a router) with Poisson arrivals at `rate_utt_per_s` for
    `duration_s`, and report the achieved throughput, end-to-end request
    latency (queue wait + packing deadline + device step) and batch fill;
    behind a router also the packs per bucket.  Over mesh servers of
    several ranks every rank calls it: the main drives the arrivals, the
    others follow, and every rank returns the main's stats."""
    front = AsyncBatchServer(server, batch_deadline_ms=batch_deadline_ms,
                             boundary_policy=boundary_policy)
    if front.plan is not None and not front.plan.is_main:
        front.close()         # returns once the main has closed its front
        return front.share(None)
    try:
        stats = _drive_load(front, rate_utt_per_s, duration_s, seed,
                            make_request)
    finally:
        front.close()
    return front.share(stats)


def _drive_load(front, rate_utt_per_s, duration_s, seed, make_request):
    rng = np.random.default_rng(seed)
    if make_request is None:
        def make_request(i):
            return default_load_request(front.server.cfg)

    lat_lock = threading.Lock()
    latencies: list = []
    futures: list = []

    def on_done(t_submit):
        def cb(fut):
            if fut.exception() is None:
                with lat_lock:
                    latencies.append(time.perf_counter() - t_submit)
        return cb

    t_start = time.perf_counter()
    i = 0
    next_t = 0.0
    while True:
        now = time.perf_counter() - t_start
        if now >= duration_s:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 0.01))
            continue
        t_submit = time.perf_counter()
        fut = front.submit(make_request(i))
        fut.add_done_callback(on_done(t_submit))
        futures.append(fut)
        i += 1
        next_t += rng.exponential(1.0 / rate_utt_per_s)
    for fut in futures:
        fut.result(timeout=60.0)
    wall = time.perf_counter() - t_start
    arr = np.asarray(latencies) * 1000
    stats = {
        "offered_rate": rate_utt_per_s,
        "achieved_utt_per_s": len(latencies) / wall,
        "p50_ms": float(np.percentile(arr, 50)),
        "p99_ms": float(np.percentile(arr, 99)),
        "mean_batch_fill": float(np.mean(front.pack_sizes)),
        "n_requests": len(latencies),
    }
    if len(front.servers) > 1:
        stats["bucket_counts"] = bucket_counts(front.bucket_choices)
    return stats


def bucket_counts(choices) -> Dict[str, int]:
    """{"max_batch,face_capacity": packs} over a front's bucket_choices."""
    return {f"{mb},{cap}": n for (mb, cap), n in sorted(
        collections.Counter(choices).items())}
