"""Micro-batching gesture generation server.

Port of `diffusestylegesture_tpu/sample/server.py`. The reference has no
serving story (its `sample.py` is a one-shot CLI,
`main/mydiffusion_zeggs/sample.py:341-420`); the denoiser is cheapest per
frame when it runs batched, so this layer packs concurrent requests into one
engine call:

  * requests (audio, style) are queued; a dispatcher thread drains up to
    `max_batch` of them, waiting at most `max_delay_ms` past the first;
  * audio lengths are padded up to a small set of window-count buckets, so
    the engine captures one denoiser graph set per batch size instead of one
    per length; WavLM runs only over the windows that carry a request's
    audio, packed and rounded up to whole chunks of one captured graph
    (`ZeggsSampler.encode_packed`), and the rest of the batch's grid of
    windows gets zero features: dummy rows are dropped, and a clip's windows
    past its own count come after every frame it delivers;
  * every request in a batch shares the window loop; per-request styles ride
    the batch axis; outputs are cropped back to their true lengths;
  * results are delivered through per-request `concurrent.futures.Future`s.

Threads. Only the dispatcher thread touches the card: it captures the
engine's CUDA graphs at first use and launches every batch. `submit` and the
callers' threads stay on the host (numpy and seeds), so no other thread
launches CUDA work while a graph is captured. The dispatcher runs two stages:
it enqueues batch k+1 (encoder, windowed denoiser, the copy of the result
into pinned host memory and an event after it) before it waits on batch k's
event, so the card holds the next batch while the host assembles and
delivers the previous one. Nothing in the dispatch waits for the card.

Tracing (`utils/profiling.py`, off by default): a `server.request` span per
request (submit → its future resolved), and per batch `server.collect`,
`server.dispatch` (its request ids, rows real and padded, bucket, windows
encoded, windows carrying a request's audio, windows skipped, windows
sampled) and `server.finalize`; a batch's id is its first request's. Beside
`batches_served` and `requests_served` the server always counts
`rows_padded`, `windows_encoded` (windows WavLM ran over),
`windows_padding` (encoded windows that carry no request's audio),
`windows_skipped` (windows of the batch's rows × bucket grid that WavLM did
not run over) and `requests_by_bucket` over the batches it dispatched;
`counters()` adds the sampler's `cond_encodes` (windows whose conditioning
invariants were computed once, at the window's start).
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils import profiling
from .engine import ZeggsSampler, _to_device, slice_audio_windows, unnormalize_poses


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    max_batch: int = 16
    max_delay_ms: float = 50.0
    # window-count buckets (ascending); requests pad up to the nearest.
    # 5 windows = 20 s of audio under the ZEGGS geometry.
    window_buckets: Sequence[int] = (1, 2, 5, 10, 20)
    # style-vector size; requests are validated against it at submit() so one
    # malformed request cannot fail its co-batched peers
    style_dim: int = 6


@dataclasses.dataclass
class _Request:
    audio: np.ndarray
    style: np.ndarray
    seed: int
    num_windows: int
    future: Future
    id: int = 0
    submitted_ns: int = 0  # time.time_ns() at submit while tracing is on, else 0


@dataclasses.dataclass
class _Dispatched:
    """A batch on its way: the pinned host copy of its output and the event
    recorded after that copy (None on the CPU, where the copy is done)."""
    host: torch.Tensor
    event: Optional[torch.cuda.Event]


class GestureServer:
    """Micro-batching front end over a `ZeggsSampler`, on the sampler's device::

        server = GestureServer(sampler, model, wavlm, mean, std).start()
        fut = server.submit(audio, style)      # from any thread
        poses = fut.result()                   # (T, njoints) un-normalized
        server.stop()

    RNG: `submit` draws a 64-bit seed for each request from a host generator
    seeded by `seed`; a batch runs under its first request's seed, each clip
    drawing its own noise through the batch axis. So a solo request
    reproduces from its own seed, and co-batched requests depend on their
    companions.
    """

    def __init__(self, sampler: ZeggsSampler, params, wavlm_params,
                 mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                 cfg: ServerConfig = ServerConfig(), seed: int = 0):
        self.sampler = sampler
        self.params = params
        self.wavlm_params = wavlm_params
        self.mean = mean
        self.std = std
        self.cfg = cfg
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # dispatcher-owned staging for requests whose bucket did not match the
        # batch being built; pending[0] is always the OLDEST unserved request
        # and sets the next batch's bucket
        self._pending: Deque[_Request] = deque()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # makes submit's running-check + enqueue atomic with stop's final
        # drain: without it a submit could pass the check and enqueue into an
        # already-drained queue (a Future that never resolves)
        self._submit_lock = threading.Lock()
        self._rng_lock = threading.Lock()
        self._rng = np.random.default_rng(seed)
        self._ids = itertools.count()
        self.batches_served = 0
        self.requests_served = 0
        self.rows_padded = 0
        self.windows_encoded = 0
        self.windows_padding = 0
        self.windows_skipped = 0
        self.requests_by_bucket: Dict[int, int] = {}

    # -- client API ---------------------------------------------------------

    def submit(self, audio: np.ndarray, style: np.ndarray) -> Future:
        """Enqueue one clip; returns a Future of (T, njoints) poses. Host work only."""
        audio = np.asarray(audio, np.float32)
        ecfg = self.sampler.cfg
        num = len(audio) // ecfg.samples_per_stride
        if num == 0:
            # as ZeggsSampler.generate: refuse instead of making motion from
            # an all-zero padded window
            raise ValueError(f"audio too short: {len(audio)} samples < one "
                             f"{ecfg.samples_per_stride}-sample window")
        style = np.asarray(style, np.float32).reshape(-1)
        if style.shape[0] != self.cfg.style_dim:
            # validated here so that a bad request cannot fail its whole batch
            raise ValueError(f"style has {style.shape[0]} dims, expected {self.cfg.style_dim}")
        if self._bucket_for(num) is None:
            raise ValueError(
                f"clip needs {num} windows > max bucket {max(self.cfg.window_buckets)}")
        with self._rng_lock:
            seed = int(self._rng.integers(0, 2 ** 63 - 1, dtype=np.int64))
        fut: Future = Future()
        with self._submit_lock:
            if self._stop.is_set() or self._thread is None:
                # a submit racing stop() (or before start()) would otherwise
                # return a Future that never resolves
                raise RuntimeError("server is not running (submit before start() or after stop())")
            self._queue.put(_Request(
                audio=audio, style=style, seed=seed, num_windows=num, future=fut,
                id=next(self._ids), submitted_ns=time.time_ns() if profiling.enabled() else 0))
        return fut

    def counters(self) -> dict:
        """The server's counters, as `cli/serve.py` prints them."""
        return {"served": self.requests_served, "batches": self.batches_served,
                "rows_padded": self.rows_padded, "windows_encoded": self.windows_encoded,
                "windows_padding": self.windows_padding,
                "windows_skipped": self.windows_skipped,
                "requests_by_bucket": dict(sorted(self.requests_by_bucket.items())),
                "cond_encodes": self.sampler.cond_encodes}

    def start(self) -> "GestureServer":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                # a long batch is still in flight past the join timeout: the
                # dispatcher owns _pending/_queue and keeps serving until they
                # drain; clearing them here would double-resolve futures
                return
            self._thread = None
        # a request that slipped past the dispatcher's final drain (the
        # submit/stop race) must not leave its client blocked forever; the
        # submit lock orders this after any in-flight enqueue
        with self._submit_lock:
            leftovers: List[_Request] = list(self._pending)
            self._pending.clear()
            while True:
                try:
                    leftovers.append(self._queue.get_nowait())
                except queue.Empty:
                    break
        self._fail(leftovers, RuntimeError("server stopped before serving this request"))

    # -- internals ----------------------------------------------------------

    def _bucket_for(self, num_windows: int) -> Optional[int]:
        for b in self.cfg.window_buckets:
            if num_windows <= b:
                return b
        return None

    def _collect_batch(self) -> List[_Request]:
        """Drain up to max_batch requests sharing the OLDEST unserved request's
        bucket, waiting at most max_delay_ms past its arrival.

        Requests of another bucket stage in `_pending` (FIFO), and the next
        batch's bucket always comes from `pending[0]`: re-queueing them at the
        queue's tail would let a steady stream of one bucket starve a request
        of another forever."""
        if not self._pending:
            try:
                self._pending.append(self._queue.get(timeout=0.1))
            except queue.Empty:
                return []
        batch = [self._pending.popleft()]
        bucket = self._bucket_for(batch[0].num_windows)
        deadline = time.monotonic() + self.cfg.max_delay_ms / 1000.0
        # sweep already-staged same-bucket requests first (order kept)
        keep: Deque[_Request] = deque()
        while self._pending and len(batch) < self.cfg.max_batch:
            req = self._pending.popleft()
            if self._bucket_for(req.num_windows) == bucket:
                batch.append(req)
            else:
                keep.append(req)
        keep.extend(self._pending)
        self._pending = keep
        # then wait for new arrivals up to the deadline
        while len(batch) < self.cfg.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if self._bucket_for(req.num_windows) == bucket:
                batch.append(req)
            else:
                self._pending.append(req)  # next batch, FIFO order
        return batch

    def _loop(self) -> None:
        """Two stages: enqueue batch k+1 on the card, then wait for batch k and
        deliver it. A batch's failure goes to its futures; the loop serves on."""
        inflight = None
        while (not self._stop.is_set() or not self._queue.empty() or self._pending
               or inflight is not None):
            with profiling.span("server.collect") as sp:
                batch = self._collect_batch()
                if batch:
                    sp.set(batch=batch[0].id)
                else:
                    sp.drop()  # a poll that found no request is no span
            dispatched = None
            if batch:
                try:
                    dispatched = (batch, self._dispatch_batch(batch))
                except Exception as e:  # deliver the failure, keep serving
                    self._fail(batch, e)
            if inflight is not None:
                try:
                    self._finalize_batch(*inflight)
                except Exception as e:
                    self._fail(inflight[0], e)
            inflight = dispatched

    def _run_batch(self, batch: List[_Request]) -> None:
        """Synchronous convenience path (dispatch + finalize)."""
        self._finalize_batch(batch, self._dispatch_batch(batch))

    @torch.inference_mode()
    def _dispatch_batch(self, batch: List[_Request]) -> _Dispatched:
        """Enqueue the batch on the device without waiting for it: inputs go
        through pinned memory, the output comes back into pinned memory, and
        an event marks the end. The pieces are `generate_multi_clip`'s: one
        encoder pass over the windows that carry the clips' audio, scattered
        into the B × bucket grid, then the window loop over the batch's
        longest clip (the windows past it would only feed windows nobody
        reads)."""
        with profiling.span("server.dispatch") as sp:
            sampler, ecfg = self.sampler, self.sampler.cfg
            dev = sampler.device
            bucket = self._bucket_for(batch[0].num_windows)
            # every batch padded to max_batch, so the engine captures one batch
            # size and the reference crossfade quirk (crossfade_n=None: the
            # weights follow the batch size) takes its n at max_batch; dummy
            # rows past len(batch) have no windows, zero features and styles,
            # and their outputs are dropped
            B = self.cfg.max_batch
            clips = [slice_audio_windows(req.audio, ecfg)[:bucket] for req in batch]
            styles = np.zeros((B, self.cfg.style_dim), np.float32)
            styles[: len(batch)] = [req.style for req in batch]
            carried = sum(c.shape[0] for c in clips)  # windows that carry a request's audio
            feats, encoded = sampler.encode_packed(self.wavlm_params, clips, B, bucket)
            generator = torch.Generator(device=dev).manual_seed(batch[0].seed)
            num_windows = max(req.num_windows for req in batch)
            out = sampler.sample_windows(self.params, lambda w: feats[:, w], num_windows,
                                         _to_device(styles, dev), generator)
            seq = out[:, :, 0].transpose(1, 2)  # (B, T, C)
            if dev.type == "cpu":
                done = _Dispatched(seq.clone(), None)
            else:
                host = torch.empty(seq.shape, dtype=seq.dtype, pin_memory=True)
                host.copy_(seq, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                done = _Dispatched(host, event)
            self.rows_padded += B - len(batch)
            self.windows_encoded += encoded
            self.windows_padding += encoded - carried
            self.windows_skipped += B * bucket - encoded
            self.requests_by_bucket[bucket] = self.requests_by_bucket.get(bucket, 0) + len(batch)
            if sp:
                sp.set(batch=batch[0].id, requests=[req.id for req in batch],
                       rows_real=len(batch), rows_padded=B - len(batch), bucket=bucket,
                       windows_encoded=encoded, windows_carried=carried,
                       windows_skipped=B * bucket - encoded, windows_sampled=num_windows)
            return done

    def _finalize_batch(self, batch: List[_Request], out: _Dispatched) -> None:
        """Wait for the batch's event (not for later batches), un-normalize on
        the host and deliver."""
        with profiling.span("server.finalize", batch=batch[0].id):
            if out.event is not None:
                out.event.synchronize()
            seq = unnormalize_poses(out.host.numpy(), self.mean, self.std)
            ecfg = self.sampler.cfg
            for i, req in enumerate(batch):
                self._resolve(req, seq[i, : req.num_windows * ecfg.stride - ecfg.n_seed])
            self.batches_served += 1
            self.requests_served += len(batch)

    def _fail(self, batch: List[_Request], e: Exception) -> None:
        for req in batch:
            if not req.future.done():
                self._resolve(req, error=e)

    def _resolve(self, req: _Request, result=None, error: Optional[Exception] = None) -> None:
        """Deliver a request's result or failure; its `server.request` span
        ends here (recorded where tracing was on at its submit)."""
        if error is None:
            req.future.set_result(result)
        else:
            req.future.set_exception(error)
        if req.submitted_ns and profiling.enabled():
            profiling.record("server.request", req.submitted_ns, time.time_ns(), request=req.id,
                             bucket=self._bucket_for(req.num_windows), windows=req.num_windows,
                             failed=error is not None)
