"""HTTP scoring service with dynamic micro-batching.

Counterpart of ``scl_deepfake_audio_detection_tpu/serving.py``.  The
reference has no serving story: deployment means re-running ``main.py
--eval`` over a file list, paying model construction and checkpoint load per
invocation.  The CLI's ``--serve`` keeps one warm model behind a stdin line
protocol; this module is the network front of the same idea:

* ``MicroBatcher``: one scoring worker in front of one fixed batch shape.
  Concurrent requests group into ``[batch, cut]`` blocks (a batch-1 forward
  leaves most of the card idle), waiting at most ``max_wait_ms`` for
  co-riders; the worker keeps two batches in flight (it dispatches N+1
  before it reads N back), so upload and compute overlap the readback.  The
  worker is the only thread that touches the device.
* ``make_server``: a stdlib ``ThreadingHTTPServer``.  Request threads
  decode and pad audio in parallel on the host and block on the batcher
  for the device part.

Endpoints::

    GET  /healthz           -> {"status": "ok", model/batch metadata, counters}
    GET  /metrics           -> the counters in Prometheus text format
    POST /score             -> body = raw audio bytes (wav/flac/mp3/... via
                               the native codec; suffix from X-Filename or
                               Content-Type), or JSON {"path": ..., "id": ...}
                               for server-local files.
                               reply {"id", "score", "log_probs": [spoof, bona]}
    POST /score_batch       -> JSON {"paths": [...]} -> {"results": [...]}
                               (items submitted concurrently, so one request
                               fills whole device batches on its own)

``score`` is the reference score column (bonafide log-prob, column 1, as
the eval writer and ``--serve`` print it), with the optional affine
calibration applied; the raw log-prob pair rides alongside.  The module is
numpy and stdlib: ``batch_score`` may return a device tensor, which the
worker reads back through its ``cpu()``.
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from scl_deepfake_audio_detection_torch.dsp.pad import pad_eval
from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio

_STOP = object()


def _read_back(out) -> np.ndarray:
    """A scorer's result on the host: a device tensor through its ``cpu()``."""
    return np.asarray(out.cpu() if hasattr(out, "cpu") else out)

# body suffix for in-memory uploads when X-Filename is absent: the decoders
# (native libav* / soundfile) sniff by container, but libav uses the name
# hint to pick a demuxer for headerless-ish formats
_CONTENT_SUFFIX = {
    "audio/wav": ".wav",
    "audio/x-wav": ".wav",
    "audio/wave": ".wav",
    "audio/flac": ".flac",
    "audio/x-flac": ".flac",
    "audio/mpeg": ".mp3",
    "audio/mp3": ".mp3",
    "audio/ogg": ".ogg",
    "audio/opus": ".opus",
}


class ServerBusy(RuntimeError):
    """Raised by submit when the pending queue is at ``max_queue`` — maps to
    HTTP 503.  Bounded queues keep loaded-latency bounded: past the device's
    sustained rate, queueing only grows wait time without adding throughput,
    so shedding at a depth of a few device batches is strictly better than
    an unbounded backlog."""


class _Request:
    """One pending scoring unit inside the batcher."""

    __slots__ = ("row", "long_wav", "event", "result", "error")

    def __init__(self, row: Optional[np.ndarray], long_wav: Optional[np.ndarray] = None):
        self.row = row
        self.long_wav = long_wav
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None

    def wait(self) -> np.ndarray:
        self.event.wait()
        if self.error is not None:
            raise RuntimeError(f"scoring failed: {self.error!r}") from self.error
        assert self.result is not None
        return self.result


class MicroBatcher:
    """Groups concurrent scoring requests into fixed-shape device batches.

    ``batch_score`` is the only thing that touches the device and is only
    ever called from the worker thread with ``[batch_size, cut]`` float32
    blocks: one batch shape, as in the stdin serve loop (``cli/serve.py``)
    and the eval writer.
    """

    def __init__(
        self,
        batch_score: Callable[[np.ndarray], np.ndarray],
        *,
        cut: int,
        batch_size: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: Optional[int] = None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.batch_score = batch_score
        self.cut = int(cut)
        self.batch_size = int(batch_size)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
        self.max_queue = max_queue  # None = unbounded (library default)
        self.served = 0  # requests completed (healthz/metrics counter)
        self.batches = 0  # device batches run
        self.errors = 0  # requests that failed in scoring
        self.rejected = 0  # submits shed at max_queue (ServerBusy / 503)
        # worker-time decomposition (healthz/metrics): seconds spent issuing
        # batch_score calls vs blocked on result readback.  Under the card's
        # async launches these are the two ends of the pipeline; everything else
        # the worker does (block assembly, reply fan-out) is host time.
        self.dispatch_s = 0.0
        self.readback_s = 0.0
        self._join_timeout_s = 30.0  # close() wait for the in-flight batch
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # serializes the closed-check+enqueue against close(): without it a
        # request could slip into the queue after _STOP and block its waiter
        # forever (its group would never run)
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name="scl-microbatch", daemon=True
        )
        self._worker.start()

    # -- submission (any thread) ------------------------------------------------
    def submit_async(self, row: np.ndarray) -> _Request:
        """Enqueue one pre-padded ``[cut]`` row; returns a waitable request."""
        row = np.asarray(row, dtype=np.float32)
        if row.shape != (self.cut,):
            raise ValueError(f"row shape {row.shape} != ({self.cut},)")
        req = _Request(row)
        with self._submit_lock:
            if self._closed:  # a submit after close() would hang forever
                raise RuntimeError("MicroBatcher is closed")
            self._check_backpressure()
            self._q.put(req)
        return req

    def _check_backpressure(self) -> None:
        # qsize() is exact here: puts are serialized by _submit_lock and the
        # worker only ever shrinks the queue between our check and put
        if self.max_queue is not None and self._q.qsize() >= self.max_queue:
            self.rejected += 1
            raise ServerBusy(
                f"pending queue at max_queue={self.max_queue}; retry later"
            )

    def submit(self, row: np.ndarray) -> np.ndarray:
        """Score one ``[cut]`` row; blocks, returns the log-prob vector."""
        return self.submit_async(row).wait()

    def submit_long(self, wav: np.ndarray) -> np.ndarray:
        """Score an arbitrarily-long clip via windowed crops.

        The chunked forwards run inside the worker (same ``[batch, cut]``
        program, serialized with everything else), so long clips never
        introduce a second batch shape or concurrent device calls.
        """
        req = _Request(None, long_wav=np.asarray(wav, dtype=np.float32))
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._check_backpressure()
            self._q.put(req)
        return req.wait()

    # -- worker ------------------------------------------------------------------
    def _collect(self, first: "_Request") -> Sequence["_Request"]:
        group = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(group) < self.batch_size:
            remaining = deadline - time.monotonic()
            try:
                item = (
                    self._q.get_nowait()
                    if remaining <= 0
                    else self._q.get(timeout=remaining)
                )
            except queue.Empty:
                break
            if item is _STOP:
                self._q.put(_STOP)  # re-post so the loop exits after this group
                break
            group.append(item)
        return group

    def _run(self) -> None:
        # Two batches in flight (same overlap as the eval writer's
        # train/scoring._pipelined): batch_score returns an un-read device
        # tensor, so dispatching group N+1 BEFORE reading back group N
        # overlaps N+1's upload+compute with N's readback.  Degrades to a
        # serial loop when batch_score blocks internally (e.g. reads its
        # result back) or when the queue runs dry (a lone request's reply
        # is never held back).
        pending = None  # (group, rows, un-read batch_score result)
        while True:
            if pending is None:
                item = self._q.get()
            else:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    pending = self._finalize(pending)
                    continue
            if item is _STOP:
                self._finalize(pending)
                return
            group = self._collect(item)
            if any(r.long_wav is not None for r in group):
                # long clips score individually (chunk count varies per
                # clip) and block inside score_long_audio: drain the pipe
                # and run the whole group serially
                pending = self._finalize(pending)
                self._score_serial(group)
                continue
            dispatched = self._dispatch(group)
            pending = self._finalize(pending)
            pending = dispatched

    def _dispatch(self, group: Sequence["_Request"]):
        """Issue one device batch for a rows-only group without waiting on
        the result; on a dispatch-time error fail the group immediately."""
        rows = [r for r in group if r.row is not None]
        block = np.zeros((self.batch_size, self.cut), np.float32)
        for i, r in enumerate(rows):
            block[i] = r.row
        try:
            t0 = time.monotonic()
            out = self.batch_score(block)
            self.dispatch_s += time.monotonic() - t0
        except BaseException as e:
            self._fail(group, e)
            return None
        return (group, rows, out)

    def _finalize(self, pending):
        """Read back a dispatched batch and fan out replies.  Returns None
        (the new pending state) so callers can write ``pending = ...``."""
        if pending is None:
            return None
        group, rows, out = pending
        try:
            t0 = time.monotonic()
            lp = _read_back(out)
            self.readback_s += time.monotonic() - t0
            self.batches += 1
            for i, r in enumerate(rows):
                r.result = lp[i]
        except BaseException as e:  # propagate to every waiter, keep serving
            for r in group:
                if r.result is None:
                    r.error = e
                    self.errors += 1
        finally:
            self.served += len(group)
            for r in group:
                r.event.set()
        return None

    def _fail(self, group: Sequence["_Request"], e: BaseException) -> None:
        for r in group:
            if r.result is None:
                r.error = e
                self.errors += 1
        self.served += len(group)
        for r in group:
            r.event.set()

    def _score_serial(self, group: Sequence["_Request"]) -> None:
        """The serial path for groups containing long clips: fixed-window
        rows share one block, then each long clip scores via windowed
        crops (same batch shape, same worker — never concurrent)."""
        rows = [r for r in group if r.row is not None]
        if rows:  # same dispatch+finalize (and counters) as the pipelined path
            self._finalize(self._dispatch(rows))
        for r in group:
            if r.long_wav is None:
                continue
            try:
                from scl_deepfake_audio_detection_torch.train.scoring import (
                    score_long_audio,
                )

                r.result = np.asarray(
                    score_long_audio(
                        r.long_wav,
                        self.batch_score,
                        window=self.cut,
                        batch=self.batch_size,
                    )
                )
            except BaseException as e:  # fail this clip, keep serving
                r.error = e
                self.errors += 1
            finally:
                self.served += 1
                r.event.set()

    def close(self) -> None:
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_STOP)  # under the lock: nothing can enqueue after it
        self._worker.join(timeout=self._join_timeout_s)
        # belt-and-braces: if the worker died abnormally, fail any stragglers
        # instead of leaving their wait() blocked forever
        stole_stop = False
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                stole_stop = True
            elif item.result is None:
                item.error = RuntimeError("MicroBatcher closed before scoring")
                self.errors += 1
                item.event.set()
        # if the join timed out (e.g. a slow first forward) the worker is
        # still alive and this drain just stole its _STOP — re-post it so the
        # worker exits after the in-flight batch instead of blocking forever
        if stole_stop and self._worker.is_alive():
            self._q.put(_STOP)


@dataclass
class ServeConfig:
    """Scoring policy shared by every endpoint."""

    cut: int = 64600
    padding_type: str = "zero"  # the CLI's --padding_type default
    calibration: Optional[Tuple[float, float]] = None
    long_audio: bool = False
    model_tag: str = ""
    started: float = field(default_factory=time.time)


def _score_payload(batcher: MicroBatcher, cfg: ServeConfig, wav: np.ndarray) -> dict:
    if cfg.long_audio and wav.shape[0] > cfg.cut:
        lp = batcher.submit_long(wav)
    else:
        lp = batcher.submit(pad_eval(wav.astype(np.float32), cfg.padding_type, cfg.cut))
    raw = float(lp[1])  # col 1 = bonafide log-prob (reference score column)
    score = (
        cfg.calibration[0] * raw + cfg.calibration[1] if cfg.calibration else raw
    )
    return {"score": score, "log_probs": [float(lp[0]), float(lp[1])]}


def _decode_upload(body: bytes, suffix: str) -> np.ndarray:
    """Decode in-memory audio bytes via the path-based decoder chain."""
    fd, path = tempfile.mkstemp(suffix=suffix or ".wav")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(body)
        return load_audio(path)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


class _Handler(BaseHTTPRequestHandler):
    server_version = "SCLServe/1.0"
    protocol_version = "HTTP/1.1"
    # per-socket-op deadline (StreamRequestHandler.setup -> settimeout):
    # bounds every body read/reply write so a client that advertises
    # Content-Length but never sends the bytes (slow-loris) can't park a
    # handler thread forever; handle_one_request treats a timed-out
    # keep-alive wait as a normal close.  Applies per read/write, not to the
    # whole request, so slow-but-moving uploads are unaffected.
    timeout = 60

    # quiet the default per-request stderr lines (the server stays scriptable)
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # -- small helpers -----------------------------------------------------------
    def _json(self, code: int, payload: dict,
              extra_headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    # an hour of 16 kHz float32 is ~230 MB; anything bigger is a client bug,
    # not audio — reject instead of buffering it into RAM
    MAX_BODY = 256 * 1024 * 1024

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        if n > self.MAX_BODY:
            # replying without draining n bytes would desync a keep-alive
            # stream (the unread body parses as the next request) — drop the
            # connection instead of reading 256MB+ just to discard it
            self.close_connection = True
            raise _ClientError(
                f"body of {n} bytes exceeds the {self.MAX_BODY}-byte limit"
            )
        return self.rfile.read(n) if n else b""

    # routes that never read their body still must not close the socket
    # with receive data pending (the close can RST away the queued reply):
    # drain small bodies, give up on oversized ones
    DRAIN_CAP = 64 * 1024

    def _drain_body(self) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            self.close_connection = True
            if n <= self.DRAIN_CAP:
                self.rfile.read(n)

    # -- endpoints ---------------------------------------------------------------
    def do_GET(self):  # noqa: N802
        b: MicroBatcher = self.server.batcher  # type: ignore[attr-defined]
        cfg: ServeConfig = self.server.cfg  # type: ignore[attr-defined]
        # a GET may legally carry a body (Content-Length set); no GET route
        # here reads one — drain it (_drain_body) so the reply lands cleanly
        self._drain_body()
        if self.path == "/metrics":
            return self._metrics(b, cfg)
        if self.path != "/healthz":
            return self._json(404, {"error": f"no route {self.path!r}"})
        self._json(
            200,
            {
                "status": "ok",
                "model": cfg.model_tag,
                "cut": cfg.cut,
                "batch_size": b.batch_size,
                "long_audio": cfg.long_audio,
                "calibrated": cfg.calibration is not None,
                "served": b.served,
                "batches": b.batches,
                "rejected": b.rejected,
                "queue_depth": b._q.qsize(),
                "max_queue": b.max_queue,
                "dispatch_s": round(b.dispatch_s, 3),
                "readback_s": round(b.readback_s, 3),
                "uptime_s": round(time.time() - cfg.started, 3),
            },
        )

    def _metrics(self, b: MicroBatcher, cfg: ServeConfig) -> None:
        """Prometheus text exposition (version 0.0.4) of the serve counters,
        so the service drops into standard scrape-based monitoring."""
        lines = [
            "# HELP scl_serve_requests_total Scoring requests completed "
            "(including failed ones).",
            "# TYPE scl_serve_requests_total counter",
            f"scl_serve_requests_total {b.served}",
            "# HELP scl_serve_errors_total Requests that failed in scoring.",
            "# TYPE scl_serve_errors_total counter",
            f"scl_serve_errors_total {b.errors}",
            "# HELP scl_serve_batches_total Device batches executed.",
            "# TYPE scl_serve_batches_total counter",
            f"scl_serve_batches_total {b.batches}",
            "# HELP scl_serve_batch_capacity Rows per device batch.",
            "# TYPE scl_serve_batch_capacity gauge",
            f"scl_serve_batch_capacity {b.batch_size}",
            "# HELP scl_serve_rejected_total Submits shed at max_queue "
            "(HTTP 503).",
            "# TYPE scl_serve_rejected_total counter",
            f"scl_serve_rejected_total {b.rejected}",
            "# HELP scl_serve_queue_depth Requests waiting in the batcher.",
            "# TYPE scl_serve_queue_depth gauge",
            f"scl_serve_queue_depth {b._q.qsize()}",
            "# HELP scl_serve_dispatch_seconds_total Worker seconds issuing "
            "device batches (async dispatch).",
            "# TYPE scl_serve_dispatch_seconds_total counter",
            f"scl_serve_dispatch_seconds_total {b.dispatch_s:.3f}",
            "# HELP scl_serve_readback_seconds_total Worker seconds blocked "
            "on device result readback.",
            "# TYPE scl_serve_readback_seconds_total counter",
            f"scl_serve_readback_seconds_total {b.readback_s:.3f}",
            "# HELP scl_serve_uptime_seconds Seconds since server start.",
            "# TYPE scl_serve_uptime_seconds gauge",
            f"scl_serve_uptime_seconds {time.time() - cfg.started:.3f}",
        ]
        body = ("\n".join(lines) + "\n").encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802
        batcher: MicroBatcher = self.server.batcher  # type: ignore[attr-defined]
        cfg: ServeConfig = self.server.cfg  # type: ignore[attr-defined]
        try:
            if self.path == "/score":
                return self._score_one(batcher, cfg)
            if self.path == "/score_batch":
                return self._score_batch(batcher, cfg)
            # 404 without dispatching: drain the unread body (_drain_body)
            # so the close can't RST away the queued 404 reply
            self._drain_body()
            return self._json(404, {"error": f"no route {self.path!r}"})
        except _ClientError as e:
            return self._json(400, {"error": str(e)})
        except ServerBusy as e:  # bounded-queue load shedding
            return self._json(503, {"error": str(e)},
                              extra_headers={"Retry-After": "1"})
        except RuntimeError as e:  # scoring-side failure
            return self._json(500, {"error": str(e)})

    def _score_one(self, batcher: MicroBatcher, cfg: ServeConfig) -> None:
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        body = self._body()
        rid = None
        if ctype == "application/json":
            req = _parse_json(body)
            rid = req.get("id")
            path = req.get("path")
            if not path:
                raise _ClientError("JSON body needs a 'path'")
            try:
                wav = load_audio(path)
            except Exception as e:
                raise _ClientError(f"cannot decode {path!r}: {e}")
        else:
            if not body:
                raise _ClientError("empty body: POST audio bytes or JSON {'path': ...}")
            name = self.headers.get("X-Filename", "")
            suffix = os.path.splitext(name)[1] or _CONTENT_SUFFIX.get(ctype, ".wav")
            rid = name or None
            try:
                wav = _decode_upload(body, suffix)
            except Exception as e:
                raise _ClientError(f"cannot decode upload ({suffix}): {e}")
        out = _score_payload(batcher, cfg, wav)
        if rid is not None:
            out["id"] = rid
        self._json(200, out)

    def _score_batch(self, batcher: MicroBatcher, cfg: ServeConfig) -> None:
        req = _parse_json(self._body())
        paths = req.get("paths")
        if not isinstance(paths, list) or not paths:
            raise _ClientError("JSON body needs a non-empty 'paths' list")
        # decode first, then submit every decodable row before waiting on any,
        # so one request fills whole device batches on its own
        pending = []
        for p in paths:
            try:
                wav = load_audio(p)
                if cfg.long_audio and wav.shape[0] > cfg.cut:
                    pending.append((p, None, wav))
                else:
                    row = pad_eval(wav.astype(np.float32), cfg.padding_type, cfg.cut)
                    pending.append((p, batcher.submit_async(row), None))
            except Exception as e:
                pending.append((p, None, _ClientError(str(e))))
        results = []
        for p, handle, extra in pending:
            if isinstance(extra, _ClientError):
                results.append({"path": p, "error": str(extra)})
                continue
            try:
                lp = handle.wait() if handle is not None else batcher.submit_long(extra)
            except RuntimeError as e:
                results.append({"path": p, "error": str(e)})
                continue
            raw = float(lp[1])
            score = (
                cfg.calibration[0] * raw + cfg.calibration[1]
                if cfg.calibration
                else raw
            )
            results.append(
                {"path": p, "score": score, "log_probs": [float(lp[0]), float(lp[1])]}
            )
        self._json(200, {"results": results})


class _ClientError(ValueError):
    """Maps to HTTP 400."""


def _parse_json(body: bytes) -> dict:
    try:
        out = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise _ClientError(f"invalid JSON body: {e}")
    if not isinstance(out, dict):
        raise _ClientError("JSON body must be an object")
    return out


class ScoreServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the batcher + scoring policy."""

    daemon_threads = True
    # socketserver's default listen backlog is 5: a burst of concurrent
    # clients gets connection-reset before a handler thread even spawns
    request_queue_size = 512

    def __init__(self, addr, batcher: MicroBatcher, cfg: ServeConfig):
        super().__init__(addr, _Handler)
        self.batcher = batcher
        self.cfg = cfg

    def close(self) -> None:
        self.server_close()
        self.batcher.close()


def make_server(
    batch_score: Callable[[np.ndarray], np.ndarray],
    *,
    cut: int,
    host: str = "127.0.0.1",
    port: int = 0,
    batch_size: int = 8,
    max_wait_ms: float = 5.0,
    max_queue: Optional[int] = None,
    padding_type: str = "zero",
    calibration: Optional[Tuple[float, float]] = None,
    long_audio: bool = False,
    model_tag: str = "",
) -> ScoreServer:
    """Build (but don't run) the HTTP scorer; ``port=0`` binds an ephemeral port."""
    batcher = MicroBatcher(
        batch_score, cut=cut, batch_size=batch_size, max_wait_ms=max_wait_ms,
        max_queue=max_queue,
    )
    cfg = ServeConfig(
        cut=cut,
        padding_type=padding_type,
        calibration=calibration,
        long_audio=long_audio,
        model_tag=model_tag,
    )
    return ScoreServer((host, port), batcher, cfg)


def serve_http(batch_score, **kw) -> int:
    """CLI entry: build the server, announce the port, run until interrupt.

    SIGTERM (the orchestrator's stop signal) drains gracefully: stop
    accepting connections, finish in-flight scoring, then exit 0 — so a
    rolling restart never drops accepted requests."""
    import signal
    import sys

    server = make_server(batch_score, **kw)
    host, port = server.server_address[:2]

    def _drain(signum, frame):
        print("serve_http: SIGTERM — draining and shutting down",
              file=sys.stderr)
        # shutdown() must not be called from the thread running
        # serve_forever(); the handler runs ON that (main) thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        prev = signal.signal(signal.SIGTERM, _drain)
    except ValueError:  # not the main thread (library/test use): skip
        prev = None
    # banner AFTER the handler: once "listening" prints, SIGTERM is graceful
    print(
        f"serve_http: listening on http://{host}:{port} "
        f"(POST /score, /score_batch; GET /healthz, /metrics)",
        file=sys.stderr,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()  # joins the batcher worker; in-flight replies land
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
    return 0
