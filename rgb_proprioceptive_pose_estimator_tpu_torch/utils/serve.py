"""HTTP pose-serving daemon over the port's `api.Predictor` (counterpart
of the JAX package's ``utils/serve.py``, with its wire protocol byte for
byte, so that a client of one serves with the other): the predict()
surface, exposed to robot stacks that are NOT in-process Python -- a ROS
bridge, a C++ controller, a remote teleop client.

Deliberately stdlib-only (http.server + json + base64): the serving host
of a robot cell should not grow a web-framework dependency tree, and the
Predictor underneath already does the real work (chunking, the CUDA
kernels, dead-camera signatures). One process serves one model;
scale-out is N processes behind any TCP load balancer.

Wire protocol (JSON over HTTP):

  GET /healthz
      -> 200 {"status": "ok", "step", "cameras", "image_size",
              "temporal_frames", "proprio_dim", "quat_order": "wxyz",
              "requests", "p50_ms"}

  POST /predict      body: a single observation
      {
        "proprio": [f32 ...],                  # (D,) or nested (B/T,D)
        "images": {
          "<camera>": {"b64": "<base64>", "encoding": "jpeg"|"png"},
          # or raw pixels: {"b64": ..., "encoding": "raw",
          #                 "shape": [H, W, 3]}   (uint8, any leading dims)
          # or plain nested uint8 lists (convenience, slow for big images)
        }
      }
      -> 200 {"pos": [x, y, z], "quat": [w, x, y, z],
              "quat_order": "wxyz", "ms": <server-side latency>}

A configured camera may be omitted exactly when the in-process Predictor
allows it (model.camera_dropout training or allow_missing_cameras) — the
dead-camera request runs the cheaper structural-absence signature.
Malformed requests get 400 with {"error": ...}; everything else 500.

Temporal streaming (temporal_frames > 1 models): instead of re-shipping
the full (T, ...) window every tick, a client adds a "session" field and
sends ONE frame per request (single-frame shapes, no T dim):

  POST /predict   {"session": "<opaque id>", "reset": false,
                   "proprio": [...], "images": {...}}

The server keeps a per-session rolling window (utils/obs_buffer.ObsBuffer
— same clamp-at-start padding as training) and predicts on the stacked
window, so frame-by-frame HTTP answers match an in-process ObsBuffer +
Predictor loop bitwise. "reset": true clears the window first (episode
boundary). Sessions are evicted after `session_ttl_s` idle seconds or
beyond `max_sessions` (LRU).

Session responses additionally carry:

  "window_fill": k, "window_size": T   — k real frames in the window; a
      client seeing k < T after it already streamed T frames knows its
      temporal context was reset (eviction, server restart) and can
      re-prime before trusting the pose.
  "session_restarted": true           — on the response that implicitly
      created the session when the request did NOT ask for "reset": true
      (an evicted-mid-episode session resuming, or a restarted server).
      Start episodes with "reset": true and this flag is unambiguous.
  "dead_cameras": [...]               — cameras the stacked window omitted
      (see below); absent when every configured camera is live.

Dead sensors mid-episode: when the model tolerates missing cameras
(trained with model.camera_dropout > 0, or the service's Predictor opts
in via allow_missing_cameras), a session frame MAY omit cameras — the
stream keeps flowing through a sensor failure instead of falling back to
full-window re-ship. A camera absent from ANY frame of the current
window is omitted from the model input entirely (whole-window structural
absence — the representation camera_dropout trains, which zeroes a
camera per sample, never per frame; utils/obs_buffer.py) and revives
automatically after T consecutive live frames. Models without dropout
training still require the full frame, as before.

Resource limits: request bodies above `max_body_mb` are refused with 413
before reading (one misbehaving client must not OOM the pose server
mid-episode); a connection that stalls mid-body for `read_timeout_s` gets
408 and is closed.

With `cli serve --coalesce-ms W` (PoseService(coalesce_ms=W)), concurrent
standard-signature requests arriving within a W-millisecond window are
micro-batched into ONE device call (see PoseService docstring) -- the
answer to multi-client load, since one batched forward costs barely more
than a batch-1 forward.

The card's host may have no OpenCV: it is imported only where a jpeg or
png image is decoded, so raw and nested-list images serve without it.
"""

from __future__ import annotations

import base64
import json
import queue
import socket
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config


class BadRequest(ValueError):
    """Client-side protocol error -> HTTP 400."""


def _decode_image(spec: Any) -> np.ndarray:
    """One camera's wire value -> uint8 ndarray (HWC or with leading
    batch/time dims). Accepts the three forms documented above."""
    if isinstance(spec, (list, tuple)):
        arr = np.asarray(spec)
        if arr.dtype.kind not in "iuf":
            raise BadRequest("image nested list must be numeric")
        return arr.astype(np.uint8)
    if not isinstance(spec, dict) or "b64" not in spec:
        raise BadRequest(
            "image must be nested uint8 lists or "
            '{"b64": ..., "encoding": "jpeg"|"png"|"raw"[, "shape": ...]}')
    try:
        buf = base64.b64decode(spec["b64"], validate=True)
    except Exception as e:
        raise BadRequest(f"invalid base64 image payload: {e}")
    enc = spec.get("encoding", "jpeg")
    if enc in ("jpeg", "png"):
        from rgb_proprioceptive_pose_estimator_tpu_torch.data.augment import (
            decode_image,
        )

        try:
            return decode_image(np.frombuffer(buf, np.uint8))
        except ValueError as e:
            raise BadRequest(str(e))
    if enc == "raw":
        shape = spec.get("shape")
        if not shape:
            raise BadRequest('raw image needs a "shape" field')
        arr = np.frombuffer(buf, np.uint8)
        try:
            return arr.reshape(shape)
        except ValueError:
            raise BadRequest(
                f"raw image payload has {arr.size} bytes, which does not "
                f"reshape to {shape}")
    raise BadRequest(f"unknown image encoding {enc!r}")


def _parse_obs(body: bytes) -> Dict[str, Any]:
    try:
        req = json.loads(body)
    except json.JSONDecodeError as e:
        raise BadRequest(f"body is not valid JSON: {e}")
    if not isinstance(req, dict):
        raise BadRequest("body must be a JSON object")
    return _obs_from_req(req)


def _obs_from_req(req: Dict[str, Any]) -> Dict[str, Any]:
    obs: Dict[str, Any] = {}
    if "proprio" in req:
        p = np.asarray(req["proprio"], dtype=np.float32)
        obs["proprio"] = p
    if "images" in req:
        if not isinstance(req["images"], dict):
            raise BadRequest('"images" must map camera name -> image')
        obs["images"] = {c: _decode_image(v)
                         for c, v in req["images"].items()}
    if not obs:
        raise BadRequest('need "proprio" and/or "images"')
    return obs


def _parse_request(body: bytes
                   ) -> Tuple[Dict[str, Any], Optional[str], bool]:
    """body -> (obs, session_id, reset). The session/reset fields ride in
    the same JSON object as the observation (wire protocol above)."""
    try:
        req = json.loads(body)
    except json.JSONDecodeError as e:
        raise BadRequest(f"body is not valid JSON: {e}")
    if not isinstance(req, dict):
        raise BadRequest("body must be a JSON object")
    session = req.get("session")
    if session is not None and not isinstance(session, str):
        raise BadRequest('"session" must be a string id')
    reset = bool(req.get("reset", False))
    return _obs_from_req(req), session, reset


class _Pending:
    """One enqueued coalescable request: the waiter blocks on `event`,
    the batch worker fills `result` (a (pos, quat) row pair) or `exc`."""

    __slots__ = ("obs", "event", "result", "exc")

    def __init__(self, obs: Dict[str, Any]):
        self.obs = obs
        self.event = threading.Event()
        self.result: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.exc: Optional[Exception] = None


class PoseService:
    """The model side of the server: one Predictor + a serialization lock
    (one device stream; interleaving calls buys nothing) + rolling
    latency stats for /healthz.

    With coalesce_ms > 0, concurrent single-observation requests are
    micro-batched: the first request opens a window of that many
    milliseconds, every standard-signature request arriving inside it
    joins the same max_batch call, and the results scatter back to their
    waiters. One device call amortizes the fixed per-call latency
    (host->device transfer + kernel launches) across the whole window --
    under N concurrent clients the serialized alternative pays that fixed
    cost N times. Requests that are already batched, use a dead-camera
    signature, or have non-standard shapes bypass the queue and run solo
    (correctness first; only the common control-loop case is
    accelerated).

    The weights are the Predictor's: the checkpoint that ``step`` names in
    ``ckpt_dir``, or ``state``/``model``, or the checkpoint file
    ``ckpt_path``, on ``device`` (CUDA by default)."""

    def __init__(self, cfg: Config, ckpt_dir: Optional[str] = None,
                 step: Union[int, str, None] = None, max_batch: int = 8,
                 warmup: bool = True, state=None, model=None,
                 coalesce_ms: float = 0.0, max_sessions: int = 64,
                 session_ttl_s: float = 600.0, *,
                 ckpt_path: Optional[str] = None, device=None):
        from rgb_proprioceptive_pose_estimator_tpu_torch.api import Predictor

        self.cfg = cfg
        self.predictor = Predictor(cfg, ckpt_dir=ckpt_dir, step=step,
                                   max_batch=max_batch, state=state,
                                   model=model, ckpt_path=ckpt_path,
                                   device=device)
        self.step = int(self.predictor.step)
        self.max_batch = max_batch
        self.coalesce_ms = float(coalesce_ms)
        self._lock = threading.Lock()
        self._lat_ms: deque = deque(maxlen=256)
        self._requests = 0
        self._n_batches = 0                  # monotonic (health "count")
        self._batch_sizes: deque = deque(maxlen=256)   # rolling (mean only)
        self._queue: "queue.SimpleQueue[Optional[_Pending]]" = \
            queue.SimpleQueue()
        # streaming sessions: id -> (ObsBuffer, last_seen monotonic);
        # OrderedDict gives LRU eviction order
        self.max_sessions = int(max_sessions)
        self.session_ttl_s = float(session_ttl_s)
        self._sessions: "OrderedDict[str, Tuple[Any, float]]" = OrderedDict()
        self._session_lock = threading.Lock()
        self._closing = False
        self._worker: Optional[threading.Thread] = None
        if self.coalesce_ms > 0:
            self._worker = threading.Thread(
                target=self._batch_loop, name="rppe-coalesce", daemon=True)
            self._worker.start()
        if warmup:
            self.predictor.warmup()

    # -- request paths ----------------------------------------------------

    def predict(self, obs: Dict[str, Any], session: Optional[str] = None,
                reset: bool = False) -> Dict[str, Any]:
        t0 = time.perf_counter()
        meta: Dict[str, Any] = {}
        if session is not None:
            obs, meta = self._session_window(session, obs, reset)
        if (self._worker is not None and not self._closing
                and self._coalescable(obs)):
            item = _Pending(obs)
            self._queue.put(item)
            # 60 s >> any first call (kernel build); a dead worker must
            # not hang the HTTP thread forever
            if not item.event.wait(timeout=60.0):
                raise RuntimeError("coalesce worker timed out")
            if item.exc is not None:
                raise item.exc
            assert item.result is not None
            pos, quat = item.result
            ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self._lat_ms.append(ms)
                self._requests += 1
        else:
            with self._lock:
                pos, quat = self.predictor(obs)
                ms = (time.perf_counter() - t0) * 1e3
                # stats mutate under the same lock health() reads them
                # with -- iterating a deque while another request thread
                # appends raises
                self._lat_ms.append(ms)
                self._requests += 1
        out = {"pos": np.asarray(pos).tolist(),
               "quat": np.asarray(quat).tolist(),
               "quat_order": "wxyz",
               "ms": round(ms, 3)}
        out.update(meta)
        return out

    def _session_window(self, sid: str, obs: Dict[str, Any], reset: bool
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Push one frame into the session's rolling window; return the
        temporally-stacked observation (training-identical clamp-at-start
        padding via ObsBuffer) plus the session-transparency response
        fields (wire protocol in the module docstring). The frame is
        validated BEFORE the push so a malformed request cannot poison the
        window; cameras may be omitted exactly when the Predictor accepts
        structurally dead cameras."""
        from rgb_proprioceptive_pose_estimator_tpu_torch.utils.obs_buffer import (
            ObsBuffer,
        )

        m = self.cfg.model
        self._check_session_frame(obs)
        now = time.monotonic()
        with self._session_lock:
            for k in [k for k, (_, seen) in self._sessions.items()
                      if now - seen > self.session_ttl_s]:
                del self._sessions[k]
            entry = self._sessions.pop(sid, None)
            # a session id we have no window for, on a request that did
            # NOT ask for a reset, means the client thinks it is
            # mid-episode but the server lost its context (TTL/LRU
            # eviction, restart) -- flag it so the degradation is never
            # silent
            restarted = entry is None and not reset
            buf = entry[0] if entry is not None else ObsBuffer(m)
            if reset:
                buf.reset()
            out = buf.push(obs)
            fill, dead = len(buf), buf.dead_cameras()
            self._sessions[sid] = (buf, now)     # most-recently-used last
            while len(self._sessions) > self.max_sessions:
                self._sessions.popitem(last=False)
        if (m.backbone != "none" and not m.use_proprio
                and len(dead) == len(m.cameras)):
            # every camera is absent from at least one frame of the window
            # (disjoint per-frame sensor gaps), so whole-window structural
            # absence leaves the model ZERO inputs. The frame itself was
            # valid and WAS recorded, so the client should keep streaming:
            # a camera revives once present for the full window. Without
            # this guard the Predictor's "supplies none of the cameras"
            # error would surface instead, wrongly telling the client its
            # (live-camera-carrying) frame was malformed.
            raise BadRequest(
                "current window has no live camera: each of "
                f"{list(m.cameras)} is missing from at least one of the "
                f"last {max(m.temporal_frames, 1)} frames and this model "
                "has no proprio branch to fall back on. The frame was "
                "recorded; keep streaming -- a camera revives once it has "
                "been present for the full window.")
        meta: Dict[str, Any] = {"window_fill": fill,
                                "window_size": max(m.temporal_frames, 1)}
        if restarted:
            meta["session_restarted"] = True
        if dead:
            meta["dead_cameras"] = dead
        return out, meta

    def _check_session_frame(self, obs: Dict[str, Any]) -> None:
        """Validate ONE single-frame observation for the session path.
        Cameras may be a SUBSET of the configured set iff the underlying
        Predictor accepts structurally dead cameras (camera_dropout
        training or allow_missing_cameras) -- the mid-episode sensor-loss
        case; otherwise the full frame is required."""
        m = self.cfg.model
        allow_dead = getattr(self.predictor, "allow_missing_cameras", False)
        if m.use_proprio:
            p = obs.get("proprio")
            if p is None or np.shape(p) != (m.proprio_dim,):
                raise BadRequest(
                    "session request must carry ONE standard frame: "
                    f"proprio of shape ({m.proprio_dim},)")
        if m.backbone != "none":
            imgs = obs.get("images")
            if not isinstance(imgs, dict):
                raise BadRequest(
                    'session request must carry ONE standard frame with an '
                    '"images" dict')
            unknown = sorted(set(imgs) - set(m.cameras))
            if unknown:
                raise BadRequest(
                    f"unknown cameras {unknown}; model.cameras="
                    f"{list(m.cameras)}")
            missing = [c for c in m.cameras if c not in imgs]
            if missing and not allow_dead:
                raise BadRequest(
                    f"session frame is missing cameras {missing} of "
                    f"model.cameras={list(m.cameras)}; streaming through a "
                    "dead sensor needs a model trained with "
                    "model.camera_dropout > 0 (or a service built with "
                    "allow_missing_cameras=True)")
            if not imgs and not m.use_proprio:
                raise BadRequest(
                    "session frame supplies no camera and the model has "
                    "no proprio branch")
            hw = (m.image_size, m.image_size, 3)
            for c, v in imgs.items():
                if np.shape(v) != hw:
                    raise BadRequest(
                        f"session frame camera {c!r} has shape "
                        f"{tuple(np.shape(v))}, expected {hw} (single "
                        "frame, no T/batch dims)")

    def _coalescable(self, obs: Dict[str, Any]) -> bool:
        """True iff obs is ONE standard-signature sample: full camera set
        at the model's resolution, proprio of the model's width -- the
        shapes that stack into one max_batch call."""
        m = self.cfg.model
        t = () if m.temporal_frames == 1 else (m.temporal_frames,)
        return self._signature_ok(obs, t)

    def _signature_ok(self, obs: Dict[str, Any], t: Tuple[int, ...]) -> bool:
        m = self.cfg.model
        if m.use_proprio:
            p = obs.get("proprio")
            if p is None or np.shape(p) != (*t, m.proprio_dim):
                return False
        if m.backbone != "none":
            imgs = obs.get("images")
            if not isinstance(imgs, dict) or set(imgs) != set(m.cameras):
                return False
            hw = (m.image_size, m.image_size, 3)
            for v in imgs.values():
                if np.shape(v) != (*t, *hw):
                    return False
        return True

    def _batch_loop(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:          # close() sentinel
                return
            items = [first]
            deadline = time.perf_counter() + self.coalesce_ms / 1e3
            while len(items) < self.max_batch:
                remaining = deadline - time.perf_counter()
                try:
                    nxt = (self._queue.get(timeout=remaining)
                           if remaining > 0 else self._queue.get_nowait())
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_batch(items)
                    return
                items.append(nxt)
            self._run_batch(items)

    def _run_batch(self, items: List[_Pending]) -> None:
        m = self.cfg.model
        try:
            stacked: Dict[str, Any] = {}
            if m.use_proprio:
                stacked["proprio"] = np.stack(
                    [np.asarray(it.obs["proprio"], np.float32)
                     for it in items])
            if m.backbone != "none":
                stacked["images"] = {
                    c: np.stack([np.asarray(it.obs["images"][c], np.uint8)
                                 for it in items])
                    for c in m.cameras}
            with self._lock:
                pos, quat = self.predictor(stacked)
                self._n_batches += 1
                self._batch_sizes.append(len(items))
            # np.stack added an explicit batch dim, so the Predictor
            # always returns (B, 3)/(B, 4) here -- no squeeze case
            pos = np.asarray(pos, np.float32)
            quat = np.asarray(quat, np.float32)
            for i, it in enumerate(items):
                it.result = (pos[i], quat[i])
        except Exception:
            # one request's weirdness must not fail the whole window:
            # fall back to solo execution per request
            for it in items:
                try:
                    with self._lock:
                        it.result = self.predictor(it.obs)
                except Exception as e:
                    it.exc = e
        finally:
            for it in items:
                it.event.set()

    def close(self) -> None:
        """Stop the coalesce worker (idempotent; in-flight requests
        complete). New requests arriving during/after close run solo."""
        if self._worker is not None:
            self._closing = True        # new predict() calls take solo path
            self._queue.put(None)
            self._worker.join(timeout=10.0)
            self._worker = None
            # a request that passed the predict() gate before _closing was
            # visible may have enqueued after the sentinel; serve those
            # stragglers here rather than leaving their waiters to time out
            leftovers: List[_Pending] = []
            while True:
                try:
                    it = self._queue.get_nowait()
                except queue.Empty:
                    break
                if it is not None:
                    leftovers.append(it)
            if leftovers:
                self._run_batch(leftovers)

    def health(self) -> Dict[str, Any]:
        m = self.cfg.model
        with self._lock:
            lat = sorted(self._lat_ms)
            sizes = list(self._batch_sizes)
        out = {
            "status": "ok",
            "step": self.step,
            "cameras": list(m.cameras) if m.backbone != "none" else [],
            "image_size": m.image_size,
            "temporal_frames": m.temporal_frames,
            "proprio_dim": m.proprio_dim if m.use_proprio else 0,
            "quat_order": "wxyz",
            "requests": self._requests,
            "p50_ms": round(lat[len(lat) // 2], 3) if lat else None,
            "active_sessions": len(self._sessions),
        }
        if self.coalesce_ms > 0:
            out["coalesce_ms"] = self.coalesce_ms
            out["coalesced_batches"] = self._n_batches   # monotonic counter
            # mean over the rolling window (last 256 batches)
            out["mean_batch"] = (round(float(np.mean(sizes)), 2)
                                 if sizes else None)
        return out


class _Handler(BaseHTTPRequestHandler):
    # set per-server via the factory in make_server()
    service: PoseService
    # HTTP/1.1 keep-alive: a control loop polling /predict reuses its TCP
    # connection instead of paying connect/teardown per request (every
    # response carries Content-Length, which keep-alive requires)
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: on a reused connection, Nagle + the peer's delayed-ACK
    # timer stalls the second write of every request/response by tens of
    # milliseconds
    disable_nagle_algorithm = True
    # resource limits, overridable via make_server(); `timeout` is the
    # socketserver per-connection socket timeout -- it bounds a stalled
    # body read (408 below) and an idle keep-alive connection (closed by
    # handle_one_request's own socket.timeout handling)
    max_body_bytes = 64 * 1024 * 1024
    timeout: Optional[float] = 30.0

    def _send(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            if self.path in ("/healthz", "/health"):
                self._send(200, self.service.health())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})
        except Exception as e:  # pragma: no cover - genuine server faults
            # an aborted connection reads as a dead daemon to a load
            # balancer; always answer
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/predict":
            self._send(404, {"error": f"unknown path {self.path}"})
            return
        try:
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                n = -1
            if n < 0:
                # a negative length would turn rfile.read(n) into
                # read-until-EOF -- the unbounded buffering the
                # max_body_bytes cap exists to prevent
                self._send(400, {"error": "invalid Content-Length"})
                self.close_connection = True
                return
            if n > self.max_body_bytes:
                # refuse BEFORE reading: an unbounded read from one
                # misbehaving client would OOM the pose server. The body
                # stays unread, so the connection cannot be reused.
                self._send(413, {
                    "error": f"request body {n} bytes exceeds the "
                             f"{self.max_body_bytes}-byte limit"})
                self.close_connection = True
                return
            try:
                body = self.rfile.read(n)
            except (socket.timeout, TimeoutError):
                # stalled mid-body for `timeout` seconds; half-read stream
                # is unrecoverable -> answer and drop the connection.
                # Scoped to the body read alone: a TimeoutError raised
                # inside predict() or while writing the response is a
                # server fault and must surface as 500, not a mislabeled
                # 408
                self._send(408, {"error": "timed out reading request body"})
                self.close_connection = True
                return
            if len(body) < n:
                self._send(400, {"error": "client closed mid-body"})
                self.close_connection = True
                return
            obs, session, reset = _parse_request(body)
            self._send(200, self.service.predict(obs, session=session,
                                                 reset=reset))
        except BadRequest as e:
            self._send(400, {"error": str(e)})
        except (KeyError, ValueError) as e:
            # Predictor-level contract errors (missing camera, bad shapes)
            # are client mistakes too
            self._send(400, {"error": str(e)})
        except Exception as e:  # pragma: no cover - genuine server faults
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args):
        # one structured line per request instead of BaseHTTPRequestHandler's
        # stderr chatter; quiet under tests
        pass


def make_server(service: PoseService, host: str = "127.0.0.1",
                port: int = 8080, max_body_mb: float = 64.0,
                read_timeout_s: Optional[float] = 30.0
                ) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; port 0 picks a free port
    (read it back from server.server_address)."""
    handler = type("BoundHandler", (_Handler,), {
        "service": service,
        "max_body_bytes": int(max_body_mb * 1024 * 1024),
        "timeout": read_timeout_s,
    })
    return ThreadingHTTPServer((host, port), handler)


def serve(cfg: Config, host: str = "127.0.0.1", port: int = 8080,
          ckpt_dir: Optional[str] = None,
          step: Union[int, str, None] = None, max_batch: int = 8,
          warmup: bool = True, coalesce_ms: float = 0.0,
          max_body_mb: float = 64.0,
          read_timeout_s: Optional[float] = 30.0, *, device=None
          ) -> Tuple[ThreadingHTTPServer, PoseService]:
    """cli serve entry: restore, warm up, listen, on ``device`` (CUDA by
    default). Returns after binding; the caller decides between
    serve_forever() (CLI) and a background thread (tests/notebooks)."""
    service = PoseService(cfg, ckpt_dir=ckpt_dir, step=step,
                          max_batch=max_batch, warmup=warmup,
                          coalesce_ms=coalesce_ms, device=device)
    return make_server(service, host, port, max_body_mb=max_body_mb,
                       read_timeout_s=read_timeout_s), service
