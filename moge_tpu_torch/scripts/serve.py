"""HTTP inference server with dynamic micro-batching (port of
moge_tpu/scripts/serve.py).

Design:
  * one dispatch thread owns the card; HTTP threads enqueue decoded images
    and block on a per-request event. ``MoGeModel.infer`` runs under
    ``torch.inference_mode``, which is thread-local, so the dispatcher
    enters it for its whole loop;
  * micro-batching: the dispatcher drains the queue up to ``max_batch``
    within ``max_wait_ms`` of the first request, groups by ``fov_x`` (one
    ``infer`` call per group), pads the batch to the next power-of-two
    bucket (repeats of the last image, dropped after) and runs one
    ``model.infer`` call;
  * one-deep readback pipeline: the maps a group asked for (and the
    intrinsics) start copying to the host asynchronously, depth / normal /
    mask as fp16 with a saturating cast (finite values stay finite, inf
    stays inf), and a finalizer thread waits for the copy and answers the
    requests while the dispatcher already runs the next batch;
  * ``warmup`` drives every bucket once before traffic.

Endpoints:
  GET  /healthz          liveness + model/device info + batching stats
  POST /v1/infer         body: raw image bytes (anything cv2 decodes);
                         query: maps=depth,normal,mask,points,intrinsics
                                fov_x=<degrees>  format=json|npz

cv2 and click are imported only inside the handler, the response encoder
and ``main``: the batcher loads on a host without them.
"""

from __future__ import annotations

import base64
import concurrent.futures as cf
import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

__all__ = ["InferenceBatcher", "make_handler", "create_server", "command", "main"]

DEFAULT_MAPS = ("depth", "intrinsics")
VALID_MAPS = ("depth", "normal", "mask", "points", "intrinsics")
_F16_MAX = float(np.finfo(np.float16).max)


@dataclass
class _Request:
    image: np.ndarray  # (H, W, 3) float32 in [0, 1], serve resolution
    fov_x: Optional[float]
    maps: Tuple[str, ...] = DEFAULT_MAPS
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, np.ndarray]] = None
    error: Optional[str] = None


def _next_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _sat16(v: torch.Tensor) -> torch.Tensor:
    """fp16 with finite values clamped to its range (inf, the invalid marker, stays inf)."""
    if v.dtype == torch.bool:
        return v.to(torch.float16)
    return torch.where(torch.isfinite(v), v.clamp(-_F16_MAX, _F16_MAX), v).to(torch.float16)


class InferenceBatcher:
    """Single-consumer micro-batcher in front of ``model.infer``."""

    def __init__(self, model, height: int, width: int, num_tokens: int,
                 max_batch: int = 8, max_wait_ms: float = 5.0, use_fp16: bool = True):
        self.model = model
        self.height, self.width = height, width
        self.num_tokens = num_tokens
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.use_fp16 = use_fp16
        self.queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_images": 0, "errors": 0}
        self._stats_lock = threading.Lock()  # "requests" is counted on the client threads
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------------
    def infer(self, image: np.ndarray, fov_x: Optional[float], maps=DEFAULT_MAPS,
              timeout_s: float = 120.0) -> Dict[str, np.ndarray]:
        req = _Request(image=image, fov_x=fov_x, maps=tuple(maps))
        with self._stats_lock:
            self.stats["requests"] += 1
        self.queue.put(req)
        if not req.event.wait(timeout_s):
            raise TimeoutError("inference timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    # -- dispatch side -------------------------------------------------------
    def _collect(self):
        first = self.queue.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                return batch  # stop marker consumed after this batch
            batch.append(nxt)
        return batch

    def _run_group(self, group):
        """One ``infer`` call for a group of one fov_x; returns the finalizer
        that waits for the readback and answers the requests."""
        n = len(group)
        bucket = _next_bucket(n, self.max_batch)
        images = np.stack([r.image for r in group])
        if bucket > n:  # pad with repeats of the last image; extras dropped
            images = np.concatenate([images, np.repeat(images[-1:], bucket - n, axis=0)])
        out = self.model.infer(torch.from_numpy(images), num_tokens=self.num_tokens,
                               fov_x=group[0].fov_x, use_fp16=self.use_fp16)
        # Only the union of the group's maps (and the intrinsics, which the
        # JSON body reports fov from) crosses to the host; maps whose
        # response encoding is 16-bit anyway travel as fp16.
        needed = set().union(*(set(r.maps) for r in group)) | {"intrinsics"}
        host = {k: (_sat16(v) if k in ("depth", "normal", "mask") else v).to("cpu", non_blocking=True)
                for k, v in out.items() if k in needed}
        done = torch.cuda.Event() if self.model.device.type == "cuda" else None
        if done is not None:
            done.record()

        def finalize():
            if done is not None:
                done.synchronize()
            out_np = {k: v.float().numpy() for k, v in host.items()}
            for i, r in enumerate(group):
                r.result = {k: v[i] for k, v in out_np.items()}
                r.event.set()

        self.stats["batches"] += 1
        self.stats["batched_images"] += n
        return finalize

    def _fail_group(self, group, e):
        self.stats["errors"] += 1
        for r in group:
            if not r.event.is_set():
                r.error = f"{type(e).__name__}: {e}"
                r.event.set()

    def _loop(self):
        # one-deep pipeline: batch N's readback overlaps batch N+1's collect + dispatch
        pool = cf.ThreadPoolExecutor(max_workers=1)
        pending = None  # (future, group)

        def drain():
            nonlocal pending
            if pending is not None:
                fut, pgroup = pending
                pending = None
                try:
                    fut.result()
                except Exception as e:  # surface to the waiting requests
                    self._fail_group(pgroup, e)

        try:
            with torch.inference_mode():
                while not self._stop.is_set():
                    batch = self._collect()
                    if batch is None:
                        return
                    groups: Dict[Any, list] = {}
                    for r in batch:  # one infer call per fov_x value
                        groups.setdefault(r.fov_x, []).append(r)
                    for group in groups.values():
                        try:
                            finalize = self._run_group(group)
                        except Exception as e:  # surface to the waiting requests
                            self._fail_group(group, e)
                            continue
                        drain()
                        pending = (pool.submit(finalize), group)
        finally:
            drain()
            pool.shutdown(wait=True)

    def warmup(self):
        """Drive every batch bucket once (cuDNN set-up, allocator growth,
        cached derived weights), each synchronised by a readback."""
        img = np.full((self.height, self.width, 3), 0.5, np.float32)
        b = 1
        with torch.inference_mode():
            while b <= self.max_batch:
                out = self.model.infer(torch.from_numpy(np.repeat(img[None], b, axis=0)),
                                       num_tokens=self.num_tokens, fov_x=None, use_fp16=self.use_fp16)
                for v in out.values():
                    v.reshape(-1)[:1].cpu()
                b *= 2

    def stop(self):
        self._stop.set()
        self.queue.put(None)
        self._thread.join(timeout=5)


def _encode_png16(arr: np.ndarray) -> bytes:
    import cv2

    ok, data = cv2.imencode(".png", arr)
    if not ok:
        raise RuntimeError("png encode failed")
    return data.tobytes()


def _response_payload(result: Dict[str, np.ndarray], maps, fmt: str):
    from ..utils import io as mio
    from ..utils.geometry_numpy import intrinsics_to_fov_numpy

    if fmt == "npz":
        buf = io.BytesIO()
        arrays = {k: result[k] for k in maps if k in result}
        np.savez_compressed(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        return "application/octet-stream", buf.getvalue()

    body: Dict[str, Any] = {}
    if "intrinsics" in result:
        intr = np.asarray(result["intrinsics"], np.float64)
        fov_x, fov_y = intrinsics_to_fov_numpy(intr)
        body["intrinsics"] = intr.tolist()
        body["fov_x_deg"] = float(np.rad2deg(fov_x))
        body["fov_y_deg"] = float(np.rad2deg(fov_y))
    if "depth" in maps and "depth" in result:
        buf = io.BytesIO()
        mio.write_depth(buf, np.asarray(result["depth"], np.float32))
        body["depth_png16_log"] = base64.b64encode(buf.getvalue()).decode()
    if "normal" in maps and "normal" in result:
        buf = io.BytesIO()
        mio.write_normal(buf, np.asarray(result["normal"], np.float32))
        body["normal_png16"] = base64.b64encode(buf.getvalue()).decode()
    if "mask" in maps and "mask" in result:
        mask = (np.asarray(result["mask"]) > 0).astype(np.uint8) * 255
        body["mask_png"] = base64.b64encode(_encode_png16(mask)).decode()
    if "points" in maps and "points" in result:
        buf = io.BytesIO()
        np.savez_compressed(buf, points=np.asarray(result["points"], np.float32))
        body["points_npz"] = base64.b64encode(buf.getvalue()).decode()
    return "application/json", json.dumps(body).encode()


def make_handler(batcher: InferenceBatcher, model_info: Dict[str, Any]):
    import cv2

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, "application/json", json.dumps(obj).encode())

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                return self._send_json(404, {"error": "not found"})
            stats = dict(batcher.stats)
            stats["mean_batch"] = stats["batched_images"] / stats["batches"] if stats["batches"] else 0.0
            self._send_json(200, {"status": "ok", **model_info, "stats": stats})

        def do_POST(self):
            if urlparse(self.path).path != "/v1/infer":
                return self._send_json(404, {"error": "not found"})
            q = parse_qs(urlparse(self.path).query)
            maps = q.get("maps", [",".join(DEFAULT_MAPS)])[0].split(",")
            bad = [m for m in maps if m not in VALID_MAPS]
            if bad:
                return self._send_json(400, {"error": f"unknown maps: {bad}"})
            fmt = q.get("format", ["json"])[0]
            fov_x = float(q["fov_x"][0]) if "fov_x" in q else None

            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                return self._send_json(400, {"error": "empty body"})
            raw = self.rfile.read(length)
            img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
            if img is None:
                return self._send_json(400, {"error": "undecodable image"})
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
            if img.shape[:2] != (batcher.height, batcher.width):
                img = cv2.resize(img, (batcher.width, batcher.height), interpolation=cv2.INTER_AREA)

            try:
                result = batcher.infer(img, fov_x, maps)
                ctype, body = _response_payload(result, maps, fmt)
            except Exception as e:
                # covers response encoding failures too: an uncaught handler
                # exception kills the connection without a status line
                return self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            self._send(200, ctype, body)

    return Handler


def create_server(model, host: str, port: int, height: int, width: int,
                  num_tokens: int, max_batch: int = 8, max_wait_ms: float = 5.0,
                  use_fp16: bool = True):
    """Build (server, batcher); the caller runs ``server.serve_forever()``."""
    batcher = InferenceBatcher(model, height, width, num_tokens,
                               max_batch=max_batch, max_wait_ms=max_wait_ms, use_fp16=use_fp16)
    device = model.device
    info = {
        "model": f"{type(model).__module__}.{type(model).__name__}",
        "device": device.type,
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "resolution": [height, width],
        "num_tokens": num_tokens,
        "max_batch": max_batch,
    }
    server = ThreadingHTTPServer((host, port), make_handler(batcher, info))
    return server, batcher


def command():
    """The ``serve`` click command (click is imported here, not with the module)."""
    import click

    @click.command(help="HTTP inference server with dynamic micro-batching.")
    @click.option("--pretrained", "pretrained_path", type=str, required=True,
                  help="Local reference-format .pt checkpoint ({'model_config', 'model'}).")
    @click.option("--version", "model_version", type=click.Choice(["v1", "v2"]), default="v2")
    @click.option("--device", "device_name", type=str, default="cuda", show_default=True,
                  help="Torch device; no fallback to the CPU when it is missing.")
    @click.option("--host", default="127.0.0.1", show_default=True)
    @click.option("--port", type=int, default=8000, show_default=True)
    @click.option("--resolution", type=int, default=518, show_default=True,
                  help="Serve resolution (images resized to RES x RES).")
    @click.option("--num_tokens", type=int, default=1369, show_default=True)
    @click.option("--max_batch", type=int, default=8, show_default=True)
    @click.option("--max_wait_ms", type=float, default=5.0, show_default=True,
                  help="Micro-batching window after the first queued request.")
    @click.option("--fp16/--no_fp16", "use_fp16", default=True, help="bf16 compute.")
    @click.option("--int8", "use_int8", is_flag=True,
                  help="W8A8 int8 encoder matmuls (v2; about 1e-2 output drift against bf16, see ops/quant.py).")
    @click.option("--warmup/--no_warmup", default=True, help="Drive every batch bucket before accepting traffic.")
    def serve(pretrained_path, model_version, device_name, host, port, resolution, num_tokens, max_batch,
              max_wait_ms, use_fp16, use_int8, warmup):
        from ..models import import_model_class_by_version

        if use_int8 and model_version != "v2":
            raise click.UsageError("--int8 is only supported for v2 models")
        device = torch.device(device_name)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise click.UsageError(f"--device {device_name}: no CUDA device (the server does not fall back to the CPU)")
        int8 = {"use_int8": True} if use_int8 else {}
        model = import_model_class_by_version(model_version).from_pretrained(
            pretrained_path, device=device, dtype=torch.bfloat16 if use_fp16 else torch.float32, **int8)
        server, batcher = create_server(model, host, port, resolution, resolution, num_tokens,
                                        max_batch=max_batch, max_wait_ms=max_wait_ms, use_fp16=use_fp16)
        if warmup:
            t0 = time.time()
            batcher.warmup()
            print(f"warmup done in {time.time() - t0:.1f}s")
        print(f"serving on http://{host}:{server.server_address[1]}  (POST /v1/infer, GET /healthz)")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
            batcher.stop()

    return serve


def main():
    command()()


if __name__ == "__main__":
    main()
