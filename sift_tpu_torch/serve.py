"""Serving layer of the PyTorch port (counterpart of `sift_tpu/serve.py`): a
warm, fixed-shape feature/matching service.

- `FeatureService`: the embeddable object. Every request is letterboxed
  into one (height, width) canvas (or refused with `strict_shape`), so the
  card always sees the same shapes; `warmup()` builds the kernels and runs
  extraction and matching once. Results come back as plain numpy.
- `python -m sift_tpu_torch.serve --port 8080 [--device cpu]`: a stdlib
  JSON-over-HTTP front: POST /extract, /match, /twoview with base64
  PNG/JPEG payloads; GET /healthz and /stats.

Transfers per request: one upload of the canvas (pinned memory, an event
wait) and, per extraction dispatch, two bulk reads (a packed (7, N)
keypoint buffer and the descriptors, uint8 with `desc_q8`); /match reads
one packed (6, M) buffer. With `batch_window_ms > 0`, concurrent
`extract()` calls are co-batched into one `extract_batch` dispatch of
`max_batch` slots (`_RequestBatcher`).

Every extraction runs at `max_batch` images, a lone canvas repeated, as
the JAX service pads every dispatch to `max_batch`: the card then sees
one set of shapes, whatever the traffic. A request's keypoints do not
depend on the batch (the extraction of an image never reads the other
slots), so they are the same alone or co-batched, in whichever slot.

Runs on the card unless `device="cpu"`; on a machine without CUDA,
`device="cuda"` raises.
"""

from __future__ import annotations

import base64
import io as _io
import json
import queue
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sift_tpu_torch.config import MatchConfig, RansacConfig, SiftConfig
from sift_tpu_torch.frontend.sift import _resolve_device, extract_batch
from sift_tpu_torch.geometry.epipolar import estimate_relative_pose
from sift_tpu_torch.matching.matcher import match_descriptors

_PHASES = ("decode_s", "upload_s", "dispatch_s", "read_s", "batch_size")


class FeatureService:
    """Fixed-shape SIFT extraction and matching for serving.

    A request of another image size is letterboxed into the service shape
    (`strict_shape=False`) or refused (`strict_shape=True`).

    `batch_window_ms > 0` enables request co-batching: concurrent
    `extract()` calls within the window share ONE `extract_batch` dispatch
    of `max_batch` slots. Single callers pay at most the window in added
    latency.
    """

    def __init__(self, height: int, width: int,
                 sift: Optional[SiftConfig] = None,
                 match: Optional[MatchConfig] = None,
                 ransac: Optional[RansacConfig] = None,
                 strict_shape: bool = False,
                 batch_window_ms: float = 0.0, max_batch: int = 8,
                 desc_q8: bool = True, device="cuda"):
        self.h, self.w = int(height), int(width)
        self.sift = sift or SiftConfig(mode="lowe")
        self.match_cfg = match or MatchConfig()
        self.ransac_cfg = ransac or RansacConfig(inlier_threshold=3.0)
        self.strict_shape = strict_shape
        self.desc_q8 = bool(desc_q8)
        self.max_batch = int(max_batch)
        self.device = _resolve_device(device, self.sift)
        self._lock = threading.Lock()     # one dispatch stream per service
        self._stats_lock = threading.Lock()
        self.dispatch_stats = {"extract_dispatches": 0, "extract_requests": 0}
        # Per-dispatch phases of co-batched extraction, in seconds (and the
        # batch size), bounded so a long-running service does not grow.
        self.phase_stats: Dict[str, deque] = {k: deque(maxlen=4096)
                                              for k in _PHASES}
        self._batcher = (_RequestBatcher(self, batch_window_ms / 1e3)
                         if batch_window_ms > 0 else None)

    # ------------------------------------------------------------ device
    def _count(self, key: str) -> None:
        with self._stats_lock:
            self.dispatch_stats[key] += 1

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of `arr`: from pinned memory without a
        stream sync, then an event wait, so the copy has landed when this
        returns (and the upload time is its own)."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return host
        dev = host.pin_memory().to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return dev

    def _pack_kp(self, kp):
        """The host-bound fields of a (B, N) `Keypoints` as ONE (B, 7, N)
        f32 buffer [x, y, scale, octave, orientation, score, valid] in
        service-frame pixels, and the (B, N, 128) descriptors: with
        `desc_q8` as uint8 round(d * 255) (half to even, as `jnp.round`),
        clamped to [0, 255]; descriptors are unit-L2 with components <= 1,
        so the error is <= 1/510 per component."""
        xs, ys = kp.to_image_xy(self.sift.subpixel)
        f32 = torch.float32
        packed = torch.stack([xs, ys, kp.scale, kp.octave.to(f32),
                              kp.orientation, kp.score, kp.valid.to(f32)],
                             dim=-2)
        desc = kp.desc
        if self.desc_q8:
            desc = torch.clamp(torch.round(desc * 255.0), 0,
                               255).to(torch.uint8)
        return packed, desc

    def _extract_batch(self, imgs: torch.Tensor):
        """(max_batch, H, W) canvases on the device -> packed
        (max_batch, 7, N), desc."""
        return self._pack_kp(extract_batch(imgs, self.sift, True,
                                           device=self.device))

    def _extract1(self, img: torch.Tensor):
        """One canvas through the same batched program, at `max_batch`
        images (the module docstring says why)."""
        imgs = img[None].expand(self.max_batch, -1, -1)
        packed, desc = self._extract_batch(imgs)
        return packed[0], desc[0]

    def _match_packed(self, pa, da, pb, db) -> torch.Tensor:
        """Match two packed extractions; returns ONE (6, M) buffer [xa, ya,
        xb, yb, distance, valid] in service-frame pixels, the match rows
        gathered on the device. q8 descriptors are dequantized on the
        device (the matching runs in f32)."""
        if da.dtype == torch.uint8:
            da = da.to(torch.float32) / 255.0
            db = db.to(torch.float32) / 255.0
        m = match_descriptors(da, pa[6] > 0.5, db, pb[6] > 0.5,
                              self.match_cfg)
        ia, ib = m.idx_a.long(), m.idx_b.long()
        return torch.stack([pa[0][ia], pa[1][ia], pb[0][ib], pb[1][ib],
                            m.distance, m.valid.to(torch.float32)])

    # ------------------------------------------------------------ helpers
    def _fit(self, img: np.ndarray) -> Tuple[np.ndarray, float, float]:
        """Letterbox `img` into the service shape; returns (canvas, sx, sy)
        where a service-frame coordinate maps back as (x/sx, y/sy)."""
        img = np.asarray(img)
        if img.ndim == 3:                       # RGB -> luma
            img = img.astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                                    np.float32)
        h, w = img.shape
        if (h, w) == (self.h, self.w):
            return img.astype(np.float32), 1.0, 1.0
        if self.strict_shape:
            raise ValueError(f"image is {h}x{w}, service compiled for "
                             f"{self.h}x{self.w}")
        s = min(self.h / h, self.w / w)
        nh, nw = max(1, round(h * s)), max(1, round(w * s))
        # Bilinear resample (nearest-neighbour upscaling produces blocky
        # plateaus that suppress DoG extrema: fewer keypoints).
        ys = ((np.arange(nh) + 0.5) / s - 0.5).clip(0, h - 1)
        xs = ((np.arange(nw) + 0.5) / s - 0.5).clip(0, w - 1)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        fy = (ys - y0)[:, None].astype(np.float32)
        fx = (xs - x0)[None, :].astype(np.float32)
        img = img.astype(np.float32)
        top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
        bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
        canvas = np.zeros((self.h, self.w), np.float32)
        canvas[:nh, :nw] = top * (1 - fy) + bot * fy
        return canvas, nw / w, nh / h

    def _kp_to_host(self, packed: np.ndarray, desc: np.ndarray,
                    sx: float, sy: float) -> Dict[str, np.ndarray]:
        """Decode a host-side (7, N) packed buffer + (N, D) descriptors."""
        if desc.dtype == np.uint8:                 # desc_q8 dequantize
            desc = desc.astype(np.float32) / 255.0
        return dict(
            x=packed[0] / sx, y=packed[1] / sy,
            scale=packed[2], octave=packed[3].astype(np.int32),
            orientation=packed[4], score=packed[5],
            valid=packed[6] > 0.5, desc=desc,
        )

    # ---------------------------------------------------------------- api
    def warmup(self) -> None:
        """Build the kernels and run extraction (batched, where the service
        co-batches) and matching once, so the first request is warm."""
        blank = np.zeros((self.h, self.w), np.float32)
        self.extract(blank)
        self.match_images(blank, blank)

    def extract(self, img: np.ndarray) -> Dict[str, np.ndarray]:
        """SIFT keypoints + descriptors for one image (original-frame
        coordinates), as plain numpy."""
        canvas, sx, sy = self._fit(img)
        self._count("extract_requests")
        if self._batcher is not None:
            packed, desc = self._batcher.submit(canvas)
        else:
            with self._lock:
                self._count("extract_dispatches")
                packed_d, desc_d = self._extract1(self._upload(canvas))
            packed, desc = packed_d.cpu().numpy(), desc_d.cpu().numpy()
        return self._kp_to_host(packed, desc, sx, sy)

    def match_images(self, img_a: np.ndarray,
                     img_b: np.ndarray) -> Dict[str, np.ndarray]:
        """Extract both images and ratio/mutual-match the descriptors.
        Returns original-frame matched coordinates + distances."""
        ca, sxa, sya = self._fit(img_a)
        cb, sxb, syb = self._fit(img_b)
        with self._lock:
            pa, da = self._extract1(self._upload(ca))
            pb, db = self._extract1(self._upload(cb))
            mm = self._match_packed(pa, da, pb, db).cpu().numpy()  # ONE read
        return dict(
            xa=mm[0] / sxa, ya=mm[1] / sya,
            xb=mm[2] / sxb, yb=mm[3] / syb,
            distance=mm[4], valid=mm[5] > 0.5,
        )

    def two_view(self, img_a: np.ndarray, img_b: np.ndarray,
                 intrinsics: Optional[Tuple[float, float, float, float]]
                 = None, noise=None) -> Dict:
        """Relative pose (R, t up to scale) between two views. Default
        intrinsics: focal = the larger side of the original image,
        principal point at its centre. RANSAC draws from `noise`, a
        (num_hypotheses, M) Gumbel tensor, or by default from a generator
        seeded with 0 on the service's device at every call."""
        mm = self.match_images(img_a, img_b)
        h, w = np.asarray(img_a).shape[:2]
        fx, fy, cx, cy = intrinsics if intrinsics is not None else \
            (float(max(h, w)), float(max(h, w)), w / 2.0, h / 2.0)
        na = np.stack([(mm["xa"] - cx) / fx, (mm["ya"] - cy) / fy], -1)
        nb = np.stack([(mm["xb"] - cx) / fx, (mm["yb"] - cy) / fy], -1)
        with self._lock:
            if noise is None:
                noise = torch.Generator(device=self.device).manual_seed(0)
            R, t, est = estimate_relative_pose(
                noise, self._upload(na.astype(np.float32)),
                self._upload(nb.astype(np.float32)),
                self._upload(mm["valid"]), self.ransac_cfg, focal=fx)
            out = torch.cat([R.reshape(-1), t.reshape(-1),
                             est.num_inliers.to(R.dtype).reshape(1),
                             est.success.to(R.dtype).reshape(1)])
            out = out.cpu().numpy()                            # ONE read
        return dict(R=out[:9].reshape(3, 3), t=out[9:12],
                    num_inliers=int(out[12]), success=bool(out[13]),
                    n_matches=int(mm["valid"].sum()))

    def close(self) -> None:
        """Stop the co-batching worker (no-op without one)."""
        if self._batcher is not None:
            self._batcher.close()


class _RequestBatcher:
    """Co-batches concurrent extract requests into one padded dispatch.

    A worker thread takes the first queued canvas, waits up to `window`
    seconds for more (up to `max_batch`), pads the batch with its first
    canvas to `max_batch` (so every dispatch has one shape), runs ONE
    `extract_batch` and hands each waiter its slot. A failed dispatch goes
    to every waiter of that batch; the worker carries on.
    """

    def __init__(self, service: FeatureService, window: float):
        self.service = service
        self.window = window
        self.max_batch = service.max_batch
        self._q: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="sift-serve-batcher")
        self._worker.start()

    def submit(self, canvas: np.ndarray):
        ev = threading.Event()
        box: Dict = {}
        self._q.put((canvas, ev, box))
        ev.wait()
        if "error" in box:
            raise box["error"]
        return box["kp"]

    def close(self) -> None:
        self._q.put(None)
        self._worker.join(timeout=60)

    def _run(self):
        while True:
            first = self._q.get()              # block for the first request
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self.window
            stop = False
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — fail the waiters, not us
                for _, ev, box in batch:
                    box["error"] = e
                    ev.set()
            if stop:
                return

    def _dispatch(self, batch):
        svc = self.service
        canvases = [c for c, _, _ in batch]
        pad = self.max_batch - len(canvases)
        imgs = np.stack(canvases + [canvases[0]] * pad)
        ph = svc.phase_stats
        with svc._lock:
            svc._count("extract_dispatches")
            t0 = time.perf_counter()
            imgs_d = svc._upload(imgs)             # upload phase, isolated
            t1 = time.perf_counter()
            packed_d, desc_d = svc._extract_batch(imgs_d)
            t2 = time.perf_counter()               # dispatch submission
        # TWO bulk reads for the whole batch, then numpy slices per request.
        packed = packed_d.cpu().numpy()
        desc = desc_d.cpu().numpy()
        t3 = time.perf_counter()                   # device exec + D2H read
        ph["upload_s"].append(t1 - t0)
        ph["dispatch_s"].append(t2 - t1)
        ph["read_s"].append(t3 - t2)
        ph["batch_size"].append(len(batch))
        for i, (_, ev, box) in enumerate(batch):
            box["kp"] = (packed[i], desc[i])
            ev.set()


# --------------------------------------------------------------- HTTP front
def _decode_image(b64: str) -> np.ndarray:
    """A base64 PNG/JPEG as (H, W) float32 gray: PIL's "L" conversion,
    which rounds to uint8."""
    from PIL import Image
    raw = base64.b64decode(b64)
    return np.asarray(Image.open(_io.BytesIO(raw)).convert("L"),
                      dtype=np.float32)


def _json_ready(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _json_ready(v) for k, v in obj.items()}
    return obj


def make_handler(service: FeatureService):
    """stdlib BaseHTTPRequestHandler bound to a FeatureService."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):            # quiet
            pass

        def _reply(self, code: int, payload: Dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "shape": [service.h, service.w]})
            elif self.path == "/stats":
                # Request/dispatch counters and per-phase latency
                # percentiles (decode/upload/dispatch/read).
                def pct(xs):
                    if not xs:
                        return None
                    a = np.percentile(np.asarray(xs) * 1e3, [50, 99])
                    return {"p50_ms": round(float(a[0]), 2),
                            "p99_ms": round(float(a[1]), 2),
                            "n": len(xs)}
                phases = {k: pct(list(v)) for k, v in
                          service.phase_stats.items() if k.endswith("_s")}
                bsz = list(service.phase_stats.get("batch_size", []))
                self._reply(200, {
                    "dispatch_stats": dict(service.dispatch_stats),
                    "phases": phases,
                    "mean_batch": (round(float(np.mean(bsz)), 2)
                                   if bsz else None)})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/extract":
                    td = time.perf_counter()
                    img = _decode_image(req["image"])
                    # Decode runs in the handler thread, before submit:
                    # with co-batching, follower decodes overlap the
                    # leader's batch window.
                    service.phase_stats["decode_s"].append(
                        time.perf_counter() - td)
                    kp = service.extract(img)
                    valid = kp.pop("valid")
                    out = {k: v[valid] for k, v in kp.items()}
                    self._reply(200, {"n": int(valid.sum()),
                                      **_json_ready(out)})
                elif self.path == "/match":
                    mm = service.match_images(_decode_image(req["image_a"]),
                                              _decode_image(req["image_b"]))
                    v = mm.pop("valid")
                    out = {k: val[v] for k, val in mm.items()}
                    self._reply(200, {"n": int(v.sum()), **_json_ready(out)})
                elif self.path == "/twoview":
                    res = service.two_view(
                        _decode_image(req["image_a"]),
                        _decode_image(req["image_b"]),
                        tuple(req["intrinsics"])
                        if "intrinsics" in req else None)
                    self._reply(200, _json_ready(res))
                else:
                    self._reply(404, {"error": "unknown path"})
            except Exception as e:  # noqa: BLE001 — serve errors as JSON
                self._reply(400, {"error": str(e)[:500]})

    return Handler


def build_parser():
    import argparse

    p = argparse.ArgumentParser(prog="sift_tpu_torch.serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--mode", choices=("lowe", "parity"), default="lowe")
    p.add_argument("--max-keypoints", type=int, default=1024)
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="co-batch concurrent /extract requests arriving "
                        "within this window into one batched dispatch "
                        "(0 = per-request dispatches)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="where to run: cuda (default) or cpu")
    return p


def service_from_args(args) -> FeatureService:
    """The service `main` serves, from `build_parser()`'s arguments."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return FeatureService(
        args.height, args.width,
        sift=SiftConfig(mode=args.mode, max_keypoints=args.max_keypoints),
        batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
        device=args.device)


def main(argv=None) -> int:
    from http.server import ThreadingHTTPServer

    args = build_parser().parse_args(argv)
    service = service_from_args(args)
    print(f"warming up ({args.height}x{args.width}, {args.mode}, "
          f"{args.device}) ...", flush=True)
    service.warmup()
    srv = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"serving on http://{args.host}:{args.port} "
          f"(/healthz /stats /extract /match /twoview)", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
