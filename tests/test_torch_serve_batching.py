"""The port's request co-batching (`sift_tpu_torch.serve._RequestBatcher`)
and `python -m sift_tpu_torch.serve` on the CPU: the co-batching and
sustained-load assertions of `tests/e2e/test_serve.py`, on a crop of a TUM
fixture frame at the JAX serve tests' size (180x240, 3 octaves, 256
keypoints). A lone request runs at the service's batch size, so
co-batched results equal it bit for bit. PyTorch runs on two threads,
light on a machine that runs other tests beside it."""

import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.serve import FeatureService
from tests.test_torch_serve import (CROP, FRAMES, H, Q8, W, _b64, _crop, _get,
                                    _post, _sift)
from tests.test_torch_sfm_loop import torch_threads

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def img():
    from sift_tpu_torch.io.image import load_image_gray
    return _crop(load_image_gray(FRAMES[0]), CROP)


def test_request_cobatching(img):
    """Concurrent extract() calls within the batch window share one
    batched dispatch; results equal the unbatched service's."""
    plain = FeatureService(H, W, sift=_sift(SiftConfig), device="cpu")
    batched = FeatureService(H, W, sift=_sift(SiftConfig), device="cpu",
                             batch_window_ms=150, max_batch=8)
    try:
        imgs = [np.roll(img, i, axis=1) for i in range(6)]
        ref = [plain.extract(im) for im in imgs]
        out = [None] * len(imgs)

        def worker(i):
            out[i] = batched.extract(imgs[i])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        st = batched.dispatch_stats
        assert st["extract_requests"] == 6
        assert st["extract_dispatches"] < 6, st
        assert sum(batched.phase_stats["batch_size"]) == 6
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(r["valid"], o["valid"])
            v = r["valid"]
            np.testing.assert_allclose(r["x"][v], o["x"][v], atol=1e-4)
            np.testing.assert_allclose(r["desc"][v], o["desc"][v],
                                       atol=1.01 * Q8)
            for k in r:
                np.testing.assert_array_equal(r[k], o[k], err_msg=k)
    finally:
        batched.close()


def test_sustained_concurrent_load_coalesces(img):
    """32 requests from 8 concurrent workers: dispatches well under one per
    request, every request completes, and the same image gives the same
    keypoints in whichever slot it rides."""
    svc = FeatureService(H, W, sift=_sift(SiftConfig), device="cpu",
                         batch_window_ms=50, max_batch=8)
    try:
        svc.warmup()
        imgs = [np.roll(img, i % 4, axis=1) for i in range(32)]
        with ThreadPoolExecutor(max_workers=8) as ex:
            list(ex.map(svc.extract, imgs[:8]))
        svc.dispatch_stats.update(extract_requests=0, extract_dispatches=0)
        with ThreadPoolExecutor(max_workers=8) as ex:
            outs = list(ex.map(svc.extract, imgs))
        st = svc.dispatch_stats
        assert st["extract_requests"] == 32
        assert st["extract_dispatches"] <= 16, st
        for i in range(4, 32):
            np.testing.assert_array_equal(outs[i]["valid"],
                                          outs[i % 4]["valid"])
            v = outs[i]["valid"]
            np.testing.assert_allclose(outs[i]["x"][v], outs[i % 4]["x"][v],
                                       atol=1e-4)
    finally:
        svc.close()


def test_batch_failure_reaches_every_waiter(img, monkeypatch):
    """A failed dispatch raises in every request of its batch; the worker
    survives and serves the next batch."""
    svc = FeatureService(H, W, sift=_sift(SiftConfig), device="cpu",
                         batch_window_ms=100, max_batch=4)
    real = svc._extract_batch
    calls = []

    def flaky(imgs):
        calls.append(imgs.shape[0])
        if len(calls) == 1:
            raise RuntimeError("injected failure")
        return real(imgs)

    monkeypatch.setattr(svc, "_extract_batch", flaky)
    try:
        with ThreadPoolExecutor(max_workers=3) as ex:
            futs = [ex.submit(svc.extract, img) for _ in range(3)]
            errors = [f.exception(timeout=120) for f in futs]
        assert calls[0] == 4
        assert len(calls) == 1 and all(
            isinstance(e, RuntimeError) and "injected" in str(e)
            for e in errors)
        assert int(svc.extract(img)["valid"].sum()) > 20
    finally:
        svc.close()


def test_module_main_serves_on_cpu(img):
    """`python -m sift_tpu_torch.serve --device cpu` answers /healthz and
    /extract."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sift_tpu_torch.serve", "--device", "cpu",
         "--port", str(port), "--height", str(H), "--width", str(W),
         "--max-keypoints", "256", "--max-batch", "2"],
        cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                assert _get(port, "/healthz")["status"] == "ok"
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.communicate()[1]
                assert time.monotonic() < deadline
                time.sleep(0.5)
        out = _post(port, "/extract", {"image": _b64(img)})
        assert out["n"] > 20
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
