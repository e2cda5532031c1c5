"""The port's micro-batching server (moge_tpu_torch.scripts.serve) on the CPU
with the tiny MoGe-2 (batched heads): the batcher answers concurrent
requests each as its own batch-1 ``infer`` would, pads to power-of-two
buckets, groups by fov_x and hands an error to every waiting request; one
HTTP round-trip whose JSON body has the keys (and values) of the JAX
server's response encoder; ``/healthz`` stats; ``--int8`` refused for v1; the
serving modules import with jax, cv2 and click blocked."""

import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from moge_tpu_torch.models.v2 import MoGeModel
from moge_tpu_torch.scripts import serve
from torch_tiny_config import TINY_CONFIG, make_points_perspective

torch.set_num_threads(1)

HW = 56
NUM_TOKENS = 16
FP32_RTOL = 1e-4  # a batch of 4 against batch 1: reduction order, then the LM solve
FP16_RTOL = 1e-3  # depth / normal / mask cross to the host as fp16 (11-bit mantissa)


@pytest.fixture(scope="module")
def model():
    """The tiny MoGe-2 with batched heads and a well-conditioned point map
    (``make_points_perspective``): answers after the focal/shift solve are
    compared across batch compositions and threads."""
    model = MoGeModel(TINY_CONFIG, "cpu", torch.float32, batched_heads=True).init_random(seed=0)
    make_points_perspective(model.module)
    return model


class Recording:
    """``model`` with a record of each ``infer`` call's batch size and fov_x; raises when ``fail``."""

    def __init__(self, model, fail=False):
        self.model, self.fail, self.calls = model, fail, []
        self.device = model.device

    def infer(self, images, **kwargs):
        self.calls.append((images.shape[0], kwargs["fov_x"]))
        if self.fail:
            raise ValueError("model failed")
        return self.model.infer(images, **kwargs)


def _images(n, seed):
    return list(np.random.default_rng(seed).uniform(0, 1, (n, HW, HW, 3)).astype(np.float32))


def _concurrently(batcher, images, fovs, maps=serve.VALID_MAPS):
    results = [None] * len(images)

    def worker(i):
        try:
            results[i] = batcher.infer(images[i], fovs[i], maps, timeout_s=120)
        except RuntimeError as e:
            results[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    return results


def _check_against_batch1(model, image, fov_x, result):
    want = {k: v.numpy() for k, v in model.infer(image[None], num_tokens=NUM_TOKENS, fov_x=fov_x,
                                                 use_fp16=False).items()}
    assert set(result) == set(want)
    for key, w in want.items():
        w = w[0].astype(np.float32)
        got = result[key]
        assert got.shape == w.shape and got.dtype == np.float32, key
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(w))
        fin = np.isfinite(w)
        rtol = FP16_RTOL if key in ("depth", "normal", "mask") else FP32_RTOL
        np.testing.assert_allclose(got[fin], w[fin], rtol=rtol, atol=rtol * max(np.abs(w[fin]).max(), 1e-6))


def test_next_bucket():
    assert [serve._next_bucket(n, 8) for n in range(1, 10)] == [1, 2, 4, 4, 8, 8, 8, 8, 8]
    assert serve._next_bucket(3, 2) == 2


def test_concurrent_requests_match_their_own_batch1_infer(model):
    rec = Recording(model)
    batcher = serve.InferenceBatcher(rec, HW, HW, NUM_TOKENS, max_batch=4, max_wait_ms=1000, use_fp16=False)
    try:
        images = _images(3, 0)
        results = _concurrently(batcher, images, [None] * 3)
    finally:
        batcher.stop()
    assert rec.calls == [(4, None)]  # three requests in one batch, padded to the bucket of 4
    assert batcher.stats["batches"] == 1 and batcher.stats["batched_images"] == 3
    assert batcher.stats["requests"] == 3
    for image, result in zip(images, results):
        _check_against_batch1(model, image, None, result)


def test_requests_are_grouped_by_fov(model):
    rec = Recording(model)
    batcher = serve.InferenceBatcher(rec, HW, HW, NUM_TOKENS, max_batch=8, max_wait_ms=1000, use_fp16=False)
    try:
        images = _images(4, 1)
        fovs = [None, 60.0, None, 60.0]
        results = _concurrently(batcher, images, fovs, maps=("depth", "intrinsics"))
    finally:
        batcher.stop()
    assert sorted(rec.calls, key=str) == [(2, 60.0), (2, None)]
    for image, fov, result in zip(images, fovs, results):
        assert set(result) == {"depth", "intrinsics"}  # only the maps asked for cross to the host
        if fov is not None:
            np.testing.assert_allclose(result["intrinsics"][0, 0], 0.5 / np.tan(np.deg2rad(30.0)), rtol=1e-6)
        want = model.infer(image[None], num_tokens=NUM_TOKENS, fov_x=fov, use_fp16=False)
        np.testing.assert_allclose(result["intrinsics"], want["intrinsics"][0].numpy(), rtol=FP32_RTOL)


def test_an_error_reaches_every_waiting_request(model):
    rec = Recording(model, fail=True)
    batcher = serve.InferenceBatcher(rec, HW, HW, NUM_TOKENS, max_batch=4, max_wait_ms=1000, use_fp16=False)
    try:
        results = _concurrently(batcher, _images(3, 2), [None, None, 45.0])
    finally:
        batcher.stop()
    assert all(isinstance(r, RuntimeError) and "model failed" in str(r) for r in results)
    assert batcher.stats["errors"] == 2  # one per fov group
    assert not batcher._thread.is_alive()


def test_sat16_keeps_finite_values_finite_and_inf_inf():
    v = torch.tensor([1e6, -1e6, float("inf"), 0.5])
    got = serve._sat16(v).float()
    assert torch.isfinite(got[:2]).all() and got[2] == float("inf") and got[3] == 0.5
    assert serve._sat16(torch.tensor([True, False])).tolist() == [1.0, 0.0]


@pytest.fixture(scope="module")
def server_url(model):
    server, batcher = serve.create_server(model, "127.0.0.1", 0, height=HW, width=HW, num_tokens=NUM_TOKENS,
                                          max_batch=4, max_wait_ms=20.0, use_fp16=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    batcher.stop()
    thread.join(timeout=10)


def _png(seed, h=80, w=100):
    import cv2

    img = np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.uint8)
    return cv2.imencode(".png", img)[1].tobytes()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_http_roundtrip_matches_the_jax_response_encoder(server_url, model):
    import cv2

    from moge_tpu.scripts.serve import _response_payload as jax_response_payload
    from moge_tpu.utils.io import read_depth

    maps = ["depth", "normal", "mask", "points", "intrinsics"]
    body = _png(0)
    status, ctype, raw = _post(f"{server_url}/v1/infer?maps={','.join(maps)}&fov_x=60", body)
    assert status == 200 and ctype == "application/json"
    got = json.loads(raw)

    # the same request through the batcher's maths on this side, encoded by the JAX server's encoder
    img = cv2.cvtColor(cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    img = cv2.resize(img.astype(np.float32) / 255.0, (HW, HW), interpolation=cv2.INTER_AREA)
    out = model.infer(img[None], num_tokens=NUM_TOKENS, fov_x=60.0, use_fp16=False)
    result = {k: serve._sat16(v[0]).float().numpy() if k in ("depth", "normal", "mask") else v[0].numpy()
              for k, v in out.items()}
    _, want_raw = jax_response_payload(result, maps, "json")
    want = json.loads(want_raw)
    assert set(got) == set(want) == {"intrinsics", "fov_x_deg", "fov_y_deg", "depth_png16_log", "normal_png16",
                                     "mask_png", "points_npz"}
    assert abs(got["fov_x_deg"] - 60.0) < 1e-3
    np.testing.assert_allclose(got["intrinsics"], want["intrinsics"], rtol=FP32_RTOL)
    depth_got = read_depth(io.BytesIO(__import__("base64").b64decode(got["depth_png16_log"])))
    depth_want = read_depth(io.BytesIO(__import__("base64").b64decode(want["depth_png16_log"])))
    assert depth_got.shape == (HW, HW)
    np.testing.assert_array_equal(np.isfinite(depth_got), np.isfinite(depth_want))
    fin = np.isfinite(depth_want)
    np.testing.assert_allclose(depth_got[fin], depth_want[fin], rtol=FP16_RTOL)


def test_http_npz_healthz_and_bad_requests(server_url):
    status, ctype, raw = _post(f"{server_url}/v1/infer?maps=depth,points&format=npz", _png(1))
    assert status == 200 and ctype == "application/octet-stream"
    arrays = np.load(io.BytesIO(raw))
    assert arrays["depth"].shape == (HW, HW) and arrays["points"].shape == (HW, HW, 3)
    with urllib.request.urlopen(f"{server_url}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["device"] == "cpu" and health["resolution"] == [HW, HW]
    stats = health["stats"]
    assert stats["requests"] >= 1 and stats["batched_images"] >= 1
    assert stats["mean_batch"] == stats["batched_images"] / stats["batches"]
    for url, body, code in ((f"{server_url}/v1/infer", b"not an image", 400),
                            (f"{server_url}/v1/infer?maps=bogus", _png(2), 400),
                            (f"{server_url}/nope", _png(2), 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, body)
        assert e.value.code == code


def test_serve_refuses_int8_and_a_missing_card():
    from click.testing import CliRunner

    result = CliRunner().invoke(serve.command(), ["--int8", "--version", "v1", "--pretrained", "model.pt"])
    assert result.exit_code == 2 and "--int8 is only supported for v2 models" in result.output
    if not torch.cuda.is_available():
        result = CliRunner().invoke(serve.command(), ["--pretrained", "model.pt", "--device", "cuda"])
        assert result.exit_code == 2 and "fall back" in result.output


def test_serving_modules_import_without_jax_cv2_click():
    code = ("import sys\n"
            "for m in ('jax', 'cv2', 'click', 'flax', 'PIL', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "import moge_tpu_torch.scripts.serve, moge_tpu_torch.scripts.infer, moge_tpu_torch.scripts.cli\n"
            "import moge_tpu_torch.models.v1, moge_tpu_torch.models.v2, moge_tpu_torch.models.multihead\n"
            "import moge_tpu_torch.models.io\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
