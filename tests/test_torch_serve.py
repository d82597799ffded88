"""The port's serving layer against the JAX package's, on the CPU.

``MicroBatcher`` (``rtdm_tpu_torch/serve/batcher.py``): row alignment under
load, tuple outputs, error propagation, the drain on close and the idle
drain, on torch outputs, and the same requests through the JAX batcher
give the same rows (exact: the fake engines compute the same numbers).

``rtdm-serve`` (``cli/serve.py``) over HTTP with PNG bodies (the JAX server
decodes those with PIL too; its native path takes only JPEG): classify
against JAX's ``_ClassifyService`` on one seeded Squeeze_ErNET fp32 engine
directory, label equal and probabilities within ``REL_TOL["fp32"]`` = 1e-4
of max |prob| (``tests/test_torch_engine.py``: summation order only);
detect with the committed yolov4-tiny-mini int8 engine, each reply equal
to ``detections_to_json`` of the same engine called directly on the same
letterboxed frame (a frame's rows do not depend on the batch it rode in);
``detections_to_json`` equal to JAX's on seeded arrays; ``run_load``
against the port's server, and ``run_direct``.
"""

import io
import json
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from rtdm_tpu_torch.serve import MicroBatcher

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = tuple(sorted((ROOT / "docs" / "examples").glob("*.jpg")))
DETECTOR = ROOT / "artifacts" / "engines" / "yolov4-tiny-mini_int8"
# tests/test_torch_engine.py: relative to max |prob| here
REL_TOL = {"fp32": 1e-4}


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads a test: the test run's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _sum_rows(frames):
    return torch.as_tensor(frames).float().sum(dim=(1, 2, 3))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_batcher_row_alignment_under_load(package):
    """25 frames through an 8-row engine: every future gets its own row;
    the port's batcher on torch outputs, JAX's on numpy ones, same rows."""
    if package == "jax":
        from rtdm_tpu.serve import MicroBatcher as Batcher
    else:
        Batcher = MicroBatcher
    calls = []

    def dispatch(frames):
        calls.append(frames.shape[0])
        time.sleep(0.01)  # queue builds up: requests coalesce
        out = _sum_rows(frames)
        return out if package == "port" else out.numpy()

    mb = Batcher(dispatch, batch_size=8, max_wait_ms=20.0)
    frames = [np.full((4, 4, 3), i, np.uint8) for i in range(25)]
    futs = [mb.submit(f) for f in frames]
    got = [f.result(timeout=30) for f in futs]
    mb.close()
    assert not mb._thread.is_alive()
    np.testing.assert_array_equal(
        got, [np.float32(f.astype(np.float32).sum()) for f in frames])
    assert all(isinstance(g, np.floating) for g in got)
    stats = mb.stats()
    assert stats.requests == 25 and stats.batches == len(calls)
    assert max(calls) > 1 and all(c <= 8 for c in calls)
    assert stats.p99_ms >= stats.p50_ms > 0


def test_batcher_tuple_outputs_align_rows():
    def dispatch(frames):
        x = torch.as_tensor(frames)
        return (x.float() * 2.0, torch.arange(x.shape[0], dtype=torch.int32))

    mb = MicroBatcher(dispatch, batch_size=4, max_wait_ms=5.0)
    futs = [mb.submit(np.full((2, 2, 3), i, np.uint8)) for i in range(6)]
    for i, fut in enumerate(futs):
        arr, idx = fut.result(timeout=30)
        assert isinstance(arr, np.ndarray) and arr.dtype == np.float32
        np.testing.assert_array_equal(arr, np.full((2, 2, 3), 2.0 * i))
        assert 0 <= idx < 4
    mb.close()


def test_batcher_dispatch_in_inference_mode():
    """A dispatch that carries its own inference mode works from the
    batcher's thread (the mode is per thread), and its rows come back as
    numpy arrays."""
    seen = []

    @torch.inference_mode()
    def dispatch(frames):
        seen.append(torch.is_inference_mode_enabled())
        return torch.as_tensor(frames).float() + 1

    mb = MicroBatcher(dispatch, batch_size=2, max_wait_ms=1.0)
    out = mb(np.zeros((3,), np.uint8), timeout=10)
    mb.close()
    assert seen == [True]
    np.testing.assert_array_equal(out, np.ones((3,), np.float32))


def test_batcher_propagates_engine_errors():
    def dispatch(frames):
        raise RuntimeError("engine on fire")

    mb = MicroBatcher(dispatch, batch_size=4, max_wait_ms=1.0)
    fut = mb.submit(np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(RuntimeError, match="engine on fire"):
        fut.result(timeout=30)
    mb.close()


def test_batcher_propagates_copy_back_errors():
    """A failure when the result is copied back reaches every waiter of
    its batch."""
    class Broken(torch.Tensor):
        def cpu(self, *a, **k):
            raise RuntimeError("device lost")

    def dispatch(frames):
        return torch.zeros(len(frames)).as_subclass(Broken)

    mb = MicroBatcher(dispatch, batch_size=4, max_wait_ms=20.0)
    futs = [mb.submit(np.zeros((1,), np.uint8)) for _ in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device lost"):
            f.result(timeout=30)
    mb.close()


def test_batcher_drains_on_close():
    def dispatch(frames):
        time.sleep(0.02)
        return torch.as_tensor(frames).float()

    mb = MicroBatcher(dispatch, batch_size=4, max_wait_ms=1.0, depth=2)
    futs = [mb.submit(np.full((1,), i, np.uint8)) for i in range(8)]
    mb.close()
    assert all(f.done() for f in futs)
    resolved = [f for f in futs if f.exception() is None]
    assert resolved, "close() must flush at least the in-flight work"
    for f in resolved:
        assert f.result().shape == (1,)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.zeros((1,), np.uint8))


def test_batcher_resolves_last_batch_when_idle():
    """A quiet server must not hold the last in-flight batch back."""
    def dispatch(frames):
        return torch.as_tensor(frames).float()

    mb = MicroBatcher(dispatch, batch_size=8, max_wait_ms=1.0, depth=2)
    t0 = time.perf_counter()
    out = mb(np.ones((2, 2, 3), np.uint8), timeout=10)
    dt = time.perf_counter() - t0
    mb.close()
    assert out.shape == (2, 2, 3)
    assert dt < 5.0


def test_detections_to_json_matches_jax():
    from rtdm_tpu.cli.serve import detections_to_json as jax_json
    from rtdm_tpu_torch.cli.serve import detections_to_json
    from rtdm_tpu_torch.data.odder import letterbox_image
    rng = np.random.default_rng(0)
    for oh, ow in ((300, 400), (480, 270), (416, 416)):
        _, gain, pads = letterbox_image(np.zeros((oh, ow, 3), np.uint8), 416)
        det = np.zeros((20, 6), np.float32)
        xy = rng.uniform(-20, 430, (12, 2)).astype(np.float32)
        wh = rng.uniform(1, 200, (12, 2)).astype(np.float32)
        det[:12, :2], det[:12, 2:4] = xy, xy + wh
        det[:12, 4] = rng.uniform(0.2, 1, 12)
        det[:12, 5] = rng.integers(0, 4, 12)
        for count in (0, 5, 12):
            got = detections_to_json(det, count, gain, pads, (oh, ow),
                                     ["person", "vehicle"])
            want = jax_json(det, count, gain, pads, (oh, ow),
                            ["person", "vehicle"])
            assert got == want


def _png(path) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    with Image.open(path) as im:
        im.convert("RGB").save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def bodies():
    return [_png(p) for p in EXAMPLES]


@pytest.fixture(scope="module")
def engine_dir(tmp_path_factory):
    """A seeded Squeeze_ErNET fp32 engine at batch 4, saved by JAX."""
    import jax
    import jax.numpy as jnp
    from rtdm_tpu.export.engine import build_engine
    from rtdm_tpu.models import create_model
    model = create_model("squeeze-ernet")
    v = jax.device_get(model.init(jax.random.key(0),
                                  jnp.zeros((1, 140, 140, 3))))
    d = str(tmp_path_factory.mktemp("serve") / "eng")
    build_engine("squeeze-ernet", v, "fp32", 4).save(d)
    return d


@pytest.fixture(scope="module")
def server(engine_dir):
    """The port's server on 127.0.0.1, classifier and detector on the
    CPU, one batcher thread each."""
    from rtdm_tpu_torch.cli.serve import (_ClassifyService, _DetectService,
                                          make_server)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    classify = _ClassifyService(engine_dir, 5.0, 2, device="cpu")
    detect = _DetectService(str(DETECTOR), 5.0, 2, device="cpu")
    srv = make_server(0, classify, detect, host="127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", classify, detect
    srv.shutdown()
    srv.server_close()
    classify.batcher.close()
    detect.batcher.close()
    thread.join(30)
    assert not thread.is_alive()
    torch.set_num_threads(saved)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def _concurrently(fn, items):
    out = [None] * len(items)

    def run(i):
        out[i] = fn(items[i])

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    return out


def test_http_classify_matches_jax_service(server, engine_dir, bodies):
    from rtdm_tpu.cli.serve import _ClassifyService as JaxClassify
    url, _, _ = server
    with urllib.request.urlopen(url + "/healthz") as r:
        assert json.load(r) == {"ok": True, "classify": True, "detect": True}
    got = _concurrently(lambda b: _post(url + "/v1/classify", b), bodies)
    jax_svc = JaxClassify(engine_dir, max_wait_ms=5.0, depth=2)
    try:
        want = [jax_svc(b) for b in bodies]
    finally:
        jax_svc.batcher.close()
    for g, w in zip(got, want):
        assert g["label"] == w["label"]
        assert g["probs"].keys() == w["probs"].keys()
        p = np.array(list(g["probs"].values()))
        q = np.array(list(w["probs"].values()))
        assert np.abs(p - q).max() <= REL_TOL["fp32"] * np.abs(q).max()
    with urllib.request.urlopen(url + "/stats") as r:
        stats = json.load(r)["classify"]
    assert stats["requests"] >= len(bodies)
    assert stats["mean_batch"] > 1.0  # concurrent requests coalesced


def test_http_detect_matches_direct_detector(server, bodies):
    from rtdm_tpu_torch.cli.serve import detect_frame, detections_to_json
    url, _, detect = server
    got = _concurrently(lambda b: _post(url + "/v1/detect", b), bodies)
    frames = [detect_frame(b, detect.size) for b in bodies]
    det, count = detect.det(np.stack([f[0] for f in frames]))
    for k, ((_, gain, pads, orig_hw), reply) in enumerate(zip(frames, got)):
        assert reply == detections_to_json(det[k], int(count[k]), gain,
                                           pads, orig_hw, detect.names)
    assert sum(r["count"] for r in got) > 0
    with urllib.request.urlopen(url + "/stats") as r:
        stats = json.load(r)["detect"]
    assert stats["requests"] >= len(bodies) and stats["batches"] >= 1


def test_http_errors(server):
    url, _, _ = server
    for path, code in (("/v1/classify", 400), ("/v1/nothing", 404)):
        req = urllib.request.Request(url + path, data=b"not an image",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == code and "error" in json.load(ei.value)


def test_run_load_against_port_server(server, bodies):
    from rtdm_tpu_torch.cli.serve_loadtest import run_load
    url, classify, _ = server
    replies = []
    res = run_load(url, "/v1/classify", clients=6, requests_per_client=4,
                   timeout=120.0, bodies=bodies[:3], responses=replies)
    assert res["errors"] == 0, res.get("first_error")
    assert res["requests"] == 24 and len(replies) == 24
    assert res["p99_ms"] >= res["p50_ms"] > 0
    assert res["server_batches"] >= 1 and res["server_mean_batch"] >= 1.0
    # every reply under load equals the engine's answer on its frame
    from rtdm_tpu_torch.cli.serve import classify_frame
    direct = [classify.engine(classify_frame(b, classify.size)[None])[0]
              for b in bodies[:3]]
    for k, reply in replies:
        p = np.array(list(reply["probs"].values()))
        np.testing.assert_array_equal(p, direct[k].astype(np.float64))
    # the default bodies: 8 seeded random JPEGs
    res = run_load(url, "/v1/classify", clients=2, requests_per_client=2)
    assert res["errors"] == 0 and res["requests"] == 4


def test_run_direct(engine_dir):
    from rtdm_tpu_torch.cli.serve_loadtest import main
    res = main(["--direct-engine", engine_dir, "--clients", "4",
                "--requests", "3", "--device", "cpu"])
    assert res["mode"] == "direct" and res["service"] == "classify"
    assert res["handler"]["errors"] == 0 and res["core"]["errors"] == 0
    assert res["handler"]["rps"] > 0 and res["core"]["rps"] > 0
    assert res["decode_ms"] > 0 and res["batcher_mean_batch"] >= 1.0
    with pytest.raises(ValueError):
        from rtdm_tpu_torch.cli.serve_loadtest import run_direct
        run_direct(device="cpu")


def test_serve_raises_without_cuda(engine_dir):
    from rtdm_tpu_torch.cli.serve import _ClassifyService
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _ClassifyService(engine_dir, 2.0, 2)
