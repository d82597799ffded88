"""Concurrent-client load test for the rtdm-serve HTTP front end.

Counterpart of ``rtdm_tpu/cli/serve_loadtest.py``. Measures what a
deployment cares about and the reference never quantified (its loops are
single-client local display, real-time-inference.py:179-208):
client-observed p50/p99 latency, steady RPS, and how well the
micro-batcher fills the engine batch under its deadline (/stats
mean_batch vs engine batch).

Usage (against a running ``python -m rtdm_tpu_torch.cli.serve ...``):
  python -m rtdm_tpu_torch.cli.serve_loadtest --url http://127.0.0.1:8000 \
      --endpoint /v1/classify --clients 32 --requests 64
or in-process, without HTTP (``--direct-engine`` / ``--direct-detector``,
with ``--device``). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np


def _jpeg(rng: np.random.Generator, h: int = 240, w: int = 320) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                    ).save(buf, format="JPEG", quality=85)
    return buf.getvalue()


def run_load(url: str, endpoint: str = "/v1/classify", clients: int = 16,
             requests_per_client: int = 32, timeout: float = 60.0,
             seed: int = 0, bodies: Optional[Sequence[bytes]] = None,
             responses: Optional[list] = None) -> Dict[str, float]:
    """Hammer `url+endpoint` with `clients` threads, each issuing
    `requests_per_client` sequential POSTs (closed-loop clients — the
    serving-benchmark standard). Returns latency percentiles, RPS, error
    count, and the server's own /stats batch-fill figures. ``bodies``
    replaces the 8 seeded random JPEGs; each (body index, parsed reply) is
    appended to ``responses`` if a list is given."""
    if bodies is None:
        bodies = [_jpeg(np.random.default_rng(seed + i)) for i in range(8)]
    lat: List[float] = []
    errors: List[str] = []
    lock = threading.Lock()
    start_gate = threading.Event()

    def client(cid: int) -> None:
        my_lat = []
        my_err = []
        my_replies = []
        start_gate.wait()
        for k in range(requests_per_client):
            b = (cid + k) % len(bodies)
            t0 = time.perf_counter()
            try:
                req = urllib.request.Request(
                    url + endpoint, data=bodies[b],
                    headers={"Content-Type": "application/octet-stream"})
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    my_replies.append((b, json.load(r)))
                my_lat.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — counted, not fatal
                my_err.append(f"{type(e).__name__}: {e}")
        with lock:
            lat.extend(my_lat)
            errors.extend(my_err)
            if responses is not None:
                responses.extend(my_replies)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    start_gate.set()
    for t in threads:
        t.join(timeout=timeout * requests_per_client)
    wall = time.perf_counter() - t_start

    out: Dict[str, float] = {
        "clients": clients,
        "requests": len(lat),
        "errors": len(errors),
        "wall_s": round(wall, 3),
        "rps": round(len(lat) / wall, 1) if wall > 0 else 0.0,
    }
    if errors:
        out["first_error"] = errors[0]  # type: ignore[assignment]
    if lat:
        q = np.quantile(np.asarray(lat), [0.5, 0.9, 0.99])
        out.update(p50_ms=round(1e3 * q[0], 2), p90_ms=round(1e3 * q[1], 2),
                   p99_ms=round(1e3 * q[2], 2))
    try:
        with urllib.request.urlopen(url + "/stats", timeout=10) as r:
            stats = json.load(r)
        key = "classify" if "classify" in endpoint else "detect"
        if key in stats:
            out["server_mean_batch"] = stats[key].get("mean_batch", 0.0)
            out["server_batches"] = stats[key].get("batches", 0)
            out["server_p50_ms"] = stats[key].get("p50_ms", 0.0)
            out["server_p99_ms"] = stats[key].get("p99_ms", 0.0)
    except Exception:  # stats endpoint is best-effort
        pass
    return out


def decode_breakdown(size: int, service: str, seed: int = 0,
                     reps: int = 16):
    """The handler's host-side work alone: 8 seeded 320x240 JPEG bodies,
    their frames (``cli/serve.py``'s ``classify_frame``, or
    ``detect_frame``'s letterbox for ``service`` "detect") and the mean ms
    of one decode and preprocess over ``reps`` after a warm call (the
    native library's first load). Returns (bodies, frames, decode_ms)."""
    from rtdm_tpu_torch.cli.serve import classify_frame, detect_frame
    bodies = [_jpeg(np.random.default_rng(seed + i), h=240, w=320)
              for i in range(8)]
    if service == "classify":
        def decode(body):
            return classify_frame(body, size)
    else:
        def decode(body):
            return detect_frame(body, size)[0]

    decode(bodies[0])  # warm
    t0 = time.perf_counter()
    for k in range(reps):
        decode(bodies[k % len(bodies)])
    decode_ms = (time.perf_counter() - t0) / reps * 1e3
    return bodies, [decode(b) for b in bodies], decode_ms


def run_direct(engine_dir: str = "", detector_dir: str = "",
               clients: int = 16, requests_per_client: int = 32,
               seed: int = 0, device="cuda") -> Dict[str, float]:
    """Handler-direct capacity: load the serve.py service in-process on
    ``device`` and hammer it without HTTP or per-request client work, from
    a pre-encoded JPEG corpus (closed-loop HTTP clients share the server's
    CPU cores and measure the box, not the server).

    Three figures isolate the stack:
      decode_ms        — per-request image decode+preprocess alone
      handler_rps      — svc(body) closed-loop: decode + batcher + engine
      core_rps         — pre-decoded frames fed straight to the batcher:
                         the serving core (batching + device) with zero
                         per-request host decode — the ceiling the HTTP
                         front end can never exceed
    """
    from rtdm_tpu_torch.cli.serve import _ClassifyService, _DetectService

    if bool(engine_dir) == bool(detector_dir):
        raise ValueError("exactly one of engine_dir/detector_dir")
    svc = (_ClassifyService(engine_dir, 2.0, 2, device)
           if engine_dir else
           _DetectService(detector_dir, 2.0, 2, device=device))
    bodies, frames, decode_ms = decode_breakdown(
        svc.size, "classify" if engine_dir else "detect", seed)

    def hammer(call, items) -> Dict[str, float]:
        lat: List[float] = []
        errors: List[str] = []
        lock = threading.Lock()
        gate = threading.Event()

        def worker(cid):
            my = []
            err = []
            gate.wait()
            for k in range(requests_per_client):
                t0 = time.perf_counter()
                try:
                    call(items[(cid + k) % len(items)])
                    my.append(time.perf_counter() - t0)
                except Exception as e:  # noqa: BLE001
                    err.append(f"{type(e).__name__}: {e}")
            with lock:
                lat.extend(my)
                errors.extend(err)

        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(clients)]
        for t in ts:
            t.start()
        t_start = time.perf_counter()
        gate.set()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t_start
        out = {"rps": round(len(lat) / wall, 1) if wall > 0 else 0.0,
               "errors": len(errors)}
        if lat:
            q = np.quantile(np.asarray(lat), [0.5, 0.99])
            out["p50_ms"] = round(1e3 * q[0], 2)
            out["p99_ms"] = round(1e3 * q[1], 2)
        return out

    # warm the full path once so no bracket ever times a first-dispatch
    svc(bodies[0])
    handler = hammer(svc, bodies)
    core = hammer(svc.batcher, frames)
    stats = svc.batcher.stats().as_dict()
    svc.batcher.close()
    return {"mode": "direct",
            "service": "classify" if engine_dir else "detect",
            "clients": clients,
            "requests_per_client": requests_per_client,
            "decode_ms": round(decode_ms, 2),
            "handler": handler, "core": core,
            "batcher_mean_batch": stats.get("mean_batch", 0.0),
            "batcher_p99_ms": stats.get("p99_ms", 0.0)}


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default="http://127.0.0.1:8000")
    ap.add_argument("--endpoint", default="/v1/classify")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=32,
                    help="requests per client")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--direct-engine", default="",
                    help="handler-direct mode: classifier engine dir "
                         "(no HTTP, no client threads on the server's "
                         "CPU — isolates server capacity)")
    ap.add_argument("--direct-detector", default="",
                    help="handler-direct mode: detector engine dir")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="handler-direct mode: where the engine runs")
    a = ap.parse_args(argv)
    if a.direct_engine or a.direct_detector:
        res = run_direct(a.direct_engine, a.direct_detector,
                         a.clients, a.requests, device=a.device)
    else:
        res = run_load(a.url, a.endpoint, a.clients, a.requests, a.timeout)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
