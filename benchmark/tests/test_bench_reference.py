"""Each plain reference against the port's CPU route at a small size."""

import os

import numpy as np
import pytest
import torch

from benchmark import frames
from benchmark.run import ROOT, load_json, load_module


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_ernet_reference_against_the_port_in_fp32_and_bf16():
    from rtdm_tpu_torch.export.engine import Engine, EngineSpec
    from rtdm_tpu_torch.models.io import load_variables
    cfg = load_json(ROOT, "benchmark", "configs", "squeeze-ernet-bf16.json")
    ref = load_module("reference", "ernet")
    pool = frames.make_pool(ROOT, 5, 6, 140)
    want = ref.forward(ref.load(cfg, ROOT, "cpu"), pool, "cpu")
    variables = load_variables(os.path.join(ROOT, cfg["engine"],
                                            "params.npz"))
    fp32 = Engine(EngineSpec(model="squeeze-ernet", quant="fp32",
                             batch_size=6), variables, device="cpu")
    np.testing.assert_allclose(fp32(pool), want, atol=2e-5)
    bf16 = Engine.load(os.path.join(ROOT, cfg["engine"]), device="cpu")
    check = load_module("checks", "softmax_rows")
    got = check.compare(bf16(pool), np.arange(6), np.arange(6), want)
    assert got["prob_l1_mean"] <= cfg["limits"]["prob_l1_mean"]


def test_darknet_int8_reference_against_the_port():
    from rtdm_tpu_torch.export.detector import load_detector
    cfg = load_json(ROOT, "benchmark", "configs", "yolov4-tiny-416-int8.json")
    ref = load_module("reference", "darknet_int8")
    pool = frames.make_pool(ROOT, 11, 10, 416, "letterbox")
    want = ref.forward(ref.load(cfg, ROOT, "cpu"), pool, "cpu")
    assert sum(len(w) for w in want) >= 3          # frames with victims
    det = load_detector(os.path.join(ROOT, cfg["engine"]), device="cpu",
                        batch_size=10)
    boxes, counts = det(pool)
    got = [boxes[i, :c] for i, c in enumerate(counts)]
    check = load_module("checks", "detections")
    numbers = check.compare(got, np.arange(10), np.arange(10), want)
    assert numbers["unmatched_share"] <= cfg["limits"]["unmatched_share"]
    assert numbers["conf_gap"] <= cfg["limits"]["conf_gap"]
    # the same detections, row for row, where both found the same count
    for g, w in zip(got, want):
        if len(g) == len(w) and len(g):
            np.testing.assert_allclose(g[:, :4], w[:, :4], atol=3.0)
            assert (g[:, 5] == w[:, 5]).all()


def test_reference_nms_is_greedy_within_a_class():
    ref = load_module("reference", "darknet_int8")
    spec = {"conf_thres": 0.25, "iou_thres": 0.45, "top_k": 512,
            "max_det": 300}
    # rows cx, cy, w, h, obj, p(cls0), p(cls1)
    pred = np.array([[50, 50, 20, 20, 0.9, 1.0, 0.0],     # kept
                     [52, 50, 20, 20, 0.8, 1.0, 0.0],     # IoU 0.82: gone
                     [52, 50, 20, 20, 0.8, 0.0, 1.0],     # other class
                     [90, 90, 20, 20, 0.7, 1.0, 0.0],     # apart: kept
                     [10, 10, 20, 20, 0.2, 1.0, 0.0],     # under conf
                     [30, 30, 1.5, 20, 0.9, 1.0, 0.0]],   # too thin
                    np.float32)
    det = ref.nms(pred, spec)
    assert det[:, 4].tolist() == pytest.approx([0.9, 0.8, 0.7])
    assert det[:, 5].tolist() == [0, 1, 0]
    np.testing.assert_allclose(det[0, :4], [40, 40, 60, 60])
