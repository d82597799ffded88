"""The ACFF bound and the operation counts against hand-worked values."""

import pytest

from benchmark import roofline
from benchmark.run import ROOT, load_json, load_module

# Squeeze_ErNET at 140x140: (C, O, input side) of the four ACFF blocks
BLOCKS = [(16, 64, 69), (64, 96, 33), (96, 128, 15), (128, 256, 6)]


def test_acff_bound_block_one_by_hand():
    # b 256, C 16, O 64, 69x69 in, 67x67 out: P = 256 * 4489 = 1,149,184
    # bytes: 2 (256*69*69*16 + P*64) + 4 (27*16 + 3*16 + 3*64) + 2*48*64
    #      = 186,097,664 + 2,688 + 6,144 = 186,106,496
    # operations: 2 P (27*16 + 48*64) = 2 * 1,149,184 * 3,504
    seconds, bound, nbytes, ops = roofline.acff_bound(256, 16, 64, 69, 69)
    assert nbytes == 186_106_496
    assert ops == 8_053_481_472
    assert bound == "bytes"
    assert seconds == pytest.approx(186_106_496 / 3.35e12)


def test_acff_bound_of_the_forward():
    # chip_smoke.py's bound for the four blocks at batch 256: 0.0883 ms
    total = roofline.acff_bound_sum(256, BLOCKS)
    assert total * 1e3 == pytest.approx(0.0883, abs=5e-5)
    assert roofline.padded_k(16) == 48 and roofline.padded_k(96) == 288


def test_squeeze_ernet_flops_by_hand():
    # conv1 69*69*27*16*2; block k: 2 P (27 C + 3 C O); head 4*4*256*5*2;
    # fc 20*5*2
    by_hand = (69 * 69 * 27 * 16 * 2
               + 2 * 67 * 67 * (27 * 16 + 48 * 64)
               + 2 * 31 * 31 * (27 * 64 + 192 * 96)
               + 2 * 13 * 13 * (27 * 96 + 288 * 128)
               + 2 * 4 * 4 * (27 * 128 + 384 * 256)
               + 4 * 4 * 256 * 5 * 2 + 20 * 5 * 2)
    assert by_hand == 90_953_544
    cfg = load_json(ROOT, "benchmark", "configs", "squeeze-ernet-bf16.json")
    ref = load_module("reference", "ernet")
    state = ref.load(cfg, ROOT, "cpu")
    assert ref.flops_per_frame(cfg, state) == by_hand
    assert ref.block_shapes(cfg, state) == BLOCKS


def test_yolov4_tiny_flops_by_hand():
    def conv(side, k, c, o):
        return 2 * side * side * k * k * c * o
    by_hand = (conv(416, 3, 3, 16) + conv(208, 3, 16, 32)
               + conv(104, 3, 32, 64) + conv(52, 3, 64, 128)
               + conv(26, 3, 128, 256) + conv(13, 3, 256, 512)
               + conv(13, 3, 512, 1024) + conv(13, 1, 1024, 256)
               + conv(13, 3, 256, 512) + conv(13, 1, 512, 28)
               + conv(13, 1, 256, 128) + conv(26, 3, 384, 256)
               + conv(26, 1, 256, 28) + conv(26, 1, 256, 128)
               + conv(52, 3, 256, 128) + conv(52, 1, 128, 28))
    cfg = load_json(ROOT, "benchmark", "configs", "yolov4-tiny-416-int8.json")
    ref = load_module("reference", "darknet_int8")
    state = ref.load(cfg, ROOT, "cpu")
    assert ref.flops_per_frame(cfg, state) == by_hand == 7_105_679_360


def test_shares_are_never_zero_where_nothing_was_read():
    ctx = type("Ctx", (), {"summary": None, "win": None})
    for name in ("acff_roofline_pct.survey", "mfu.survey",
                 "device_idle_pct.survey", "upload_us_per_image.survey"):
        ctx.win = type("W", (), {"dispatches": [], "completed_in_window": 0})
        assert load_module("metrics", name).read(ctx) is None
