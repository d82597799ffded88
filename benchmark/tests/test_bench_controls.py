"""Each configuration's control, the plain reference in the precision below
the configuration's, put in the program's place at a size a test run can
hold: it has to fail the configuration's limits."""

import pytest
import torch

from benchmark import frames, loops
from benchmark.run import ROOT, load_json, load_module


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("config,fit,count", [
    ("squeeze-ernet-bf16", "resize", 256),
    ("yolov4-tiny-416-int8", "letterbox", 10)])
def test_control_fails_the_limits(config, fit, count):
    cfg = load_json(ROOT, "benchmark", "configs", config + ".json")
    ref = load_module("reference", cfg["reference"])
    check = load_module("checks", cfg["check"])
    state = ref.load(cfg, ROOT, "cpu")
    pool = frames.make_pool(ROOT, 2001, count, int(cfg["image_size"]), fit)
    want = ref.forward(state, pool, "cpu")
    low = ref.forward(state, pool, "cpu", precision=cfg["control_precision"])
    # in the program's place, as the window's batches hold the pool
    ids, slots = loops.cycle(min(int(cfg["batch"]), count), count)
    numbers = check.compare([low[i] for i in ids], ids, slots, want)
    limits = cfg["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers
    same = check.compare([want[i] for i in ids], ids, slots, want)
    assert all(same[k] <= limits[k] for k in limits), same
