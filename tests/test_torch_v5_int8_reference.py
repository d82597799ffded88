"""The port's int8 YOLOv5s against the benchmark's plain reference
(``benchmark/reference/yolov5_int8.py``), and the ``det:v5:*`` spans.

A yolov5s graph (the committed engine's yaml at nc = 2) with seeded random
weights and seeded BatchNorm statistics is built int8 through the port's
own path (``build_detector`` calibrating on seeded frames,
``save_detector(..., sealed=True)``) at 96x96 and loaded back with
``load_detector`` on the CPU. The reference loads the same directory and
is imported by file path, as the benchmark loads it.

Raw head maps are compared, not detections: random weights put the
confidences near the threshold. The program runs its convs, kernels and
BatchNorm affine in bf16 and the reference in fp32; each rounding that
moves an int8 code by one spreads through the layers after it, so the
maps differ by about 1% of their mean magnitude (``REL_TOL`` leaves half
as much again above that). The reference at int4, a Bottleneck of the P3
or the P4 stage without its residual and SiLU replaced by ReLU each read
more than twice ``REL_TOL``.

Imports no JAX."""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
YAML = ROOT / "artifacts" / "engines" / "yolov5s-mini_int8" / "model.txt"
SIZE = 96
# largest over the three levels of mean |port - reference| / mean
# |reference|: the port reads 0.0120; int4 0.1848, ReLU 0.4777, the P3 and
# P4 Bottlenecks without their residual 0.0368-0.0666 (the P2 one, m2.m0,
# only 0.0232)
REL_TOL = 0.018
SPANS = {"det:v5:focus", "det:v5:conv", "det:v5:c3", "det:v5:spp",
         "det:v5:resample", "det:v5:head", "det:v5:epilogue"}


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _reference():
    path = ROOT / "benchmark" / "reference" / "yolov5_int8.py"
    spec = importlib.util.spec_from_file_location("yolov5_int8_ref", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _seeded_bn(variables, rng):
    """Every BatchNorm leaf drawn from ``rng``, so that the reference's
    reading of the running statistics and of the affine matters."""
    draw = {"scale": lambda n: rng.uniform(0.5, 1.5, n),
            "bias": lambda n: rng.normal(0.0, 0.2, n),
            "mean": lambda n: rng.normal(0.0, 0.2, n),
            "var": lambda n: rng.uniform(0.5, 2.0, n)}

    def walk(node, parent):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, key)
            elif parent == "bn":
                node[key] = draw[key](val.shape).astype(np.float32)
    walk(variables, None)
    return variables


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """(directory of the sealed int8 engine, frames)."""
    from rtdm_tpu_torch.export.detector import (DetectorSpec, build_detector,
                                                load_detection_model,
                                                save_detector)
    from rtdm_tpu_torch.models.io import save_variables
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("v5int8")
    yaml = tmp / "yolov5s.yaml"
    shutil.copy(YAML, yaml)
    rng = np.random.default_rng(7)
    _, variables, _ = load_detection_model(str(yaml), None, SIZE,
                                           num_classes=2)
    save_variables(str(tmp / "w.npz"), _seeded_bn(variables, rng))
    calib = rng.integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8)
    det = build_detector(str(yaml), str(tmp / "w.npz"),
                         DetectorSpec(cfg_name="yolov5s.yaml", img_size=SIZE,
                                      quant="int8"),
                         batch_size=4, num_classes=2, calib_images=calib,
                         device="cpu")
    save_detector(det, str(tmp / "engine"), sealed=True)
    frames = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    return tmp / "engine", frames


def _load(directory):
    from rtdm_tpu_torch.export.detector import load_detector
    return load_detector(str(directory), device="cpu")


def _want(directory, frames, precision="int8"):
    ref = _reference()
    state = ref.load({"engine": directory.name}, str(directory.parent),
                     "cpu")
    return ref.raw_maps(state, frames, "cpu", precision=precision)


def _rel_err(got, want):
    """Largest over the levels of mean |got - want| / mean |want|."""
    return max(float(np.abs(g - w).mean() / np.abs(w).mean())
               for g, w in zip(got, want))


def _maps(det, frames):
    return [m.float().numpy() for m in det.raw_maps(torch.from_numpy(frames))]


def test_port_raw_maps_match_the_reference(engine):
    directory, frames = engine
    want = _want(directory, frames)
    got = _maps(_load(directory), frames)
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (4, SIZE // s, SIZE // s, 21) for s in (8, 16, 32)]
    assert _rel_err(got, want) <= REL_TOL


def _no_residual(det, name):
    det.net.get_submodule(name).add = False


def _relu_for_silu(monkeypatch):
    import rtdm_tpu_torch.models.yolov5 as yolov5
    monkeypatch.setattr(yolov5, "silu", lambda x, round_output=True: (
        torch.relu(x.float()) if not round_output else torch.relu(x)))


@pytest.mark.parametrize("control", ["int4", "no_residual_m4",
                                     "no_residual_m6", "relu"])
def test_controls_fail_the_tolerance(engine, monkeypatch, control):
    directory, frames = engine
    want = _want(directory, frames)
    if control == "int4":
        got = _want(directory, frames, precision="int4")
    else:
        det = _load(directory)
        if control == "relu":
            _relu_for_silu(monkeypatch)
        else:
            _no_residual(det, {"no_residual_m4": "m4.m0",
                               "no_residual_m6": "m6.m1"}[control])
        got = _maps(det, frames)
    assert _rel_err(got, want) > 2 * REL_TOL


def test_submit_opens_the_v5_spans_and_changes_nothing(engine):
    directory, frames = engine
    det = _load(directory)
    plain = [t.clone() for t in det.submit(frames)[:2]]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = det.submit(frames)[:2]
    names = [e.name for e in prof.events()]
    assert SPANS <= set(names)
    assert "det:v5:other" not in names
    # 62 convs with BatchNorm and SiLU, 7 residual adds; one C3 range each
    assert names.count("det:v5:epilogue") == 59 + 7
    assert names.count("det:v5:c3") == 8
    assert names.count("det:v5:head") == 1
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_train_step_is_the_same_under_a_profiler():
    from rtdm_tpu_torch.models.darknet import init_darknet
    from rtdm_tpu_torch.models.yolov5 import YoloV5
    model = YoloV5(YAML.read_text(), 2)
    init_darknet(model, seed=5)
    model.train()
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, 64, 64, 3), np.float32))

    def step():
        model.zero_grad()
        loss = sum(m.square().mean() for m in model(x))
        loss.backward()
        return [loss.detach()] + [p.grad.clone() for p in model.parameters()]
    plain = step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = step()
    assert "det:v5:epilogue" in {e.name for e in prof.events()}
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_exported_program_holds_no_range(tmp_path):
    """``torch.export`` traces with the spans open (``span`` enters a
    ``record_function`` while compiling); the program keeps no node of
    them and equals the eager forward."""
    from rtdm_tpu_torch.export.serialize import export_program
    from rtdm_tpu_torch.models.darknet import init_darknet
    from rtdm_tpu_torch.models.yolov5 import YoloV5
    model = YoloV5(YAML.read_text(), 2)
    init_darknet(model, seed=5)
    model.eval()
    x = torch.from_numpy(np.random.default_rng(4).random(
        (2, 64, 64, 3), np.float32))
    program = export_program(lambda t: model(t), [x])
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert not [t for t in targets if "record_function" in t
                or "profiler" in t]
    with torch.no_grad():
        for a, b in zip(program.module()(x), model(x)):
            assert torch.equal(a, b)
