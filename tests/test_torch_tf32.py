"""TF32 is one process-wide setting in PyTorch; ``core/precision.py::tf32``
sets it for the body of a ``with`` under a process-wide lock, and the fp32
``Engine`` enqueues each forward inside ``tf32(False)``.

Before that repair the fp32 engine turned TF32 off once, at construction,
and ``tf32`` took no lock: a detector thread inside ``tf32(True)`` (an int8
or bf16 detector's network) left the fp32 classifier served beside it
running its convs under TF32. On the CPU the setting changes no arithmetic,
so these tests read the setting itself where the fp32 engine's stem conv
runs: a forward pre-hook on ``conv1``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from rtdm_tpu_torch.core.precision import tf32
from rtdm_tpu_torch.export.engine import Engine, EngineSpec
from rtdm_tpu_torch.models.io import load_variables
from tests.torch_port_goldens import params_path

JOIN_S = 30.0


def _settings():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture(scope="module")
def fp32_engine():
    spec = EngineSpec("squeeze-ernet", "fp32", batch_size=2, image_size=140)
    return Engine(spec, load_variables(params_path("squeeze-ernet")),
                  device="cpu")


@pytest.fixture
def stem_seen(fp32_engine):
    """The cuDNN TF32 setting at each call of the engine's stem conv."""
    seen = []
    handle = fp32_engine.model.conv1.register_forward_pre_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    yield seen
    handle.remove()


def _frames(n=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 140, 140, 3),
                                                dtype=np.uint8)


def test_fp32_engine_sets_no_global_at_construction(fp32_engine):
    saved = _settings()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        Engine(fp32_engine.spec, fp32_engine.variables, device="cpu")
        assert _settings() == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_fp32_engine_sees_tf32_off_while_another_thread_has_it_on(
        fp32_engine, stem_seen):
    inside, release = threading.Event(), threading.Event()

    def detector_thread():
        with tf32(True):
            inside.set()
            release.wait(JOIN_S)

    other = threading.Thread(target=detector_thread, daemon=True)
    other.start()
    assert inside.wait(JOIN_S)
    result = {}

    def classify():
        result["probs"] = fp32_engine(_frames())

    caller = threading.Thread(target=classify, daemon=True)
    caller.start()
    caller.join(0.5)
    # the engine waits for the other thread's section to end
    assert caller.is_alive() and not stem_seen
    release.set()
    other.join(JOIN_S)
    caller.join(JOIN_S)
    assert not other.is_alive() and not caller.is_alive()
    assert stem_seen == [False]
    assert result["probs"].shape == (2, 5)


def test_tf32_sections_never_interleave_under_load(fp32_engine, stem_seen):
    """A thread toggling ``tf32(True)`` as fast as it can against the fp32
    engine called in a loop: every stem conv runs with TF32 off."""
    stop = threading.Event()
    toggles = [0]

    def toggler():
        while not stop.is_set():
            with tf32(True):
                assert _settings() == (True, True)
                toggles[0] += 1

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=toggler, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        frames = _frames(1)
        for _ in range(6):
            fp32_engine(frames)
        stop.set()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert toggles[0] > 0
    assert stem_seen == [False] * 6


def test_nested_tf32_in_one_thread_restores_each_level():
    saved = _settings()
    try:
        with tf32(False):
            assert _settings() == (False, False)
            with tf32(True):
                assert _settings() == (True, True)
                with tf32(False):
                    assert _settings() == (False, False)
                assert _settings() == (True, True)
            assert _settings() == (False, False)
        assert _settings() == saved
        with pytest.raises(RuntimeError):
            with tf32(not saved[0]):
                raise RuntimeError("body fails")
        assert _settings() == saved
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_tf32_lock_is_released_after_a_failing_body():
    with pytest.raises(ValueError):
        with tf32(True):
            raise ValueError("body fails")
    done = threading.Event()

    def other():
        with tf32(False):
            done.set()

    t = threading.Thread(target=other, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert done.is_set() and not t.is_alive()
