"""Fixed-batch classifier engines on the card.

Counterpart of ``rtdm_tpu/export/engine.py``. An engine directory holds
``spec.json`` + ``params.npz`` (+ ``act_scales.npz`` for int8), the same
format the JAX package reads and writes, so every classifier directory in
``artifacts/engines/`` loads in both. The forward — device-side normalize,
network, optional softmax — runs at the spec's fixed batch: callers with
fewer frames are zero-padded up to ``spec.batch_size``, more raise.

Precisions: fp32, bf16 ('fp16'/'half' are aliases of bf16, as in the
JAX package) and int8. In bf16 only the parameters are cast; BatchNorm
running statistics stay fp32. An fp32 engine enqueues each forward with
TF32 off for cuDNN and cuBLAS, which would otherwise keep about three
digits, under ``core/precision.py::tf32``'s lock, whatever other threads
set meanwhile. int8 is the JAX package's QDQ engine (``quant/int8.py``):
kernels QDQ'd per output channel on the JAX-layout tree, then cast to
bf16; activations QDQ'd with the calibrated ``act_scales`` at every conv
and dense input, inside the ACFF blocks by the bf16 kernel's QDQ mode.
``build_engine`` calibrates an int8 engine on the frames it is given
(``quant/calibrate.py``). Not ported: ``exec_cache`` (serialized XLA
executables).

``mesh`` (``core/mesh.py``; a data-parallel engine over the mesh's 'data'
axis, the batch a multiple of it): every rank is handed the global batch,
runs its own rows through the network on its device (its ACFF blocks
launching the kernel of the engine's precision on them) and all-gathers
the outputs, so each rank returns what the one-process engine returns.

On the card ``dispatch`` replays the forward as one CUDA graph
(``CapturedForward``): the first call at a given number of rows (the
spec's batch, or the rank's rows under a mesh) warms the eager forward up
on a side stream and captures it on a static uint8 input; every call then
copies its frames into that input, zeroes the rows past them, replays the
graph and returns a copy of its output, so a batch in flight keeps its
answer while the next one replays. The replayed output is the eager
forward's bit for bit. The graph holds the model's parameters and the
ACFF blocks' packed arguments as they were at capture: an engine's
weights do not change after its first call. On the CPU the forward runs
eagerly; ``_forward`` stays the eager forward, which ``torch.export``
traces (``cli/export_model.py``).

Spans (``utils/profiler.py::span``): ``engine:upload`` from the zeroed
device batch through the copy, ``engine:upload:wait`` around the copy (it
blocks the host until the card has taken the frames), ``engine:forward``
around normalize, network, softmax and the cast (on the card: around the
replay and the output's copy), ``engine:graph`` around the replay, and
``engine:download:wait`` around ``__call__``'s copy back.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rtdm_tpu_torch.core.mesh import (data_sharding, mesh_device,
                                      require_data_divisible)
from rtdm_tpu_torch.core.precision import (ENGINE_DTYPES, cast_floating,
                                           normalized_quant, tf32)
from rtdm_tpu_torch.data.aider import (IMAGENET_MEAN, IMAGENET_STD,
                                       normalize_batch)
from rtdm_tpu_torch.models.ernet import create_model, input_size_for
from rtdm_tpu_torch.models.io import (flatten_tree, infer_num_classes,
                                      load_variables,
                                      torch_state_dict_from_variables)
from rtdm_tpu_torch.ops.acff import LAUNCHES
from rtdm_tpu_torch.parallel.comms import all_gather_along
from rtdm_tpu_torch.quant.calibrate import calibrate_classifier
from rtdm_tpu_torch.quant.int8 import quantize_classifier, quantize_params
from rtdm_tpu_torch.utils.profiler import span


@dataclasses.dataclass
class EngineSpec:
    model: str
    quant: str = "bf16"           # fp32 | bf16 (fp16 alias) | int8
    batch_size: int = 256
    image_size: int = 140
    num_classes: int = 5
    with_softmax: bool = True
    calib_method: str = "percentile"  # percentile | entropy (int8 act cal)
    version: str = "1"

    def normalized_quant(self) -> str:
        return normalized_quant(self.quant)


@dataclasses.dataclass
class CapturedForward:
    """The engine's forward at one number of rows on one card, captured
    as a CUDA graph: it reads the static uint8 input ``x`` and writes the
    static output ``out``; ``launches`` holds the ACFF launches
    (``ops/acff.py::LAUNCHES``, by kernel) recorded into it, since a
    replay launches nothing from the host."""
    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    out: torch.Tensor
    launches: Dict[str, int]


class Engine:
    """A fixed-batch classifier engine over uint8 NHWC frames."""

    def __init__(self, spec: EngineSpec, variables: Dict[str, Any],
                 act_scales: Optional[Dict[str, np.ndarray]] = None,
                 device=None, mesh=None):
        """``device``: the card unless given; under ``mesh``, the mesh's
        (``core/mesh.py::mesh_device``)."""
        quant = spec.normalized_quant()
        if quant not in ENGINE_DTYPES:
            raise ValueError(f"unknown engine precision {spec.quant!r}")
        if quant == "int8" and not act_scales:
            raise ValueError("an int8 engine needs act_scales (calibrate "
                             "with build_engine(..., calib_images=...))")
        if mesh is not None:
            require_data_divisible(spec.batch_size, mesh, "engine batch")
        self.spec = spec
        self.variables = variables
        self.act_scales = act_scales
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.dtype = ENGINE_DTYPES[quant]
        if quant == "int8":
            variables = {**variables,
                         "params": quantize_params(variables["params"])}
        self.model = load_model(spec, variables, self.device, self.dtype)
        if quant == "int8":
            quantize_classifier(self.model, act_scales)
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)
        # on the card: the captured forward by (rows, device), and the lock
        # that one call holds from its upload into the static input through
        # the copy of the graph's output (the serve batcher dispatches from
        # its own thread)
        self.graphs: Dict[Tuple[int, torch.device], CapturedForward] = {}
        self._lock = threading.Lock()

    @torch.inference_mode()
    def dispatch(self, images_u8) -> torch.Tensor:
        """Enqueue a batch without waiting for it: returns the float32
        device output, padded to ``spec.batch_size``; slice ``[:n]``. Under
        a mesh the rank runs its rows and the output is all-gathered."""
        b, s = self.spec.batch_size, self.spec.image_size
        n = images_u8.shape[0]
        if n > b:
            raise ValueError(f"batch {n} exceeds engine max batch {b}")
        frames = torch.as_tensor(images_u8)
        if frames.dtype != torch.uint8 or tuple(frames.shape[1:]) != (s, s, 3):
            raise ValueError(f"expected uint8 frames (n, {s}, {s}, 3), got "
                             f"{frames.dtype} {tuple(frames.shape)}")
        rows = (slice(0, b) if self.mesh is None
                else data_sharding(self.mesh).rows(b))
        mine = frames[rows.start:min(rows.stop, n)]
        if self.device.type == "cuda":
            out = self._replay(mine, rows.stop - rows.start)
        else:
            with span("engine:upload"):
                x = torch.zeros((rows.stop - rows.start, s, s, 3),
                                dtype=torch.uint8, device=self.device)
                with span("engine:upload:wait"):
                    x[:mine.shape[0]].copy_(mine)
            out = self._eager(x)
        return out if self.mesh is None else all_gather_along(out, self.mesh)

    def _replay(self, mine: torch.Tensor, rows: int) -> torch.Tensor:
        """``mine`` (at most ``rows`` frames) through the captured forward
        of ``rows`` rows, captured at its first call: a copy of its
        output."""
        s = self.spec.image_size
        k = mine.shape[0]
        with self._lock:
            captured = self.graphs.get((rows, self.device))
            x = (captured.x if captured is not None else
                 torch.empty((rows, s, s, 3), dtype=torch.uint8,
                             device=self.device))
            with span("engine:upload"):
                if k < rows:
                    x[k:].zero_()
                with span("engine:upload:wait"):
                    x[:k].copy_(mine)
            if captured is None:
                captured = self._capture(x)
                self.graphs[(rows, self.device)] = captured
            with span("engine:forward"):
                with span("engine:graph"):
                    captured.graph.replay()
                return captured.out.clone()

    def _capture(self, x: torch.Tensor) -> CapturedForward:
        """The forward on the static input ``x`` as a CUDA graph, after one
        eager forward on a side stream that sets what the capture must find
        ready: the kernels' attributes, cuDNN's choice and the ACFF blocks'
        packed arguments. Another thread may use the card meanwhile
        (``thread_local``: only this thread's calls are held to the
        capture's rules)."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._eager(x)
        current.wait_stream(side)
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._eager(x)
        return CapturedForward(graph, x, out, {k: n - before[k] for k, n
                                               in LAUNCHES.items()})

    def _eager(self, x: torch.Tensor) -> torch.Tensor:
        """``_forward`` in the engine's precision: fp32 with TF32 off."""
        if self.dtype != torch.float32:   # bf16 convs take no TF32
            return self._forward(x)
        with tf32(False):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("engine:forward"):
            x = normalize_batch(x, self._mean, self._std).to(self.dtype)
            return self.model(x, apply_softmax=self.spec.with_softmax).float()

    def __call__(self, images_u8) -> np.ndarray:
        n = images_u8.shape[0]
        out = self.dispatch(images_u8)[:n]
        with span("engine:download:wait"):
            out = out.cpu()
        return out.numpy()

    def save(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "spec.json"), "w") as f:
            json.dump(dataclasses.asdict(self.spec), f, indent=2)
        np.savez(os.path.join(directory, "params.npz"),
                 **flatten_tree(self.variables))
        if self.act_scales:
            np.savez(os.path.join(directory, "act_scales.npz"),
                     **{k: np.asarray(v) for k, v in self.act_scales.items()})
        return directory

    @classmethod
    def load(cls, directory: str, device=None, mesh=None) -> "Engine":
        with open(os.path.join(directory, "spec.json")) as f:
            spec = EngineSpec(**json.load(f))
        variables = load_variables(os.path.join(directory, "params.npz"))
        scales_path = os.path.join(directory, "act_scales.npz")
        act_scales = None
        if os.path.exists(scales_path):
            with np.load(scales_path) as archive:
                act_scales = dict(archive)
        return cls(spec, variables, act_scales, device=device, mesh=mesh)


def load_model(spec: EngineSpec, variables: Dict[str, Any], device,
               dtype: torch.dtype) -> torch.nn.Module:
    """The spec's classifier on ``device`` in eval mode, with the tree's
    weights: parameters cast to ``dtype``, BatchNorm statistics as
    stored."""
    model = create_model(spec.model, device=device,
                         num_classes=spec.num_classes,
                         image_size=spec.image_size)
    state = {k: v.to(device) for k, v in
             torch_state_dict_from_variables(variables).items()}
    params = {name for name, _ in model.named_parameters()}
    state.update(cast_floating({k: state[k] for k in params if k in state},
                               dtype))
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()


def build_engine(model_name: str, variables: Dict[str, Any],
                 quant: str = "bf16", batch_size: int = 256,
                 calib_images: Optional[np.ndarray] = None,
                 calib_method: str = "percentile",
                 verify: bool = True, num_classes: Optional[int] = None,
                 device=None, mesh=None) -> Engine:
    """Build (and optionally verify) an engine from a variables tree.

    For int8, ``calib_images`` (uint8 NHWC frames) calibrate the activation
    scales by ``calib_method`` ('percentile' or 'entropy') on the fp32
    model on the engine's device. ``num_classes`` defaults to what the
    checkpoint's head says. Verify runs one zero frame and checks the
    output's shape and finiteness."""
    if num_classes is None:
        num_classes = infer_num_classes(variables) or 5
    image_size = input_size_for(model_name)
    spec = EngineSpec(model=model_name, quant=quant, batch_size=batch_size,
                      image_size=image_size, num_classes=num_classes,
                      calib_method=calib_method)
    act_scales = None
    if spec.normalized_quant() == "int8":
        if calib_images is None:
            raise ValueError("int8 engines need calib_images")
        act_scales = calibrate_classifier(
            load_model(spec, variables, mesh_device(mesh, device),
                       torch.float32),
            calib_images, method=calib_method)
    engine = Engine(spec, variables, act_scales, device=device, mesh=mesh)
    if verify:
        out = engine(np.zeros((1, image_size, image_size, 3), np.uint8))
        if out.shape != (1, num_classes) or not np.all(np.isfinite(out)):
            raise RuntimeError(f"engine verification failed: output "
                               f"{out.shape}, finite={np.isfinite(out).all()}")
    return engine
