"""Fixed-batch detector engines: uint8 letterboxed frames -> boxes.

Counterpart of ``rtdm_tpu/export/detector.py``. A ``Detector`` runs
``/255 -> darknet or v5 graph -> decode -> NMS`` on the card and returns
``det`` (n, max_det, 6) rows x1, y1, x2, y2, conf, cls (zero-padded) and
``count`` (n,). An engine directory holds ``spec.json``, ``model.txt`` (the
cfg or yaml text), ``params.npz`` (sealed: int8 kernel codes and
per-channel scales) and, for int8, ``act_scales.npz``: the format the JAX
package writes, so every detector directory in ``artifacts/engines/``
loads in both.

As the compiled JAX program computes it:
- frames are padded with zero frames up to the engine's batch; any (h, w)
  letterbox shape runs, decoded at its own strides;
- ``/255`` is a multiply by fp32(1/255), then a cast to the engine's dtype
  (bf16 for bf16 and int8); in an int8 darknet engine whose first layer is
  a QDQ'd conv, XLA folds the /255 into that QDQ (one multiply of the
  uint8 value by fp32(1/255) * fp32(1/s), no bf16 rounding in between),
  and so does ``_preprocess``;
- a darknet graph has conv+BN folded at build (``ops/fuse.py``);
- int8 is ``quantize_params`` on the tree, bf16 parameters, and the
  activation QDQ hooks of ``quant/int8.py::quantize_detector``;
- the network's convs whose product BN reads in fp32 run as fp32 convs of
  bf16 values. On the card TF32 is turned on for the network's forward of
  a bf16 or int8 engine (bf16 operands are exact in TF32) and off for an
  fp32 one, and restored after each call; decode and NMS run in fp32 with
  TF32 off.

TTA (``spec.tta``) pools the predictions at three scales before one NMS
(``tta_pooled_pred``), with ``resize_bilinear`` in place of
``jax.image.resize``: its antialiased triangle weights, built as JAX's
``scale_and_translate`` builds them.

``mesh`` (``core/mesh.py``) makes a data-parallel detector over the
mesh's 'data' axis, its batch a multiple of it: every rank is handed the
global batch, runs the network, decode and NMS over its own frames (each
rank suppresses within its own frames, as each shard does in JAX) and
all-gathers ``(det, count)``, so each rank returns what the one-process
detector returns.

Spans (``utils/profiler.py::span``): ``det:upload``, ``det:normalize``,
``det:network``, ``det:decode``, ``det:nms``; each point where a call
blocks the host on the device is a ``:wait`` span inside them:
``det:upload:wait`` (the copy of the frames), ``det:decode:wait`` (each
head's anchors and stride, copied from the host), ``det:nms:wait``
(``ops/nms.py``) and, in ``__call__``, ``det:download:wait`` around each
copy back.

Not ported: ``exec.xla`` / the executable cache (XLA executables, TPU
only: neither written nor read).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rtdm_tpu_torch.core.device import resolve_device
from rtdm_tpu_torch.core.mesh import (data_sharding, mesh_device,
                                      require_data_divisible)
from rtdm_tpu_torch.core.precision import tf32
from rtdm_tpu_torch.models.io import (flatten_tree, load_variables,
                                      save_variables,
                                      torch_state_dict_from_variables)
from rtdm_tpu_torch.parallel.comms import all_gather_along
from rtdm_tpu_torch.utils.profiler import span


@dataclasses.dataclass
class DetectorSpec:
    cfg_name: str
    img_size: int = 416
    conf_thres: float = 0.25
    iou_thres: float = 0.45
    max_det: int = 300
    top_k: int = 512
    quant: str = "bf16"            # fp32 | bf16 | int8
    calib_method: str = "percentile"  # percentile | entropy
    tta: bool = False
    nms_method: str = "greedy"     # greedy | or | vision_batch | merge |
    #                                soft | and
    multi_label: bool = False
    class_agnostic: bool = False
    classes: Optional[Tuple[int, ...]] = None
    fuse: bool = True              # fold conv+BN at build
    version: str = "1"

    def __post_init__(self):
        if self.classes is not None:
            self.classes = tuple(int(c) for c in self.classes)
        q = {"fp16": "bf16", "half": "bf16"}.get(self.quant.lower(),
                                                 self.quant.lower())
        if q not in ("fp32", "bf16", "int8"):
            raise ValueError(f"unknown detector quant {self.quant!r} "
                             "(fp32|bf16|fp16|half|int8)")
        self.quant = q


def resize_weights(m: int, n: int, device="cpu",
                   fused: bool = False) -> torch.Tensor:
    """(m, n) fp32 weights that resize an axis of m samples to n, as
    ``jax.image.scale_and_translate`` computes them for the bilinear
    (triangle) kernel with antialiasing: on a downscale the triangle is
    widened by 1/scale; each output's weights are normalised to sum 1 and
    zeroed where its sample lies outside the input. ``fused`` computes
    them as the jitted function does (the sample position one fused
    multiply-add, the division by the kernel's scale a multiply by its
    fp32 reciprocal), else as the eager one."""
    inv = torch.tensor(1.0 / (n / m), dtype=torch.float32)
    kscale = torch.clamp(inv, min=1.0)
    pos = torch.arange(n, dtype=torch.float32) + 0.5
    grid = torch.arange(m, dtype=torch.float32)[:, None]
    if fused:
        sample = torch.addcmul(torch.tensor(-0.5), pos, inv)
        dist = (sample[None, :] - grid).abs() * torch.reciprocal(kscale)
    else:
        sample = pos * inv - 0.5
        dist = (sample[None, :] - grid).abs() / kscale
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    fused: bool = False) -> torch.Tensor:
    """``jax.image.resize(x, (b, h, w, c), "bilinear")`` of an NHWC batch:
    the height then the width axis contracted with ``resize_weights``
    (cast to x's dtype, as JAX casts them), each product summed in fp32
    and rounded to x's dtype."""
    h, w = size
    out = x
    for axis, n in ((1, h), (2, w)):
        m = out.shape[axis]
        if m == n:
            continue
        wt = resize_weights(m, n, x.device, fused).to(x.dtype).float()
        eq = "bmwc,mn->bnwc" if axis == 1 else "bhmc,mn->bhnc"
        out = torch.einsum(eq, out.float(), wt).to(x.dtype)
    return out


def tta_pooled_pred(apply_pred, x: torch.Tensor, img_size: int
                    ) -> torch.Tensor:
    """TTA pooling (yolov5/models/yolo.py:123-134): ``apply_pred(xi, si)``
    at scales 1/0.83/0.67 (lr-flip on the middle scale), each prediction
    set descaled into the base frame (cx un-flipped) and concatenated for
    one NMS pass; ``rtdm_tpu/export/detector.py::tta_pooled_pred``."""
    s0 = img_size
    preds = []
    for scale, flip in ((1.0, False), (0.83, True), (0.67, False)):
        si = max(int(round(s0 * scale / 32)) * 32, 32)
        xi = x if si == s0 else resize_bilinear(x, (si, si))
        if flip:
            xi = xi.flip(2)
        p = apply_pred(xi, si).float()
        g = s0 / si
        cx, cy = p[..., 0] * g, p[..., 1] * g
        if flip:
            cx = s0 - cx
        preds.append(torch.cat([cx[..., None], cy[..., None],
                                p[..., 2:3] * g, p[..., 3:4] * g,
                                p[..., 4:]], -1))
    return torch.cat(preds, 1)


def model_heads(model) -> Any:
    """Head metadata for either family."""
    return tuple(model.heads)


def _family(model) -> str:
    from rtdm_tpu_torch.models.yolov5 import YoloV5
    return "yolov5" if isinstance(model, YoloV5) else "darknet"


def _model_text(model) -> str:
    return model.yaml_text if _family(model) == "yolov5" else model.cfg_text


def _new_model(family: str, text: str, num_classes: Optional[int] = None,
               device="cpu"):
    from rtdm_tpu_torch.models.darknet import Darknet
    from rtdm_tpu_torch.models.yolov5 import YoloV5
    with torch.device(device):
        return (YoloV5(text, num_classes) if family == "yolov5"
                else Darknet(text))


def load_detection_model(model_path: str, weights: Optional[str],
                         img_size: int, num_classes: Optional[int] = None,
                         intersect: bool = False):
    """(model, variables, heads) from a darknet .cfg or a v5 .yaml: a fresh
    init (v5: with the focal-prior Detect biases, which a partial load
    leaves where it skips the head), then the weights if given, opened at
    that path and nowhere else: ``.npz``; a v5 ``.pt``/``.pth``
    (``intersect`` skips shape-mismatched tensors); a darknet
    ``.weights`` or the fork's ``.pt``/``.pth``. A missing file of a name
    the reference publishes goes through ``utils/downloads.py::
    attempt_download`` first (fetched only with ``RTDM_ALLOW_DOWNLOAD=1``;
    no other directory is searched)."""
    from rtdm_tpu_torch.models.darknet import (create_darknet, init_darknet,
                                               load_darknet_torch_checkpoint,
                                               load_darknet_weights)
    from rtdm_tpu_torch.models.yolov5 import (create_yolov5,
                                              initialize_detect_biases,
                                              load_yolov5_torch_checkpoint)
    from rtdm_tpu_torch.utils.downloads import attempt_download
    weights = attempt_download(weights)
    v5 = model_path.endswith((".yaml", ".yml"))
    if v5:
        model = create_yolov5(model_path, num_classes)
        variables = init_darknet(model)
        variables = initialize_detect_biases(model, variables, img_size)
    else:
        model = create_darknet(model_path)
        variables = init_darknet(model)
    if not weights:
        return model, variables, model_heads(model)
    if weights.endswith(".npz"):
        variables = load_variables(weights)
    elif weights.endswith((".pt", ".pth")):
        variables = (load_yolov5_torch_checkpoint(variables, weights,
                                                  intersect=intersect)
                     if v5 else load_darknet_torch_checkpoint(
                         variables, model.cfg_text, weights))
    elif weights.endswith(".weights") and not v5:
        variables = load_darknet_weights(variables, model.cfg_text, weights)
    else:
        raise ValueError(f"{weights}: {'v5' if v5 else 'darknet'} models "
                         "load .npz, .pt or .pth"
                         + ("" if v5 else " or .weights") + " weights")
    return model, variables, model_heads(model)


class Detector:
    """Callable over uint8 letterboxed NHWC batches -> (det, count)."""

    def __init__(self, model, variables: Dict[str, Any], spec: DetectorSpec,
                 batch_size: int = 1, heads=None,
                 act_scales: Optional[Dict[str, float]] = None,
                 device=None, mesh=None):
        """``model`` is a port ``Darknet`` or ``YoloV5`` (its structure;
        the weights come from ``variables``, a JAX-layout tree);
        ``device`` the card unless given, under ``mesh`` the mesh's."""
        from rtdm_tpu_torch.models.darknet import Darknet
        from rtdm_tpu_torch.quant.int8 import (quantize_detector,
                                               quantize_params)
        if mesh is not None:
            require_data_divisible(batch_size, mesh, "detector batch")
        self.spec = spec
        self.model = model           # unfused: what save_detector writes
        self.batch_size = int(batch_size)
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.act_scales = ({k: float(v) for k, v in act_scales.items()}
                           if act_scales else None)
        if spec.quant == "int8" and not self.act_scales:
            raise ValueError("an int8 detector needs act_scales (calibrate "
                             "with build_detector(..., calib_images=...))")
        heads = heads if heads is not None else model_heads(model)
        self.heads = tuple(heads)
        self.num_classes = int(self.heads[0].num_classes)
        self.dtype = torch.float32 if spec.quant == "fp32" else torch.bfloat16

        family, text = _family(model), _model_text(model)
        if (spec.fuse and isinstance(model, Darknet)
                and variables.get("batch_stats")):
            from rtdm_tpu_torch.ops.fuse import (fuse_darknet_variables,
                                                 strip_bn_from_cfg)
            variables = fuse_darknet_variables(variables, text)
            text = strip_bn_from_cfg(text)
        if spec.quant == "int8":
            variables = {**variables,
                         "params": quantize_params(variables["params"])}
        net = _new_model(family, text, getattr(model, "num_classes", None),
                         device="meta")
        state = {k: v.to(self.device) for k, v in
                 torch_state_dict_from_variables(variables).items()}
        params = {name for name, _ in net.named_parameters()}
        state = {k: v.to(self.dtype) if k in params else v
                 for k, v in state.items()}
        net.load_state_dict(state, strict=True, assign=True)
        self.net = net.eval()
        self._input_scale = None
        if spec.quant == "int8":
            quantize_detector(self.net, self.act_scales)
            first = getattr(self.net, "defs", ({},))[0]
            if first.get("type") == "convolutional":
                self._input_scale = self.act_scales.get("l0_conv")
        self.stats: Dict[str, Any] = {}

    def _preprocess(self, u8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> the network's input, rounded as the compiled JAX
        program rounds ``u8.astype(dtype) / 255``."""
        x = u8.float()
        inv255 = np.float32(1.0) / np.float32(255.0)
        if self._input_scale is not None:
            s = np.float32(self._input_scale)
            gain = np.float32(inv255 * (np.float32(1.0) / s))
            code = torch.clamp(torch.round(x * torch.tensor(gain)), -127, 127)
            return (code * torch.tensor(s)).to(self.dtype)
        return (x * torch.tensor(inv255)).to(self.dtype)

    @torch.inference_mode()
    def raw_maps(self, u8: torch.Tensor):
        """Device uint8 NHWC -> the network's raw NHWC head maps."""
        with tf32(self.spec.quant != "fp32"):
            with span("det:normalize"):
                x = self._preprocess(u8)
            with span("det:network"):
                return self.net(x)

    @torch.inference_mode()
    def decoded(self, u8: torch.Tensor) -> torch.Tensor:
        """Device uint8 NHWC -> the decoded rows NMS takes, (n, N, 5+nc);
        with ``spec.tta`` the three scales' rows pooled
        (``tta_pooled_pred``) from the square frame."""
        from rtdm_tpu_torch.ops.yolo import decode_all
        if not self.spec.tta:
            raw = self.raw_maps(u8)
            with tf32(False), span("det:decode"):
                return decode_all(raw, self.heads, tuple(u8.shape[1:3]))
        s = self.spec.img_size
        if tuple(u8.shape[1:3]) != (s, s):
            raise ValueError("rect batches are not supported with TTA (the "
                             "TTA pyramid is square)")

        def apply_pred(xi, si):
            with tf32(self.spec.quant != "fp32"), span("det:network"):
                raw = self.net(xi)
            with tf32(False), span("det:decode"):
                return decode_all(raw, self.heads, (si, si))
        with span("det:normalize"):
            inv255 = torch.tensor(np.float32(1.0) / np.float32(255.0))
            x = (u8.float() * inv255).to(self.dtype)
        with tf32(False):
            return tta_pooled_pred(apply_pred, x, s)

    def predictions(self, images_u8) -> np.ndarray:
        """uint8 NHWC frames (at most the batch) -> ``decoded`` on the host,
        for holding two runs' NMS decisions against each other
        (``eval/detection.py::candidates``)."""
        x, n = self._upload(images_u8)
        return self._gathered(self.decoded(x))[:n].float().cpu().numpy()

    def _gathered(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (this rank's alone without a mesh)."""
        return x if self.mesh is None else all_gather_along(x, self.mesh)

    @torch.inference_mode()
    def forward(self, u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device uint8 NHWC -> (det, count) on the device."""
        from rtdm_tpu_torch.ops.nms import batched_nms
        spec = self.spec
        pred = self.decoded(u8)
        with tf32(False):
            with span("det:nms"):
                return batched_nms(pred, spec.conf_thres, spec.iou_thres,
                                   spec.max_det, spec.top_k,
                                   multi_label=spec.multi_label,
                                   class_agnostic=spec.class_agnostic,
                                   method=spec.nms_method,
                                   classes=spec.classes, stats=self.stats)

    def _upload(self, images_u8) -> Tuple[torch.Tensor, int]:
        """n uint8 NHWC frames -> (one engine batch on the device, the
        frames first and zero frames after them; under a mesh this rank's
        rows of it; n)."""
        frames = torch.as_tensor(images_u8)
        n = frames.shape[0]
        b = self.batch_size
        if n > b:
            raise ValueError(f"batch {n} exceeds detector batch {b}")
        if frames.dtype != torch.uint8 or frames.dim() != 4 \
                or frames.shape[-1] != 3:
            raise ValueError(f"expected uint8 frames (n, h, w, 3), got "
                             f"{frames.dtype} {tuple(frames.shape)}")
        rows = (slice(0, b) if self.mesh is None
                else data_sharding(self.mesh).rows(b))
        with span("det:upload"):
            x = torch.zeros((rows.stop - rows.start,)
                            + tuple(frames.shape[1:]), dtype=torch.uint8,
                            device=self.device)
            mine = frames[rows.start:min(rows.stop, n)]
            with span("det:upload:wait"):
                x[:mine.shape[0]].copy_(mine)
        return x, n

    def submit(self, images_u8):
        """Upload and run a batch without copying the result back: returns
        (device det, device count, n); slice ``[:n]``."""
        x, n = self._upload(images_u8)
        det, count = self.forward(x)
        return self._gathered(det), self._gathered(count), n

    def warmup(self, shapes=None) -> float:
        """Run a zero batch at each (h, w) (default: the square) once;
        returns the seconds spent."""
        import time
        t0 = time.perf_counter()
        s = self.spec.img_size
        for h, w in (shapes or [(s, s)]):
            _, count, _ = self.submit(
                np.zeros((self.batch_size, h, w, 3), np.uint8))
            count.cpu()
        return time.perf_counter() - t0

    def __call__(self, images_u8) -> Tuple[np.ndarray, np.ndarray]:
        det, count, n = self.submit(images_u8)
        with span("det:download:wait"):
            det = det[:n].cpu()
        with span("det:download:wait"):
            count = count[:n].cpu()
        return det.numpy(), count.numpy()


def build_detector(model_path: str, weights: Optional[str] = None,
                   spec: Optional[DetectorSpec] = None, batch_size: int = 1,
                   num_classes: Optional[int] = None,
                   calib_images: Optional[np.ndarray] = None,
                   device="cuda") -> Detector:
    """A detector engine from a cfg/yaml and its weights (any format
    ``load_detection_model`` reads; None: the seeded init). For int8,
    ``calib_images`` (letterboxed uint8 NHWC) calibrate the activation
    scales with ``spec.calib_method`` on the fp32 model on ``device``."""
    spec = spec or DetectorSpec(cfg_name=os.path.basename(model_path))
    device = resolve_device(device)
    model, variables, heads = load_detection_model(
        model_path, weights, spec.img_size, num_classes)
    act_scales = None
    if spec.quant == "int8":
        if calib_images is None:
            raise ValueError("int8 detector engines need calib_images for "
                             "activation calibration")
        from rtdm_tpu_torch.quant.calibrate import calibrate_detector
        fp32 = _new_model(_family(model), _model_text(model),
                          getattr(model, "num_classes", None), device="meta")
        fp32.load_state_dict({k: v.to(device) for k, v in
                              torch_state_dict_from_variables(
                                  variables).items()},
                             strict=True, assign=True)
        act_scales = calibrate_detector(fp32.eval(), calib_images,
                                        method=spec.calib_method)
    det = Detector(model, variables, spec, batch_size, heads,
                   act_scales=act_scales, device=device)
    det._variables = variables
    det._model_source = model_path
    return det


def save_detector(det: Detector, directory: str, sealed: bool = False
                  ) -> str:
    """Write ``spec.json`` + ``model.txt`` + ``params.npz`` (+
    ``act_scales.npz``). ``sealed=True`` (int8 only) folds conv+BN
    (darknet) and stores every kernel as int8 codes + per-channel scales
    (``quant/int8.py::seal_kernel``); the fp32 masters are not kept."""
    from rtdm_tpu_torch.models.darknet import Darknet
    from rtdm_tpu_torch.quant.int8 import seal_kernel
    os.makedirs(directory, exist_ok=True)
    spec_d = dataclasses.asdict(det.spec)
    variables = det._variables
    model_text = _model_text(det.model)
    if _family(det.model) == "yolov5":
        spec_d["family"] = "yolov5"
        spec_d["num_classes"] = det.model.num_classes
    else:
        spec_d["family"] = "darknet"
    if sealed:
        if det.spec.quant != "int8":
            raise ValueError("sealed save is for int8 engines; other "
                             "precisions keep canonical fp32 masters")
        if (det.spec.fuse and isinstance(det.model, Darknet)
                and variables.get("batch_stats")):
            from rtdm_tpu_torch.ops.fuse import (fuse_darknet_variables,
                                                 strip_bn_from_cfg)
            variables = fuse_darknet_variables(variables, model_text)
            model_text = strip_bn_from_cfg(model_text)
        spec_d["sealed"] = True
    spec_d["batch_size"] = det.batch_size
    with open(os.path.join(directory, "spec.json"), "w") as f:
        json.dump(spec_d, f, indent=2)
    with open(os.path.join(directory, "model.txt"), "w") as f:
        f.write(model_text)
    if sealed:
        out = {}
        for key, val in flatten_tree(variables).items():
            if key.endswith("/kernel"):
                out[key + ".q"], out[key + ".s"] = seal_kernel(val)
            else:
                out[key] = val
        np.savez(os.path.join(directory, "params.npz"), **out)
    else:
        save_variables(os.path.join(directory, "params.npz"), variables)
    if det.act_scales:
        np.savez(os.path.join(directory, "act_scales.npz"),
                 **{k: np.float32(v) for k, v in det.act_scales.items()})
    return directory


def load_detector(directory: str, device=None, spec_overrides=None,
                  batch_size: Optional[int] = None, mesh=None) -> Detector:
    """Rebuild a saved engine on ``device`` (the card unless given; under
    ``mesh`` a data-parallel one on the mesh's). ``spec_overrides``
    replaces DetectorSpec fields (thresholds, classes, max_det, ...);
    ``batch_size`` replaces the stored batch."""
    with open(os.path.join(directory, "spec.json")) as f:
        raw = json.load(f)
    family = raw.pop("family", "darknet")
    num_classes = raw.pop("num_classes", None)
    stored_batch = raw.pop("batch_size", 1)
    batch_size = stored_batch if batch_size is None else int(batch_size)
    spec = DetectorSpec(**{k: v for k, v in raw.items()
                           if k in DetectorSpec.__dataclass_fields__})
    if spec_overrides:
        spec = dataclasses.replace(spec, **spec_overrides)
    with open(os.path.join(directory, "model.txt")) as f:
        model_text = f.read()
    model = _new_model(family, model_text, num_classes, device="meta")
    variables = load_variables(os.path.join(directory, "params.npz"))
    act_scales = None
    scales_path = os.path.join(directory, "act_scales.npz")
    if os.path.exists(scales_path):
        with np.load(scales_path) as z:
            act_scales = {k: float(z[k]) for k in z.files}
    det = Detector(model, variables, spec, batch_size, model_heads(model),
                   act_scales=act_scales, device=device, mesh=mesh)
    det._variables = variables
    return det
