"""ODDER detection data: darknet-style lists, YOLO label txts, letterbox.

Counterpart of ``rtdm_tpu/data/odder.py``: ``.data`` files and v5 data
yamls (``load_data_spec``, read by ``utils/yaml_io.py``), image lists,
label files with the reference's checks, the letterbox
(``letterbox_image``, PIL bilinear, gray 114 border), rect buckets
(``minimal_rect_shape``, ``rect_batch_plan``), the ``DetectionDataset``
eval and training samples (mosaic, mosaic9, mixup, the affine warp, HSV,
cutout and the flip from ``data/yolo_augment.py``, each draw from the
sample's generator in the reference's order), ``image_weights`` and the
threaded ``DetectionBatchLoader`` (its epoch order from
``default_rng(seed + epoch)``, shuffled or drawn by image weight). A
``.jpg``/``.jpeg`` frame is decoded by ``data/native_io.py`` (libjpeg with
DCT prescaling, the cv2-matching resize and the letterbox in one native
call) where it is built and the image cache is off, as in the JAX package;
other frames, cached ones and a failed native decode take PIL.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

PAD_COLOR = 114


def parse_data_cfg(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = (s.strip() for s in line.split("=", 1))
            out[k] = v
    return out


IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")


def collect_image_paths(source, base_dir) -> List[str]:
    """Resolve an image-list source into absolute image paths.

    Mirrors the reference's three v5 data-yaml spellings
    (yolov5/data/aider.yaml:1 comment; consumed by
    yolov5/utils/datasets.py:368-384): a directory of images, a txt file
    with one path per line, or a list of either. Darknet .data files only
    use the txt-file form (yolov3/utils/parse_config.py:55-71).
    """
    base_dir = Path(base_dir)
    if isinstance(source, (list, tuple)):
        out: List[str] = []
        for s in source:
            out.extend(collect_image_paths(s, base_dir))
        return out
    p = Path(source)
    if not p.is_absolute():
        p = base_dir / p
    if p.is_dir():
        # recursive, like the v5 loader's `glob(p/'**'/'*.*', recursive)`
        # (datasets.py:368-384) — images may live in per-scene subdirs
        return sorted(str(f) for f in p.rglob("*")
                      if f.suffix.lower() in IMAGE_SUFFIXES)
    with open(p) as f:
        rels = [ln.strip() for ln in f if ln.strip()]
    return [str(Path(r) if os.path.isabs(r) else base_dir / r)
            for r in rels]


def load_data_spec(path: str) -> Dict[str, object]:
    """Unified dataset-config loader: darknet `.data` OR yolov5 data yaml.

    Returns {classes:int, train, valid, test(optional), names:List[str]|None,
    base:str}. `train`/`valid`/`test` stay in source form (dir/txt/list) —
    pass them with `base` to collect_image_paths / DetectionDataset.

    - .data (yolov3/utils/parse_config.py:55-71): classes/train/valid/names
      keys; paths relative to the directory containing the 'data' dir.
    - .yaml (yolov5/data/aider.yaml, consumed by train.py:71-77 +
      general.check_dataset): train/val[/test] sources, nc, inline names;
      same base-dir resolution (the reference resolves against the yolov5
      cwd, which is the parent of the data/ dir holding the yaml).
    """
    path = os.path.abspath(path)
    base = os.path.dirname(os.path.dirname(path))
    if path.endswith((".yaml", ".yml")):
        from rtdm_tpu_torch.utils import yaml_io
        d = yaml_io.load(path) or {}
        names = d.get("names")
        nc = int(d.get("nc", len(names) if names else 2))
        spec: Dict[str, object] = {"classes": nc, "names": names,
                                   "base": base}
        if "train" in d:
            spec["train"] = d["train"]
        if "val" in d or "valid" in d:
            spec["valid"] = d.get("val", d.get("valid"))
        if "test" in d:
            spec["test"] = d["test"]
        return spec
    dcfg = parse_data_cfg(path)
    names = None
    names_path = dcfg.get("names", "")
    if names_path:
        if not os.path.isabs(names_path):
            names_path = os.path.join(base, names_path)
        if os.path.exists(names_path):
            names = load_names(names_path)
    spec = {"classes": int(dcfg.get("classes", len(names) if names else 2)),
            "names": names, "base": base}
    for k in ("train", "valid", "test"):
        if k in dcfg:
            spec[k] = dcfg[k]
    return spec


def load_names(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


# the reference's class-name fallbacks (tensorrt_inference/utils/
# yolo_classes.py:6-9 AIDER list, :12-92 COCO list, get_cls_dict's
# "CLS{i}" default for any other class count)
AIDER_NAMES = ["person", "vehicle"]
COCO_NAMES = (
    "person bicycle car motorbike aeroplane bus train truck boat "
    "traffic_light fire_hydrant stop_sign parking_meter bench bird cat "
    "dog horse sheep cow elephant bear zebra giraffe backpack umbrella "
    "handbag tie suitcase frisbee skis snowboard sports_ball kite "
    "baseball_bat baseball_glove skateboard surfboard tennis_racket "
    "bottle wine_glass cup fork knife spoon bowl banana apple sandwich "
    "orange broccoli carrot hot_dog pizza donut cake chair sofa "
    "pottedplant bed diningtable toilet tvmonitor laptop mouse remote "
    "keyboard cell_phone microwave oven toaster sink refrigerator book "
    "clock vase scissors teddy_bear hair_drier toothbrush").split()


def default_names(num_classes: int) -> List[str]:
    """Class names for a model with no .names file: the AIDER pair for
    nc=2, COCO for nc=80, generic CLS{i} otherwise (get_cls_dict)."""
    if num_classes == 2:
        return list(AIDER_NAMES)
    if num_classes == 80:
        return list(COCO_NAMES)
    return [f"CLS{i}" for i in range(num_classes)]


def label_path_for(image_path: str) -> str:
    sep = os.sep
    p = image_path.replace(f"{sep}images{sep}", f"{sep}labels{sep}")
    return str(Path(p).with_suffix(".txt"))


def letterbox_image(img: np.ndarray, size, gain_cap: Optional[float] = None
                    ) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """HWC uint8 -> (H,W,3) uint8, returns (out, gain, (pad_w, pad_h)).

    `size` is an int (square target) or an (h, w) tuple — the rect-batch
    target shape (datasets.py:430-431 letterbox(img, batch_shape,
    auto=False)). `gain_cap` bounds the resize factor: rect buckets can
    exceed the nominal image size (v5's +pad term, stride rounding), and
    the reference renders that surplus as BORDER, not extra resolution
    (load_image scales the long side to img_size, then letterbox runs
    with scaleup=False — datasets.py:430-431,548)."""
    from PIL import Image

    th, tw = ((int(size), int(size)) if isinstance(size, (int, np.integer))
              else (int(size[0]), int(size[1])))
    h, w = img.shape[:2]
    gain = min(th / h, tw / w)
    if gain_cap is not None:
        gain = min(gain, gain_cap)
    nw, nh = int(round(w * gain)), int(round(h * gain))
    resized = np.asarray(
        Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.uint8)
    out = np.full((th, tw, 3), PAD_COLOR, np.uint8)
    pad_w, pad_h = (tw - nw) // 2, (th - nh) // 2
    out[pad_h:pad_h + nh, pad_w:pad_w + nw] = resized
    return out, gain, (float(pad_w), float(pad_h))


def minimal_rect_shape(h: int, w: int, img_size: int, stride: int = 32
                       ) -> Tuple[int, int]:
    """Minimal stride-multiple letterbox target for one frame — the
    reference's letterbox auto=True mode (datasets.py:599-630: long side
    scaled to img_size, short-side pad reduced modulo stride). Feeding
    `letterbox_image` this target reproduces that geometry exactly (the
    long axis binds the gain; the short axis only gains pad).

    Integer arithmetic throughout: ceil(dim * gain) computed as exact
    integer ceil-div of dim*img_size by max(h, w). Float rounding here
    (e.g. 1050x525 @ 320) could land epsilon above img_size and bump the
    long-side target a whole stride, silently upscaling past the nominal
    network scale on every frame of that shape."""
    m = max(int(h), int(w), 1)
    th_px = -(-int(h) * int(img_size) // m)
    tw_px = -(-int(w) * int(img_size) // m)
    th = -(-th_px // stride) * stride
    tw = -(-tw_px // stride) * stride
    return int(th), int(tw)


def rect_batch_plan(wh: np.ndarray, img_size: int, batch_size: int,
                    stride: int = 32, pad: float = 0.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Aspect-ratio-sorted rect batch shape plan.

    Transcribed semantics of yolov3/utils/datasets.py:285-316 (v5 adds the
    `+ pad` term, yolov5/utils/datasets.py:412-416 with test-time pad=0.5):
    sort by h/w, then per batch pick [maxi, 1] (all-wide) or [1, 1/mini]
    (all-tall) height/width fractions, ceil to stride multiples.

    `wh`: (n, 2) float array of original (width, height) per image.
    Returns (order, batch_shapes_px) with batch_shapes_px[b] = (h, w) ints.
    """
    wh = np.asarray(wh, np.float64)
    ar = wh[:, 1] / wh[:, 0]  # h/w
    order = np.argsort(ar, kind="stable")
    n = len(order)
    nb = (n + batch_size - 1) // batch_size
    shapes = np.ones((nb, 2), np.float64)  # (h_frac, w_frac)
    for b in range(nb):
        ari = ar[order[b * batch_size:(b + 1) * batch_size]]
        mini, maxi = ari.min(), ari.max()
        if maxi < 1:        # all wide: shrink height
            shapes[b] = (maxi, 1.0)
        elif mini > 1:      # all tall: shrink width
            shapes[b] = (1.0, 1.0 / mini)
    bs_px = (np.ceil(shapes * img_size / stride + pad)
             .astype(np.int64) * stride)
    return order, bs_px


class DetectionDataset:
    """Fixed-shape detection sample producer."""

    def __init__(self, list_file: str, img_size: int = 416,
                 max_labels: int = 100, base_dir: Optional[str] = None,
                 train: bool = False,
                 aug_hyp: Optional[Dict[str, float]] = None,
                 seed: int = 0, num_classes: Optional[int] = None,
                 single_cls: bool = False, cache_images: bool = False,
                 rect: bool = False, batch_size: int = 8,
                 stride: int = 32, rect_pad: float = 0.0,
                 eval_scaleup: bool = False):
        self.num_classes = num_classes
        self.single_cls = single_cls
        self.cache_images = cache_images
        self.train = train
        # Family-gated eval geometry: the v3 reference only ever scales
        # DOWN at eval (datasets.py:517 `r < 1 or (self.augment and
        # r != 1)` + letterbox scaleup=False), but v5's load_image resizes
        # whenever r != 1 (yolov5/utils/datasets.py:645) — v5 DOES upscale
        # images smaller than img_size at eval. eval_scaleup=True keeps
        # the uncapped img_size/max(h,w) fit at eval (v5 families).
        self.eval_scaleup = bool(eval_scaleup)
        self.aug_hyp = aug_hyp or {}
        self._rng = np.random.default_rng(seed)
        if isinstance(list_file, (str, os.PathLike)):
            # default base = two levels above the list (the darknet layout
            # data/custom/test-min.txt -> data/..); shallower paths fall
            # back to cwd instead of raising IndexError
            parents = Path(str(list_file)).parents
            self.base_dir = (Path(base_dir) if base_dir
                             else parents[2] if len(parents) > 2
                             else Path.cwd())
        else:  # list-of-sources spelling needs an explicit base
            self.base_dir = Path(base_dir) if base_dir else Path.cwd()
        self.image_paths = collect_image_paths(list_file, self.base_dir)
        self._list_file = (list_file
                           if isinstance(list_file, (str, os.PathLike))
                           else None)
        self.img_size = int(img_size)
        self.max_labels = int(max_labels)
        self.stats = {"found": 0, "missing": 0, "empty": 0, "corrupt": 0,
                      "duplicate_rows": 0}
        self.labels = [self._load_label(p) for p in self.image_paths]
        # --cache-images (yolov3/utils/datasets.py:383-391): decoded
        # original-size frames held in RAM, filled on first touch; and the
        # mosaic tiles, resized, keyed by (idx, long side)
        self._img_cache: List[Optional[np.ndarray]] = (
            [None] * len(self.image_paths) if cache_images else [])
        self._scaled_cache: Dict[Tuple[int, int], np.ndarray] = {}
        # Rectangular batches (datasets.py:285-316): images sorted by
        # aspect ratio; each batch letterboxed to one stride-multiple
        # (h, w) bucket instead of the full square: the bucket set is small
        # (ARs cluster), less padded compute per batch.
        self.rect = bool(rect)
        self.rect_order: Optional[np.ndarray] = None
        self.rect_shapes: Optional[List[Tuple[int, int]]] = None
        if self.rect:
            self._build_rect_plan(int(batch_size), int(stride),
                                  float(rect_pad))

    def _build_rect_plan(self, batch_size: int, stride: int,
                         pad: float) -> None:
        n_imgs = len(self.image_paths)
        wh = self._read_image_shapes(n_imgs)
        order, bs_px = rect_batch_plan(wh, self.img_size, batch_size,
                                       stride, pad)
        n = len(order)
        self.rect_order = order
        self.rect_batch_size = batch_size
        self.rect_wh = wh  # header (w, h) per image; drives the gain cap
        self.rect_shapes = [None] * n
        for pos, idx in enumerate(order):
            h, w = bs_px[pos // batch_size]
            self.rect_shapes[int(idx)] = (int(h), int(w))

    def _read_image_shapes(self, n_imgs: int) -> np.ndarray:
        """(w, h) per image from headers, cached next to the list file as
        `<list>.shapes` (the reference's shapefile, datasets.py:287-295);
        read-only dataset dirs silently skip the cache write, and dirs
        under RTDM_PROTECTED_DATA_ROOT are never written even when the
        filesystem would allow it."""
        sp = None
        writable = False
        lf = getattr(self, "_list_file", None)
        if isinstance(lf, (str, os.PathLike)) and str(lf).endswith(".txt"):
            # resolve against base_dir exactly like collect_image_paths
            # does for the list itself — a raw relative string (e.g.
            # 'data/train.txt' from a .data file) must not drop a .shapes
            # cache into the cwd where an unrelated dataset could adopt it
            lfp = Path(str(lf))
            if not lfp.is_absolute():
                lfp = self.base_dir / lfp
            sp = str(lfp).replace(".txt", ".shapes")
            protected = os.environ.get("RTDM_PROTECTED_DATA_ROOT", "")
            writable = not (protected and os.path.abspath(sp).startswith(
                os.path.abspath(protected) + os.sep))
        if sp and os.path.exists(sp):
            try:
                cached = np.loadtxt(sp, ndmin=2, dtype=np.float64)
                if len(cached) == n_imgs:
                    return cached
            except Exception:
                pass  # stale/corrupt shapefile: recompute below
        from PIL import Image

        wh = np.ones((n_imgs, 2), np.float64)
        for i, p in enumerate(self.image_paths):
            try:  # header-only size read
                with Image.open(p) as im:
                    wh[i] = im.size
            except Exception:
                wh[i] = (self.img_size, self.img_size)
        if sp and writable:
            try:
                np.savetxt(sp, wh, fmt="%g")
            except OSError:
                pass  # read-only dataset dir (e.g. the bundled fixtures)
        return wh

    def __len__(self) -> int:
        return len(self.image_paths)

    def _load_label(self, image_path: str) -> np.ndarray:
        lp = label_path_for(image_path)
        if not os.path.exists(lp):
            self.stats["missing"] += 1
            return np.zeros((0, 5), np.float32)
        try:
            rows = np.loadtxt(lp, ndmin=2, dtype=np.float32)
        except Exception as e:
            logger.warning("corrupt label %s: %s", lp, e)
            self.stats["corrupt"] += 1
            return np.zeros((0, 5), np.float32)
        if rows.size == 0:
            self.stats["empty"] += 1
            return np.zeros((0, 5), np.float32)
        # explicit raises (not asserts): these guards are load-bearing and
        # must survive `python -O`
        if rows.shape[1] != 5:
            raise ValueError(f"{lp}: expected 5 columns")
        if not ((rows[:, 1:] <= 1.0).all() and (rows[:, 1:] >= 0.0).all()):
            raise ValueError(f"{lp}: coords must be normalized to [0,1]")
        if self.num_classes is not None:
            # the reference catches this inside build_targets
            # (yolov3/utils/utils.py:480-483, "possible class labels are
            # 0-%g"); on TPU the loss is jitted so the guard must run at
            # LOAD time — a bad class id would silently scatter into
            # nothing (or the wrong row) on device
            if not ((rows[:, 0] < self.num_classes).all()
                    and (rows[:, 0] >= 0).all()):
                raise ValueError(
                    f"{lp}: class ids must be in [0, {self.num_classes}); "
                    f"got {sorted(set(rows[:, 0].astype(int).tolist()))}")
        if self.single_cls:
            # --single-cls: collapse every class to 0 (the reference maps
            # at load time, yolov5/utils/datasets.py:410); zero BEFORE
            # dedup so rows differing only by class collapse too
            rows = rows.copy()
            rows[:, 0] = 0.0
        dedup = np.unique(rows, axis=0)
        if len(dedup) < len(rows):
            self.stats["duplicate_rows"] += len(rows) - len(dedup)
        self.stats["found"] += 1
        return dedup

    def image_weights(self, class_weights: np.ndarray) -> np.ndarray:
        """Per-image sampling weights from per-class weights
        (labels_to_image_weights, yolov3/utils/utils.py; train.py:236-239)."""
        nc = len(class_weights)
        w = np.zeros(len(self), np.float64)
        for i, lab in enumerate(self.labels):
            counts = np.bincount(lab[:, 0].astype(int), minlength=nc) \
                if len(lab) else np.zeros(nc)
            w[i] = float((counts * class_weights).sum())
        if w.sum() <= 0:
            return np.ones(len(self)) / max(len(self), 1)
        return w / w.sum()

    def load(self, idx: int,
             rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        """Sample ``idx``: the training sample (drawn from ``rng``, else the
        dataset's own generator) or the eval sample, which draws nothing."""
        if self.train:
            return self._load_train(idx, rng or self._rng)
        return self._load_eval(idx)

    def _load_train(self, idx: int,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Mosaic + affine + HSV + hflip training sample (datasets.py
        __getitem__ train path); labels come back as class + pixel cxcywh.
        Rect mode has no mosaic (datasets.py:283): every sample letterboxes
        to its bucket, then takes the other augmentations."""
        from rtdm_tpu_torch.data.yolo_augment import (
            DEFAULT_AUG_HYP, augment_hsv, cutout, load_mosaic, load_mosaic9,
            mixup, random_affine)

        hyp = {**DEFAULT_AUG_HYP, **self.aug_hyp}
        if not self.rect and rng.random() < hyp["mosaic"]:
            if rng.random() < hyp.get("mosaic9", 0.0):
                img, lab_xyxy = load_mosaic9(self, idx, rng, hyp)
            else:
                img, lab_xyxy = load_mosaic(self, idx, rng, hyp)
            if rng.random() < hyp.get("mixup", 0.0):
                idx2 = int(rng.integers(0, len(self)))
                img2, lab2 = load_mosaic(self, idx2, rng, hyp)
                img, lab_xyxy = mixup(img, lab_xyxy, img2, lab2, rng)
        else:
            sample = self._load_eval(idx)
            img = sample["image"]
            n = int(sample["num_labels"])
            cxcywh = sample["labels"][:n]
            lab_xyxy = np.zeros((n, 5), np.float32)
            lab_xyxy[:, 0] = cxcywh[:, 0]
            lab_xyxy[:, 1] = cxcywh[:, 1] - cxcywh[:, 3] / 2
            lab_xyxy[:, 2] = cxcywh[:, 2] - cxcywh[:, 4] / 2
            lab_xyxy[:, 3] = cxcywh[:, 1] + cxcywh[:, 3] / 2
            lab_xyxy[:, 4] = cxcywh[:, 2] + cxcywh[:, 4] / 2
            # the reference warps the non-mosaic sample too, with the
            # degenerate-box filter (datasets.py:451-458)
            img, new_boxes, new_cls = random_affine(
                img, lab_xyxy[:, 1:5], lab_xyxy[:, 0],
                hyp["degrees"], hyp["translate"], hyp["scale"],
                hyp["shear"], rng)
            lab_xyxy = (np.concatenate(
                [new_cls[:, None], new_boxes], axis=1).astype(np.float32)
                if len(new_boxes) else np.zeros((0, 5), np.float32))
        img = augment_hsv(img, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"], rng)
        if rng.random() < hyp.get("cutout", 0.0):
            img, lab_xyxy = cutout(img, lab_xyxy, rng)
        if rng.random() < hyp["fliplr"]:
            img = img[:, ::-1].copy()
            if len(lab_xyxy):
                w = img.shape[1]
                x1 = lab_xyxy[:, 1].copy()
                lab_xyxy[:, 1] = w - lab_xyxy[:, 3]
                lab_xyxy[:, 3] = w - x1

        n = min(len(lab_xyxy), self.max_labels)
        labels = np.zeros((self.max_labels, 5), np.float32)
        if n:
            sel = lab_xyxy[:n]
            labels[:n, 0] = sel[:, 0]
            labels[:n, 1] = (sel[:, 1] + sel[:, 3]) / 2
            labels[:n, 2] = (sel[:, 2] + sel[:, 4]) / 2
            labels[:n, 3] = sel[:, 3] - sel[:, 1]
            labels[:n, 4] = sel[:, 4] - sel[:, 2]
        return {"image": np.ascontiguousarray(img), "labels": labels,
                "num_labels": np.int32(n),
                "orig_hw": np.array(img.shape[:2], np.int32),
                # train labels are in the augmented image's pixels already
                "letterbox": np.array([1.0, 0.0, 0.0], np.float32),
                "index": np.int32(idx)}

    def load_raw(self, idx: int) -> np.ndarray:
        """Decoded original-size RGB uint8 frame, RAM-cached with
        ``cache_images``. Corrupt/missing files fall back to a black
        img_size square (aider.py:49-56 blank-frame convention)."""
        if self.cache_images and self._img_cache[idx] is not None:
            return self._img_cache[idx]
        from PIL import Image
        try:
            with open(self.image_paths[idx], "rb") as f:
                img = np.asarray(Image.open(f).convert("RGB"), np.uint8)
        except Exception as e:
            logger.warning("failed to load %s: %s", self.image_paths[idx], e)
            img = np.zeros((self.img_size, self.img_size, 3), np.uint8)
        if self.cache_images:
            self._img_cache[idx] = img
        return img

    def load_scaled(self, idx: int, size: int) -> np.ndarray:
        """The frame with its long side resized to ``size``, aspect kept,
        no padding (the mosaic tile, load_image semantics,
        yolov3/utils/datasets.py:393-404). With the cache off, a ``.jpg``
        takes the native decode (at about the target resolution, then the
        cv2-matching resize), cropped out of its letterboxed square; cached
        and other frames take ``load_raw`` and PIL bilinear, cached with
        ``cache_images``."""
        path = self.image_paths[idx]
        if self.cache_images:
            hit = self._scaled_cache.get((idx, int(size)))
            if hit is not None:
                return hit
        elif path.lower().endswith((".jpg", ".jpeg")):
            from rtdm_tpu_torch.data.native_io import decode_jpeg_letterbox
            try:
                with open(path, "rb") as f:
                    res = decode_jpeg_letterbox(f.read(), size)
            except OSError as e:
                logger.warning("native decode failed for %s: %s", path, e)
                res = None
            if res is not None:
                sq, gain, (pad_w, pad_h), (h0, w0) = res
                # the pads are whole pixels ((size - nw) // 2); the resized
                # shape is rtdm_io.cpp's, in its fp32 arithmetic (float64
                # could round a .5 boundary the other way)
                g32 = np.float32(gain)
                nh = max(int(np.float32(h0) * g32 + np.float32(0.5)), 1)
                nw = max(int(np.float32(w0) * g32 + np.float32(0.5)), 1)
                y0, x0 = int(pad_h), int(pad_w)
                return np.ascontiguousarray(sq[y0:y0 + nh, x0:x0 + nw])
        img = self.load_raw(idx)
        h0, w0 = img.shape[:2]
        gain = size / max(h0, w0)
        if gain != 1:
            from PIL import Image
            img = np.asarray(Image.fromarray(img).resize(
                (max(int(w0 * gain), 1), max(int(h0 * gain), 1)),
                Image.BILINEAR), np.uint8)
        if self.cache_images:
            self._scaled_cache[(idx, int(size))] = img
        return img

    def _load_eval(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.image_paths[idx]
        # Resize-factor caps reproducing the reference's two-stage geometry
        # (load_image then letterbox): TRAIN scales the long side to
        # img_size in both directions (datasets.py:517 `r < 1 or
        # (self.augment and r != 1)`, letterbox scaleup=self.augment
        # :431); v3 EVAL only ever scales DOWN — images smaller than
        # img_size keep their native resolution and gain only border
        # (r < 1 branch + scaleup=False), hence the extra min(cap, 1).
        # v5 eval (eval_scaleup=True) keeps the uncapped fit — see
        # __init__ for the yolov5/utils/datasets.py:645 citation.
        native = (not self.cache_images   # a cached raw frame is cheaper
                  and path.lower().endswith((".jpg", ".jpeg")))
        if self.rect:
            # rect bucket target (datasets.py:430: shape =
            # batch_shapes[batch[index]]). The gain cap
            # keeps the reference's geometry — without it a pad-inflated
            # bucket (v5's +0.5, stride rounding) would upscale instead
            # of rendering border. The native path takes the cap from the
            # header size the buckets were planned from.
            th, tw = self.rect_shapes[idx]
            if native:
                w_hdr, h_hdr = self.rect_wh[idx]
                cap = self.img_size / max(h_hdr, w_hdr, 1.0)
                if not self.train and not self.eval_scaleup:
                    cap = min(cap, 1.0)
                res = _native_decode(path, th, tw, cap)
                if res is not None:
                    out, gain, (pad_w, pad_h), (orig_h, orig_w) = res
                    return self._pack_eval(out, idx, orig_h, orig_w, gain,
                                           pad_w, pad_h)
            img = self.load_raw(idx)
            orig_h, orig_w = img.shape[:2]
            cap = self.img_size / max(orig_h, orig_w, 1)
            if not self.train and not self.eval_scaleup:
                cap = min(cap, 1.0)
            out, gain, (pad_w, pad_h) = letterbox_image(img, (th, tw),
                                                        gain_cap=cap)
            return self._pack_eval(out, idx, orig_h, orig_w, gain,
                                   pad_w, pad_h)
        if native:
            # v3 eval caps the gain at 1 (never upscale: the square fit is
            # img_size / max(h, w), so the cap binds only on images smaller
            # than img_size); train and v5 eval keep the uncapped fit
            uncapped = self.train or self.eval_scaleup
            res = _native_decode(path, self.img_size, self.img_size,
                                 0.0 if uncapped else 1.0)
            if res is not None:
                out, gain, (pad_w, pad_h), (orig_h, orig_w) = res
                return self._pack_eval(out, idx, orig_h, orig_w, gain,
                                       pad_w, pad_h)
        img = self.load_raw(idx)
        orig_h, orig_w = img.shape[:2]
        out, gain, (pad_w, pad_h) = letterbox_image(
            img, self.img_size,
            gain_cap=None if (self.train or self.eval_scaleup) else 1.0)
        return self._pack_eval(out, idx, orig_h, orig_w, gain, pad_w, pad_h)

    def _pack_eval(self, out: np.ndarray, idx: int, orig_h: int,
                   orig_w: int, gain: float, pad_w: float,
                   pad_h: float) -> Dict[str, np.ndarray]:
        raw = self.labels[idx]
        n = min(len(raw), self.max_labels)
        labels = np.zeros((self.max_labels, 5), np.float32)
        if n:
            lab = raw[:n].copy()
            # normalized xywh (original frame) -> letterboxed pixel xywh
            lab[:, 1] = lab[:, 1] * orig_w * gain + pad_w
            lab[:, 2] = lab[:, 2] * orig_h * gain + pad_h
            lab[:, 3] = lab[:, 3] * orig_w * gain
            lab[:, 4] = lab[:, 4] * orig_h * gain
            labels[:n] = lab
        # the letterbox actually applied, for exact back-mapping of saved
        # detections (the reference threads shapes/ratio_pad from the
        # dataset to scale_coords for the same reason, yolov5/test.py:137,
        # datasets.py:441-443) — a recomputed gain diverges whenever the
        # gain cap binds (no-upscale eval, pad-inflated rect buckets)
        return {"image": out, "labels": labels,
                "num_labels": np.int32(n),
                "orig_hw": np.array([orig_h, orig_w], np.int32),
                "letterbox": np.array([gain, pad_w, pad_h], np.float32),
                "index": np.int32(idx)}


def _native_decode(path: str, out_h: int, out_w: int, gain_cap: float):
    """``native_io.decode_jpeg_letterbox_rect`` of the file at ``path`` with
    the gray border; None where native IO, the file or its decode fails."""
    from rtdm_tpu_torch.data.native_io import decode_jpeg_letterbox_rect
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_jpeg_letterbox_rect(data, out_h, out_w, PAD_COLOR,
                                      gain_cap=gain_cap)


class DetectionBatchLoader:
    """Threaded fixed-shape batch iterator; eval batches zero-padded with a
    valid count (same convention as data/aider.py)."""

    def __init__(self, dataset: DetectionDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 8, seed: int = 0,
                 image_weights: Optional[np.ndarray] = None):
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, int(num_workers))
        self.seed = seed
        self.epoch = 0
        # optional weighted resampling (with replacement) per epoch
        self.image_weights = image_weights

    def __len__(self) -> int:
        n = len(self.ds)
        return (n // self.batch_size if self.drop_last
                else (n + self.batch_size - 1) // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
        n = len(self.ds)
        epoch_rng = np.random.default_rng(self.seed + self.epoch)
        if getattr(self.ds, "rect", False):
            # rect mode fixes the AR-sorted order so every batch shares
            # one bucket shape (the reference disables shuffling and
            # image-weights under rect, datasets.py:278, train.py rect
            # path); shapes were planned for a specific batch size
            if self.image_weights is not None or self.shuffle:
                raise ValueError("rect batches are incompatible with "
                                 "shuffle/image-weight resampling "
                                 "(datasets.py:278)")
            if self.batch_size != self.ds.rect_batch_size:
                raise ValueError(
                    f"rect plan was built for batch {self.ds.rect_batch_size}"
                    f", loader uses {self.batch_size}")
            order = self.ds.rect_order.copy()
        elif self.image_weights is not None:
            order = epoch_rng.choice(n, size=n, replace=True,
                                     p=self.image_weights)
        else:
            order = np.arange(n)
            if self.shuffle:
                epoch_rng.shuffle(order)
        if self.drop_last and 0 < n < self.batch_size:
            # tiny dataset: cycle indices so training still sees one full
            # fixed-shape batch instead of silently yielding nothing
            order = np.resize(order, self.batch_size)
            n = self.batch_size
        self.epoch += 1
        bs = self.batch_size
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, n, bs):
                idxs = order[start:start + bs]
                if len(idxs) < bs and self.drop_last:
                    break
                rngs = [np.random.default_rng(epoch_rng.integers(2 ** 63))
                        for _ in idxs]
                samples = list(pool.map(lambda t: self.ds.load(*t),
                                        zip(idxs, rngs)))
                batch = {k: np.stack([s[k] for s in samples])
                         for k in samples[0]}
                if len(idxs) < bs:  # pad to fixed shape
                    pad = bs - len(idxs)
                    for k, v in batch.items():
                        batch[k] = np.concatenate(
                            [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                yield batch, len(idxs)
