"""AIDER dataset, batch loader and input normalisation.

Counterpart of ``rtdm_tpu/data/aider.py``: CSV rows are
(relative_path, label), labels 0..4 = collapsed_building, fire,
flooded_areas, normal, traffic_incident. ``AiderDataset`` loads an image
with PIL and emits uint8 HWC: the eval transform (bilinear resize of the
short side to int(1.14*size), center crop), or with ``train=True`` a
random train transform drawn from a numpy ``Generator``, in the
albumentations style (random resized crop 0.8-1.0, a flip or rot90, a
blur, a colour and a distortion one-of; cv2 for the heavy ones) or the
torchvision style (random resized crop 0.08-1.0, flips, colour jitter,
grayscale), numpy and cv2 copies of the JAX package's, equal to them bit
for bit. A corrupt or missing image becomes a black frame, counted in
``load_errors``. ``BatchLoader`` decodes on a thread pool and yields
fixed-shape uint8 NHWC batches with the count of valid rows: the order
shuffled from ``seed + epoch`` if asked, each sample's transform from its
own child generator, the last batch zero-padded or dropped.
``normalize_batch`` does /255 and the ImageNet normalize on the device.
"""

from __future__ import annotations

import csv
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

CLASS_NAMES = ("collapsed_building", "fire", "flooded_areas", "normal",
               "traffic_incident")


def _load_image(path: str):
    from PIL import Image, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    try:
        with open(path, "rb") as f:
            return Image.open(f).convert("RGB")
    except Exception as e:  # corrupt/missing -> caller falls back to black
        logger.warning("failed to load %s: %s", path, e)
        return None


def _resize(img, size_wh, resample=None):
    from PIL import Image
    return img.resize(size_wh, resample or Image.BILINEAR)


class AiderDataset:
    """Fixed-shape uint8 sample producer for the AIDER CSV splits."""

    def __init__(self, csv_file, root_dir, image_size: int = 140,
                 train: bool = False, seed: int = 42,
                 aug_style: str = "albumentations"):
        # aug_style: 'albumentations' (the reference default train augs,
        # aider.py:282-307) or 'torchvision' (the --no-albumentations
        # branch, aider.py:392-409: RandomResizedCrop + flips +
        # ColorJitter(0.4,0.4,0.4,0.1) p=0.8 + RandomGrayscale p=0.2)
        csv_file = Path(csv_file)
        if not csv_file.exists():
            raise FileNotFoundError(str(csv_file))
        self.root_dir = Path(root_dir)
        self.image_size = int(image_size)
        self.train = train
        self.samples: List[Tuple[str, int]] = []
        with open(csv_file, newline="") as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    self.samples.append(
                        (str(self.root_dir / row[0]), int(row[1])))
        self.rng = np.random.default_rng(seed)
        self.load_errors = 0
        if aug_style not in ("albumentations", "torchvision"):
            raise ValueError(f"unknown aug_style {aug_style!r}")
        self.aug_style = aug_style

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def labels(self) -> np.ndarray:
        return np.array([lbl for _, lbl in self.samples], np.int32)

    def class_weights(self) -> np.ndarray:
        from rtdm_tpu_torch.train.losses import \
            inverse_frequency_class_weights
        return inverse_frequency_class_weights(self.labels,
                                               len(CLASS_NAMES))

    # ------------------------------------------------------------------
    def load(self, idx: int, rng: Optional[np.random.Generator] = None
             ) -> Tuple[np.ndarray, int]:
        path, label = self.samples[idx]
        img = _load_image(path)
        s = self.image_size
        if img is None:
            self.load_errors += 1
            return np.zeros((s, s, 3), np.uint8), label
        if self.train:
            tf = (self._train_transform_tv
                  if self.aug_style == "torchvision"
                  else self._train_transform)
            arr = tf(img, rng or self.rng)
        else:
            arr = self._eval_transform(img)
        return arr, label

    def _eval_transform(self, img) -> np.ndarray:
        """Resize short side to int(1.14*s), center-crop s — torchvision
        parity (reference aider.py:413-419)."""
        s = self.image_size
        w, h = img.size
        target = int(s * 1.14)
        if w <= h:
            nw, nh = target, max(int(round(h * target / w)), target)
        else:
            nh, nw = target, max(int(round(w * target / h)), target)
        img = _resize(img, (nw, nh))
        left, top = (nw - s) // 2, (nh - s) // 2
        img = img.crop((left, top, left + s, top + s))
        return np.asarray(img, np.uint8)

    def _random_resized_crop(self, img, rng, lo: float, hi: float):
        """RandomResizedCrop(scale=(lo,hi), ratio=(3/4,4/3)) -> (s,s)
        uint8; falls back to a plain resize when 10 draws don't fit."""
        s = self.image_size
        w, h = img.size
        area = w * h
        for _ in range(10):
            target_area = area * rng.uniform(lo, hi)
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if cw <= w and ch <= h:
                left = rng.integers(0, w - cw + 1)
                top = rng.integers(0, h - ch + 1)
                img = img.crop((left, top, left + cw, top + ch))
                break
        return np.asarray(_resize(img, (s, s)), np.uint8)

    def _train_transform_tv(self, img, rng: np.random.Generator
                            ) -> np.ndarray:
        """The --no-albumentations torchvision branch (reference
        aider.py:392-409): RandomResizedCrop (torchvision default scale
        0.08-1.0) + RandomHorizontalFlip + RandomVerticalFlip +
        ColorJitter(0.4,0.4,0.4,0.1) p=0.8 + RandomGrayscale p=0.2."""
        arr = self._random_resized_crop(img, rng, 0.08, 1.0)
        if rng.random() < 0.5:
            arr = arr[:, ::-1]
        if rng.random() < 0.5:
            arr = arr[::-1]
        if rng.random() < 0.8:
            arr = _color_jitter(arr, rng, 0.4, 0.4, 0.4, 0.1)
        if rng.random() < 0.2:
            gray = (arr @ np.array([0.299, 0.587, 0.114],
                                   np.float32)).astype(np.uint8)
            arr = np.repeat(gray[..., None], 3, axis=-1)
        return np.ascontiguousarray(arr)

    def _train_transform(self, img, rng: np.random.Generator) -> np.ndarray:
        # RandomResizedCrop(scale=(0.8, 1.0), ratio=(3/4, 4/3))
        arr = self._random_resized_crop(img, rng, 0.8, 1.0)
        # flips / rot90 (one-of, p=0.5 — aider.py:284-288)
        if rng.random() < 0.5:
            k = rng.integers(0, 3)
            if k == 0:
                arr = arr[:, ::-1]
            elif k == 1:
                arr = arr[::-1]
            else:
                arr = np.rot90(arr, rng.integers(1, 4))
        # blur one-of (p=0.2 — aider.py:289-293: motion 0.2 / median 0.1 /
        # box 0.1, normalized to 0.5/0.25/0.25 selection weights)
        if rng.random() < 0.2:
            arr = _random_blur(arr, rng)
        # color one-of (p=0.3 — aider.py:294-298: CLAHE 0.2 / brightness-
        # contrast 0.3 / HSV 0.3 -> weights 0.25/0.375/0.375)
        if rng.random() < 0.3:
            u = rng.random()
            if u < 0.25:
                arr = _clahe(arr)
            elif u < 0.625:
                f = np.float32(arr)
                b = rng.uniform(-0.2, 0.2) * 255
                c = 1.0 + rng.uniform(-0.2, 0.2)
                f = (f - 127.5) * c + 127.5 + b
                arr = np.clip(f, 0, 255).astype(np.uint8)
            else:
                arr = _hsv_jitter(arr, rng)
        # distortion one-of (p=0.2 — aider.py:299-303: optical 0.3 /
        # grid 0.1 / elastic 0.2 -> weights 0.5/0.167/0.333)
        if rng.random() < 0.2:
            u = rng.random()
            if u < 0.5:
                arr = _optical_distortion(arr, rng)
            elif u < 2.0 / 3.0:
                arr = _grid_distortion(arr, rng)
            else:
                arr = _elastic_transform(arr, rng)
        return np.ascontiguousarray(arr)


# --- heavy train augs (the albumentations subset, aider.py:289-303) ---
# cv2-based; each cites the reference op it mirrors. Geometry ops use
# BORDER_REFLECT_101 (the albumentations default).


def _color_jitter(arr, rng, brightness, contrast, saturation, hue):
    """torchvision ColorJitter semantics: each op draws a factor from
    [1-x, 1+x] (hue from [-hue, hue] of the hue circle) and the four ops
    apply in a random order."""
    import cv2

    ops = list(rng.permutation(4))

    def apply(op, a):
        f32 = np.float32(a)
        if op == 0:    # brightness: multiply
            f = rng.uniform(1 - brightness, 1 + brightness)
            return np.clip(f32 * f, 0, 255).astype(np.uint8)
        if op == 1:    # contrast: blend with the mean gray
            f = rng.uniform(1 - contrast, 1 + contrast)
            mean = (a @ np.array([0.299, 0.587, 0.114], np.float32)).mean()
            return np.clip((f32 - mean) * f + mean, 0, 255).astype(np.uint8)
        if op == 2:    # saturation: blend with per-pixel gray
            f = rng.uniform(1 - saturation, 1 + saturation)
            gray = f32 @ np.array([0.299, 0.587, 0.114], np.float32)
            return np.clip(f32 * f + gray[..., None] * (1 - f),
                           0, 255).astype(np.uint8)
        # hue: shift the HSV hue channel (cv2 H range is [0, 180))
        d = rng.uniform(-hue, hue)
        hsv = cv2.cvtColor(a, cv2.COLOR_RGB2HSV)
        hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                       + int(round(d * 180))) % 180
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)

    for op in ops:
        arr = apply(op, arr)
    return arr


def _random_blur(arr, rng):
    """MotionBlur(3) | MedianBlur(3) | Blur(3). Motion blur uses an
    axis-aligned 3px line kernel (albumentations picks a random line; at
    blur_limit=3 the visible difference is negligible)."""
    import cv2

    u = rng.random()
    if u < 0.5:
        kern = np.zeros((3, 3), np.float32)
        if rng.random() < 0.5:
            kern[1, :] = 1.0 / 3.0
        else:
            kern[:, 1] = 1.0 / 3.0
        return cv2.filter2D(arr, -1, kern)
    if u < 0.75:
        return cv2.medianBlur(arr, 3)
    return cv2.blur(arr, (3, 3))


def _clahe(arr):
    """CLAHE(clip_limit=2.0) on the LAB lightness channel."""
    import cv2

    lab = cv2.cvtColor(arr, cv2.COLOR_RGB2LAB)
    clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    lab[..., 0] = clahe.apply(lab[..., 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


def _hsv_jitter(arr, rng):
    """HueSaturationValue(20, 30, 20)."""
    import cv2

    dh = int(rng.integers(-20, 21))
    ds = int(rng.integers(-30, 31))
    dv = int(rng.integers(-20, 21))
    hsv = cv2.cvtColor(arr, cv2.COLOR_RGB2HSV).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + dh) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + ds, 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + dv, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def _optical_distortion(arr, rng, limit: float = 0.05):
    """OpticalDistortion(distort_limit=0.05): radial barrel/pincushion
    remap r' = r(1 + k r^2) in normalized coordinates."""
    import cv2

    h, w = arr.shape[:2]
    k = rng.uniform(-limit, limit)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    xn = (xs - w / 2) / (w / 2)
    yn = (ys - h / 2) / (h / 2)
    f = 1.0 + k * (xn * xn + yn * yn)
    mapx = xn * f * (w / 2) + w / 2
    mapy = yn * f * (h / 2) + h / 2
    return cv2.remap(arr, mapx, mapy, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REFLECT_101)


def _grid_distortion(arr, rng, steps: int = 5, limit: float = 0.3):
    """GridDistortion(num_steps=5, distort_limit=0.3): per-cell random
    stretch along each axis via piecewise-linear source maps."""
    import cv2

    h, w = arr.shape[:2]

    def axis_map(n):
        widths = (n / steps) * (1.0 + rng.uniform(-limit, limit, steps))
        src = np.concatenate([[0.0], np.cumsum(widths)])
        src *= n / src[-1]
        tgt = np.linspace(0, n, steps + 1)
        return np.interp(np.arange(n, dtype=np.float32), tgt,
                         src).astype(np.float32)

    mapx = np.broadcast_to(axis_map(w)[None, :], (h, w)).copy()
    mapy = np.broadcast_to(axis_map(h)[:, None], (h, w)).copy()
    return cv2.remap(arr, mapx, mapy, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REFLECT_101)


def _elastic_transform(arr, rng, alpha: float = 1.0, sigma: float = 50.0):
    """ElasticTransform(alpha=1, sigma=50): gaussian-smoothed random
    pixel displacement (the affine component of the albumentations op is
    covered by RandomResizedCrop upstream)."""
    import cv2

    h, w = arr.shape[:2]
    dx = cv2.GaussianBlur(rng.uniform(-1, 1, (h, w)).astype(np.float32),
                          (0, 0), sigma) * alpha
    dy = cv2.GaussianBlur(rng.uniform(-1, 1, (h, w)).astype(np.float32),
                          (0, 0), sigma) * alpha
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    return cv2.remap(arr, xs + dx, ys + dy, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REFLECT_101)


class BatchLoader:
    """Fixed-shape batch iterator with threaded decode: yields (uint8 NHWC
    images, int32 labels, valid count). Decode fans out over a thread pool
    (PIL releases the GIL in decode). Each pass draws its order (when
    ``shuffle``) and one child generator a sample from ``seed + epoch``;
    the final partial batch is zero-padded to the fixed shape, or dropped
    with ``drop_last``."""

    def __init__(self, dataset: AiderDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 8, seed: int = 42):
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, int(num_workers))
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        n = len(self.ds)
        order = np.arange(n)
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(order)
        self.epoch += 1
        bs = self.batch_size
        s = self.ds.image_size
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, n, bs):
                idxs = order[start:start + bs]
                if len(idxs) < bs and self.drop_last:
                    break
                child_rngs = [np.random.default_rng(rng.integers(2 ** 63))
                              for _ in idxs]
                results = list(pool.map(
                    lambda a: self.ds.load(a[0], a[1]),
                    zip(idxs, child_rngs)))
                images = np.zeros((bs, s, s, 3), np.uint8)
                labels = np.zeros((bs,), np.int32)
                for i, (img, lbl) in enumerate(results):
                    images[i] = img
                    labels[i] = lbl
                yield images, labels, len(idxs)


def normalize_batch(images_u8: torch.Tensor, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 NHWC, on the tensor's device.

    Rounded as the jitted JAX function computes ``(x / 255 - mean) / std``:
    ``fma(x, fp32(1/255), -mean) * fp32(1/std)``. XLA turns each division
    by a constant into a multiply by its fp32 reciprocal and fuses the
    first multiply with the subtraction (``addcmul``, one rounding)."""
    x = images_u8.float()
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    inv255 = torch.full((), np.float32(1.0) / 255, device=x.device)
    return torch.addcmul(-mean, x, inv255) * (1.0 / std)
