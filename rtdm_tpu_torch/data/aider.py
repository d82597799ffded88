"""AIDER dataset, batch loader and input normalisation.

Counterpart of ``rtdm_tpu/data/aider.py`` for evaluation: CSV rows are
(relative_path, label), labels 0..4 = collapsed_building, fire,
flooded_areas, normal, traffic_incident. ``AiderDataset`` loads an image
with PIL and applies the eval transform (bilinear resize of the short side
to int(1.14*size), center crop), emitting uint8 HWC; a corrupt or missing
image becomes a black frame, counted in ``load_errors``. ``BatchLoader``
decodes on a thread pool and yields fixed-shape uint8 NHWC batches, the
last one zero-padded, with the count of valid rows. ``normalize_batch``
does /255 and the ImageNet normalize on the device. The train transforms
(and cv2) wait for the training slice.
"""

from __future__ import annotations

import csv
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Tuple

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


class AiderDataset:
    """Fixed-shape uint8 sample producer for the AIDER CSV splits (the eval
    transform only)."""

    def __init__(self, csv_file, root_dir, image_size: int = 140):
        csv_file = Path(csv_file)
        if not csv_file.exists():
            raise FileNotFoundError(str(csv_file))
        self.root_dir = Path(root_dir)
        self.image_size = int(image_size)
        self.samples: List[Tuple[str, int]] = []
        with open(csv_file, newline="") as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    self.samples.append(
                        (str(self.root_dir / row[0]), int(row[1])))
        self.load_errors = 0

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def labels(self) -> np.ndarray:
        return np.array([lbl for _, lbl in self.samples], np.int32)

    def load(self, idx: int) -> Tuple[np.ndarray, int]:
        path, label = self.samples[idx]
        img = _load_image(path)
        if img is None:
            self.load_errors += 1
            s = self.image_size
            return np.zeros((s, s, 3), np.uint8), label
        return self._eval_transform(img), label

    def _eval_transform(self, img) -> np.ndarray:
        """Resize the short side to int(1.14*s), center-crop s
        (torchvision's Resize + CenterCrop)."""
        from PIL import Image
        s = self.image_size
        w, h = img.size
        target = int(s * 1.14)
        if w <= h:
            nw, nh = target, max(int(round(h * target / w)), target)
        else:
            nh, nw = target, max(int(round(w * target / h)), target)
        img = img.resize((nw, nh), Image.BILINEAR)
        left, top = (nw - s) // 2, (nh - s) // 2
        img = img.crop((left, top, left + s, top + s))
        return np.asarray(img, np.uint8)


class BatchLoader:
    """Fixed-shape batch iterator with threaded decode, in dataset order:
    yields (uint8 NHWC images, int32 labels, valid count), the last batch
    zero-padded. Shuffling and dropping the last batch wait for the
    training slice."""

    def __init__(self, dataset: AiderDataset, batch_size: int,
                 num_workers: int = 8):
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.num_workers = max(1, int(num_workers))

    def __len__(self) -> int:
        return -(-len(self.ds) // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        n, bs, s = len(self.ds), self.batch_size, self.ds.image_size
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, n, bs):
                idxs = range(start, min(start + bs, n))
                images = np.zeros((bs, s, s, 3), np.uint8)
                labels = np.zeros((bs,), np.int32)
                for i, (img, lbl) in enumerate(pool.map(self.ds.load, idxs)):
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
