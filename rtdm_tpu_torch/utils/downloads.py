"""Weight files the reference fetches from its published mirrors.

Counterpart of ``rtdm_tpu/utils/downloads.py``: the reference resolves a
missing weight file by downloading it from its mirrors before loading it
(yolov3/models.py:553-572 ``attempt_download``). ``attempt_download``
returns a path that exists as it is; for a missing file of a known name it
fetches to the requested path when ``RTDM_ALLOW_DOWNLOAD=1``, and raises a
``FileNotFoundError`` naming the mirror otherwise; a missing file of any
other name is returned for the loader to raise its own error.

Unlike the JAX package, it searches no other directory for the basename:
a mistyped path would load other weights without a word. A loader of the
port opens only the path it was given.
"""

from __future__ import annotations

import os
from typing import Optional

# the reference's published weight mirrors (yolov3/models.py:555-560,
# weights/download_yolov3_weights.sh): name -> url or "gdrive:<id>"
KNOWN_WEIGHTS = {
    "yolov3.weights": "https://pjreddie.com/media/files/yolov3.weights",
    "yolov3-tiny.weights":
        "https://pjreddie.com/media/files/yolov3-tiny.weights",
    "yolov3-spp.weights":
        "https://pjreddie.com/media/files/yolov3-spp.weights",
    "darknet53.conv.74":
        "https://pjreddie.com/media/files/darknet53.conv.74",
    "yolov3.pt": "gdrive:1SHNFyoe5Ni8DajDNEqgB2oVKBb_NoEad",
    "yolov3-spp.pt": "gdrive:1f6Ovy3BSq2wYq4UfvFUpxJFNDFfrIDcR",
    "yolov3-tiny.pt": "gdrive:1-GWwTxFEBZdzxXnGQ1AdCdh-VGsERCgJ",
}


def mirror_url(src: str) -> str:
    """The download URL of a ``KNOWN_WEIGHTS`` entry."""
    if src.startswith("gdrive:"):
        return ("https://drive.google.com/uc?export=download&id="
                + src.split(":", 1)[1])
    return src


def attempt_download(weights: Optional[str]) -> Optional[str]:
    """``weights`` if it is empty or exists; a missing file of a name in
    ``KNOWN_WEIGHTS`` is fetched to that path with ``RTDM_ALLOW_DOWNLOAD=1``
    and raises ``FileNotFoundError`` naming its mirror without it; any
    other missing path is returned as given."""
    if not weights or os.path.exists(weights):
        return weights
    src = KNOWN_WEIGHTS.get(os.path.basename(weights))
    if src is None:
        return weights
    if os.environ.get("RTDM_ALLOW_DOWNLOAD") == "1":
        import urllib.request
        os.makedirs(os.path.dirname(weights) or ".", exist_ok=True)
        urllib.request.urlretrieve(mirror_url(src), weights)  # noqa: S310
        return weights
    raise FileNotFoundError(
        f"{weights} not found; the reference downloads it from {src} "
        "(yolov3/models.py:553-572). Set RTDM_ALLOW_DOWNLOAD=1 on a host "
        "with network access, or place the file at that path.")
