"""Corrupt-image scanner.

Counterpart of ``rtdm_tpu/cli/img_verify.py`` (the reference's
yolov5/img-verify.py:1-12): PIL's ``verify()`` over every image of a tree,
printing the files that fail it, and removing them with ``--delete``.

Run: python -m rtdm_tpu_torch.cli.img_verify --root <dir> [--delete]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Scan for corrupt images")
    p.add_argument("--root", required=True)
    p.add_argument("--delete", action="store_true",
                   help="remove corrupt files")
    args = p.parse_args(argv)

    from PIL import Image

    exts = (".jpg", ".jpeg", ".png", ".bmp")
    bad = []
    total = 0
    for dirpath, _, files in os.walk(args.root):
        for fn in files:
            if not fn.lower().endswith(exts):
                continue
            total += 1
            path = os.path.join(dirpath, fn)
            try:
                with Image.open(path) as img:
                    img.verify()
            except Exception as e:
                bad.append(path)
                print(f"CORRUPT {path}: {e}")
                if args.delete:
                    os.remove(path)
    print(f"scanned {total} images, {len(bad)} corrupt"
          + (" (deleted)" if args.delete and bad else ""))
    return bad


if __name__ == "__main__":
    main()
