"""Image-list generator.

Counterpart of ``rtdm_tpu/cli/gen_txts.py`` (the reference's
yolov3/data/gen-txts.py): the sorted image files of a directory as a
darknet list txt, optionally relative to a directory.

Run: python -m rtdm_tpu_torch.cli.gen_txts \
         --images data/custom/train/images \
         --output data/custom/train.txt --relative-to data/..
"""

from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate image-list txts")
    p.add_argument("--images", required=True, help="images directory")
    p.add_argument("--output", required=True, help="list txt to write")
    p.add_argument("--relative-to", help="emit paths relative to this dir")
    args = p.parse_args(argv)

    exts = (".jpg", ".jpeg", ".png", ".bmp")
    paths = sorted(pth for pth in glob.glob(os.path.join(args.images, "*"))
                   if pth.lower().endswith(exts))
    if args.relative_to:
        paths = [os.path.relpath(pth, args.relative_to) for pth in paths]
    with open(args.output, "w") as f:
        f.write("\n".join(paths) + ("\n" if paths else ""))
    print(f"wrote {len(paths)} entries to {args.output}")
    return paths


if __name__ == "__main__":
    main()
