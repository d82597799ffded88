"""Dataset-artifact logging CLI.

Counterpart of ``rtdm_tpu/cli/log_dataset.py`` (the reference's W&B
dataset job, yolov5/utils/wandb_logging/log_dataset.py:11-24): from a
darknet ``.data`` file or a v5 data yaml, a manifest of each split (images,
labelled images, instances per class) and a fingerprint over the image
paths and sizes (v5's label-cache hash, yolov5/utils/datasets.py:456-460),
written as ``<project>/<name>-artifact.json`` and recorded through
``utils/experiment_log.py::ExperimentLogger`` (W&B where the package
exists, the local JSONL run log always).

Run: python -m rtdm_tpu_torch.cli.log_dataset --data .../aider.yaml
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os


def build_manifest(data_path: str, single_cls: bool = False) -> dict:
    import numpy as np

    from rtdm_tpu_torch.data.odder import (collect_image_paths,
                                           label_path_for, load_data_spec)

    spec = load_data_spec(data_path)
    base = str(spec["base"])
    nc = 1 if single_cls else int(spec["classes"])  # type: ignore[arg-type]
    names = list(spec.get("names") or [])
    manifest: dict = {"data": os.path.abspath(data_path), "nc": nc,
                      "names": names, "splits": {}}
    fp = hashlib.sha256()
    for split in ("train", "valid", "test"):
        if split not in spec:
            continue
        paths = collect_image_paths(spec[split], base)
        per_class = np.zeros(nc, np.int64)
        labelled = 0
        for p in sorted(paths):
            st = os.stat(p) if os.path.exists(p) else None
            fp.update(f"{p}:{st.st_size if st else -1}".encode())
            lp = label_path_for(p)
            if os.path.exists(lp):
                labelled += 1
                rows = np.loadtxt(lp, ndmin=2)
                if rows.size:
                    cls = (np.zeros(len(rows), int) if single_cls
                           else rows[:, 0].astype(int))
                    per_class += np.bincount(cls, minlength=nc)[:nc]
        manifest["splits"][split] = {
            "images": len(paths), "labelled": labelled,
            "instances_per_class": per_class.tolist()}
    manifest["fingerprint"] = fp.hexdigest()[:16]
    return manifest


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="Log a dataset as a versioned artifact")
    p.add_argument("--data", required=True,
                   help="darknet .data file or yolov5 data yaml")
    p.add_argument("--single-cls", action="store_true",
                   help="treat all labels as one class")
    p.add_argument("--project", default="runs/dataset",
                   help="artifact/run directory (W&B project analogue)")
    args = p.parse_args(argv)

    manifest = build_manifest(args.data, args.single_cls)
    os.makedirs(args.project, exist_ok=True)
    out = os.path.join(
        args.project,
        os.path.splitext(os.path.basename(args.data))[0] + "-artifact.json")
    with open(out, "w") as f:
        json.dump(manifest, f, indent=2)

    from rtdm_tpu_torch.utils.experiment_log import ExperimentLogger
    log = ExperimentLogger(args.project, run_name="dataset",
                           use_tensorboard=False,
                           config={"data": args.data,
                                   "job_type": "Dataset Creation"})
    log.log_artifact(out, kind="dataset")
    log.close()
    print(json.dumps(manifest))
    return manifest


if __name__ == "__main__":
    main()
