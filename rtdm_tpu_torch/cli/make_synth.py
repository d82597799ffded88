"""Write the synthetic training sets (``data/synth.py``).

Usage:
    python -m rtdm_tpu_torch.cli.make_synth --out data/synth \
        --det-train 800 --det-val 100 --cls-per-class 160

The reference's AIDER and ODDER image sets do not ship with the repo;
these procedural sets have their scale and file layouts, so training at
the dataset's scale runs end to end. Counterpart of
``rtdm_tpu/cli/make_synth.py``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True, help="output root directory")
    p.add_argument("--det-train", type=int, default=800)
    p.add_argument("--det-val", type=int, default=100)
    p.add_argument("--cls-per-class", type=int, default=160)
    p.add_argument("--cls-val-per-class", type=int, default=25)
    p.add_argument("--cls-test-per-class", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--det-only", action="store_true")
    p.add_argument("--cls-only", action="store_true")
    a = p.parse_args(argv)

    from rtdm_tpu_torch.data.synth import (generate_classification_dataset,
                                     generate_detection_dataset)

    out = {}
    if not a.cls_only:
        data_path, yaml_path = generate_detection_dataset(
            a.out + "/det", n_train=a.det_train, n_val=a.det_val,
            seed=a.seed)
        out["det_data"] = data_path
        out["det_yaml"] = yaml_path
        print(f"detection: {a.det_train}+{a.det_val} images -> {data_path}")
    if not a.det_only:
        root = generate_classification_dataset(
            a.out + "/cls", n_train_per_class=a.cls_per_class,
            n_val_per_class=a.cls_val_per_class,
            n_test_per_class=a.cls_test_per_class, seed=a.seed)
        out["cls_root"] = root
        print(f"classification: {a.cls_per_class}/class train -> {root}")
    return out


if __name__ == "__main__":
    main()
