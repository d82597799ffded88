"""Test-set classification evaluation CLI.

Counterpart of ``rtdm_tpu/cli/evaluate_classification.py``: accuracy, F1,
precision and recall with the per-class breakdown from the confusion
matrix, and frames/s timed over forward passes only (data already in host
memory, each forward ending in its copy back to the host). ``--engine``
evaluates an engine directory (any precision, int8 included);
``--weights`` runs the raw weights through an engine at ``--precision``
with the batch of ``--batch-size``. Runs on the card unless ``--device
cpu``. ``--data-parallel`` shards each batch over the ranks of the process
group (``core/mesh.py::data_parallel_mesh``: launched by ``torchrun``, one
rank a card; without a launcher one rank, and nothing changes): every rank
loads the same batches and returns the all-gathered probabilities. The
raw-weights path needs ``--batch-size`` to divide over the ranks; an
engine directory checks its own batch.

Run: python -m rtdm_tpu_torch.cli.evaluate_classification \
         --model squeeze-ernet --weights ... --root-dir data/AIDER \
         --test-split .../aider_test.csv
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate AIDER classifier")
    p.add_argument("--model", default="squeeze-ernet",
                   choices=["ernet", "squeeze-ernet", "squeeze-redconv"])
    p.add_argument("--weights", help="weights (.npz or torch .pt/.pth)")
    p.add_argument("--engine", help="engine directory")
    p.add_argument("--root-dir", default="data/AIDER")
    p.add_argument("--test-split", default="dataloaders/aider_test.csv")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--data-parallel", action="store_true",
                   help="shard eval batches over the ranks of the process "
                   "group (torchrun; one rank without a launcher)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if not args.engine and not args.weights:
        p.error("--weights is required unless --engine is given")

    import numpy as np

    from rtdm_tpu_torch.data.aider import AiderDataset, BatchLoader
    from rtdm_tpu_torch.eval.classification import ClassificationMetrics
    from rtdm_tpu_torch.export.engine import Engine, build_engine
    from rtdm_tpu_torch.models.ernet import CLASS_NAMES

    mesh = None
    if args.data_parallel:
        from rtdm_tpu_torch.core.mesh import (data_parallel_mesh,
                                              require_data_divisible)
        mesh = data_parallel_mesh(args.device)
        if not args.engine:
            try:
                require_data_divisible(args.batch_size, mesh,
                                       "--batch-size")
            except ValueError as e:
                raise SystemExit(str(e))
    if args.engine:
        engine = Engine.load(args.engine, device=args.device, mesh=mesh)
    else:
        from rtdm_tpu_torch.models.io import load_variables
        engine = build_engine(args.model, load_variables(args.weights),
                              quant=args.precision,
                              batch_size=args.batch_size, verify=False,
                              device=args.device, mesh=mesh)
    ds = AiderDataset(args.test_split, args.root_dir,
                      engine.spec.image_size)
    loader = BatchLoader(ds, args.batch_size, num_workers=args.num_workers)
    metrics = ClassificationMetrics(len(CLASS_NAMES), CLASS_NAMES)
    times = []
    warm = False
    for images, labels, valid in loader:
        if not warm:
            engine(images[:valid])        # warm-up, first batch only
            warm = True
        t0 = time.perf_counter()
        probs = engine(images[:valid])    # ends in a copy to the host
        times.append(time.perf_counter() - t0)
        preds = np.argmax(probs, axis=-1)
        cm = np.zeros((len(CLASS_NAMES),) * 2, np.int64)
        np.add.at(cm, (labels[:valid], preds), 1)
        metrics.update(cm, 0.0, valid)

    print(metrics.report())
    if times:
        mean_t = float(np.mean(times[1:] if len(times) > 1 else times))
        print(f"avg inference time/batch: {mean_t * 1e3:.3f} ms  "
              f"({args.batch_size / mean_t:.1f} frames/s on {args.device})")
    return metrics


if __name__ == "__main__":
    main()
