"""Power-usage measurement CLI.

Counterpart of ``rtdm_tpu/cli/power_usage.py`` (the reference's
calculate-power-usage.py:214-280): classifier inference over a share of
the AIDER data while logging a power trace, then total energy, average
power and energy per frame, and optionally the trace plotted with event
markers (PowerLogger.showDataTraces / getTotalEnergy, :105-211).

The reference samples INA3221 rails on a Jetson TX2 (:25-77). Here the
trace is ``utils/profiler.py``'s busy-time model: the device's busy watts
(``--chip-watts``, by default the card's power limit from ``nvidia-smi``,
or 65 W with ``--device cpu``) while a batch runs, idle watts otherwise.

Run: python -m rtdm_tpu_torch.cli.power_usage --model squeeze-ernet \
         --weights w.npz --root-dir data/AIDER --test-data-pc 30
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Modelled power/energy report for classifier inference")
    p.add_argument("--model", default="squeeze-ernet",
                   choices=["ernet", "squeeze-ernet", "squeeze-redconv"])
    p.add_argument("--weights", help="an .npz variables archive or a "
                   "torch .pt/.pth")
    p.add_argument("--engine", help="saved engine dir (the --trt path, "
                   "calculate-power-usage.py:223)")
    p.add_argument("--root-dir", default="data/AIDER")
    p.add_argument("--test-split", default="dataloaders/aider_test.csv")
    p.add_argument("--test-data-pc", type=int, default=30, metavar="N",
                   help="run on N%% of the split "
                        "(calculate-power-usage.py:220-221)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--chip-watts", type=float, default=None,
                   help="busy power; default: the card's power limit")
    p.add_argument("--idle-watts", type=float, default=30.0)
    p.add_argument("--plot", help="write the power-trace PNG here "
                   "(showDataTraces analogue, :159-185)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if not args.engine and not args.weights:
        p.error("--weights is required unless --engine is given")

    import numpy as np

    from rtdm_tpu_torch.data.aider import AiderDataset, BatchLoader
    from rtdm_tpu_torch.utils.profiler import PowerMonitor

    if args.engine:
        from rtdm_tpu_torch.export.engine import Engine
        engine = Engine.load(args.engine, device=args.device)
        # the engine's spec is authoritative: it runs (batch, size, size, 3)
        args.batch_size = min(args.batch_size, engine.spec.batch_size)
    else:
        from rtdm_tpu_torch.export.engine import build_engine
        from rtdm_tpu_torch.models.io import load_variables
        engine = build_engine(args.model, load_variables(args.weights),
                              quant=args.precision,
                              batch_size=args.batch_size, verify=False,
                              device=args.device)
    size = engine.spec.image_size

    ds = AiderDataset(args.test_split, args.root_dir, size)
    n = max(int(len(ds) * args.test_data_pc / 100.0), args.batch_size)
    rng = np.random.default_rng(0)
    ds.samples = [ds.samples[i]
                  for i in rng.permutation(len(ds))[:min(n, len(ds))]]
    loader = BatchLoader(ds, args.batch_size, num_workers=4)

    mon = PowerMonitor(chip_watts=args.chip_watts,
                       idle_watts=args.idle_watts, device=args.device)
    mon.start()
    frames = 0
    warm = False
    for images, labels, valid in loader:
        if not warm:  # the first call's set-up outside the energy account
            engine(images)
            warm = True
            mon.mark_event("inferenceStart")
        t0 = time.perf_counter()
        engine(images)  # returns on the host: waits for the card
        mon.record_busy(time.perf_counter() - t0)
        frames += int(valid)
    mon.mark_event("inferenceEnd")
    mon.stop()

    total_j = mon.get_total_energy()
    span = mon.samples[-1].t if mon.samples else 0.0
    # the per-node table analogue (printFullReport, :83-98): one modelled
    # device instead of 12 INA3221 rails
    node = "gpu/card" if args.device == "cuda" else "cpu"
    print(f"{'node':>14} {'busy W':>8} {'idle W':>8} {'avg W':>8}")
    print(f"{node:>14} {mon.chip_watts:>8.1f} {mon.idle_watts:>8.1f} "
          f"{total_j / max(span, 1e-9):>8.1f}")
    print(f"frames {frames}  wall {span:.2f}s  "
          f"({frames / max(span, 1e-9):.1f} FPS)")
    print(f"total energy (modelled): {total_j:.1f} J")
    print(f"energy/frame: {mon.energy_per_frame(frames):.3f} mJ")
    if args.plot:
        print(f"power trace: {mon.plot(args.plot)}")
    return {"frames": frames, "total_j": total_j,
            "mj_per_frame": mon.energy_per_frame(frames)}


if __name__ == "__main__":
    main()
