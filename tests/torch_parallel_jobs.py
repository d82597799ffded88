"""Process groups for the port's data-parallel tests.

``start_group(job, world, work)`` spawns ``world`` processes that join one
gloo group through a ``file://`` store under ``work`` (no TCP port, so
pytest-xdist workers cannot collide), each running ``python -m
tests.torch_parallel_jobs <job> <rank> <world> <store> <work> <options>``
on the CPU with two torch threads. Each rank runs the job's checks once and
writes ``<work>/<job>.<rank>.npz``; ``Group.results()`` waits for them all
(a failed rank fails the test with its log) and returns one dict a rank.

The jobs' inputs are made here from seeds with numpy, so that a test can
run the same function in its own process with ``mesh=None`` (one process)
or the JAX counterpart on the same arrays. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ENGINES = ROOT / "artifacts" / "engines"
THREADS = 2
TIMEOUT_S = 600
ENGINE_BATCH = 16
DETECT_BATCH = 16
SPATIAL_KERNELS = ((3, 3, 16), (1, 1, 4), (1, 3, 4), (3, 1, 4), (5, 3, 4))
YOLO_FRAMES = 8      # the detector train golden's first frames: 8 divides
#                      over 2 ranks and JAX's 8 devices alike
YOLO_STEPS = 2
ELASTIC_BATCH = 8


# ---------------------------------------------------------------------------
# the parent side


class Group:
    def __init__(self, job, world, work, procs, logs):
        self.job, self.world, self.work = job, world, Path(work)
        self.procs, self.logs = procs, logs

    def results(self):
        try:
            for p in self.procs:
                p.wait(timeout=TIMEOUT_S)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        failed = [(r, p.returncode) for r, p in enumerate(self.procs)
                  if p.returncode != 0]
        if failed:
            text = "\n".join(f"--- rank {r} (rc {rc})\n"
                             + self.logs[r].read_text()[-4000:]
                             for r, rc in failed)
            raise AssertionError(f"{self.job} at world size {self.world} "
                                 f"failed:\n{text}")
        out = []
        for r in range(self.world):
            with np.load(self.work / f"{self.job}.{r}.npz",
                         allow_pickle=False) as z:
                out.append(dict(z))
        return out


def start_group(job: str, world: int, work, store=None,
                **options) -> Group:
    """Start ``world`` ranks of ``job`` in the background; ``store`` (a
    host:port for the ``init_*`` jobs) defaults to a file under ``work``."""
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    store = store or f"file://{work / f'{job}.store'}"
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "OMP_NUM_THREADS": str(THREADS)}
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT", "JAX_COORDINATOR_ADDRESS",
                 "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(name, None)
    procs, logs = [], []
    for rank in range(world):
        log = work / f"{job}.{rank}.log"
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_parallel_jobs", job,
                 str(rank), str(world), store, str(work),
                 json.dumps(options)],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT))
    return Group(job, world, work, procs, logs)


# ---------------------------------------------------------------------------
# inputs, from seeds


def engine_frames(n=ENGINE_BATCH):
    return np.random.default_rng(0).integers(
        0, 255, (n, 140, 140, 3)).astype(np.uint8)


def engine_parts(quant):
    """(spec fields, variables, act_scales) of the committed Squeeze_ErNET
    engine of ``quant`` (fp32: the bf16 engine's weights)."""
    from rtdm_tpu_torch.models.io import load_variables
    name = "squeeze-ernet_int8" if quant == "int8" else "squeeze-ernet_bf16"
    directory = ENGINES / name
    variables = load_variables(str(directory / "params.npz"))
    scales = None
    if quant == "int8":
        with np.load(directory / "act_scales.npz") as z:
            scales = dict(z)
    return variables, scales


def port_engine(quant, batch, mesh=None):
    from rtdm_tpu_torch.export.engine import Engine, EngineSpec
    variables, scales = engine_parts(quant)
    return Engine(EngineSpec(model="squeeze-ernet", quant=quant,
                             batch_size=batch, image_size=140),
                  variables, scales, device="cpu", mesh=mesh)


def detector_frames():
    """The detector golden's 10 letterboxed frames repeated to the batch."""
    with np.load(ROOT / "tests" / "goldens" / "torch_port" /
                 "detector_int8.npz") as g:
        frames = g["frames_416"]
    return np.concatenate([frames, frames])[:DETECT_BATCH]


def spatial_inputs():
    """(x NHWC, [HWIO kernels]) of the halo-conv checks."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 32, 8)).astype(np.float32)
    kernels = [(rng.normal(size=(kh, kw, 8, o)) * 0.1).astype(np.float32)
               for kh, kw, o in SPATIAL_KERNELS]
    return x, kernels


def oihw(k_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0,
                                                                  1)))


def yolo_golden_batch():
    """The detector train golden with its first YOLO_FRAMES frames."""
    import chip_smoke
    golden = chip_smoke._yolo_golden()
    for k in ("images", "labels", "num_labels"):
        golden[k] = golden[k][:YOLO_FRAMES]
    return golden


# ---------------------------------------------------------------------------
# runs that a test makes with mesh=None and a job with a mesh


def _gathered(x, mesh):
    from rtdm_tpu_torch.parallel.comms import all_gather_along
    return x if mesh is None else all_gather_along(x, mesh)


def draw_run(mesh=None):
    """Two Squeeze_ErNET train steps with dropout 0.2, mixup and cutmix
    (grad accumulation 2): every microbatch's mixed input to the model and
    every dropout mask, of the global batch."""
    from rtdm_tpu_torch.core.precision import FP32_POLICY
    from rtdm_tpu_torch.data.aider import normalize_batch
    from rtdm_tpu_torch.models import create_model
    from rtdm_tpu_torch.models.io import (torch_state_dict_from_variables,
                                          unflatten_tree)
    from rtdm_tpu_torch.models.layers import Dropout
    from rtdm_tpu_torch.train.losses import make_classification_loss
    from rtdm_tpu_torch.train.schedules import make_optimizer
    from rtdm_tpu_torch.train.trainer import Trainer
    import chip_smoke
    golden = chip_smoke._train_golden()
    model = create_model("squeeze-ernet", device="cpu", dropout_rate=0.2)
    model.load_state_dict(torch_state_dict_from_variables(unflatten_tree(
        {k[5:]: v for k, v in golden.items() if k.startswith("init/")})))
    inputs, masks = [], []
    model.conv1.register_forward_pre_hook(
        lambda m, a: inputs.append(a[0].detach().clone()))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.register_forward_hook(lambda m, a, out: masks.append(
                ((out != 0) | (a[0] == 0)).detach()))
    trainer = Trainer(model, make_optimizer("sgd", 0.05),
                      make_classification_loss("label_smoothing"),
                      policy=FP32_POLICY, grad_accum_steps=2, mesh=mesh,
                      mixup_alpha=0.2, cutmix_alpha=0.1)
    state = trainer.init_state()
    x = normalize_batch(torch.from_numpy(golden["images"]))
    y = torch.from_numpy(golden["labels"]).long()
    for _ in range(2):
        state, _ = trainer.train_step(state, x, y, 5)
    out = {f"input_{i}": _gathered(t, mesh) for i, t in enumerate(inputs)}
    out.update({f"mask_{i}": _gathered(t, mesh)
                for i, t in enumerate(masks)})
    return out


def _seeded_classifier(bn_group=None, dropout_rate=0.0):
    """Squeeze_ErNET from seed 0; ``bn_group``: its BatchNorm synced over
    that mesh."""
    from rtdm_tpu_torch.models import create_model
    from rtdm_tpu_torch.models.layers import set_bn_group
    model = create_model("squeeze-ernet", device="cpu",
                         generator=torch.Generator().manual_seed(0),
                         dropout_rate=dropout_rate)
    set_bn_group(model, bn_group)
    return model


def _flat_state(model):
    from rtdm_tpu_torch.models.io import (flatten_tree,
                                          variables_from_torch_state_dict)
    return flatten_tree(variables_from_torch_state_dict(model.state_dict()))


def shard_map_batch():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(8, 140, 140, 3)).astype(np.float32),
            rng.integers(0, 5, (8,)).astype(np.int64))


def gspmd_step(mesh=None, sync_bn=True):
    """One data-parallel step (sgd 0.01, no clip, cross entropy, dropout
    off), as tests/test_parallel.py's GSPMD half: (loss, flat variables).
    ``sync_bn`` False: each rank's BatchNorm statistics its own."""
    from rtdm_tpu_torch.core.precision import FP32_POLICY
    from rtdm_tpu_torch.train.losses import make_classification_loss
    from rtdm_tpu_torch.train.schedules import make_optimizer
    from rtdm_tpu_torch.train.trainer import Trainer
    x, y = (torch.from_numpy(a) for a in shard_map_batch())
    trainer = Trainer(_seeded_classifier(),
                      make_optimizer("sgd", 0.01, grad_clip=None),
                      make_classification_loss("crossentropy"),
                      policy=FP32_POLICY, mesh=mesh, sync_bn=sync_bn)
    state, metrics = trainer.train_step(trainer.init_state(), x, y, 1)
    return float(metrics["loss"]), _flat_state(state.model)


def shard_map_step(mesh):
    """The same step in the DDP form: a model whose BatchNorm is synced
    over the mesh (``set_bn_group``)."""
    from rtdm_tpu_torch.parallel.shard import make_shard_map_train_step
    from rtdm_tpu_torch.train.losses import make_classification_loss
    from rtdm_tpu_torch.train.schedules import make_optimizer
    from rtdm_tpu_torch.train.trainer import create_train_state
    x, y = (torch.from_numpy(a) for a in shard_map_batch())
    tx = make_optimizer("sgd", 0.01, grad_clip=None)
    state = create_train_state(_seeded_classifier(bn_group=mesh), tx)
    step = make_shard_map_train_step(
        tx, make_classification_loss("crossentropy"), mesh)
    state, loss = step(state, x, y, 1)
    return float(loss), _flat_state(state.model)


def yolo_dp_runs(mesh, work, control=False):
    """The detector train step of cases a (yolov5s-mini, v5 loss, EMA) and
    b (yolov4-tiny-mini, v3 loss, two microbatches) of the train golden,
    YOLO_STEPS steps on its first YOLO_FRAMES frames, flat as
    ``chip_smoke.golden_yolo_case`` gives them. ``control``: each rank's
    loss is the one-process loss of its own rows, divided by the ranks
    (the mean of per-rank losses), on case a."""
    import chip_smoke
    from rtdm_tpu_torch.train.yolo_loss import yolo_loss_v5
    golden = yolo_golden_batch()
    out = {}
    cases = ("a",) if control else ("a", "b")
    n = 1 if mesh is None else mesh.size

    def mean_of_rank_losses(*args, mesh=None, **kwargs):
        loss, comps = yolo_loss_v5(*args, **kwargs)
        return loss / n, {k: v / n for k, v in comps.items()}

    for case in cases:
        run = chip_smoke.golden_yolo_case(
            golden, case, "cpu", Path(work) / f"yolo_{case}",
            steps=YOLO_STEPS, mesh=mesh,
            loss_fn=mean_of_rank_losses if control else None)
        out[case] = run
    return out


def write_hue_set(root: Path, n_train=16, n_eval=8) -> Path:
    """An AIDER-style set of flat-hue images (one hue a class) with CSV
    splits; returns the root."""
    from PIL import Image
    hues = ((200, 30, 30), (30, 200, 30), (30, 30, 200), (200, 200, 30),
            (30, 200, 200))
    rng = np.random.default_rng(0)
    root.mkdir(parents=True, exist_ok=True)
    for split, n in (("train", n_train), ("val", n_eval), ("test", n_eval)):
        rows = []
        for i in range(n):
            label = i % len(hues)
            img = np.clip(np.array(hues[label]) + rng.normal(
                0, 20, (160, 160, 3)), 0, 255).astype(np.uint8)
            name = f"{split}_{i}.png"
            Image.fromarray(img).save(root / name)
            rows.append(f"{name},{label}")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")
    return root


def aider_config(data: Path, run: Path):
    from rtdm_tpu_torch.core.config import TrainingConfig
    return TrainingConfig(
        model="squeeze-ernet", root_dir=str(data),
        train_split=str(data / "train.csv"), val_split=str(data / "val.csv"),
        test_split=str(data / "test.csv"), batch_size=4, epochs=2,
        precision="fp32", augment=False, num_workers=2, grad_accum_steps=2,
        checkpoint_dir=str(run / "ckpt"), log_dir=str(run / "logs"),
        early_stopping=False, device="cpu", seed=3)


def yolo_argv(cfg, weights, data, out, *extra, batch=4, nominal=4):
    """``nominal`` None: the CLI's default nominal batch (64)."""
    return ["--cfg", cfg, "--weights", weights, "--data", data,
            "--img-size", "128", "--batch-size", str(batch),
            *(["--nominal-batch", str(nominal)] if nominal else []),
            "--epochs", "1", "--lr0", "0.01", "--momentum", "0.937",
            "--burn-in", "1", "--seed", "3", "--num-workers", "2",
            "--no-plots", "--ema", "--device", "cpu", "--output", str(out),
            *extra]


def yolo_accumulate_run(cfg, weights, data, out, *extra):
    """``yolo_train`` at batch 8 with the default nominal batch and no
    eval: (the losses of its epoch, its last loss, its microbatch count)."""
    from rtdm_tpu_torch.cli import yolo_train
    res = yolo_train.train(yolo_train.parse_args(yolo_argv(
        cfg, weights, data, out, "--notest", *extra, batch=8,
        nominal=None)))
    return {"history_loss": np.array([h["loss"] for h in res["history"]]),
            "last_loss": np.array(res["last_loss"]),
            "accumulate": np.array(res["accumulate"])}


# ---------------------------------------------------------------------------
# the jobs (one process a rank)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def job_infer(mesh, work, opts):
    """Comms, the halo conv and the data-parallel engines (and detectors)."""
    from rtdm_tpu_torch.core.mesh import create_mesh
    from rtdm_tpu_torch.parallel.comms import (all_gather_along,
                                               broadcast_from,
                                               broadcast_object, pmean_along,
                                               pmean_grads, psum_along,
                                               shard_batch)
    from rtdm_tpu_torch.parallel.shard import spatial_shard_conv
    world, rank = mesh.size, mesh.rank
    out = {}
    x = torch.arange(4, dtype=torch.float32) + 4 * rank
    out["psum"] = psum_along(x, mesh)
    out["pmean"] = pmean_along(x, mesh)
    out["pmean_tree"] = pmean_grads({"a": x, "b": [2 * x]}, mesh)["b"][0]
    out["gather"] = all_gather_along(x, mesh)
    out["gather_axis1"] = all_gather_along(x.view(2, 2), mesh, axis=1)
    out["bcast"] = broadcast_from(x, mesh, src=world - 1)
    out["object"] = np.array(broadcast_object(f"rank {rank}", mesh))
    out["shard"] = shard_batch(np.arange(12 * world).reshape(4 * world, 3),
                               mesh)
    w = torch.ones(4, requires_grad=True)
    (psum_along(x * w, mesh) * (rank + 1)).sum().backward()
    out["psum_grad"] = w.grad

    smesh = create_mesh((world,), ("spatial",), "cpu")
    xs, kernels = spatial_inputs()
    rows = 64 // world
    local = torch.from_numpy(xs[:, rank * rows:(rank + 1) * rows].copy())
    for i, k in enumerate(kernels):
        y = spatial_shard_conv(local, oihw(k), smesh)
        out[f"spatial_{i}"] = all_gather_along(y, smesh, "spatial", axis=1)

    frames = engine_frames()
    for quant in ("fp32", "int8"):
        out[f"engine_{quant}"] = port_engine(quant, ENGINE_BATCH, mesh)(
            frames)
    try:
        port_engine("fp32", 4 * world + 1, mesh)
        out["divide"] = np.array("")
    except ValueError as e:
        out["divide"] = np.array(str(e))
    if opts.get("engine_dir"):
        from rtdm_tpu_torch.export.engine import Engine
        out["engine_load"] = Engine.load(opts["engine_dir"], device="cpu",
                                         mesh=mesh)(frames)
    for name in opts.get("detectors", ()):
        from rtdm_tpu_torch.export.detector import load_detector
        det = load_detector(str(ENGINES / name), device="cpu",
                            batch_size=DETECT_BATCH, mesh=mesh)
        frames416 = detector_frames()
        out[f"det_{name}"], out[f"count_{name}"] = det(frames416)
        out[f"pred_{name}"] = det.predictions(frames416)
    return out


def job_train(mesh, work, opts):
    """The classifier's data-parallel step: the golden cases, the draws,
    the shard_map form, the BatchNorm control, the elastic leg and (at
    ``opts['aider']``) the aider_train CLI."""
    import chip_smoke
    from rtdm_tpu_torch.models import layers
    out = {}
    golden = chip_smoke._train_golden()
    for case in opts.get("cases", ()):
        metrics, final = chip_smoke.golden_train_case(golden, case, "cpu",
                                                      mesh=mesh)
        out.update({f"{case}/{k}": v for k, v in metrics.items()})
        out.update({f"{case}/final/{k}": v for k, v in final.items()})
    out.update({f"draws/{k}": v for k, v in draw_run(mesh).items()})
    out["gspmd/loss"], flat = gspmd_step(mesh)
    out.update({f"gspmd/{k}": v for k, v in flat.items()})
    out["shard_map/loss"], flat = shard_map_step(mesh)
    out.update({f"shard_map/{k}": v for k, v in flat.items()})
    out["local_bn/loss"], flat = gspmd_step(mesh, sync_bn=False)
    out.update({f"local_bn/{k}": v for k, v in flat.items()})
    if opts.get("mesh_shape"):
        from rtdm_tpu_torch.core.config import TrainingConfig
        grid = TrainingConfig(mesh_shape=tuple(opts["mesh_shape"]),
                              device="cpu").mesh()
        out["grid_lines"] = np.array([grid.lines[a]
                                      for a in grid.axis_names])
        out["grid/loss"], flat = gspmd_step(grid)
        out.update({f"grid/{k}": v for k, v in flat.items()})

    # the control: BatchNorm's statistics all-reduced by a plain
    # dist.all_reduce, which carries no gradient
    import torch.distributed as dist

    def plain_pmean(t, mesh, axis_name="data"):
        t = t.clone()
        dist.all_reduce(t, group=mesh.groups[axis_name])
        return t / mesh.shape[axis_name]

    saved = layers.pmean_along
    layers.pmean_along = plain_pmean
    try:
        metrics, final = chip_smoke.golden_train_case(golden, "a", "cpu",
                                                      mesh=mesh)
    finally:
        layers.pmean_along = saved
    out.update({f"control/{k}": v for k, v in metrics.items()})
    out.update({f"control/final/{k}": v for k, v in final.items()})

    pre, cont, step = chip_smoke.elastic_leg(
        mesh, opts["elastic_dir"], opts["restore"], "cpu", ELASTIC_BATCH)
    out.update({"elastic/pre": pre, "elastic/cont": cont,
                "elastic/step": step})
    if opts.get("aider"):
        from rtdm_tpu_torch.cli.aider_train import train_model
        config = aider_config(Path(opts["aider"]), Path(work) / "aider")
        _, history = train_model(config)
        out.update({f"aider/{k}": np.array(v) for k, v in history.items()})
        out["aider/weights"] = np.array(config.weights)
    return out


def job_yolo(mesh, work, opts):
    """The detector's data-parallel step (cases a and b, and the control)
    and the yolo_train CLI with --sync-bn."""
    import chip_smoke
    out = {}
    rank_work = Path(work) / f"rank{mesh.rank}"
    for case, run in yolo_dp_runs(mesh, rank_work).items():
        out.update(chip_smoke.flat_yolo_run(run, f"{case}/"))
    if opts.get("control"):
        for case, run in yolo_dp_runs(mesh, rank_work,
                                      control=True).items():
            out.update(chip_smoke.flat_yolo_run(run, f"control_{case}/"))
    if opts.get("cli"):
        from rtdm_tpu_torch.cli import yolo_train
        cfg, weights, data = opts["cli"]
        res = yolo_train.train(yolo_train.parse_args(yolo_argv(
            cfg, weights, data, Path(work) / "cli", "--sync-bn")))
        out["cli/history_loss"] = np.array([h["loss"]
                                            for h in res["history"]])
        out["cli/last_loss"] = np.array(res["last_loss"])
        out["cli/map50"] = np.array(res["last_eval"]["map50"])
        out.update({f"accumulate/{k}": v for k, v in yolo_accumulate_run(
            cfg, weights, data, Path(work) / "accumulate").items()})
    return out


JOBS = {"infer": job_infer, "train": job_train, "yolo": job_yolo}


def _init_modes(mode, rank, world, store):
    """distributed_init as a user would call it: explicit arguments, JAX's
    variables or torchrun's (``store`` here a host:port)."""
    from rtdm_tpu_torch.core.mesh import distributed_init
    if mode == "init_args":
        return distributed_init(store, world, rank, device="cpu")
    if mode == "init_env":
        os.environ.update(JAX_COORDINATOR_ADDRESS=store,
                          NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
    else:
        host, port = store.rsplit(":", 1)
        os.environ.update(MASTER_ADDR=host, MASTER_PORT=port,
                          WORLD_SIZE=str(world), RANK=str(rank))
    return distributed_init(device="cpu")


def main(argv):
    job, rank, world, store, work, opts = argv
    rank, world, opts = int(rank), int(world), json.loads(opts)
    torch.set_num_threads(THREADS)
    import torch.distributed as dist

    from rtdm_tpu_torch.core.mesh import distributed_init, local_mesh
    if job.startswith("init_"):
        joined = _init_modes(job, rank, world, store)
        mesh = local_mesh(device="cpu")
        from rtdm_tpu_torch.parallel.comms import psum_along
        total = psum_along(torch.tensor([float(rank + 1)]), mesh)
        out = {"joined": np.array(joined), "world": np.array(mesh.size),
               "rank": np.array(mesh.rank), "psum": _np(total)}
    else:
        distributed_init(init_method=store, num_processes=world,
                         process_id=rank, device="cpu")
        mesh = local_mesh(device="cpu")
        out = {k: _np(v) for k, v in JOBS[job](mesh, work, opts).items()}
    np.savez(Path(work) / f"{job}.{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
