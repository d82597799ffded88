"""The port's multi-device layer against the JAX package's 8-device mesh.

gloo groups of 2 and 4 CPU processes (``tests/torch_parallel_jobs.py``,
each group one spawned job) against JAX's virtual 8-device CPU mesh, run
in this process, and against the port in one process:

- ``core/mesh.py`` and ``parallel/comms.py``: all-reduce sum and mean (and
  the gradient of the sum), the tiled all-gather, the broadcast, the rank's
  rows of a batch, at world sizes 2 and 4 (counterparts of
  ``tests/test_parallel.py``'s comms tests); the mesh's refusals;
  ``distributed_init`` in two processes from explicit arguments, JAX's
  variables and torchrun's.
- ``parallel/shard.py::spatial_shard_conv``: the halo-exchange conv at 2 and
  4 ranks against the port's plain conv and JAX's on the 8-way ``spatial``
  mesh (rtol / atol 2e-5), with 1-row, 1xk, kx1 and 5x3 kernels.
- ``Engine(mesh=)`` fp32 and int8 at batch 16 (and ``Engine.load(mesh=)``)
  against the one-process engine (rtol 1e-5, atol 1e-6) and JAX's mesh
  engine; a batch that does not divide raises.
- ``load_detector(mesh=)`` with both committed int8 detectors at batch 16
  against one process, by ``eval/detection.py::meets_strict``.
- ``evaluate_classification --data-parallel`` without a launcher (one
  rank) equals the run without the flag.
"""

import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_parallel_jobs as J

WORLDS = (2, 4)
DETECTORS = ("yolov4-tiny-mini_int8", "yolov5s-mini_int8")
# the port's one-process engine against JAX's mesh engine on the same
# weights and frames (probabilities): the two differ by the order of conv
# sums, as the mesh and the one-process engine do
JAX_ENGINE_TOL = {"fp32": (1e-5, 1e-6), "int8": (1e-5, 1e-6)}


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The groups, started before the references are computed here."""
    work = tmp_path_factory.mktemp("parallel")
    J.port_engine("bf16", J.ENGINE_BATCH).save(str(work / "engine"))
    groups = {w: J.start_group(
        "infer", w, work / f"w{w}", engine_dir=str(work / "engine"),
        detectors=list(DETECTORS) if w == 2 else []) for w in WORLDS}
    return work, groups


@pytest.fixture(scope="module")
def one_process(started):
    """The port in one process and JAX on its 8-device mesh, on the jobs'
    inputs."""
    from rtdm_tpu.core.mesh import create_mesh
    from rtdm_tpu.export.engine import Engine as JaxEngine
    from rtdm_tpu.export.engine import EngineSpec as JaxSpec
    from rtdm_tpu.models.io import load_variables as jax_load
    from rtdm_tpu.parallel.shard import spatial_shard_conv as jax_spatial

    from rtdm_tpu_torch.export.detector import load_detector
    from rtdm_tpu_torch.export.engine import Engine
    from rtdm_tpu_torch.ops.convpool import conv2d
    work, _ = started
    torch.set_num_threads(2)
    ref = {}
    x, kernels = J.spatial_inputs()
    smesh = create_mesh((8,), ("spatial",))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(smesh,
                                                      P(None, "spatial")))
    for i, k in enumerate(kernels):
        ref[f"spatial_{i}"] = conv2d(torch.from_numpy(x), J.oihw(k), None,
                                     1, (k.shape[0] // 2,
                                         k.shape[1] // 2)).numpy()
        ref[f"jax_spatial_{i}"] = np.asarray(jax_spatial(xs, jnp.asarray(k),
                                                         smesh))
    frames = J.engine_frames()
    mesh8 = create_mesh((8,), ("data",))
    for quant in ("fp32", "int8"):
        ref[f"engine_{quant}"] = J.port_engine(quant, J.ENGINE_BATCH)(frames)
        name = "squeeze-ernet_int8" if quant == "int8" else \
            "squeeze-ernet_bf16"
        scales = None
        if quant == "int8":
            with np.load(J.ENGINES / name / "act_scales.npz") as z:
                scales = dict(z)
        ref[f"jax_engine_{quant}"] = JaxEngine(
            JaxSpec(model="squeeze-ernet", quant=quant,
                    batch_size=J.ENGINE_BATCH, image_size=140),
            jax_load(str(J.ENGINES / name / "params.npz")), scales,
            mesh=mesh8)(frames)
    ref["engine_load"] = Engine.load(str(work / "engine"),
                                     device="cpu")(frames)
    for name in DETECTORS:
        det = load_detector(str(J.ENGINES / name), device="cpu",
                            batch_size=J.DETECT_BATCH)
        frames416 = J.detector_frames()
        ref[f"det_{name}"], ref[f"count_{name}"] = det(frames416)
        ref[f"pred_{name}"] = det.predictions(frames416)
        ref[f"conf_{name}"] = det.spec.conf_thres
        ref[f"iou_{name}"] = det.spec.iou_thres
    return ref


@pytest.fixture(scope="module")
def ranks(started, one_process):
    _, groups = started
    return {w: g.results() for w, g in groups.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_comms(ranks, world):
    """psum, pmean, all-gather (tiled, along axis 0 and 1), broadcast from
    the last rank, the rank's rows, the gradient of a psum (every rank's
    cotangent summed), on every rank."""
    xs = [np.arange(4, dtype=np.float32) + 4 * r for r in range(world)]
    total = np.sum(xs, 0)
    for rank, res in enumerate(ranks[world]):
        np.testing.assert_array_equal(res["psum"], total)
        np.testing.assert_allclose(res["pmean"], total / world, rtol=1e-7)
        np.testing.assert_allclose(res["pmean_tree"], 2 * total / world,
                                   rtol=1e-7)
        np.testing.assert_array_equal(res["gather"], np.concatenate(xs))
        np.testing.assert_array_equal(
            res["gather_axis1"],
            np.concatenate([x.reshape(2, 2) for x in xs], 1))
        np.testing.assert_array_equal(res["bcast"], xs[-1])
        assert str(res["object"]) == "rank 0"
        np.testing.assert_array_equal(
            res["shard"], np.arange(12 * world).reshape(4 * world, 3)[
                4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(
            res["psum_grad"], xs[rank] * sum(range(1, world + 1)))


@pytest.mark.parametrize("index", range(len(J.SPATIAL_KERNELS)),
                         ids=[f"k{kh}x{kw}" for kh, kw, _ in
                              J.SPATIAL_KERNELS])
@pytest.mark.parametrize("world", WORLDS)
def test_spatial_shard_conv(ranks, one_process, world, index):
    want = one_process[f"spatial_{index}"]
    for res in ranks[world]:
        got = res[f"spatial_{index}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, one_process[f"jax_spatial_{index}"],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("quant", ["fp32", "int8"])
@pytest.mark.parametrize("world", WORLDS)
def test_engine_matches_one_process_and_jax_mesh(ranks, one_process, world,
                                                 quant):
    want = one_process[f"engine_{quant}"]
    for res in ranks[world]:
        np.testing.assert_allclose(res[f"engine_{quant}"], want, rtol=1e-5,
                                   atol=1e-6)
    rtol, atol = JAX_ENGINE_TOL[quant]
    np.testing.assert_allclose(want, one_process[f"jax_engine_{quant}"],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(ranks[world][0][f"engine_{quant}"],
                               one_process[f"jax_engine_{quant}"],
                               rtol=max(rtol, 1e-5), atol=max(atol, 1e-6))


@pytest.mark.parametrize("world", WORLDS)
def test_engine_load_with_a_mesh(ranks, one_process, world):
    for res in ranks[world]:
        np.testing.assert_allclose(res["engine_load"],
                                   one_process["engine_load"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_engine_batch_must_divide(ranks, world):
    for res in ranks[world]:
        msg = str(res["divide"])
        assert f"engine batch {4 * world + 1} must divide over the " \
               f"{world}-way 'data' mesh axis" == msg


@pytest.mark.parametrize("name", DETECTORS)
def test_detector_matches_one_process(ranks, one_process, name):
    from rtdm_tpu_torch.eval.detection import (candidates,
                                               compare_detections,
                                               meets_strict, summary)
    conf = one_process[f"conf_{name}"]
    for res in ranks[2]:
        rep = compare_detections(
            one_process[f"det_{name}"], one_process[f"count_{name}"],
            res[f"det_{name}"], res[f"count_{name}"], conf,
            one_process[f"iou_{name}"],
            candidates(one_process[f"pred_{name}"], conf),
            candidates(res[f"pred_{name}"], conf))
        assert meets_strict(rep), summary(rep)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["args", "env", "torchrun"])
def test_distributed_init_two_process(tmp_path, mode):
    """Two processes join from explicit arguments, JAX's variables or
    torchrun's, and a psum crosses them (tests/test_parallel.py's
    counterpart)."""
    group = J.start_group(f"init_{mode}", 2, tmp_path,
                          store=f"127.0.0.1:{_free_port()}")
    for rank, res in enumerate(group.results()):
        assert bool(res["joined"]) and int(res["world"]) == 2
        assert int(res["rank"]) == rank
        np.testing.assert_array_equal(res["psum"], [3.0])


def test_mesh_without_a_group(monkeypatch):
    """One process and no launcher: a world-size-1 mesh; every collective
    is the identity; a launcher's larger world that was not joined, a
    coordinator without a count, and a shape that is not the world raise."""
    from rtdm_tpu_torch.core.mesh import (create_mesh, data_sharding,
                                          distributed_init, local_mesh,
                                          replicated)
    from rtdm_tpu_torch.parallel.comms import all_gather_along, psum_along
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "NUM_PROCESSES",
                 "PROCESS_ID", "JAX_COORDINATOR_ADDRESS",
                 "COORDINATOR_ADDRESS", "SLURM_JOB_NUM_NODES"):
        monkeypatch.delenv(name, raising=False)
    assert distributed_init(device="cpu") is False
    mesh = local_mesh(device="cpu")
    assert mesh.size == 1 and mesh.shape == {"data": 1}
    assert mesh.device == torch.device("cpu")
    x = torch.arange(6.0).view(3, 2)
    assert psum_along(x, mesh) is x and all_gather_along(x, mesh) is x
    assert data_sharding(mesh).rows(6) == slice(0, 6)
    assert replicated(mesh)(x) is not None
    with pytest.raises(ValueError, match="#devices"):
        create_mesh((2,), device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        distributed_init("127.0.0.1:1", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            local_mesh()        # the card unless the CPU is asked for
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="distributed_init"):
        local_mesh(device="cpu")


def test_a_failed_init_raises(tmp_path):
    """No quiet fall back to one process: a group that cannot form raises
    and leaves no group behind."""
    import torch.distributed as dist

    from rtdm_tpu_torch.core.mesh import distributed_init
    with pytest.raises(RuntimeError, match="rank < size"):
        distributed_init(init_method=f"file://{tmp_path / 'store'}",
                         num_processes=2, process_id=5, device="cpu")
    assert not dist.is_initialized()


def test_row_shards():
    from rtdm_tpu_torch.core.mesh import RowShard
    assert [RowShard(i, 4).rows(16) for i in range(4)] == [
        slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
    with pytest.raises(ValueError, match="does not split"):
        RowShard(0, 4).rows(10)


def test_evaluate_cli_data_parallel_is_one_rank_without_a_launcher(
        tmp_path, monkeypatch):
    from rtdm_tpu_torch.cli import evaluate_classification as eval_cli
    from tests.torch_port_goldens import params_path
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    data = J.write_hue_set(tmp_path / "hue", n_train=0, n_eval=8)
    argv = ["--weights", params_path("squeeze-ernet"), "--precision",
            "fp32", "--root-dir", str(data), "--test-split",
            str(data / "test.csv"), "--batch-size", "4", "--num-workers",
            "2", "--device", "cpu"]
    plain = eval_cli.main(argv)
    dp = eval_cli.main(argv + ["--data-parallel"])
    np.testing.assert_array_equal(dp.confusion, plain.confusion)
    assert dp.total == plain.total == 8
