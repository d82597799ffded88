"""The port's ``aider_predict`` CLI picks the same class as the JAX CLI, at
fp32, bf16 and int8."""

import pytest

from rtdm_tpu.cli import aider_predict as jax_cli
from rtdm_tpu_torch.cli import aider_predict as port_cli

ENGINE = "artifacts/engines/squeeze-ernet_bf16"
IMAGES = ["docs/examples/fire_image0232.jpg",
          "docs/examples/flood_image0205.jpg"]


@pytest.mark.parametrize("image", IMAGES)
def test_engine_prediction_matches_jax_cli(image, capsys):
    want = jax_cli.main(["--image", image, "--weights",
                         f"{ENGINE}/params.npz", "--model", "squeeze-ernet",
                         "--quant", "bf16"])
    got = port_cli.main(["--image", image, "--engine", ENGINE,
                         "--device", "cpu"])
    assert got == want
    out = capsys.readouterr().out
    assert "prediction:" in out and "on cpu" in out


def test_weights_paths_match_jax_cli(capsys):
    image = IMAGES[0]
    want = jax_cli.main(["--image", image, "--weights",
                         f"{ENGINE}/params.npz", "--model", "squeeze-ernet"])
    for extra in ([], ["--quant", "fp32"]):
        got = port_cli.main(["--image", image, "--weights",
                             f"{ENGINE}/params.npz", "--model",
                             "squeeze-ernet", "--device", "cpu", *extra])
        assert got == want


def test_quant_must_match_engine():
    with pytest.raises(SystemExit):
        port_cli.main(["--image", IMAGES[0], "--engine", ENGINE,
                       "--quant", "fp32", "--device", "cpu"])


@pytest.mark.parametrize("image", IMAGES)
def test_int8_weights_path_matches_jax_cli(image):
    """--weights --quant int8 calibrates on the image repeated 8 times in
    both CLIs and picks the same class."""
    args = ["--image", image, "--weights", f"{ENGINE}/params.npz",
            "--model", "squeeze-ernet", "--quant", "int8"]
    want = jax_cli.main(args)
    assert port_cli.main([*args, "--device", "cpu"]) == want


def test_int8_engine_dir_predicts_the_jax_golden_class():
    """--engine on a committed int8 directory picks the class of the JAX
    int8 engine's logits for that image (the int8 golden)."""
    import numpy as np

    from tests.torch_port_goldens import GOLDEN_INT8
    with np.load(GOLDEN_INT8) as g:
        names, logits = list(g["names"]), g["squeeze-ernet"]
    for image in IMAGES:
        want = int(logits[names.index(image.split("/")[-1])].argmax())
        got = port_cli.main(["--image", image, "--engine",
                             "artifacts/engines/squeeze-ernet_int8",
                             "--quant", "int8", "--device", "cpu"])
        assert got == want
