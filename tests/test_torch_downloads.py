"""``utils/downloads.py::attempt_download`` and its use in
``export/detector.py::load_detection_model``, beside the JAX function.

The port keeps the JAX behaviour except the basename search: a missing
path whose basename lies in ``weights/`` (or any search directory) is not
replaced by that file. No test reaches the network: every download goes
to a stand-in for ``urllib.request.urlretrieve``.
"""

import os
import urllib.request

import pytest

from rtdm_tpu_torch.export.detector import load_detection_model
from rtdm_tpu_torch.utils.downloads import (KNOWN_WEIGHTS, attempt_download,
                                            mirror_url)


@pytest.fixture()
def offline(monkeypatch, tmp_path):
    """No download allowed, cwd a fresh directory, and a urlretrieve that
    fails the test if reached."""
    monkeypatch.delenv("RTDM_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.chdir(tmp_path)

    def refuse(*args, **kwargs):
        raise AssertionError(f"network reached: {args}")
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    return tmp_path


def test_existing_and_empty_paths_are_returned(offline):
    path = offline / "yolov3.weights"
    path.write_bytes(b"w")
    assert attempt_download(str(path)) == str(path)
    assert attempt_download("") == ""
    assert attempt_download(None) is None


def test_no_basename_substitution(offline):
    """A file of the same name in weights/ is not loaded in place of the
    missing path, as the JAX function does."""
    from rtdm_tpu.utils.downloads import attempt_download as jax_attempt
    (offline / "weights").mkdir()
    for name in ("yolov3.pt", "mine.npz"):
        (offline / "weights" / name).write_bytes(b"other weights")
    assert jax_attempt("typo/mine.npz") == os.path.join("weights",
                                                        "mine.npz")
    assert attempt_download("typo/mine.npz") == "typo/mine.npz"
    assert jax_attempt("typo/yolov3.pt") == os.path.join("weights",
                                                         "yolov3.pt")
    with pytest.raises(FileNotFoundError, match="1SHNFyoe5Ni8DajDNEqgB2oV"):
        attempt_download("typo/yolov3.pt")


def test_missing_known_name_names_its_mirror(offline):
    with pytest.raises(FileNotFoundError,
                       match="pjreddie.com/media/files/yolov3-tiny.weights"):
        attempt_download(str(offline / "w" / "yolov3-tiny.weights"))
    unknown = str(offline / "w" / "detector.npz")
    assert attempt_download(unknown) == unknown


@pytest.mark.parametrize("name", ["darknet53.conv.74", "yolov3-spp.pt"])
def test_allowed_download_goes_to_the_requested_path(monkeypatch, offline,
                                                     name):
    calls = []

    def fetch(url, path):
        calls.append((url, path))
        with open(path, "wb") as f:
            f.write(b"fetched")
    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    monkeypatch.setenv("RTDM_ALLOW_DOWNLOAD", "1")
    want = str(offline / "new" / "dir" / name)
    assert attempt_download(want) == want
    assert calls == [(mirror_url(KNOWN_WEIGHTS[name]), want)]
    assert open(want, "rb").read() == b"fetched"
    if name.endswith(".pt"):
        assert calls[0][0].startswith("https://drive.google.com/uc?")


def test_load_detection_model_resolves_weights_first(monkeypatch, offline):
    with pytest.raises(FileNotFoundError, match="pjreddie"):
        load_detection_model("any.cfg", str(offline / "yolov3.weights"),
                             416)
    seen = []

    def fetch(url, path):
        seen.append(path)
        raise ConnectionError("stand-in")
    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    monkeypatch.setenv("RTDM_ALLOW_DOWNLOAD", "1")
    with pytest.raises(ConnectionError, match="stand-in"):
        load_detection_model("any.yaml", str(offline / "yolov3.pt"), 416)
    assert seen == [str(offline / "yolov3.pt")]
    # an unknown missing name reaches the loader's own error
    monkeypatch.delenv("RTDM_ALLOW_DOWNLOAD")
    cfg = offline / "tiny.cfg"
    cfg.write_text("[net]\nwidth=32\nheight=32\nchannels=3\n\n"
                   "[convolutional]\nbatch_normalize=1\nfilters=8\nsize=3\n"
                   "stride=1\npad=1\nactivation=leaky\n")
    with pytest.raises(FileNotFoundError):
        load_detection_model(str(cfg), str(offline / "missing.npz"), 32)
