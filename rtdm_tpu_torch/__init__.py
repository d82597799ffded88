"""rtdm_tpu_torch — the classifier and detector engines of ``rtdm_tpu`` in
PyTorch and CUDA for an NVIDIA H100.

A package beside ``rtdm_tpu``, which stays the reference: it imports
``torch``, numpy and PIL, never JAX and nothing of ``rtdm_tpu``. Module
names mirror ``rtdm_tpu``'s. Public functions keep its layout (NHWC in,
NHWC or (N, classes) out); the ACFF block runs as a hand-written CUDA
kernel (``csrc/acff.cu``), and JPEGs decode through the host library
``csrc/rtdm_io.cpp`` (``data/native_io.py``). Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
