"""nr3d_lib_tpu_torch — the PyTorch/CUDA port of nr3d_lib_tpu.

Same module layout and names as the JAX package; plain tensor code is
PyTorch and every Pallas kernel on a ported path is a CUDA kernel written
for Hopper (`csrc/`, built at first use by `ops/_build.py`).

Entry points run on CUDA unless the caller passes `device="cpu"`. Kernel
wrappers pick their route by the device of their input tensor: a CPU tensor
takes the plain PyTorch version, a CUDA tensor launches the kernel or
raises.
"""

from nr3d_lib_tpu_torch.device import resolve_device  # noqa: F401
