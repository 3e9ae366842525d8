"""phaneron_tpu_torch — the PyTorch + CUDA port of phaneron_tpu.

The channel frame program (v210 / planar 4:2:2 unpack, axis-aligned DVE
warp, dissolve, 'over' composite, v210 pack) runs on an NVIDIA Hopper
GPU through hand-written CUDA kernels (``csrc/``), each with a plain
PyTorch version beside it.  A kernel wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises.

Importing the package builds nothing: the kernels compile with ``nvcc``
at first use into ``build/kernels/`` (ops/_build.py).
"""
