"""phaneron_tpu_torch — the PyTorch + CUDA port of phaneron_tpu.

The channel frame program (graph/pipeline.py: every source format's
unpack, deinterlace, DVE warps and rotations, dissolves and wipes, the
'over' composite, every output format's pack) runs on an NVIDIA Hopper
GPU through hand-written CUDA kernels (``csrc/``), each with a plain
PyTorch version beside it.  A kernel wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises.  The
runtime above it (runtime/channel.py and its layers, producers,
consumers and audio) ticks channels through that program, on ``cuda:0``
unless a channel is given the CPU.

Importing the package builds nothing: the kernels compile with ``nvcc``
at first use into ``build/kernels/`` (ops/_build.py).
"""
