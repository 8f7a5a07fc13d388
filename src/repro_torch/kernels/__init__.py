"""Hand-written Hopper (sm_90a) kernels of the port and their dispatch.

One module per kernel, each holding the wrapper that launches
``csrc/<name>.cu`` on CUDA tensors, the plain PyTorch version that CPU
tensors run, a launch counter (``launches``) and a note on the TPU kernel it
replaces. ``ops.py`` is the public API; ``build.py`` compiles the sources
with ``nvcc`` at first use and loads them with ``ctypes``.

Kernels (the partitioner's main path):
  * ``match_keys`` — jittered masked arc keys of device heavy-edge matching.
  * ``bucket_assign`` — capacity-boundary bucket search of the device
    initial partition.
  * ``quotient_link_loads`` — the paper's objective: arc list -> per-link
    communication load.
  * ``partition_gain`` — the dense refinement round's ``[n, k]``
    connectivity rows (ELL).
"""
