"""repro_torch — the PyTorch/CUDA port of the Threadle engine.

The package mirrors ``src/repro/`` module for module (``core/...``,
``kernels/...``) and runs on an NVIDIA H100: plain tensor code is
PyTorch, and each Pallas kernel of the JAX package on the ported path is
a hand-written CUDA kernel (``csrc/``), built with ``nvcc`` on first use.
The JAX package stays the reference the port is tested against; this
package imports neither it nor JAX.
"""
