"""occformer_tpu_torch: the PyTorch/CUDA port of occformer_tpu.

It mirrors the JAX package's layout (``ops/``, ``models/``, ``engine/``,
``configs/``) module for module, keeps its public layouts (images
``[B, N, H, W, 3]``, channels-last volumes ``[B, X, Y, Z, C]``, ``(x, y, z)``
coordinates) and the reference checkpoints' state-dict key space.  The
deformable-attention gather runs as a hand-written CUDA kernel
(``csrc/ms_deform_gather3d.cu``); everything else is plain PyTorch.

Entry points run on ``cuda`` unless the caller asks for the CPU.  The port
imports nothing of ``occformer_tpu`` or JAX.
"""

__version__ = "0.1.0"
