"""occformer_tpu_torch: the PyTorch/CUDA port of occformer_tpu.

It mirrors the JAX package's layout (``ops/``, ``models/``, ``engine/``,
``configs/``) module for module, keeps its public layouts (images
``[B, N, H, W, 3]``, channels-last volumes ``[B, X, Y, Z, C]``, ``(x, y, z)``
coordinates) and the reference checkpoints' state-dict key space.  Every
Pallas kernel of the JAX package is a hand-written CUDA kernel under
``csrc/`` (K1-K4 with their backwards, the probe's P1 and P2), each with a
plain PyTorch version beside its wrapper in ``ops/``; everything else is
plain PyTorch.  ``tools/`` holds the train and test CLIs and the viability
probe.

Entry points run on ``cuda`` unless the caller asks for the CPU.  The port
imports nothing of ``occformer_tpu`` or JAX.
"""

__version__ = "0.1.0"
