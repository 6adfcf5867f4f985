"""The port's command-line entry points, run as ``python3 -m occformer_tpu_torch.tools.<name>``."""
