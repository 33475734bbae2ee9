"""repro_torch.kernels — hand-written CUDA kernels, their wrappers and
their plain torch versions (``ref.py``)."""
