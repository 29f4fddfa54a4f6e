"""The benchmark of the PyTorch/CUDA port (`magi_tpu_torch`): see README.md."""
