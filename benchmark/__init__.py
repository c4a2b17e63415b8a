"""The benchmark of the PyTorch port (`mofanerf_tpu_torch`): see README.md."""
