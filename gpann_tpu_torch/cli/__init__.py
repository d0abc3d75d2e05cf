"""Command-line drivers of the PyTorch port (counterpart of ``gpann_tpu/cli``)."""
