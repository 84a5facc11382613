"""Command-line tools of the PyTorch port (``python -m retinex_tpu_torch.scripts.<name>``)."""
