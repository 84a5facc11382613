"""Networks of the PyTorch port (NCHW nn.Modules)."""
