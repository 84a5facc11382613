"""Image operators of the PyTorch port: colour, resize, letterbox, CLAHE."""
