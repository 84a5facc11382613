"""Inference routes of the PyTorch port."""
