"""The seven unsupervised losses and their weighted total, in PyTorch."""
