"""Measurement tools of the PyTorch/CUDA port (run on the card)."""
