"""Core simulator layers of the PyTorch port."""
