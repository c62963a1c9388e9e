"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
importing nothing of the port."""
