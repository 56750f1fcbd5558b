"""Kernels of the PyTorch port: the scan engine and its families."""
