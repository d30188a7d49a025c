"""Compute ops: TX synthesis (host) and RX scoring / state machine (PyTorch + CUDA)."""
