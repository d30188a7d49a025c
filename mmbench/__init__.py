"""The benchmark of minimodem_tpu_torch, the PyTorch and CUDA port, on an
NVIDIA H100: one cell (a modem configuration under one traffic mix) run
once per process.  See mmbench/README.md."""
