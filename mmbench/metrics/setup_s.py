"""setup_s: seconds from the process's start to the first timed request:
imports, the CUDA context, the kernel library (built with nvcc on a
checkout's first run, else loaded from minimodem_tpu_torch/build/), the
seeded inputs and the warm-up of every shape the window uses."""


def read(run):
    return run.setup_s
