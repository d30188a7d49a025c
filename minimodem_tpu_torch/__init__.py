"""minimodem_tpu_torch: the PyTorch + CUDA port of minimodem_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs.  It keeps the
JAX package's module paths so each module's counterpart is easy to find;
the jax-free host modules (config, codecs, sigio, native, ops/tx.py) are
carried as copies.  Every TPU kernel on the receive path is a hand-written
CUDA kernel here (csrc/), with a plain PyTorch version beside it that runs
when the tensors lie on the CPU.

Layers:
- cli / models   : command-line driver, baudmode presets, FskModem API
- codecs         : databits byte<->frame codecs (ascii/baudot/binary/cid/uic)
- ops            : TX synthesis (host) + RX scoring and state machine (torch/CUDA)
- rx             : event rendering (codecs + protocol lines)
- sigio          : audio stream abstraction + WAV/AU/RAW codec
- parallel       : the fleet service on torch.distributed: a (dp, sp)
                   device mesh, sharded scoring and the sharded receivers
"""

__version__ = "0.1.0"

from .config import ModemConfig, RxOptions, TxOptions  # noqa: E402,F401


def __getattr__(name):
    # lazy: importing FskModem pulls in torch and the ops stack
    if name == "FskModem":
        from .models.modem import FskModem
        return FskModem
    raise AttributeError(name)
