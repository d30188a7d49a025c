"""K4, the loopback's synthesis kernel (csrc/tx_synth.cu), on the CPU.

The kernel itself runs only on a card (tests/test_torch_gpu.py holds it
against its plain route there).  Here: its C entries are bound and
defined, the loopback on the CPU takes the plain route (the plain
synthesis called, K4 never launched) and the wrapper refuses tensors that
are not on a CUDA device, so no CPU run can pass through it unnoticed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from minimodem_tpu_torch.codecs import Ascii8Codec
from minimodem_tpu_torch.models.modem import FskModem
from minimodem_tpu_torch.ops import _kernels
from minimodem_tpu_torch.ops import tx_device as T
from minimodem_tpu_torch.ops.device_rx import DeviceLoopback

ENTRIES = ("mm_tx_synth_bits", "mm_tx_synth_frames")
SOURCE = Path(_kernels.SRC_DIR) / "tx_synth.cu"


def _cfg(mode="1200", stopbits=None):
    cfg = FskModem(mode, device="cpu").cfg
    if stopbits is not None:
        cfg.nstopbits = np.float32(stopbits)
        cfg.finalize()
    return cfg


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_is_bound(entry):
    sig = _kernels._SIGNATURES[entry]
    assert sig[-1] is _kernels._P           # the stream, as every entry
    assert _kernels._D in sig               # the float64 phase constants


@pytest.mark.parametrize("entry", ENTRIES)
def test_source_defines_entry(entry):
    src = SOURCE.read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, entry
    # one C parameter a ctypes argtype
    assert len(m.group(1).split(",")) == len(_kernels._SIGNATURES[entry])
    assert "return (int)cudaGetLastError();" in src


def test_source_is_built_with_the_others():
    assert SOURCE in _kernels._sources()
    assert "-fmad=false" in _kernels.NVCC_FLAGS


def _counts():
    return (T.TxSynth.launches, T.TxSynth.frames_launches,
            T.device_synthesize.calls, T.device_synthesize_frames.calls)


def test_cpu_loopback_takes_the_plain_route():
    """A CPU DeviceLoopback batch, flat and frames mode: the plain
    synthesis called, K4 never launched; the buffer is the plain route's
    (zero tail from the schedule's end)."""
    texts = [b"hello K4", b"plain route"]
    before = _counts()
    cfg = _cfg()
    lb = DeviceLoopback(cfg, device="cpu")
    lb.run_events_batch([T.tx_bit_schedule(t, cfg, Ascii8Codec())
                         for t in texts])
    cfg15 = _cfg(stopbits=1.5)
    rows = [T.tx_frame_schedule(t, cfg15, Ascii8Codec()) for t in texts]
    DeviceLoopback(cfg15, device="cpu").run_events_frames_batch(
        [r[0] for r in rows], rows[0][1:])
    after = _counts()
    assert after[:2] == before[:2]
    assert after[2] > before[2] and after[3] > before[3]


def test_cpu_synthesize_is_the_plain_route():
    cfg = _cfg()
    lb = DeviceLoopback(cfg, device="cpu")
    loop = lb.build_loop(512)
    packed = torch.from_numpy(np.packbits(np.random.default_rng(1).integers(
        0, 2, (2, 512), dtype=np.uint8), axis=1, bitorder="little"))
    x = loop.synthesize(packed)
    assert x.shape == (2, loop.t_total + lb.halo)
    assert torch.equal(x, loop.synthesize_plain(packed))
    n = 512 * cfg.bit_nsamples_tx
    assert torch.count_nonzero(x[:, n:]) == 0
    bits = ((packed[:, :, None] >> torch.arange(8, dtype=torch.uint8)) & 1)
    assert torch.equal(x[:, :n], T.device_synthesize(bits.reshape(2, 512),
                                                     cfg))


def test_tx_synth_refuses_cpu_tensors():
    cfg = _cfg()
    k4 = T.TxSynth(cfg)
    before = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        k4.bits(torch.zeros((1, 64), dtype=torch.uint8),
                512 * cfg.bit_nsamples_tx)
    with pytest.raises(ValueError, match="CUDA"):
        k4.frames(torch.zeros((1, 4, cfg.n_data_bits), dtype=torch.uint8),
                  torch.zeros(1, dtype=torch.int32), (2, 2), 10 ** 4)
    assert _counts() == before
