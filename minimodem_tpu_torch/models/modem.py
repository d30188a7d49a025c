"""High-level modem API: the library-facing counterpart of the CLI.

    >>> m = FskModem("1200")             # device="cuda"; "cpu" for the CPU
    >>> wav = m.modulate(b"hello world\\n")
    >>> m.demodulate(wav)
    b'hello world\\n'
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np

from ..codecs import get_codec
from ..config import RxOptions, TxOptions
from ..ops.tx import Transmitter
from ..sigio import SampleFormat
from ..utils import device as _device
from .presets import PRESETS, Preset, bell_like


class FskModem:
    def __init__(self, mode: str = "1200", sample_rate: int = 48000,
                 rx_options: Optional[RxOptions] = None,
                 tx_options: Optional[TxOptions] = None,
                 sample_format: SampleFormat = SampleFormat.FLOAT,
                 precision: str = "auto", usos: bool = True,
                 device=_device.DEFAULT):
        factory = PRESETS.get(str(mode).lower())
        if factory is not None:
            preset: Preset = factory(sample_rate=sample_rate)
        else:
            preset = bell_like(float(mode), sample_rate)
        self.preset = preset
        self.cfg = preset.cfg
        self.rx_options = rx_options or RxOptions(precision=precision)
        self.tx_options = tx_options or TxOptions()
        self.sample_format = sample_format
        self.precision = precision
        self.usos = usos                 # baudot unshift-on-space (-u)
        self.device = device             # demodulate(), "jax" synthesis

    # ------------------------------------------------------------------
    def modulate(self, data: bytes, synth_backend: str = "numpy") -> np.ndarray:
        """Encode bytes to FSK audio samples (synth_backend "jax": the
        device synthesis on self.device, the same samples)."""
        if not self.preset.tx_supported:
            raise NotImplementedError(
                f"{self.preset.decoder} --tx mode is not supported")
        kw = {"usos": self.usos} if self.preset.encoder == "baudot" else {}
        encoder = get_codec(self.preset.encoder, **kw)
        txer = Transmitter(self.cfg, self.tx_options, encoder,
                           self.sample_format, synth_backend, self.device)
        for b in data:
            txer.send(b)
        txer.finish()
        return txer.drain(None)

    # ------------------------------------------------------------------
    def demodulate(self, samples: np.ndarray, return_events: bool = False,
                   in_encoding: str = None, wire_pack="auto"):
        """Decode FSK audio samples to bytes on self.device.

        in_encoding: raw-u8 wire encoding ("ulaw"/"alaw"/"pcm8") when
        `samples` holds unexpanded bytes — the device expands them
        (1 byte/sample over the host link, bit-identical values).

        wire_pack: "auto"/True/False — the delta-bitpack wire for int16
        samples (Receiver.run)."""
        from ..rx.engine import Receiver

        # int16 passes through raw: the device normalizes it
        if in_encoding is None and samples.dtype != np.int16:
            samples = np.asarray(samples, np.float32)

        codec = get_codec(self.preset.decoder, **(
            {"usos": self.usos} if self.preset.decoder == "baudot" else {}))
        sink = io.BytesIO()
        events: list[str] = []
        rxer = Receiver(self.cfg, self.rx_options, codec,
                        sink.write, events.append, device=self.device)
        rxer.run(samples, in_encoding=in_encoding, wire_pack=wire_pack)
        if return_events:
            return sink.getvalue(), events
        return sink.getvalue()
