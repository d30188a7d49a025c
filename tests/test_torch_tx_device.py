"""Device TX parity: the port's ops/tx_device.py and ops/tx_synth.py
against the JAX package on the CPU.

- The host half of tx_device.py (bit and frame schedules, synthesis
  constants) is a copy: equal outputs.
- device_synthesize / device_synthesize_frames against the JAX functions
  under jax.jit with x64, sample for sample.  The per-sample phase is one
  fused multiply-add in both (XLA contracts it on the CPU; the port rounds
  it once with fma_f32_exact).  Two things stay apart: the sine (the port
  evaluates it in float64 and rounds once, XLA's sinf differs by at most
  one float32 ulp, ~6e-8 on [-1, 1]) and the float64 prefix sums (the
  scan orders differ, so a phase can land on the other side of a float32
  rounding and move one float32 ulp of the turns).  Tolerance: one
  float32 ulp of the largest per-sample turns (a bit's, or a frame
  segment's, phase advance plus 1), times 2pi, plus one ulp of a phase
  and of the sine — 3.6e-6 at Bell-202, 2.8e-5 at tdd's 1056-sample
  bits — and fewer than 3% of samples differ at all.
- The `--synth-backend jax` path (ops/tx_synth.py): LUT output
  bit-identical to the numpy backend and to the JAX backend; direct-sine
  output bit-identical to numpy and within one float32 ulp (S16: one
  step) of the JAX backend, decoding byte-exact.
"""

import numpy as np
import pytest
import torch

from .helpers import _redirect
from minimodem_tpu import cli as jax_cli
from minimodem_tpu.models.modem import FskModem
from minimodem_tpu_torch import cli as torch_cli

TEXT = b"device tx parity \x00\xff 0123456789"
BAUDOT = b"RYRY THE QUICK BROWN FOX 73"
MAX_DIFF_SHARE = 0.03


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _encoders(mode):
    from minimodem_tpu.codecs import get_codec as jcodec
    from minimodem_tpu_torch.codecs import get_codec as tcodec

    m = FskModem(mode)
    if m.preset.encoder == "baudot":
        return m, BAUDOT, jcodec("baudot", usos=True), tcodec("baudot",
                                                              usos=True)
    return m, TEXT, jcodec(m.preset.encoder), tcodec(m.preset.encoder)


@pytest.mark.parametrize("mode", ["1200", "300", "rtty", "tdd", "same",
                                  "callerid"])
def test_schedule_copies_match_jax(mode):
    from minimodem_tpu.ops import tx_device as J
    from minimodem_tpu_torch.ops import tx_device as P

    m, text, jenc, tenc = _encoders(mode)
    cfg = m.cfg
    assert P.uniform_bits_supported(cfg) == J.uniform_bits_supported(cfg)
    if J.uniform_bits_supported(cfg):
        np.testing.assert_array_equal(P.tx_bit_schedule(text, cfg, tenc),
                                      J.tx_bit_schedule(text, cfg, jenc))
        assert P.synth_params(cfg) == J.synth_params(cfg)
    fp, lp, tp = P.tx_frame_schedule(text, cfg, tenc)
    fj, lj, tj = J.tx_frame_schedule(text, cfg, jenc)
    np.testing.assert_array_equal(fp, fj)
    assert (lp, tp) == (lj, tj)
    a, b = P.frame_synth_params(cfg), J.frame_synth_params(cfg)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _atol(seg_len, cfg) -> float:
    """The tolerance above for segments of up to seg_len samples."""
    turns = seg_len * max(float(cfg.mark_f), float(cfg.space_f)) \
        / cfg.sample_rate + 1.0
    ulp = float(np.spacing(np.float32(turns)))
    return 2 * np.pi * (ulp + 2.0 ** -24) + 2.0 ** -24


def _close(got, ref, atol):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    diff = np.abs(got.astype(np.float64) - ref)
    assert diff.max() <= atol, diff.max()
    assert np.count_nonzero(diff) <= MAX_DIFF_SHARE * diff.size


@pytest.mark.parametrize("mode", ["1200", "300", "same", "callerid", "tdd"])
def test_device_synthesize_matches_jax(mode):
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops import tx_device as J
    from minimodem_tpu_torch.ops.tx_device import device_synthesize

    m, text, jenc, _ = _encoders(mode)
    s = J.tx_bit_schedule(text, m.cfg, jenc)
    rng = np.random.default_rng(5)
    bits = np.stack([s, rng.integers(0, 2, s.size, dtype=np.uint8)])
    fn = jax.jit(lambda b: J.device_synthesize(b, m.cfg, 0.7))
    ref = np.stack([np.asarray(fn(jnp.asarray(r))) for r in bits])
    got = device_synthesize(torch.from_numpy(bits), m.cfg, 0.7).numpy()
    _close(got, ref, _atol(m.cfg.bit_nsamples_tx, m.cfg))


@pytest.mark.parametrize("mode", ["rtty", "tdd"])
def test_device_synthesize_frames_matches_jax(mode):
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops import tx_device as J
    from minimodem_tpu_torch.ops.tx_device import device_synthesize_frames

    m, _, jenc, _ = _encoders(mode)
    rows = []
    for text in (BAUDOT, b"CQ CQ DE K1ABC K"):
        fb, lead, trail = J.tx_frame_schedule(text, m.cfg, jenc)
        rows.append(fb)
    f_pad = 40
    bits = np.zeros((2, f_pad, m.cfg.n_data_bits), np.uint8)
    for i, fb in enumerate(rows):
        bits[i, :len(fb)] = fb
    nf = np.asarray([len(fb) for fb in rows], np.int32)
    fn = jax.jit(lambda fb, n: J.device_synthesize_frames(
        fb, n, m.cfg, lead, trail, 0.9))
    ref = np.stack([np.asarray(fn(jnp.asarray(bits[i]), jnp.int32(nf[i])))
                    for i in range(2)])
    got = device_synthesize_frames(torch.from_numpy(bits),
                                   torch.from_numpy(nf), m.cfg, lead, trail,
                                   0.9).numpy()
    _close(got, ref, _atol(max(J.frame_synth_params(m.cfg)["seg_len"]),
                           m.cfg))


def test_fma_f32_exact_is_one_rounding():
    """fma_f32_exact against ops/demod.py::fma_f32 (exact by its own
    test against XLA's FMA chain), on seeded floats, on exact float32
    ties and on a sum that float64 rounds onto a float32 tie although it
    lies below it (rounding twice would round it up)."""
    from minimodem_tpu_torch.ops.demod import fma_f32
    from minimodem_tpu_torch.ops.tx_device import fma_f32_exact

    rng = np.random.default_rng(11)
    a = rng.standard_normal(20000).astype(np.float32)
    b = rng.standard_normal(20000).astype(np.float32)
    c = rng.standard_normal(20000).astype(np.float32)
    a[:8], b[:8], c[:8] = 1.0, 1.0, 2.0 ** -24       # exact ties
    # 1 + 2^-23 + 2^-24 - 2^-70: float64 rounds it to the tie
    a[8] = np.float32(2.0 ** -12 * (1 + 2.0 ** -23))
    b[8] = np.float32(2.0 ** -12 * (1 - 2.0 ** -23))
    c[8] = np.float32(1 + 2.0 ** -23)
    t = [torch.from_numpy(v) for v in (a, b, c)]
    got = fma_f32_exact(*t).numpy()
    ref = fma_f32(*(v.to(torch.float64) for v in t)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert got[8] == c[8]
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert twice[8] != got[8]


def _transmit(pkg, mode, lut, fmt, backend, payload=TEXT):
    if pkg == "jax":
        from minimodem_tpu.codecs import Ascii8Codec
        from minimodem_tpu.config import TxOptions
        from minimodem_tpu.ops.tx import Transmitter
        from minimodem_tpu.sigio import SampleFormat
        kw = {}
    else:
        from minimodem_tpu_torch.codecs import Ascii8Codec
        from minimodem_tpu_torch.config import TxOptions
        from minimodem_tpu_torch.ops.tx import Transmitter
        from minimodem_tpu_torch.sigio import SampleFormat
        kw = {"device": "cpu"}
    tx = Transmitter(FskModem(mode).cfg,
                     TxOptions(sin_table_len=lut, amplitude=0.7),
                     Ascii8Codec(), getattr(SampleFormat, fmt), backend, **kw)
    for byte in payload:
        tx.send(byte)
    tx.finish()
    return tx.drain(None)


@pytest.mark.parametrize("lut", [4096, 16])
@pytest.mark.parametrize("fmt", ["S16", "FLOAT"])
def test_lut_synthesis_bit_identical(lut, fmt):
    got = _transmit("torch", "1200", lut, fmt, "jax")
    for ref in (_transmit("jax", "1200", lut, fmt, "numpy"),
                _transmit("jax", "1200", lut, fmt, "jax"),
                _transmit("torch", "1200", lut, fmt, "numpy")):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fmt", ["S16", "FLOAT"])
def test_direct_sin_synthesis(fmt):
    """No LUT: bit-identical to the numpy backend, within one float32 ulp
    (S16: one step) of the JAX backend's sinf, and it decodes
    byte-exact through the port."""
    from minimodem_tpu_torch.models.modem import FskModem as TorchModem

    got = _transmit("torch", "1200", 0, fmt, "jax")
    np.testing.assert_array_equal(got, _transmit("jax", "1200", 0, fmt,
                                                 "numpy"))
    ref = _transmit("jax", "1200", 0, fmt, "jax")
    diff = np.abs(got.astype(np.float64) - ref)
    assert diff.max() <= (1 if fmt == "S16" else 2.0 ** -24)
    tm = TorchModem("1200", device="cpu")
    assert tm.demodulate(got) == TEXT


def test_modem_modulate_synth_backend():
    """FskModem.modulate(data, synth_backend) has its argument back: the
    device backend gives the numpy backend's samples."""
    from minimodem_tpu_torch.models.modem import FskModem as TorchModem

    tm = TorchModem("300", device="cpu")
    jw = FskModem("300").modulate(TEXT, synth_backend="jax")
    tw = tm.modulate(TEXT, synth_backend="jax")
    np.testing.assert_array_equal(tw, tm.modulate(TEXT))
    np.testing.assert_allclose(tw, jw, rtol=0, atol=2.0 ** -24)


def test_cli_tx_device_synthesis_writes_the_jax_wav(tmp_path):
    """--tx --synth-backend jax --device cpu writes the JAX CLI's WAV
    bytes (LUT synthesis, the CLI default)."""
    text = b"device synthesis through the CLI\n"
    a, b = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    with _redirect(text):
        assert jax_cli.main(["--tx", "--file", a, "1200", "--synth-backend",
                             "jax"]) == 0
    with _redirect(text):
        assert torch_cli.main(["--tx", "--file", b, "1200", "--synth-backend",
                               "jax", "--device", "cpu"]) == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_cli_tx_device_synthesis_without_a_card_exits_1(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with _redirect(b"x") as (out, err):
        code = torch_cli.main(["--tx", "--file", str(tmp_path / "c.wav"),
                               "1200", "--synth-backend", "jax"])
    assert code == 1
    msg = err.getvalue()
    assert msg.startswith("E: ") and msg.count("\n") == 1
