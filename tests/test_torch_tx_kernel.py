"""K4, the loopback's synthesis kernel (csrc/tx_synth.cu), on the CPU.

The kernel itself runs only on a card (tests/test_torch_gpu.py holds it
against its plain route there).  Here: its C entries are bound and
defined; the host's divisor (magic_divisor: K4's division a sample, a
multiply-high and a shift) equals // on both sides of every quotient
boundary up to the loopback's row widths and at random n < 2^31, for
every preset's bit and frame length; the frame map K4 is handed
(frame_map, through the kernel's arithmetic) equals frame_synth_params'
seg_of / off_in; the loopback on the CPU takes the plain route (the plain
synthesis called, K4 never launched) and the wrappers refuse tensors
that are not on a CUDA device, so no CPU run can pass through them
unnoticed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from minimodem_tpu_torch.codecs import Ascii8Codec
from minimodem_tpu_torch.models.modem import FskModem
from minimodem_tpu_torch.models.presets import PRESETS
from minimodem_tpu_torch.ops import _kernels
from minimodem_tpu_torch.ops import tx_device as T
from minimodem_tpu_torch.ops.device_rx import DeviceLoopback

ENTRIES = ("mm_tx_synth_bits", "mm_tx_synth_frames")
SOURCE = Path(_kernels.SRC_DIR) / "tx_synth.cu"
# the headline buffer's row (128 x 64.3 s Bell-202 in the loopback) and a
# 2^23-sample margin past it
ROW_WIDTH = 3146168 + (1 << 23)
TX_MODES = [m for m, f in PRESETS.items() if f().tx_supported]


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


def test_sine_check_entry_is_bound():
    # lo, hi, stride; the count and first-mismatch pointers; the stream
    assert _kernels._SIGNATURES["mm_tx_sin_check"] == [
        _kernels._U, _kernels._U, _kernels._U, _kernels._P, _kernels._P,
        _kernels._P]


@pytest.mark.parametrize("entry", ENTRIES + ("mm_tx_sin_check",))
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


def test_sine_check_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        T.sin_check(0, 16, device="cpu")


def _divides(d: int, n: np.ndarray) -> bool:
    m, s = T.magic_divisor(d)
    assert 0 < m < 2 ** 32 and 0 <= s <= 31
    n = n.astype(np.uint64)
    q = ((n << np.uint64(1)) * np.uint64(m)) >> np.uint64(32 + s)
    return bool(np.array_equal(q, n // np.uint64(d)))


def _boundaries(d: int, top: int) -> np.ndarray:
    """Both sides of every multiple of d up to top, and the top of the
    31-bit range's last multiples."""
    k = np.arange(1, top // d + 2, dtype=np.int64) * d
    last = (2 ** 31 - 1) // d * d
    n = np.concatenate([k - 1, k, [0, last - 1, last, 2 ** 31 - 1]])
    return n[(n >= 0) & (n < 2 ** 31)]


def _lengths():
    """Every TX preset's bit length and frame length, and the frame
    lengths at 1.5 stop bits (the frame schedules' case)."""
    out = set()
    for mode in TX_MODES:
        for stop in (None, 1.5):
            cfg = _cfg(mode, stop)
            out.add(cfg.bit_nsamples_tx)
            out.add(T.frame_synth_params(cfg)["frame_len"])
    return sorted(out)


@pytest.mark.parametrize("d", _lengths())
def test_magic_divisor_equals_floor_division(d):
    rng = np.random.default_rng(d)
    assert _divides(d, _boundaries(d, ROW_WIDTH))
    assert _divides(d, rng.integers(0, 2 ** 31, 200_000))


@pytest.mark.parametrize("d", [1, 2, 3, 7, 2 ** 16 + 1, 2 ** 30 - 1, 2 ** 30,
                               2 ** 30 + 1, 2 ** 31 - 1])
def test_magic_divisor_at_the_range_edges(d):
    rng = np.random.default_rng(d)
    n = np.concatenate([_boundaries(d, 1 << 16),
                        rng.integers(0, 2 ** 31, 100_000)])
    assert _divides(d, n)
    with pytest.raises(ValueError):
        T.magic_divisor(0)
    with pytest.raises(ValueError):
        T.magic_divisor(2 ** 31)


@pytest.mark.parametrize("stop", [None, 1.5, 2.0])
@pytest.mark.parametrize("mode", TX_MODES)
def test_frame_map_equals_seg_of_off_in(mode, stop):
    """The kernel's sample -> (segment, offset) map of one frame: o's
    segment and offset from frame_map through the kernel's arithmetic
    (tx_synth_frames_kernel: the divisions by magic_divisor), against
    frame_synth_params' tables, at every offset of the frame and of the
    frames around it."""
    p = T.frame_synth_params(_cfg(mode, stop))
    fm = T.frame_map(p)
    frame_len = p["frame_len"]
    assert (fm["s_uni"] + fm["n_uni"] + (len(p["seg_len"]) > fm["s_uni"]
                                         + fm["n_uni"])
            == len(p["seg_len"]))
    m = np.arange(3 * frame_len, dtype=np.int64)
    fd, fs = T.magic_divisor(frame_len)
    ud, us = T.magic_divisor(fm["uni_len"])
    f = ((m << 1) * fd) >> (32 + fs)
    o = m - f * frame_len
    d = o - fm["head"]
    j = np.minimum(((np.maximum(d, 0) << 1) * ud) >> (32 + us), fm["n_uni"])
    seg = np.where(d < 0, 0, fm["s_uni"] + j)
    off = np.where(d < 0, o, d - j * fm["uni_len"])
    np.testing.assert_array_equal(f, m // frame_len)
    np.testing.assert_array_equal(seg, np.tile(p["seg_of"], 3))
    np.testing.assert_array_equal(off.astype(np.float32),
                                  np.tile(p["off_in"], 3))


@pytest.mark.parametrize("n_seg", range(1, 17))
def test_frame_sum_in_its_stated_order(n_seg):
    """The plain frames route's sum over a frame's segments, against the
    order K4's prep kernel takes written out on Python floats (lanes over
    the whole groups of four, the rest from 0.0, then the lanes), so the
    CPU's plain version is the same on every host; and, on a host whose
    CPU sum runs four float64 lanes, equal to torch's own sum."""
    rng = np.random.default_rng(n_seg)
    x = rng.random((5, n_seg)) * 7.3
    whole = n_seg - n_seg % 4
    want = []
    for row in x.tolist():
        lanes = [0.0] * 4
        for s in range(whole):
            lanes[s % 4] += row[s]
        fin = 0.0
        for v in row[whole:]:
            fin += v
        for v in lanes:
            fin += v
        want.append(fin)
    got = T._frame_sum(torch.from_numpy(x))
    assert got.tolist() == want
    if torch.backends.cpu.get_cpu_capability() in ("AVX2", "AVX512"):
        assert torch.equal(got, torch.from_numpy(x).sum(-1))


def _smoke():
    """chip_smoke.py as a module (it imports nothing at its top but the
    standard library)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# cuobjdump -sass's layout: a tile loop around a float4 sample loop (one
# 16-byte store of four samples a pass) and a scalar loop (the rest)
SASS = """
        Function : _ZN12_GLOBAL__N_120tx_synth_bits_kernelE8BitsArgs
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   LDS.128 R4, [R2] ;
        /*0030*/                   DFMA R2, R4, R6, R2 ;
        /*0040*/                   DMUL R8, R2, R2 ;
        /*0050*/                   F2F.F32.F64 R0, R2 ;
        /*0060*/                   FRND.FLOOR R3, R3 ;
        /*0070*/              @!P0 FFMA R0, R0, R0, R3 ;
        /*0080*/                   IMAD.HI.U32 R5, R5, R6, RZ ;
        /*0090*/                   STG.E.128 desc[UR4][R8.64], R12 ;
        /*00a0*/               @P1 BRA 0x20 ;
        /*00b0*/                   DFMA R2, R4, R6, R2 ;
        /*00c0*/                   STG.E desc[UR4][R8.64], R12 ;
        /*00d0*/               @P2 BRA 0xb0 ;
        /*00e0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00f0*/               @P3 BRA 0x10 ;
        /*0100*/                   EXIT ;
"""


def test_census_takes_the_float4_sample_loop():
    smoke = _smoke()
    funcs = smoke.sass_functions(SASS)
    (code,) = funcs.values()
    assert len(code) == 17 and code[10] == (0xa0, "BRA", "", 0x20)
    c = smoke.sample_loop_census(code)
    # 0x20 .. 0xa0: 9 instructions, one 16-byte store: four samples
    assert c["samples_a_pass"] == 4
    assert c["fp64"] == 2 / 4 and c["quarter"] == 2 / 4
    assert c["fp32"] == 1 / 4 and c["alu"] == 1 / 4 and c["mem"] == 1 / 4
    assert c["stg"] == 1 / 4 and c["issue"] == 9 / 4


def test_pipe_floors():
    smoke = _smoke()
    census = {"sms": 132, "clock_mhz": 1980.0}
    floors = smoke.pipe_floors({"fp64": 15.0, "issue": 45.75},
                               398_458_880, census)
    hz = 132 * 1980e6
    assert floors["fp64"] == pytest.approx(398_458_880 * 15 / (64 * hz) * 1e3)
    assert floors["issue"] == pytest.approx(
        398_458_880 * 45.75 / (128 * hz) * 1e3)
    assert floors["quarter"] == 0.0
