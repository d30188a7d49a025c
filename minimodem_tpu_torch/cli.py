"""minimodem-tpu-torch command-line interface.

The minimodem-tpu CLI on the PyTorch + CUDA port: the same flags, presets
and stdout/stderr split, plus --device {cuda,cpu} (default cuda) for
where the receiver, `--synth-backend jax` and `--benchmarks` run.  Full
flag surface and baudmode-preset semantics of the reference CLI
(reference: src/minimodem.c:377-440 usage, 591-886 option/preset parsing,
900-965 defaulting rules, 977-1012 TX flow, 1014-1131 RX setup).
stdout carries decoded data; stderr carries protocol messages — tests
depend on that split (reference: tests/self-test:56-69).
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from . import __version__
from .codecs import get_codec
from .config import (
    ConfigError,
    ModemConfig,
    RxOptions,
    TxOptions,
    resolve_mode_defaults,
)
from .sigio import Direction, SampleFormat, open_stream
from .utils.cfloat import F32_EPSILON, f32

_SHORT_OPTS = "Vtrc:l:ai875u:f:b:v:M:S:T:qsAR:"
_LONG_OPTS = [
    "version", "tx", "transmit", "write", "rx", "receive", "read",
    "confidence=", "limit=", "auto-carrier", "inverted", "ascii", "baudot",
    "usos=", "msb-first", "file=", "bandwidth=", "volume=", "mark=",
    "space=", "startbits=", "stopbits=", "invert-start-stop", "sync-byte=",
    "quiet", "alsa=", "sndio=", "samplerate=", "lut=",
    "float-samples", "rx-one", "benchmarks", "binary-output", "binary-raw=",
    "print-filter", "print-eot", "Xrxnoise=", "tx-carrier",
    # extensions beyond the reference:
    "precision=", "synth-backend=", "chunk-len=", "engine=", "Xprofile=",
    "device=",
]

USAGE = """usage: minimodem-tpu-torch [--tx|--rx] [options] {baudmode}
\t\t    -t, --tx, --transmit, --write
\t\t    -r, --rx, --receive,  --read     (default)
\t\t[options]
\t\t    -a, --auto-carrier
\t\t    -i, --inverted
\t\t    -c, --confidence {min-confidence-threshold}
\t\t    -l, --limit {max-confidence-search-limit}
\t\t    -8, --ascii\t\tASCII  8-N-1
\t\t    -7,\t\t\tASCII  7-N-1
\t\t    -5, --baudot\tBaudot 5-N-1
\t\t    -u, --usos {0|1}
\t\t    -f, --file {filename.wav}
\t\t    -A, --alsa[=plughw:X,Y]
\t\t    -s, --sndio[=device]
\t\t    -b, --bandwidth {rx_bandwidth}
\t\t    -v, --volume {amplitude or 'E'}
\t\t    -M, --mark {mark_freq}
\t\t    -S, --space {space_freq}
\t\t    --startbits {n}
\t\t    --stopbits {n.n}
\t\t    --invert-start-stop
\t\t    --sync-byte {0xXX}
\t\t    -q, --quiet
\t\t    -R, --samplerate {rate}
\t\t    -V, --version
\t\t    --lut={tx_sin_table_len}
\t\t    --float-samples
\t\t    --rx-one
\t\t    --benchmarks
\t\t    --binary-output
\t\t    --binary-raw {nbits}
\t\t    --print-filter
\t\t    --print-eot
\t\t    --tx-carrier
\t\t    --precision {auto|float32|float64}
\t\t    --device {cuda|cpu}
\t\t{baudmode}
\t    any_number_N       Bell-like      N bps --ascii
\t\t    1200       Bell202     1200 bps --ascii
\t\t     300       Bell103      300 bps --ascii
\t\t    rtty       RTTY       45.45 bps --baudot --stopbits=1.5
\t\t     tdd       TTY/TDD    45.45 bps --baudot --stopbits=2.0
\t\t    same       NOAA SAME 520.83 bps --sync-byte=0xAB ...
\t\tcallerid       Bell202 CID 1200 bps
\t  uic{-train,-ground}       UIC-751-3 Train/Ground 600 bps
"""


def _usage() -> "NoReturn":  # noqa: F821
    sys.stderr.write(USAGE)
    sys.exit(1)


def _version() -> None:
    print(f"minimodem-tpu-torch {__version__}\n"
          "GPU-native software FSK modem (PyTorch/CUDA).\n"
          "Functionally equivalent to kamalmostafa/minimodem.")


def _atof(s: str) -> float:
    """C atof(): parse leading float, 0.0 on garbage."""
    import re
    m = re.match(r"[ \t\n\v\f\r]*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
    return float(m.group(0)) if m else 0.0


def _atoi(s: str) -> int:
    import re
    m = re.match(r"[ \t\n\v\f\r]*[+-]?\d+", s)
    return int(m.group(0)) if m else 0


def _strtol0(s: str) -> int:
    """C strtol(s, NULL, 0): leading hex/octal/decimal prefix parse,
    0 on garbage (reference parses --sync-byte this way,
    src/minimodem.c:700-702)."""
    import re
    m = re.match(r"[ \t\n\v\f\r]*([+-]?)(0[xX][0-9a-fA-F]+|0[0-7]*|[1-9]\d*)", s)
    if not m:
        return 0
    sign = -1 if m.group(1) == "-" else 1
    tok = m.group(2)
    if tok[:2].lower() == "0x":
        v = int(tok, 16)
    elif tok.startswith("0") and len(tok) > 1:
        v = int(tok, 8)
    else:
        v = int(tok, 10)
    return sign * v


# short options with a required argument (the ':'-suffixed entries of
# _SHORT_OPTS) — the optional-arg pre-splitter must not rewrite their
# attached or following argument
_OPT_REQARG = {c for c, nxt in zip(_SHORT_OPTS, _SHORT_OPTS[1:] + " ")
               if c != ":" and nxt == ":"}
# GNU optional-argument short options (reference optstring `s::A::`,
# src/minimodem.c:634) mapped to their equivalent long form
_OPT_OPTARG = {"A": "--alsa", "s": "--sndio"}


def _presplit_optional_args(argv: list) -> list:
    """GNU-getopt optional-arg parity: the reference declares `s::A::`
    (src/minimodem.c:634), so `-Aplughw:1,0` / `-s<dev>` attach the
    device name to the flag (a separate following word is NOT consumed
    — GNU optional args must be attached).  Python getopt has no
    optional short arguments; rewrite `-A<dev>` / `-s<dev>` — including
    inside clusters like `-qAdev` — into the equivalent long form
    before parsing.  Bare long forms `--alsa` / `--sndio` are likewise
    normalized to `--alsa=` / `--sndio=` so the optional long argument
    never consumes the following word (GNU `optional_argument`
    semantics)."""
    bare_long = {lo: lo + "=" for lo in _OPT_OPTARG.values()}
    # long options with a REQUIRED argument: when given as a separate
    # word (`--file x`), GNU getopt_long binds the next argv element
    # verbatim — even one that looks like `-Adev.wav` — so the
    # pre-splitter must skip over it, not rewrite it
    reqarg_long = {"--" + lo[:-1] for lo in _LONG_OPTS
                   if lo.endswith("=")} - set(_OPT_OPTARG.values())

    def _long_match(tok: str):
        """Unambiguous long-option match (getopt prefix semantics) for
        a bare `--name` token, else None."""
        if not tok.startswith("--") or "=" in tok or tok == "--":
            return None
        full = [lo for lo in ("--" + x.rstrip("=") for x in _LONG_OPTS)
                if lo.startswith(tok)]
        return full[0] if len(full) == 1 else None

    out = []
    i, n = 0, len(argv)
    while i < n:
        a = argv[i]
        if a == "--":
            out.extend(argv[i:])
            return out
        m = _long_match(a)
        if m in bare_long:
            # bare (possibly abbreviated) optional-arg long form: GNU
            # optional_argument never consumes the following word
            out.append(bare_long[m])
            i += 1
            continue
        if m in reqarg_long and i + 1 < n:
            out.extend(argv[i:i + 2])   # long opt + its verbatim arg
            i += 2
            continue
        if len(a) < 2 or a[0] != "-" or a[1] == "-":
            out.append(a)
            i += 1
            continue
        j, handled = 1, False
        while j < len(a):
            ch = a[j]
            if ch in _OPT_OPTARG:
                if a[1:j]:
                    out.append("-" + a[1:j])    # preceding cluster flags
                out.append(_OPT_OPTARG[ch] + "=" + a[j + 1:])
                handled = True
                break
            if ch in _OPT_REQARG:
                # required-arg option: the rest of the cluster (or the
                # next word) is its argument — copy verbatim so an
                # argument like "-Afile.wav" is never rewritten
                out.append(a)
                if j == len(a) - 1 and i + 1 < n:
                    out.append(argv[i + 1])
                    i += 1
                handled = True
                break
            j += 1
        if not handled:
            out.append(a)
        i += 1
    return out


def _card_ready(device: str, flag: str = "--device") -> bool:
    """False, after one E: line, when `flag` cuda has no card."""
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            sys.stderr.write(f"E: {flag} cuda: no CUDA device is "
                             f"available (use {flag} cpu)\n")
            return False
    return True


def main(argv=None) -> int:
    argv = _presplit_optional_args(
        list(sys.argv[1:] if argv is None else argv))
    try:
        optlist, args = getopt.gnu_getopt(argv, _SHORT_OPTS, _LONG_OPTS)
    except getopt.GetoptError as e:
        sys.stderr.write(f"E: {e}\n")
        _usage()

    tx_mode = None
    quiet_mode = False
    output_print_filter = False
    band_width = f32(0.0)
    mark_f = f32(0.0)
    space_f = f32(0.0)
    inverted_freqs = False
    nstartbits = -1
    nstopbits = -1.0
    do_rx_sync = False
    do_tx_sync_bytes = 0
    sync_byte = -1
    n_data_bits = 0
    msb_first = False
    invert_start_stop = False
    filename = None
    carrier_autodetect_threshold = 0.0
    confidence_threshold = 1.5
    confidence_search_limit = 2.3
    sample_fmt = SampleFormat.S16
    sample_rate = 48000
    nchannels = 1
    sa_backend = "sysdefault"
    sa_device = None
    tx_amplitude = f32(1.0)
    tx_sin_table_len = 4096
    rx_one = False
    rxnoise_factor = 0.0
    txcarrier = False
    tx_print_eot = False
    output_mode_binary = False
    output_mode_raw_nbits = 0
    usos = True
    precision = "auto"
    synth_backend = "numpy"
    chunk_len = 1 << 17
    engine = "auto"
    profile_dir = None
    run_benchmarks = False
    device = "cuda"

    encoder_name = "ascii8"
    decoder_name = "ascii8"

    for opt, val in optlist:
        if opt in ("-V", "--version"):
            _version()
            return 0
        elif opt in ("-t", "--tx", "--transmit", "--write"):
            if tx_mode is False:
                _usage()
            tx_mode = True
        elif opt in ("-r", "--rx", "--receive", "--read"):
            if tx_mode is True:
                _usage()
            tx_mode = False
        elif opt in ("-c", "--confidence"):
            confidence_threshold = _atof(val)
        elif opt in ("-l", "--limit"):
            confidence_search_limit = _atof(val)
        elif opt in ("-a", "--auto-carrier"):
            carrier_autodetect_threshold = 0.001
        elif opt in ("-i", "--inverted"):
            inverted_freqs = True
        elif opt in ("-f", "--file"):
            filename = val
        elif opt in ("-8", "--ascii"):
            n_data_bits = 8
        elif opt == "-7":
            n_data_bits = 7
        elif opt in ("-5", "--baudot"):
            n_data_bits = 5
            encoder_name = decoder_name = "baudot"
        elif opt in ("-u", "--usos"):
            usos = bool(_atoi(val))
        elif opt == "--msb-first":
            msb_first = True
        elif opt in ("-b", "--bandwidth"):
            band_width = f32(_atof(val))
            assert float(band_width) != 0
        elif opt in ("-v", "--volume"):
            if val[:1] == "E":
                tx_amplitude = F32_EPSILON
            else:
                tx_amplitude = f32(_atof(val))
            assert float(tx_amplitude) > 0.0
        elif opt in ("-M", "--mark"):
            mark_f = f32(_atof(val))
            assert float(mark_f) > 0
        elif opt in ("-S", "--space"):
            space_f = f32(_atof(val))
            assert float(space_f) > 0
        elif opt == "--startbits":
            nstartbits = _atoi(val)
            assert 0 <= nstartbits <= 20
        elif opt == "--stopbits":
            nstopbits = _atof(val)
            assert nstopbits >= 0
        elif opt == "--invert-start-stop":
            invert_start_stop = True
        elif opt == "--sync-byte":
            do_rx_sync = True
            do_tx_sync_bytes = 16
            sync_byte = _strtol0(val)
        elif opt in ("-q", "--quiet"):
            quiet_mode = True
        elif opt in ("-R", "--samplerate"):
            sample_rate = _atoi(val)
            assert sample_rate > 0
        elif opt in ("-A", "--alsa"):
            sa_backend = "alsa"
            sa_device = val or None
        elif opt in ("-s", "--sndio"):
            sa_backend = "sndio"
            sa_device = val or None
        elif opt == "--lut":
            tx_sin_table_len = _atoi(val)
        elif opt == "--float-samples":
            sample_fmt = SampleFormat.FLOAT
        elif opt == "--rx-one":
            rx_one = True
        elif opt == "--benchmarks":
            run_benchmarks = True
        elif opt == "--binary-output":
            output_mode_binary = True
        elif opt == "--binary-raw":
            output_mode_raw_nbits = _atoi(val)
        elif opt == "--print-filter":
            output_print_filter = True
        elif opt == "--print-eot":
            tx_print_eot = True
        elif opt == "--Xrxnoise":
            rxnoise_factor = _atof(val)
        elif opt == "--tx-carrier":
            txcarrier = True
        elif opt == "--precision":
            precision = val
        elif opt == "--synth-backend":
            synth_backend = val
        elif opt == "--chunk-len":
            chunk_len = _atoi(val)
        elif opt == "--engine":
            if val not in ("auto", "device", "host", "host-native"):
                sys.stderr.write(f"E: unknown engine {val!r}\n")
                return 1
            engine = val
        elif opt == "--Xprofile":
            profile_dir = val
        elif opt == "--device":
            if val not in ("cuda", "cpu"):
                sys.stderr.write(f"E: unknown device {val!r}\n")
                return 1
            device = val
        elif opt == "-T":
            _usage()  # reference accepts -T in optstring but has no case
        else:
            _usage()

    if run_benchmarks:
        if not _card_ready(device):
            return 1
        from .bench import run_decode_benchmarks, run_tx_benchmarks
        run_tx_benchmarks(device=device)
        run_decode_benchmarks(device=device)
        return 0

    if tx_mode is None:
        tx_mode = False

    # RX needs float samples for the demodulator (reference: :787-788)
    if not tx_mode:
        sample_fmt = SampleFormat.FLOAT

    if len(args) != 1:
        sys.stderr.write('E: *** Must specify {baudmode} (try "300") ***\n')
        _usage()
    modem_mode = args[0]

    # ---- baudmode presets (reference: :819-886) ----
    data_rate = 0.0
    expect_data_string = ""
    expect_n_bits = 0
    mm = modem_mode.lower()
    if mm == "rtty":
        encoder_name = decoder_name = "baudot"
        data_rate = 45.45
        if n_data_bits == 0:
            n_data_bits = 5
        if nstopbits < 0:
            nstopbits = 1.5
    elif mm == "tdd":
        encoder_name = decoder_name = "baudot"
        data_rate = 45.45
        if n_data_bits == 0:
            n_data_bits = 5
        if nstopbits < 0:
            nstopbits = 2.0
        mark_f = f32(1400)
        space_f = f32(1800)
    elif mm == "same":
        # NOAA SAME (reference: :837-848)
        data_rate = 520.0 + 5 / 6.0
        n_data_bits = 8
        nstartbits = 0
        nstopbits = 0.0
        do_rx_sync = True
        do_tx_sync_bytes = 16
        sync_byte = 0xAB
        mark_f = f32(2083.0 + 1 / 3.0)
        space_f = f32(1562.5)
        band_width = f32(data_rate)
    elif mm.startswith("caller"):
        if tx_mode:
            sys.stderr.write("E: callerid --tx mode is not supported.\n")
            return 1
        if carrier_autodetect_threshold > 0.0:
            sys.stderr.write(
                "W: callerid with --auto-carrier is not recommended.\n")
        decoder_name = "callerid"
        data_rate = 1200.0
        n_data_bits = 8
    elif mm.startswith("uic"):
        if tx_mode:
            sys.stderr.write("E: uic-751-3 --tx mode is not supported.\n")
            return 1
        decoder_name = (
            "uic-train" if len(mm) > 4 and mm[4] == "t" else "uic-ground")
        data_rate = 600.0
        n_data_bits = 39
        mark_f = f32(1300)
        space_f = f32(1700)
        nstartbits = 8
        nstopbits = 0.0
        expect_data_string = (
            "11110010ddddddddddddddddddddddddddddddddddddddd")
        expect_n_bits = 47
    elif mm.startswith("v.21"):
        data_rate = 300.0
        mark_f = f32(980)
        space_f = f32(1180)
        n_data_bits = 8
    else:
        data_rate = _atof(modem_mode)
        if n_data_bits == 0:
            n_data_bits = 8
    if f32(data_rate) == f32(0.0):
        _usage()

    if output_mode_binary or output_mode_raw_nbits:
        decoder_name = "binary"
    if output_mode_raw_nbits:
        nstartbits = 0
        nstopbits = 0.0
        n_data_bits = output_mode_raw_nbits

    # ---- build config ----
    cfg = ModemConfig(
        sample_rate=sample_rate,
        data_rate=f32(data_rate),
        n_data_bits=n_data_bits,
        mark_f=mark_f,
        space_f=space_f,
        band_width=band_width,
        msb_first=msb_first,
        invert_start_stop=invert_start_stop,
        inverted_freqs=inverted_freqs,
        do_rx_sync=do_rx_sync,
        do_tx_sync_bytes=do_tx_sync_bytes,
        sync_byte=sync_byte,
        expect_data_string=expect_data_string,
        expect_n_bits=expect_n_bits,
    )
    resolve_mode_defaults(cfg, data_rate)

    # defaults: 1 start bit, 1 stop bit (reference: :936-940)
    cfg.nstartbits = 1 if nstartbits < 0 else nstartbits
    cfg.nstopbits = f32(1.0) if nstopbits < 0 else f32(nstopbits)

    tx_leader_bits_len = 2
    if cfg.nstartbits == 0:
        tx_leader_bits_len = 0

    if inverted_freqs:
        cfg.mark_f, cfg.space_f = cfg.space_f, cfg.mark_f

    rx_opts = RxOptions(
        confidence_threshold=confidence_threshold,
        confidence_search_limit=confidence_search_limit,
        carrier_autodetect_threshold=carrier_autodetect_threshold,
        rx_one=rx_one,
        rxnoise_factor=rxnoise_factor,
        quiet=quiet_mode,
        print_filter=output_print_filter,
        precision=precision,
    ).sanitize()

    if filename is None:
        # live audio: resolve the system backend up front so a missing
        # client library is one clear error (reference default chain
        # pulse->alsa->sndio, src/simpleaudio.c:71-112)
        import importlib

        from .sigio import system_backend

        if sa_backend == "sysdefault":
            resolved = system_backend()
            if resolved is None:
                sys.stderr.write(
                    "E: no system audio available on this host (no "
                    "libpulse-simple, libasound, or libsndio),\n"
                    "E:   so only the --file mode is supported.\n")
                return 1
            sa_backend = resolved
        else:
            loaders = {
                "pulseaudio": "pulse.load_libpulse",
                "alsa": "alsa.load_libasound",
                "sndio": "sndio.load_libsndio",
            }
            mod_name, fn_name = loaders[sa_backend].split(".")
            mod = importlib.import_module(f".sigio.{mod_name}", __package__)
            if getattr(mod, fn_name)() is None:
                sys.stderr.write(
                    f"E: the {sa_backend} client library is not available "
                    "on this host; use --file mode.\n")
                return 1

    # ============== TX ==============
    if tx_mode:
        try:
            cfg.finalize()
        except ConfigError as e:
            sys.stderr.write(f"E: {e}\n")
            return 1
        # interactive = live audio output (no --file) — reference:
        # src/minimodem.c:981-985
        tx_interactive = filename is None
        tx_opts = TxOptions(
            amplitude=tx_amplitude,
            sin_table_len=tx_sin_table_len,
            interactive=tx_interactive,
            print_eot=tx_print_eot,
            tx_carrier=txcarrier,
            leader_bits_len=tx_leader_bits_len,
        )
        from .ops.tx import Transmitter
        kw = {"usos": usos} if encoder_name == "baudot" else {}
        encoder = get_codec(encoder_name, **kw)
        if synth_backend == "jax" and not _card_ready(device):
            return 1
        try:
            if filename is None:
                stream = open_stream(sa_backend, sa_device,
                                     Direction.PLAYBACK, sample_fmt,
                                     sample_rate, nchannels,
                                     "minimodem-tpu", "output audio")
            else:
                stream = open_stream("file", None, Direction.PLAYBACK,
                                     sample_fmt, sample_rate, nchannels,
                                     "minimodem-tpu", filename)
        except (OSError, RuntimeError) as e:
            sys.stderr.write(f"{filename or 'audio'}: {e}\n")
            return 1
        txer = Transmitter(cfg, tx_opts, encoder, sample_fmt, synth_backend,
                           device)
        # the reference's stdin loop: select() idle detection + idle
        # carrier, SIGALRM trailer when interactive (minimodem.c:114-250)
        txer.transmit_stdin(sys.stdin.buffer, stream, tx_interactive,
                            txcarrier)
        stream.close()
        return 0

    # ============== RX ==============
    if not _card_ready(device):
        return 1
    if filename is None:
        return _rx_live(cfg, rx_opts, decoder_name, usos, sa_backend,
                        sa_device, sample_rate, nchannels, rxnoise_factor,
                        device)
    try:
        stream = open_stream("file", None, Direction.RECORD, sample_fmt,
                             sample_rate, nchannels, "minimodem-tpu", filename)
    except (OSError, RuntimeError) as e:
        sys.stderr.write(f"{filename}: {e}\n")
        return 1
    if rxnoise_factor != 0.0:
        stream.set_rxnoise(rxnoise_factor)
    cfg.sample_rate = stream.rate  # file rate wins (reference: :1029)
    try:
        cfg.finalize()
    except ConfigError as e:
        sys.stderr.write(f"E: {e}\n")
        return 1

    # the demodulator is single-channel (reference: src/simpleaudio.c:123-128)
    if stream.channels != nchannels:
        sys.stderr.write(
            f"{filename}: input stream must be {nchannels}-channel "
            f"(not {stream.channels})\n")
        return 1

    # compact-wire fast paths (no read-noise only): PCM16 ships raw
    # int16 (half the transfer, normalized on-chip); u-law/A-law/PCM8
    # sources ship their raw bytes (quarter the transfer) and expand on
    # device via the same G.711 algebra as the host tables — identical
    # values either way
    in_encoding = None
    if rxnoise_factor == 0.0:
        if (getattr(stream, "_src_fmt_tag", None) == 1
                and getattr(stream, "_src_bits", 0) == 16):
            stream.format = SampleFormat.S16
        elif engine in ("auto", "device"):
            enc_fn = getattr(stream, "raw_u8_encoding", None)
            in_encoding = enc_fn() if enc_fn is not None else None
            if in_encoding is not None:
                stream.enable_raw_u8()

    # read the whole stream (file mode); half-buffer read emulation happens
    # inside the engine's counters
    chunks = []
    while True:
        c = stream.read(1 << 20)
        if c.size == 0:
            break
        chunks.append(c)
    stream.close()
    samples = (np.concatenate(chunks) if chunks
               else np.zeros(0, np.float32))

    if decoder_name == "baudot":
        codec = get_codec("baudot", usos=usos)
    else:
        codec = get_codec(decoder_name)

    from .rx.engine import Receiver

    out = sys.stdout.buffer

    def write_out(b: bytes) -> None:
        out.write(b)
        out.flush()

    rxer = Receiver(cfg, rx_opts, codec, write_out, device=device)
    if profile_dir:
        # observability hook: a torch.profiler chrome trace of the
        # decode (the analogue of the reference's FSK_DEBUG tracing)
        ret = _profiled(profile_dir, device, rxer.run, samples,
                        engine=engine, in_encoding=in_encoding)
    else:
        ret = rxer.run(samples, engine=engine, in_encoding=in_encoding)
    return -ret if ret < 0 else ret


def _rx_live(cfg, rx_opts, decoder_name, usos, sa_backend, sa_device,
             sample_rate, nchannels, rxnoise_factor: float = 0.0,
             device: str = "cuda") -> int:
    """Live RX from a system audio capture stream: half-second reads feed
    the streaming receiver on `device`; SIGINT stops cleanly with the
    final stats (reference: src/minimodem.c:368-374, 1135-1174)."""
    from .ops.device_rx import DeviceStreamReceiver
    from .rx.engine import Receiver

    try:
        stream = open_stream(sa_backend, sa_device, Direction.RECORD,
                             SampleFormat.FLOAT, sample_rate, nchannels,
                             "minimodem-tpu", "input audio")
    except (OSError, RuntimeError) as e:
        sys.stderr.write(f"audio: {e}\n")
        return 1
    if rxnoise_factor != 0.0:
        # the reference sets rxnoise on the RX stream whether file or
        # live (src/minimodem.c:1031-1032)
        stream.set_rxnoise(rxnoise_factor)
    try:
        cfg.finalize()
    except ConfigError as e:
        sys.stderr.write(f"E: {e}\n")
        return 1
    if decoder_name == "baudot":
        codec = get_codec("baudot", usos=usos)
    else:
        codec = get_codec(decoder_name)
    out = sys.stdout.buffer

    def write_out(b: bytes) -> None:
        out.write(b)
        out.flush()

    rxer = Receiver(cfg, rx_opts, codec, write_out, device=device)
    if rx_opts.carrier_autodetect_threshold > 0.0:
        # -a on a live stream: the reference's autodetect runs on any
        # RECORD source (src/minimodem.c:1179-1220); run_live_autodetect
        # takes the chunk feed as it comes
        def live_chunks():
            while True:
                c = stream.read(sample_rate // 2)
                if c.size == 0:
                    return
                yield np.asarray(c, np.float32)

        rxer.run_live_autodetect(live_chunks())
        stream.close()
        return 0
    sr = DeviceStreamReceiver(
        cfg, rx_opts.precision, rx_opts.rx_one,
        segment_len=1 << 16,            # ~1.4 s decode latency at 48 kHz
        conf_threshold=float(rx_opts.confidence_threshold),
        conf_search_limit=float(rx_opts.confidence_search_limit),
        device=device)
    try:
        while True:
            chunk = stream.read(sample_rate // 2)
            if chunk.size == 0:
                break
            rxer.render_events(*sr.feed(np.asarray(chunk, np.float32)))
    except KeyboardInterrupt:
        pass
    rxer.render_events(*sr.finish())
    stream.close()
    return 0


def _profiled(profile_dir: str, device: str, fn, *args, **kw):
    """Run fn under torch.profiler; writes profile_dir/trace.json."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        ret = fn(*args, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return ret


def console_entry() -> int:
    """Entry point hardened against SIGPIPE (e.g. `minimodem-tpu-torch -V | head`)."""
    try:
        return main()
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(console_entry())
