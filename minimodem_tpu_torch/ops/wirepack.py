"""Lossless delta-bitpack wire transport for int16 sample uploads.

Counterpart of minimodem_tpu/ops/wirepack.py: the host half (choose_params,
count_exceptions, pack and the spec token) is a copy of the JAX module's,
and unpack_expand is its device half in PyTorch.

FSK audio is highly compressible with integer linear prediction: the
order-k finite difference of a sampled tone of angular frequency w
shrinks by ~(2 sin(w/2))^k per order.  Bit transitions locally spike the
deltas.  The format is fully STATIC-stride, so the device decode needs
no gathers:

  - every delta packs at one global even width w (dense reshape +
    static shifts decode), and
  - the sparse transition spikes (|delta| >= 2^(w-1)) ride a
    fixed-capacity exception list applied with ONE small scatter.

It is opt-in (wire_pack=True, or "auto" with MINIMODEM_TPU_WIREPACK=1;
see default_on): it pays only where the host link is slower than the
host's pack.  PERF.md holds its split on the port's card.

The payload layout is PLANE-MAJOR, so the device decode touches only
contiguous long-minor-axis slices.  Deltas split into 8 strided lanes
(lane j holds body[j*G:(j+1)*G], G = ceil(n/8)); position g of the 8
lanes packs into w/2 uint16 PLANES (plane h carries bits [16h, 16h+16)
of the 8w-bit group), each plane a contiguous G-element u16 run.  The
wire uploads as int16 and decodes with static shifts + one concat.

Wire format (per stream row; all offsets static given the spec;
units of uint16):

  [ 32 x u16 header | w/2 base planes | exc pos plane | 2 exc val planes ]
  header:  12 x int32 LE (= 24 u16): seeds[0..5] (first k entries of
           the k-pass delta array), n_exc, 5 reserved/zero
  base:    plane h in [0, w/2): u16[G] holding bits [16h, 16h+16) of
           each position's 8-lane group; exception slots pack as 0
  exc pos: E_cap x uint16 position deltas (first is absolute);
           gaps > 65535 use dummy records repeating the previous
           entry; slots past n_exc repeat the last record
  exc val: E_cap x u16 low halves, then E_cap x u16 high halves of
           the int32 delta values

The spec (k, w, n_packed, E_cap) is static per receiver program
(spec_str token).  k first differences invert with k inclusive scans;
round-trip is bit-exact (all integer arithmetic), so decode decisions
are identical to the raw int16 wire.  choose_params falls back to the
raw wire (None) when packing would not pay.  The reference has no
analogue (it reads from a local soundcard/file,
src/simpleaudio-sndfile.c); this is serving transport engineering, the
ingest-side sibling of the raw-u8 G.711 wires.
"""

from __future__ import annotations

import numpy as np

HEADER_BYTES = 64
MAX_ORDER = 5
_WIDTHS = (4, 6, 8, 10, 12, 14)
_EXC_ALIGN = 1 << 14            # exception capacity bucket


def _native():
    """The native packer (wirepack.cpp), or None.  The NumPy packer
    below is the behavioral reference (byte-parity pinned by
    tests/test_wirepack.py); the C++ one exists because the pack must
    run faster than the host link for the wire to pay."""
    from ..native import load

    lib = load()
    return lib if lib is not None and hasattr(lib, "mm_wirepack_pack") \
        else None


def delta_encode(x: np.ndarray, k: int) -> np.ndarray:
    """k passes of first differences (each pass keeps element 0), int32.
    Inverse of k inclusive scans."""
    a = x.astype(np.int32)
    for _ in range(k):
        a = np.concatenate([a[:1], np.diff(a)])
    return a


def _size_bits(n: int, w: int, n_exc: int) -> float:
    return HEADER_BYTES * 8 + w * n + 48 * n_exc


def choose_params(x: np.ndarray, max_ratio: float = 0.92,
                  sample: bool = True):
    """Pick (k, w) minimizing base-width bits + 6-byte exception
    records for int16 samples x, or None when nothing beats max_ratio
    of the raw 16-bit wire.  With sample=True the choice runs on ~1M
    sampled samples ((k, w) only steer the RATIO — exceptions are
    always measured exactly at pack time — so a sampled choice is
    safe)."""
    if x.dtype != np.int16 or len(x) <= MAX_ORDER + 4:
        return None
    if sample and len(x) > 1 << 20:
        nwin = 16
        wlen = (1 << 20) // nwin
        step = (len(x) - wlen) // (nwin - 1)
        x = np.concatenate([x[i * step:i * step + wlen]
                            for i in range(nwin)])
    n = len(x)
    best = None                     # (bits, k, w)
    lib = _native()
    if lib is not None:
        import ctypes

        xs = np.ascontiguousarray(x)
        counts = np.zeros((MAX_ORDER + 1, len(_WIDTHS)), np.int64)
        lib.mm_wirepack_scan(
            xs.ctypes.data_as(ctypes.c_void_p), n, MAX_ORDER,
            counts.ctypes.data_as(ctypes.c_void_p))
        for k in range(MAX_ORDER + 1):
            for wi, w in enumerate(_WIDTHS):
                bits = _size_bits(n, w, int(counts[k, wi]))
                if best is None or bits < best[0]:
                    best = (bits, k, w)
    else:
        a = x.astype(np.int32)
        for k in range(MAX_ORDER + 1):
            if k:
                a = np.concatenate([a[:1], np.diff(a)])
            ab = np.abs(a[k:])
            for w in _WIDTHS:
                n_exc = int((ab >= (1 << (w - 1))).sum())
                bits = _size_bits(n, w, n_exc)
                if best is None or bits < best[0]:
                    best = (bits, k, w)
    if best is None or best[0] >= max_ratio * 16 * n:
        return None
    return best[1], best[2]


def _layout(n_packed: int, k: int, w: int, e_cap: int):
    """-> (G, base16, pos16, val16, row16): lane length and section
    offsets in UINT16 units (row bytes = 2 * row16, always even, so
    the wire uploads as an int16 view)."""
    G = max(1, -(-(n_packed - k) // 8))
    base = HEADER_BYTES // 2
    pos = base + G * (w // 2)
    val = pos + e_cap
    row = val + 2 * e_cap
    return G, base, pos, val, row


def count_exceptions(x: np.ndarray, k: int, w: int) -> int:
    """Exact exception count pack() will emit for samples x (incl.
    dummy records for >65535-sample gaps)."""
    lib = _native()
    if lib is not None and x.dtype == np.int16:
        import ctypes

        xs = np.ascontiguousarray(x)
        return int(lib.mm_wirepack_count(
            xs.ctypes.data_as(ctypes.c_void_p), len(xs), k, w))
    body = delta_encode(x, k)[k:]
    pos = np.nonzero(np.abs(body) >= (1 << (w - 1)))[0]
    return len(_with_dummies(pos, body)[0]) if len(pos) else 0


def _with_dummies(pos: np.ndarray, body: np.ndarray):
    """Insert dummy records (repeating a nearby in-range position) so
    every position delta fits uint16."""
    if not len(pos):
        return pos, np.zeros(0, np.int32)
    deltas = np.diff(pos, prepend=0)
    n_dum = np.maximum(0, (deltas - 1) // 65535)
    if n_dum.sum() == 0:
        return pos, body[pos]
    out_pos = []
    prev = 0
    for p, nd in zip(pos, n_dum):
        for j in range(int(nd)):
            out_pos.append(prev + 65535 * (j + 1))
        out_pos.append(int(p))
        prev = int(p)
    out_pos = np.asarray(out_pos, np.int64)
    return out_pos, body[out_pos]


def pack(x: np.ndarray, n_packed: int, k: int, w: int, e_cap: int,
         out: np.ndarray = None) -> np.ndarray:
    """Pack int16 samples (len(x) <= n_packed; the shortfall decodes
    as zero deltas, masked on device) into a u8 wire row.  Raises
    ValueError when the exceptions exceed e_cap (callers fall back to
    the raw wire).  Delegates to the native packer (wirepack.cpp,
    byte-identical — pinned by test_native_pack_byte_parity) when the
    library is available."""
    lib = _native()
    if lib is not None:
        import ctypes

        assert x.dtype == np.int16 and w % 2 == 0
        row_b = row_bytes(n_packed, k, w, e_cap)
        if out is None:
            out = np.empty(row_b, np.uint8)
        elif len(out) < row_b:
            raise ValueError(f"wire capacity {len(out)} < row {row_b}")
        xs = np.ascontiguousarray(x)
        rc = lib.mm_wirepack_pack(
            xs.ctypes.data_as(ctypes.c_void_p), len(xs), n_packed,
            k, w, e_cap, out.ctypes.data_as(ctypes.c_void_p), len(out))
        if rc == -1:
            raise ValueError(f"exceptions exceed capacity {e_cap}")
        if rc < 0:
            raise ValueError(f"native pack rejected args rc={rc}")
        return out
    return _pack_py(x, n_packed, k, w, e_cap, out)


def _pack_py(x: np.ndarray, n_packed: int, k: int, w: int, e_cap: int,
             out: np.ndarray = None) -> np.ndarray:
    """Pure-NumPy packer — the behavioral reference for wirepack.cpp."""
    assert x.dtype == np.int16 and w % 2 == 0
    d = delta_encode(x, k)
    body = d[k:]
    G, base16, pos16, val16, row16 = _layout(n_packed, k, w, e_cap)
    exc_pos = np.nonzero(np.abs(body) >= (1 << (w - 1)))[0]
    exc_pos, exc_val = _with_dummies(exc_pos, body)
    n_exc = len(exc_pos)
    if n_exc > e_cap:
        raise ValueError(f"{n_exc} exceptions > capacity {e_cap}")
    if out is None:
        out = np.zeros(2 * row16, np.uint8)
    elif len(out) < 2 * row16:
        raise ValueError(f"wire capacity {len(out)} < row {2 * row16}")
    o16 = out.view(np.uint16)
    hdr = np.zeros(12, np.int32)
    hdr[:k] = d[:k]
    hdr[6] = n_exc
    o16[:24] = hdr.view(np.uint16)
    # base payload: exception slots pack as 0 (overwritten on device)
    bb = body.copy()
    if n_exc:
        bb[exc_pos] = 0
    q = np.zeros(8 * G, np.int32)
    q[:len(bb)] = bb
    q = q.reshape(8, G)                     # lane j = body[j*G:(j+1)*G]
    mask = np.int32((1 << w) - 1)
    for h in range(w // 2):                 # plane h = bits [16h, 16h+16)
        acc = np.zeros(G, np.int32)
        for j in range(8):
            lo = j * w - 16 * h
            if lo >= 16 or lo + w <= 0:
                continue
            vj = q[j] & mask
            acc |= (vj << lo) if lo >= 0 else (vj >> -lo)
        o16[base16 + h * G:base16 + (h + 1) * G] = (
            acc & np.int32(0xFFFF)).astype(np.uint16)
    if n_exc:
        pd = np.diff(exc_pos, prepend=0).astype(np.uint16)
        o16[pos16:pos16 + n_exc] = pd
        v = exc_val.astype(np.int32)
        # pad slots are dropped on device via the header's n_exc
        o16[val16:val16 + n_exc] = (v & 0xFFFF).astype(np.uint16)
        o16[val16 + e_cap:val16 + e_cap + n_exc] = (
            (v >> 16) & 0xFFFF).astype(np.uint16)
    return out


def unpack_expand(wire, totals, k: int, w: int, n_packed: int,
                  e_cap: int, n_target: int, extra: int = 0):
    """Device-side inverse of pack (minimodem_tpu/ops/wirepack.py:299-360):
    int16-framed wire [B, row16] -> float32 samples [B, n_target] on the
    wire's device, normalized exactly like the int16 wire (v / 32768),
    with positions >= totals + extra masked to exact 0.0 (expand_wire's
    rule for the raw-u8 wires).  Dense except one e_cap-element scatter:
    the 8 lane decodes are static shifts of contiguous [B, G] planes, and
    reconstruction is k inclusive scans.

    Integer widths: every 32-bit word is built as hi * 65536 + lo from
    the signed high half, which never overflows int32 (no shift that
    wraps); the scans run in int64, exact at every position, including
    the zero-delta extension past n_packed that the mask then zeroes."""
    import torch

    from .device_rx import expand_wire

    if wire.dtype != torch.int16:
        raise ValueError(f"a dpack wire is int16-framed, got {wire.dtype}")
    b = wire.shape[0]
    G, base16, pos16, val16, _ = _layout(n_packed, k, w, e_cap)

    def u16(sl):                                 # zero-extended halves
        return sl.to(torch.int32) & 0xFFFF

    def i32(lo, hi):                             # lo | hi << 16, hi signed
        return hi.to(torch.int32) * 65536 + u16(lo)

    hdr = i32(wire[:, 0:24:2], wire[:, 1:24:2])  # [B, 12]
    p = [u16(wire[:, base16 + h * G:base16 + (h + 1) * G])
         for h in range(w // 2)]
    p.append(torch.zeros_like(p[0]))
    mask, sign = (1 << w) - 1, 1 << (w - 1)
    cols = []
    for j in range(8):
        o, s = divmod(j * w, 16)                 # static per lane
        # s + w <= 28, so only the next plane's low 13 bits reach the
        # lane: the pair fits 29 bits
        v = ((p[o] | ((p[o + 1] & 0x1FFF) << 16)) >> s) & mask
        cols.append(v - ((v & sign) << 1))       # sign-extend
    body = torch.cat(cols, dim=1)                # [B, 8G] natural order
    if e_cap:
        # pos-delta scan -> absolute positions, one scatter.  Slots past
        # the header's n_exc (or out of range) go to a spare column that
        # is cut after the scatter: JAX's .at[].set(mode="drop")
        pos = torch.cumsum(u16(wire[:, pos16:pos16 + e_cap]), dim=1,
                           dtype=torch.int64)
        slot = torch.arange(e_cap, device=wire.device)
        live = (slot[None, :] < hdr[:, 6:7]) & (pos < 8 * G)
        pos = torch.where(live, pos, 8 * G)
        val = i32(wire[:, val16:val16 + e_cap],
                  wire[:, val16 + e_cap:val16 + 2 * e_cap])
        body = torch.cat([body, body.new_zeros((b, 1))], dim=1)
        body.scatter_(1, pos, val)
        body = body[:, :8 * G]
    d = torch.cat([hdr[:, :k], body], dim=1) if k else body
    if d.shape[1] >= n_target:
        d = d[:, :n_target]
    else:
        d = torch.nn.functional.pad(d, (0, n_target - d.shape[1]))
    for _ in range(k):
        d = torch.cumsum(d, dim=1, dtype=torch.int64)
    # the int16 wire's own normalization and tail mask, so the rounding
    # cannot drift from the raw wire's
    return expand_wire(d, totals, "int16", extra)


def exc_capacity(n_exc: int) -> int:
    """Exception capacity bucket: headroom + alignment so segments of
    similar content share one receiver program."""
    return (-(-(n_exc + n_exc // 4 + 512) // _EXC_ALIGN) * _EXC_ALIGN)


def row_bytes(n_packed: int, k: int, w: int, e_cap: int) -> int:
    return 2 * _layout(n_packed, k, w, e_cap)[4]


def default_on() -> bool:
    """Whether "auto" wire packing engages: OFF unless
    MINIMODEM_TPU_WIREPACK=1/on.  The packed wire trades host pack time
    for link bytes, so it pays only on a host link slower than the pack
    (PERF.md: the break-even rate on the port's card)."""
    import os

    return os.environ.get("MINIMODEM_TPU_WIREPACK", "") in ("1", "on")


def spec_str(k: int, w: int, n_packed: int, e_cap: int) -> str:
    """Wire-dtype token for the RX builder caches (all layout params)."""
    return f"dpack{k}w{w}n{n_packed}e{e_cap}"


def parse_spec(s: str):
    """-> (k, w, n_packed, e_cap) or None if s is not a dpack token."""
    if not (isinstance(s, str) and s.startswith("dpack")):
        return None
    body = s[5:]
    k, rest = body.split("w")
    w, rest = rest.split("n")
    n, e = rest.split("e")
    return int(k), int(w), int(n), int(e)
