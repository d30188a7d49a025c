"""K1, the fused scorer, timed and censused on the card, to compare two
trees of the repository in one call (in turns: A, B, B, A).  Run from a
tree's root: it imports that tree's minimodem_tpu_torch.

    cd <tree> && python3 <this file> [--out FILE] [--split] [--sweep]

Prints one JSON line, and appends it to FILE where given:

- `card`: nvidia-smi's name and power limit.
- `census`: K1's kernels as the tree builds them, one entry an
  instantiation (its template arguments, none before the buckets):
  registers, spill bytes and static shared memory (nvcc -Xptxas -v on
  csrc/fused_score.cu at the library's flags), the CTAs resident per SM at
  each preset geometry's shared memory (and, where the tree queries it,
  the occupancy API's count: `ctas_api`), and static SASS counts of the
  loaded library (cuobjdump -sass) by instruction class: stage 1's tap
  loop per tap and offset, its task loop outside the tap loop per offset,
  stage 2's loop (the one that stores the planes) per pass of its
  offsets a thread, with its MUFU operations and FCHK tests (one in each
  inline __fdiv_rn, none in __frcp_rn) and the loops nested in it.
- `loopback`: K1 at the headline loopback buffer [128, 3146168] (K4's
  synthesis of 128 streams of 64.3 s of Bell-202, bench.py's payloads):
  alone (torch.profiler, the kernel's device time) and queued (CUDA
  events over launches queued behind a sleeping kernel); its first 8 rows
  against score_planes_plain (words differing; launched at the whole
  buffer's run of tiles) and the share of their offsets whose stage-2
  guard takes the IEEE division (`guard_share`).
- `skimmer`: K1 at rtty.skimmer32's shape, [32, 3145728 + halo] of keyed
  RTTY text under noise; `alerts`: at same.alerts128's, [128, 3407872 +
  halo] of keyed SAME bytes under noise, its first 2 rows against
  score_planes_plain; `file` and `stream`: Bell-202 at the file decode's
  segment [1, 2^21 + halo] and a streaming segment's [1, 65536 + halo].
  Each alone and queued, with the tiles a CTA walks there (`run`, for a
  tree that walks them) and the card's CTA slots at the geometry
  (`slots`: SMs x CTAs an SM, from the occupancy API).
- `sweep` (with --sweep): K1 at the skimmer and alerts shapes at the runs
  that pick_run gives for RUN_WAVES of 2, 4, 8, 16 and 32, alone and
  queued, to settle RUN_WAVES.
- `split` (with --split): the tree's K1 against variants built from a
  copy of its csrc/fused_score.cu in a temporary directory, never the
  package: `nodiv`, every __fdiv_rn a multiply; `stage1`, stage 2
  replaced by one store of each offset's signal and noise words into its
  planes.  Alone and queued at the loopback buffer and at the skimmer and
  alerts shapes.
- `rows`: the batched loopback (bench.py; synchronous, pipeline 8).
"""

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PRESETS = ("1200", "300", "same", "rtty")     # K1's CTA sizes
SM_SMEM = 233472          # an H100 SM's shared memory a CTA can use, bytes
SM_REGS = 65536
THREADS = 256             # K1's CTA


def queued_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alone_ms(fn, reps=5, tries=5):
    """Device time a call of the kernels named fused_score* (torch.profiler),
    None when five windows saw none of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if "fused_score" in e.key)
        if us:
            return us / reps / 1e3
    return None


def guard_share(x, geo, t_len) -> dict:
    """The offsets of x's rows whose stage-2 guard (csrc/fused_score.cu
    averages()) takes the IEEE division: tsig above the window's top, or
    an average that a tap divides by outside the window.  The comb sums
    as the plain version takes them (ops/demod.py score_frame_channels).
    None for a tree without the guard."""
    import numpy as np
    import torch

    from minimodem_tpu_torch.ops import fused_score
    from minimodem_tpu_torch.ops.demod import correlate, make_basis

    if not hasattr(fused_score, "RCP_WINDOW"):
        return None                   # a K1 that divides every tap by IEEE
    lo, hi = fused_score.RCP_WINDOW
    basis = torch.from_numpy(make_basis(geo, np.float32)).to(x.device)
    c = correlate(x[:, :t_len + geo.halo], basis, t_len + geo.max_begin)
    scal = float(np.float32(geo.magscalar))

    def mag(re_, im):
        return torch.sqrt((re_ * re_ + im * im).double()).float() * scal

    mm, ms = mag(c[:, 0], c[:, 1]), mag(c[:, 2], c[:, 3])
    bit = mm > ms
    sig = torch.where(bit, mm, ms)
    zero = torch.zeros((x.shape[0], t_len), device=x.device)
    tsig, msig = zero, zero
    n_mark = torch.zeros(zero.shape, dtype=torch.int32, device=x.device)
    for k in range(geo.n_bits):
        o = int(geo.bit_begin[k])
        sk, bk = sig[:, o:o + t_len], bit[:, o:o + t_len]
        tsig = tsig + sk
        msig = msig + torch.where(bk, sk, zero)
        n_mark = n_mark + bk.int()
    nm = n_mark.float()
    ns = torch.full_like(zero, float(geo.n_bits)) - nm
    avg_m = torch.where(nm > 0, msig / nm, zero)
    avg_s = torch.where(ns > 0, (tsig - msig) / ns, zero)

    def inw(v):
        return (v >= lo) & (v <= hi)

    fast = (tsig <= hi) & ((n_mark == 0) | inw(avg_m)) & (
        (n_mark == geo.n_bits) | inw(avg_s))
    n = fast.numel()
    slow = int((~fast).sum())
    return {"offsets": n, "fallback": slow, "share": slow / n}


def _regions(code):
    """Loops of a SASS function: (start, end) index pairs of the regions a
    backward branch closes, one a start (the farthest branch)."""
    at = {e[0]: i for i, e in enumerate(code)}
    ends = {}
    for j, (_, op, _, tgt) in enumerate(code):
        if op == "BRA" and tgt in at and at[tgt] <= j:
            ends[at[tgt]] = max(ends.get(at[tgt], j), j)
    return sorted(ends.items())


def _counts(code, idx, smoke) -> dict:
    cls = {}
    for i in idx:
        _, op, mods, _ = code[i]
        if op == "NOP":
            continue
        c = smoke.sass_class(op)
        cls[c] = cls.get(c, 0) + 1
        for key, hit in (("mufu", op == "MUFU"), ("fchk", op == "FCHK"),
                         ("ffma", op == "FFMA"),
                         ("lds128", op == "LDS" and ".128" in mods)):
            if hit:
                cls[key] = cls.get(key, 0) + 1
    cls["issue"] = sum(v for k, v in cls.items() if k not in (
        "mufu", "fchk", "ffma", "lds128"))
    return cls


def _scaled(cnt: dict, by: float) -> dict:
    return {k: round(v / by, 3) for k, v in sorted(cnt.items())}


def sass_census(code, q: int, smoke) -> dict:
    """Stage 1's tap loop (of the loops with 32 FFMA or more outside their
    nested loops, the one that is most FFMA; 4 FFMA a tap and offset), its
    task loop (the innermost loop
    around it, outside it, per offset of its kR = 8), and stage 2's loop
    (the innermost holding an STG), per pass of q offsets, with each loop
    nested in it."""
    regs = _regions(code)
    inner = {}
    for s, e in regs:
        nested = [(a, b) for a, b in regs if s <= a and b <= e
                  and (a, b) != (s, e)]
        inner[(s, e)] = [i for i in range(s, e + 1)
                         if not any(a <= i <= b for a, b in nested)]
    own = {r: _counts(code, idx, smoke) for r, idx in inner.items()}
    taps = [r for r in own if own[r].get("ffma", 0) >= 32]
    tap = max(taps, key=lambda r: own[r]["ffma"] / own[r]["issue"],
              default=None)
    out = {}
    if tap:
        out["stage1_tap_loop_per_tap_offset"] = _scaled(
            own[tap], own[tap]["ffma"] / 4)
        around = [r for r in regs if r[0] <= tap[0] and tap[1] <= r[1]
                  and r != tap]
        if around:
            task = min(around, key=lambda r: r[1] - r[0])
            out["stage1_task_loop_per_offset"] = _scaled(own[task], 8)
    stg = [r for r in regs if any(code[i][1] == "STG"
                                  for i in range(r[0], r[1] + 1))]
    if stg:
        s2 = min(stg, key=lambda r: r[1] - r[0])
        out["stage2_offsets_a_pass"] = q
        out["stage2_loop_a_pass"] = own[s2]
        out["stage2_nested"] = [own[r] for r in regs if r != s2
                                and s2[0] <= r[0] and r[1] <= s2[1]]
    return out


def _template_args(name: str):
    m = re.search(r"fused_score_kernel(I(?:Li\d+E|Lb[01]E)+E)", name)
    return [int(a) for a in re.findall(r"L[ib](\d+)E", m.group(1))] if m \
        else []


def ctas_per_sm(regs, smem_dyn, smem_static) -> int:
    warp_regs = math.ceil(regs * 32 / 256) * 256
    by_regs = SM_REGS // (warp_regs * THREADS // 32)
    by_smem = SM_SMEM // (smem_dyn + smem_static + 1024)
    return min(by_regs, by_smem, 2048 // THREADS)


def preset_smem() -> dict:
    """Each preset's K1 CTA: (shared memory at its tile, frame bits)."""
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops import fused_score
    from minimodem_tpu_torch.ops.device_rx import device_rx_key, geo_from_key

    out = {}
    for mode in PRESETS:
        geo = geo_from_key(device_rx_key(FskModem(mode, device="cpu").cfg))
        out[mode] = (fused_score.smem_bytes(geo, fused_score.pick_tile(geo)),
                     geo.n_bits)
    return out


def ptxas_info(text: str) -> dict:
    """nvcc -Xptxas -v output -> {entry: {registers, smem_static, spill}}
    for K1's kernels."""
    info, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if "fused_score_kernel" in m.group(1) else None
            if cur:
                info[cur] = {"template": _template_args(cur)}
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            info[cur]["smem_static"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info[cur]["spill"] = [int(m.group(1)), int(m.group(2))]
    return info


def k1_census(smoke) -> dict:
    from minimodem_tpu_torch.ops import _kernels

    nvcc = _kernels.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    lib = _kernels.load()._name
    r = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                       text=True, timeout=300)
    funcs = smoke.sass_functions(r.stdout) if r.returncode == 0 else {}
    # the anonymous namespace's mangled name differs from build to build:
    # the library's functions by their template arguments
    by_args = {tuple(_template_args(f)): c for f, c in funcs.items()
               if "fused_score_kernel" in f}
    sizes = preset_smem()
    with tempfile.TemporaryDirectory() as tmp:
        v = subprocess.run(
            [nvcc, *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "k1.o"),
             str(_kernels.SRC_DIR / "fused_score.cu")],
            capture_output=True, text=True, timeout=300)
    info = ptxas_info(v.stdout + v.stderr)
    res = {}
    for name, d in info.items():
        targs = d["template"]
        q = targs[2] if targs else 4          # stage 2's offsets a thread
        regs = d.get("registers")
        entry = dict(d)
        if regs:
            entry["ctas_per_sm"] = {
                k: ctas_per_sm(regs, s, d.get("smem_static", 0))
                for k, (s, _) in sizes.items()}
        code = by_args.get(tuple(targs))
        if code:
            entry["sass_lines"] = len(code)
            entry.update(sass_census(code, q, smoke))
        res[name] = entry
    res["cuobjdump"] = r.returncode == 0
    res["ctas_api"] = ctas_api()
    return res


def ctas_api() -> dict:
    """Each preset's CTAs an SM as the tree's launcher reads them from the
    occupancy API (fused_score.card_slots / the SMs); None for a tree that
    does not query it."""
    import torch

    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops import fused_score
    from minimodem_tpu_torch.ops.device_rx import device_rx_key, geo_from_key

    if not hasattr(fused_score, "card_slots"):
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {mode: fused_score.card_slots(
        geo_from_key(device_rx_key(FskModem(mode, device="cpu").cfg)),
        torch.device("cuda", 0)) // sms for mode in PRESETS}


def _stage2_span(src: str):
    """(start, end) of stage 2 in a copy of csrc/fused_score.cu: from its
    marker comment to the end of the kernel that holds it."""
    s = src.index("    // ---- stage 2")
    depth, i = 0, s
    while True:
        ch = src[i]
        if ch == "{":
            depth += 1
        elif ch == "}":
            if depth == 0:
                return s, i
            depth -= 1
        i += 1


def _stage1_only(src: str) -> str:
    s, e = _stage2_span(src)
    read = ("const float2 p = sn[at]; const int w0 = __float_as_int(p.x), "
            "w1 = __float_as_int(p.y);") if "float2* sn" in src else (
        "const int w0 = __float_as_int(ss[at]), "
        "w1 = __float_as_int(ng[at]);")
    body = f"""    // variant: an offset's signal and noise words as its planes
    const long long plane = (long long)t_len;
    int* orow = out + (long long)b * n_planes * plane + t0;
    for (int t = tid; t < n_t; t += kThreads) {{
        const int at = (t & 3) * ph + (t >> 2);
        {read}
        for (int p = 0; p < n_planes; ++p)
            orow[p * plane + t] = p == 2 ? w1 : w0;
    }}
"""
    return src[:s] + body + src[e:]


VARIANTS = {"nodiv": lambda s: s.replace("__fdiv_rn(", "__fmul_rn("),
            "stage1": _stage1_only}


def build_variant(name: str, tmp: str):
    """A copy of the tree's csrc/fused_score.cu, changed by VARIANTS[name],
    built alone into a library in tmp; None where the change does not
    apply."""
    import ctypes

    from minimodem_tpu_torch.ops import _kernels

    src = (_kernels.SRC_DIR / "fused_score.cu").read_text()
    try:
        var = VARIANTS[name](src)
    except ValueError:
        return None
    cu = os.path.join(tmp, f"{name}.cu")
    Path(cu).write_text(var)
    so = os.path.join(tmp, f"{name}.so")
    r = subprocess.run([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS,
                        "-Xptxas", "-v", "-shared", "-I",
                        str(_kernels.SRC_DIR), "-o", so, cu], check=True,
                       capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(so)
    lib.mm_fused_score.argtypes = _kernels._SIGNATURES["mm_fused_score"]
    lib.mm_fused_score.restype = ctypes.c_int
    lib.ptxas = ptxas_info(r.stdout + r.stderr)
    return lib


def run_of(scorer, rows, t_len, dev):
    """The tiles a CTA of the tree's K1 walks at this shape; None for a
    tree whose CTAs score one tile each."""
    from minimodem_tpu_torch.ops import fused_score

    if not hasattr(fused_score, "pick_run"):
        return None
    return fused_score.pick_run(scorer.geo, rows, t_len,
                                fused_score.card_slots(scorer.geo, dev))


def launch_with(lib, scorer, x, t_len, out, run=None):
    """FusedScorer._launch's call, through another library; `run` for a
    tree that walks runs of tiles."""
    import numpy as np
    import torch

    from minimodem_tpu_torch.ops import _kernels, fused_score

    geo = scorer.geo
    basis, begin = scorer._device_consts(x.device)
    walk = () if run is None else (run,)
    err = lib.mm_fused_score(
        x.data_ptr(), x.stride(0), x.shape[0], t_len, basis.data_ptr(),
        geo.nb, begin.data_ptr(), geo.n_bits, geo.max_begin,
        float(np.float32(geo.magscalar)), scorer.d_mask, scorer.d_val,
        scorer.s_mask, scorer.s_val, scorer.n_planes, scorer.tile, *walk,
        fused_score.smem_bytes(geo, scorer.tile), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(err, "mm_fused_score (variant)")


def loopback_buffer(dev):
    """The headline loopback's audio [128, t_total + halo] by K4 and its
    scored length."""
    import numpy as np
    import torch

    from minimodem_tpu_torch import bench
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback, _sched_pad
    from minimodem_tpu_torch.ops.tx_device import tx_bit_schedule

    cfg = FskModem("1200", device="cpu").cfg
    base = bench._bench_payload(cfg, 64.3)
    head = [tx_bit_schedule(bytes((b + i) % 94 + 33 for b in base), cfg,
                            Ascii8Codec()) for i in range(128)]
    lb = DeviceLoopback(cfg, device=dev)
    b_pad = _sched_pad(max(len(s) for s in head))
    bits = np.zeros((len(head), b_pad), np.uint8)
    for i, sch in enumerate(head):
        bits[i, :len(sch)] = sch
    packed = torch.from_numpy(np.packbits(bits, axis=1,
                                          bitorder="little")).to(dev)
    loop = lb.build_loop(b_pad)
    return cfg, loop.synthesize(packed), loop.t_total


def skimmer_buffer(dev, t_len=12 << 18, rows=32):
    """rows of keyed RTTY text (Baudot letters) under uniform noise, each
    row the stream rotated, [rows, t_len + halo] float32."""
    import numpy as np
    import torch

    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import device_rx_key, geo_from_key

    m = FskModem("rtty", device="cpu")
    geo = geo_from_key(device_rx_key(m.cfg))
    rng = np.random.default_rng(45)
    text = bytes(rng.choice(list(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ "), 1200))
    wav = np.resize(m.modulate(text), t_len + geo.halo).astype(np.float32)
    x = np.stack([np.roll(wav, 977 * i) for i in range(rows)])
    x += (rng.random(x.shape, dtype=np.float32) - np.float32(0.5)) \
        * np.float32(0.6)
    return geo, torch.from_numpy(x).to(dev)


def keyed_buffer(dev, mode, t_len, rows, seed):
    """rows of keyed text (capitals and spaces) in `mode` under uniform
    noise, each row the stream rotated, [rows, t_len + halo] float32."""
    import numpy as np
    import torch

    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import device_rx_key, geo_from_key

    m = FskModem(mode, device="cpu")
    geo = geo_from_key(device_rx_key(m.cfg))
    rng = np.random.default_rng(seed)
    text = bytes(rng.choice(list(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ "), 1200))
    wav = np.resize(m.modulate(text), t_len + geo.halo).astype(np.float32)
    x = torch.empty((rows, t_len + geo.halo), dtype=torch.float32,
                    device=dev)
    noise = torch.Generator(device=dev).manual_seed(seed)
    w = torch.from_numpy(wav).to(dev)
    for i in range(rows):
        x[i] = torch.roll(w, 977 * i)
    x += (torch.rand(x.shape, generator=noise, device=dev) - 0.5) * 0.6
    return geo, x


def alerts_shape():
    """same.alerts128's K1 shape: (rows, the loopback's scored length of
    its 35,030-bit schedules)."""
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import (_round_up_pow2,
                                                   _sched_pad)

    cfg = FskModem("same", device="cpu").cfg
    return 128, _round_up_pow2(_sched_pad(35030) * cfg.bit_nsamples_tx
                               + cfg.nsamples_overscan + 1)


def time_shape(scorer, x, t_len, dev) -> dict:
    """K1 at one shape: alone and queued, with its run and slots."""
    from minimodem_tpu_torch.ops import fused_score

    res = {"shape": list(x.shape), "t_len": t_len}
    run = run_of(scorer, x.shape[0], t_len, dev)
    walk = ()
    if run is not None:
        res["run"], walk = run, (run,)
        res["slots"] = fused_score.card_slots(scorer.geo, dev)
    res["counts"] = fused_score.launch_counts(scorer.geo, x.shape[0], t_len,
                                              *walk)
    fn = lambda: scorer(x, t_len)                       # noqa: E731
    res["alone_ms"] = alone_ms(fn)
    res["queued_ms"] = queued_ms(fn)
    return res


def sweep(scorer, x, t_len, dev) -> dict:
    """K1 at the runs pick_run gives for RUN_WAVES of 2 .. 32."""
    from minimodem_tpu_torch.ops import fused_score

    if not hasattr(fused_score, "pick_run"):
        return None
    slots = fused_score.card_slots(scorer.geo, dev)
    res = {}
    for waves in (2, 4, 8, 16, 32):
        old = fused_score.RUN_WAVES
        fused_score.RUN_WAVES = waves
        try:
            run = fused_score.pick_run(scorer.geo, x.shape[0], t_len, slots)
        finally:
            fused_score.RUN_WAVES = old
        fn = lambda: scorer._launch(x, t_len, _run=run)   # noqa: E731
        res[str(waves)] = {"run": run, "alone_ms": alone_ms(fn),
                           "queued_ms": queued_ms(fn)}
    return res


def split_at(scorer, x, t_len, dev, tmp, libs) -> dict:
    """The variants and the tree's K1 at one shape, alone and queued."""
    import torch

    split = {}
    out = torch.empty((x.shape[0], scorer.n_planes, t_len),
                      dtype=torch.int32, device=dev)
    run = run_of(scorer, x.shape[0], t_len, dev)
    for name in VARIANTS:
        if name not in libs:
            t0 = time.perf_counter()
            libs[name] = build_variant(name, tmp)
            if libs[name] is not None:
                libs[name].build_s = time.perf_counter() - t0
        lib = libs[name]
        if lib is None:
            split[name] = None
            continue
        vrun = lambda: launch_with(lib, scorer, x, t_len, out, run)  # noqa
        split[name] = {"build_s": lib.build_s,
                       "ptxas": list(lib.ptxas.values()),
                       "alone_ms": alone_ms(vrun),
                       "queued_ms": queued_ms(vrun)}
    run_full = lambda: scorer(x, t_len)                 # noqa: E731
    split["full"] = {"alone_ms": alone_ms(run_full),
                     "queued_ms": queued_ms(run_full)}
    del out
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="append the JSON line to this file")
    ap.add_argument("--split", action="store_true",
                    help="time the nodiv and stage1 variants besides")
    ap.add_argument("--sweep", action="store_true",
                    help="time K1 at the runs of 2 .. 32 waves besides")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import importlib.util

    import torch

    import minimodem_tpu_torch
    from minimodem_tpu_torch import bench
    from minimodem_tpu_torch.ops.device_rx import device_rx_key, geo_from_key
    from minimodem_tpu_torch.ops.fused_score import (FusedScorer,
                                                     score_planes_plain)

    if not torch.cuda.is_available():
        print("E: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    res = {"tree": os.path.dirname(minimodem_tpu_torch.__file__),
           "card": card}
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res["census"] = k1_census(smoke)

    cfg, audio, t_total = loopback_buffer(dev)
    scorer = FusedScorer(geo_from_key(device_rx_key(cfg)))
    lb = time_shape(scorer, audio, t_total, dev)
    run = lb.get("run")
    sub = audio[:8].contiguous()
    got = (scorer(sub, t_total) if run is None
           else scorer._launch(sub, t_total, _run=run))
    ref = score_planes_plain(sub, scorer.geo, t_total)
    lb["rows_checked"] = 8
    lb["words_differing"] = int((got != ref).sum())
    del got, ref
    lb["guard"] = guard_share(sub, scorer.geo, t_total)
    torch.cuda.empty_cache()
    res["loopback"] = lb

    libs = {}
    tmp = tempfile.TemporaryDirectory()
    if args.split:
        res["split"] = {"loopback": split_at(scorer, audio, t_total, dev,
                                             tmp.name, libs)}
    del audio
    torch.cuda.empty_cache()

    geo, x = skimmer_buffer(dev)
    sk = FusedScorer(geo)
    res["skimmer"] = time_shape(sk, x, 12 << 18, dev)
    if args.sweep:
        res.setdefault("sweep", {})["skimmer"] = sweep(sk, x, 12 << 18, dev)
    if args.split:
        res["split"]["skimmer"] = split_at(sk, x, 12 << 18, dev, tmp.name,
                                           libs)
    del x
    torch.cuda.empty_cache()

    rows_a, t_a = alerts_shape()
    geo, x = keyed_buffer(dev, "same", t_a, rows_a, 46)
    al = FusedScorer(geo)
    res["alerts"] = time_shape(al, x, t_a, dev)
    sub = x[:2].contiguous()
    run = res["alerts"].get("run")
    got = (al(sub, t_a) if run is None
           else al._launch(sub, t_a, _run=run))
    ref = score_planes_plain(sub, geo, t_a)
    res["alerts"]["rows_checked"] = 2
    res["alerts"]["words_differing"] = int((got != ref).sum())
    del got, ref, sub
    if args.sweep:
        res.setdefault("sweep", {})["alerts"] = sweep(al, x, t_a, dev)
    if args.split:
        res["split"]["alerts"] = split_at(al, x, t_a, dev, tmp.name, libs)
    del x
    torch.cuda.empty_cache()
    tmp.cleanup()

    for name, t_len in (("file", 1 << 21), ("stream", 1 << 16)):
        geo, x = keyed_buffer(dev, "1200", t_len, 1, 47)
        res[name] = time_shape(FusedScorer(geo), x, t_len, dev)
        del x

    res["census"]["runs"] = {
        k: res[k].get("run") for k in ("loopback", "skimmer", "alerts",
                                       "file", "stream")}
    rows = {}
    for name, pipe in (("synchronous", 1), ("pipeline 8", 8)):
        r = bench.batched_loopback_throughput("1200", 64.3, 128,
                                              pipeline=pipe, device=dev)
        rows[name] = {"wall_ms": r["wall_seconds"] * 1e3,
                      "real_time_factor": r["real_time_factor"],
                      "decode_exact": r["decode_exact"]}
    res["rows"] = rows
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    ok = lb["words_differing"] == 0 == res["alerts"]["words_differing"] \
        and all(r["decode_exact"] for r in rows.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
