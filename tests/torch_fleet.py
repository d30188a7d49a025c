"""The port's side of the fleet parity tests (test_torch_service.py,
test_torch_sharding.py): the cases run on every rank of a world of gloo
processes on the CPU (minimodem_tpu_torch/parallel/launch.py
spawn_world), which import torch and the port only and send numpy results
back.  The inputs are made here, by the port's host TX (the JAX
package's code, copied), so the JAX side of a test reads the same arrays.
"""

import traceback

import numpy as np

SEED = 1200
THR, LIM = 1.5, 2.3

TEXTS = {
    "five": [b"stream zero", b"stream one is longer", b"s2",
             b"stream three ~!@#", b"stream four 44444"],
    "two": [b"parity check", b"abcdefgh" * 4],
    "three": [b"fleet mega ingest", b"stream two ~!@#", b"s3"],
    "sp": [b"sequence parallel stream zero", b"sp stream one ~!@#$%^&*()",
           b"x" * 40],
    "same": [b"ZCZC-WXR-RWT-000000+", b"NNNN"],
    "pad": [b"a", b"bb", b"ccc"],
    "loopback": [b"fleet stream zero", b"fs1", b"fleet stream two ~!@#",
                 b"D" * 40, b"fleet stream four"],
}


def modem(mode="1200"):
    from minimodem_tpu_torch.models.modem import FskModem

    return FskModem(mode, device="cpu")


def streams(name, mode="1200"):
    """The modulated texts of TEXTS[name]: a list of float32 arrays."""
    m = modem(mode)
    return [m.modulate(t) for t in TEXTS[name]]


def batch(name, mode="1200", enc=None):
    """(x [B, L], totals) of TEXTS[name]; enc: None (float32), "int16" or
    "ulaw" (the container codec's bytes)."""
    waves = streams(name, mode)
    if enc is not None:
        s16 = [np.clip(np.rint(w * 32768.0), -32768, 32767).astype(np.int16)
               for w in waves]
        if enc == "ulaw":
            from minimodem_tpu_torch.sigio.containers import _ulaw_encode

            waves = [_ulaw_encode(s) for s in s16]
        else:
            waves = s16
    x = np.zeros((len(waves), max(len(w) for w in waves)), waves[0].dtype)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    return x, [len(w) for w in waves]


def schedules(mode="1200"):
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.ops.tx_device import tx_bit_schedule

    cfg = modem(mode).cfg
    return [tx_bit_schedule(p, cfg, Ascii8Codec()) for p in TEXTS["loopback"]]


def step_samples(n_streams, t_len):
    """Noisy Bell-202 rows for the sharded scoring step: the text of
    TEXTS["sp"][0] plus uniform noise of amplitude 0.3 (finite
    confidences everywhere)."""
    rng = np.random.default_rng(SEED)
    wav = streams("sp")[0][:t_len]
    x = np.zeros((n_streams, t_len), np.float32)
    x[:, :len(wav)] = wav
    x += (rng.random(x.shape, dtype=np.float32) - np.float32(0.5)) \
        * np.float32(0.6)
    return x


def _error(fn):
    """(type name, message) of what fn() raises, or None."""
    try:
        fn()
    except (ValueError, AssertionError) as e:
        return type(e).__name__, str(e)
    return None


def _run_cases(cases) -> dict:
    """{name: result} with a failing case's traceback in its place (a case
    that raises on every rank leaves the others running)."""
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = ("error", traceback.format_exc())
    return out


def service_world() -> dict:
    """Every ShardedReceiver / ShardedLoopback case on a world of 4."""
    from minimodem_tpu_torch.parallel.service import (ShardedLoopback,
                                                      ShardedReceiver)
    from minimodem_tpu_torch.parallel.sharding import make_mesh

    mesh4 = make_mesh(4, dp=4, sp=1, device="cpu")
    mesh22 = make_mesh(4, dp=2, sp=2, device="cpu")
    mesh14 = make_mesh(4, dp=1, sp=4, device="cpu")
    cfg = modem().cfg

    def svc(mesh, mode="1200", **kw):
        return ShardedReceiver(modem(mode).cfg, mesh, device="cpu", **kw)

    def events(mesh, name, mode="1200", enc=None, **kw):
        x, totals = batch(name, mode, enc)
        return svc(mesh, mode, **kw).run_events_batch(
            x, totals, THR, LIM, in_encoding=enc if enc == "ulaw" else None)

    def compact_vs_wide():
        return {c: (svc(mesh4, compact=c).decode_batch(streams("three")),
                    events(mesh4, "three", compact=c)[0])
                for c in (True, False)}

    return _run_cases({
        "decode_dp4": lambda: svc(mesh4).decode_batch(streams("five")),
        "events_dp4": lambda: events(mesh4, "two"),
        "ulaw_dp4": lambda: events(mesh4, "three", enc="ulaw"),
        "compact_vs_wide_dp4": compact_vs_wide,
        "sp22": lambda: (svc(mesh22).decode_batch(streams("sp")),
                         events(mesh22, "sp")),
        "sp14": lambda: (svc(mesh14).decode_batch(streams("sp")),
                         events(mesh14, "sp")),
        "ulaw_sp22": lambda: events(mesh22, "three", enc="ulaw"),
        "int16_sp14": lambda: events(mesh14, "three", enc="int16"),
        "same_sp22": lambda: (svc(mesh22, "same").decode_batch(
                                  streams("same", "same")),
                              events(mesh22, "same", "same")),
        "loopback_dp4": lambda: ShardedLoopback(
            cfg, mesh4, device="cpu").run_events_batch(schedules()),
        "padding_dp4": lambda: svc(mesh4).decode_batch(streams("pad")),
        "errors": lambda: {
            "loopback_sp": _error(lambda: ShardedLoopback(cfg, mesh22,
                                                          device="cpu")),
            # 1 baud: a bit is 48000 samples, the halo far past t_local
            "halo_sp": _error(lambda: svc(mesh14, "1").run_events_batch(
                np.zeros((1, 100), np.float32), [100])),
        },
    })


def sharding_world() -> dict:
    """make_mesh and sharded_decode_step on a world of 4."""
    from minimodem_tpu_torch.parallel.sharding import (make_mesh,
                                                       sharded_decode_step)

    cfg = modem().cfg

    def shapes():
        return {
            "default": make_mesh(device="cpu").shape,
            "dp4": make_mesh(4, dp=4, device="cpu").shape,
            "sp4": make_mesh(4, sp=4, device="cpu").shape,
            "dp3": _error(lambda: make_mesh(4, dp=3, device="cpu")),
            "dp1sp1": _error(lambda: make_mesh(4, dp=1, sp=1,
                                               device="cpu")),
            "n8": _error(lambda: make_mesh(8, device="cpu")),
        }

    def step(dp, sp, n_streams, t_local):
        mesh = make_mesh(4, dp=dp, sp=sp, device="cpu")
        return sharded_decode_step(cfg, mesh,
                                   step_samples(n_streams, sp * t_local),
                                   t_local, "float32")

    def errors():
        mesh = make_mesh(4, dp=2, sp=2, device="cpu")
        return {
            "halo": _error(lambda: sharded_decode_step(
                cfg, mesh, np.zeros((2, 32), np.float32), 16, "float32")),
            "length": _error(lambda: sharded_decode_step(
                cfg, mesh, np.zeros((2, 9000), np.float32), 4096,
                "float32")),
            "batch": _error(lambda: sharded_decode_step(
                cfg, mesh, np.zeros((3, 100), np.float32), 4096,
                "float32")),
        }

    def devices():
        import os

        from minimodem_tpu_torch.parallel.sharding import rank_device

        return (int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"]),
                str(rank_device("cuda")), str(rank_device("cpu")))

    return _run_cases({
        "devices": devices,
        "mesh": shapes,
        "step_dp2_sp2": lambda: step(2, 2, 4, 1 << 12),
        "step_dp4_sp1": lambda: step(4, 1, 4, 1 << 12),
        "errors": errors,
    })
