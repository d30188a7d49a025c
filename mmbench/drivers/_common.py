"""What the drivers share: the program's modem configuration for a
configuration file, the reference run in blocks of streams, and the
comparison of per-stream results."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import modem, score, statemachine

# streams the reference scores at once on the card (its float64
# temporaries take ~0.35 GB a stream of 2^21 samples)
REF_BLOCK = 8


def program_config(cell):
    """The program's ModemConfig for the configuration file's baudmode,
    held to the file's stated parameters."""
    from minimodem_tpu_torch.models.presets import PRESETS
    from minimodem_tpu_torch.ops.demod import geometry_from_config

    m = cell.config["modem"]
    cfg = PRESETS[cell.config["baudmode"]](sample_rate=m["sample_rate"]).cfg
    stated = {k: (float(v) if isinstance(v, float) else v)
              for k, v in m.items()}
    got = {k: (float(getattr(cfg, k)) if isinstance(stated[k], float)
               else getattr(cfg, k)) for k in stated}
    if got != stated:
        mode = cell.config["baudmode"]
        raise ValueError(f"{cell.config_name}: the program's {mode} is "
                         f"{got}, the file states {stated}")
    geo = geometry_from_config(cfg)
    if geo.use_f64 != (cell.config["precision"] == "float64"):
        raise ValueError(f"{cell.config_name}: the program scores in "
                         f"{'float64' if geo.use_f64 else 'float32'}")
    return cfg


def ref_planes(x: np.ndarray, g, t_total: int, device: str,
               precision: str = "float32"):
    """Score planes [B, P, t_total] int32 (numpy) of float32 rows x
    [B, >= t_total + halo], in blocks of REF_BLOCK streams on `device`."""
    out = []
    for i in range(0, len(x), REF_BLOCK):
        xt = torch.from_numpy(np.ascontiguousarray(x[i:i + REF_BLOCK])).to(
            device)
        out.append(score.planes(xt, g, t_total, precision).cpu().numpy())
        del xt
    return np.concatenate(out) if out else np.zeros((0, g.n_planes, t_total),
                                                    np.int32)


def ref_decode(planes: np.ndarray, g, t_total: int, totals, compact: bool,
               thr: float, lim: float) -> list:
    """Per stream: (ev_type, ev_pay[, bytes]) as the receiver returns
    them."""
    st = modem.statics(g, t_total, compact)
    out = []
    for p, total in zip(planes, totals):
        rec, by = statemachine.run_stream(g, st, p, int(total), thr, lim)
        ev = statemachine.events(rec)
        out.append((*ev, by) if compact else ev)
    return out


def same(a, b) -> bool:
    """Two per-stream results (tuples of arrays) equal element for
    element, dtype and shape."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or not np.array_equal(x.view(np.uint8),
                                                    y.view(np.uint8)):
            return False
    return True


def differing(kept: dict, ref: dict) -> int:
    """Sampled answers (key -> every result the program gave for it in the
    window) that differ from the reference's at least once, or that the
    window never produced."""
    return sum(1 for k, r in ref.items()
               if not kept.get(k) or not all(same(p, r) for p in kept[k]))
