"""k1_roofline: the fused scorer's share of its roofline.  Work a
launch: every stream's audio read once (its offsets plus the frame's halo,
float32) and its score planes written once (int32); the correlation's 4 x
nb multiply-adds an offset, the magnitudes and the frame channels' sums
(10 + 6 n_bits + 6 FLOPs an offset)."""

from mmbench.readers import roofline_pct

KERNELS = ("fused_score_kernel",)


def work(s):
    n = s["streams"] * s["offsets"]
    nbytes = s["streams"] * (s["offsets"] + s["halo"]) * 4 + \
        n * s["planes"] * 4
    flops = n * (8 * s["nb"] + 10 + 6 * s["n_bits"] + 6)
    return nbytes, flops


def read(run):
    return roofline_pct(run, "score", work, KERNELS, KERNELS[0])
