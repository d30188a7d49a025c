"""k5_roofline: the frame channels' share of their roofline.  Work a
launch (a tile): the four correlation rows read once (float32) and the
score planes written once (int32); the magnitudes and the frame sums (10 +
6 n_bits + 6 FLOPs an offset)."""

from mmbench.readers import roofline_pct

KERNELS = ("magnitudes_kernel", "channels_kernel")


def work(s):
    n = s["streams"] * s["offsets"]
    nbytes = n * 4 * 4 + n * s["planes"] * 4
    return nbytes, n * (10 + 6 * s["n_bits"] + 6)


def read(run):
    return roofline_pct(run, "channels", work, KERNELS, KERNELS[1])
