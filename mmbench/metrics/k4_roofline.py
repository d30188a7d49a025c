"""k4_roofline: the loopback synthesis's share of its roofline.  Work
a launch: every stream's samples written once (float32) and its bit
schedule read once (a bit a bit); a multiply-add a sample."""

from mmbench.readers import roofline_pct

KERNELS = ("tx_synth_bits_kernel", "tx_synth_prefix_kernel")


def work(s):
    nbytes = s["streams"] * (s["samples"] * 4 + s["bits"] / 8)
    return nbytes, 2 * s["streams"] * s["samples"]


def read(run):
    return roofline_pct(run, "synthesis", work, KERNELS, KERNELS[0])
