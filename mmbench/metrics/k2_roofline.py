"""k2_roofline: the carrier state machine's share of its roofline.
Work a launch: each decoded frame's search reads its candidates'
confidences and the winner's amplitude and bits once (4 bytes each), and
the decoded output is written once; no FLOPs counted.  The searches of
carrier-less stretches are left out, so this share is a lower bound."""

from mmbench.readers import roofline_pct

KERNELS = ("mega_rx_kernel",)


def work(s):
    nbytes = s["streams"] * (s["frames"] * (s["candidates"] + 2) * 4
                             + s["bytes_out"])
    return nbytes, 0


def read(run):
    return roofline_pct(run, "statemachine", work, KERNELS, KERNELS[0])
