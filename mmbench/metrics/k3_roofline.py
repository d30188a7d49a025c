"""k3_roofline: the stage-1 correlation's share of its roofline.  Work
a launch (a tile): every stream's samples read once (float32) and its four
correlation rows written once (float32); 4 x nb multiply-adds an
offset."""

from mmbench.readers import roofline_pct

KERNELS = ("correlate_kernel",)


def work(s):
    n = s["streams"] * s["offsets"]
    nbytes = s["streams"] * (s["offsets"] + s["nb"] - 1) * 4 + n * 4 * 4
    return nbytes, n * 8 * s["nb"]


def read(run):
    return roofline_pct(run, "stage1", work, KERNELS, KERNELS[0])
