"""audio_rate: audio seconds whose decode reached the host in the window,
summed over every stream of every batch collected, over the window's
seconds.  audio_rate.<suffix> is the same reading under a bound of its
own, in cells whose runs spread otherwise."""

from mmbench.readers import audio_rate


def read(run):
    return audio_rate(run)
