"""The product path's device decimation against its least time: the
least time of one block's ÷2^k (roofline.decimator_least_ms) over the
device ms a block of K1's kernel, picked out by its name."""

from portbench import roofline

KERNEL = "flat_decimate_kernel"


def read(view):
    s = view.stretch
    if s is None:
        return None
    ms = s.device_ms_per_block(lambda op: KERNEL in op.name)
    if not ms:
        return None
    least = roofline.decimator_least_ms(view.config["device_block"], view.config["log2_decim"])
    return 100.0 * least / ms
