"""The bank gear's device decimation against its least time: the least
time of one block's ÷2^k over the device ms a block launched inside the
gear's decimator range."""

from portbench import roofline

RANGE = "gear ÷2^k decimator"


def read(view):
    s = view.stretch
    if s is None:
        return None
    ms = s.device_ms_per_block(lambda op: op.owner == RANGE)
    if not ms:
        return None
    least = roofline.decimator_least_ms(view.config["block"], view.config["log2_decim"])
    return 100.0 * least / ms
