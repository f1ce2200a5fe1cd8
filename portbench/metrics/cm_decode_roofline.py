"""K2's share of its roofline, %: the least time of the op's CM payloads and rows over K2's device time."""


def read(ctx):
    return ctx.cm_roofline("cm_decode_kernel", "decode")
