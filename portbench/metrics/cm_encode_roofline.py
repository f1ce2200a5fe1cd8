"""K1's share of its roofline, %: the least time of the op's CM rows and payloads over K1's device time."""


def read(ctx):
    return ctx.cm_roofline("cm_encode_kernel", "encode")
