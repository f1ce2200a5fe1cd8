"""Device seconds an op of K2 (cm_decode_kernel), from the device trace."""


def read(ctx):
    return ctx.kernel_s("cm_decode_kernel", "decode")
