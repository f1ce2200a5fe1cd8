"""Device seconds an op of K1 (cm_encode_kernel), from the device trace."""


def read(ctx):
    return ctx.kernel_s("cm_encode_kernel", "encode")
