"""Share of the encode calls' time with no operation on the card, %, from the device trace."""


def read(ctx):
    return ctx.idle_pct("encode")
