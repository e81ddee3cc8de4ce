"""Device: the share of the traced window in which no kernel, copy or set
ran on the card, %."""

from bench360.metrics._idle import idle


def read(ctx):
    return idle(ctx)
