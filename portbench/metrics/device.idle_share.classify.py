"""Share of the traced invocations' service time (featurize to feedback)
in which no device operation ran, in percent."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
