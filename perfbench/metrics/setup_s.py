"""Process start to the first timed step or request, in seconds."""


def read(run):
    return run.setup_s
