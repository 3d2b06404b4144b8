"""Set-up: the process's start to the end of the entry's warm-up, host clock, s."""

def read(run):
    return run.setup_s
