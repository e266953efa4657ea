"""setup_s: seconds from the process's start to the first timed unit."""


def read(r):
    return r.setup_s
