"""setup_s: seconds from the process's start to the window's (imports, the
kernel library's build or load, the model build, reset, one warm-up unit)."""


def read(rec):
    return rec.setup_s
