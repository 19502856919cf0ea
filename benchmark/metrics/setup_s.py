"""setup_s: process start to the first timed frame (imports, world,
kernel library load or build, the program's state, warm-up frames)."""


def read(rec):
    return rec["setup_s"]
