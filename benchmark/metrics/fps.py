"""fps: frames tracked in the window over the window's seconds (every
instance's frame counts)."""


def read(rec):
    return rec["frames"] / rec["seconds"]
