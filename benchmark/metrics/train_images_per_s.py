"""train_images_per_s: every image trained in the window over the
window's wall time (host clock, from before its first step to the
synchronise after its last), epoch boundaries included."""


def read(rec):
    return rec["images"] / rec["window_s"]
