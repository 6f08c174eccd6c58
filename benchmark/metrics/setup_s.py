"""setup_s: host clock from the end of PyTorch's own import to the
window's start (`run.T_START`)."""


def read(rec):
    return rec["setup_s"]
