"""graph_captures: CUDA graphs captured inside the window
(`ops._build.graph_counts['captured']`'s rise); 0 when set-up warmed every
shape the window meets."""


def read(rec):
    return float(rec["graph_captures"])
