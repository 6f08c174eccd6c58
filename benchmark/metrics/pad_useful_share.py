"""pad_useful_share: the window's real node rows over its padded node rows
(each batch's `node_mask`), in %."""


def read(rec):
    if not rec["padded"]["nodes"]:
        return None
    return rec["real"]["nodes"] / rec["padded"]["nodes"] * 100.0
