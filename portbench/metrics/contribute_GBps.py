"""Layer 1's hashing rate: the bytes of set-up's k `Replica.contribute`
calls (content ids, OR-Set adds) over their seconds by the host clock."""


def read(view):
    f = view.facts
    if not f.get("contribute_s"):
        return None
    return f["contribute_bytes"] / f["contribute_s"] / 1e9
