"""Utterances a forward in the traced stretch: the utterances of its calls
over the frontend kernel's launches (one a forward)."""


def read(tr):
    n = tr.get("launches", {}).get("frontend", 0)
    return tr["utterances"] / n if n and tr.get("utterances") else None
