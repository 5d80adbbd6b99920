"""The share of the tensors the optimizer updated through its list-wise
step, in %: the program's `optim.multi_tensor` over it and
`optim.per_tensor`, in the traced stretch. A program that counts neither
(one whose optimizer loops over the tensors uncounted) gives None."""

from asrbench.spans import summary


def read(tr):
    s = summary()
    if s is None:
        return None
    multi = s.get("optim.multi_tensor", 0)
    whole = multi + s.get("optim.per_tensor", 0)
    return 100.0 * multi / whole if whole else None
