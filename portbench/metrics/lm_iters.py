"""LM iterations a solve (``SolveStats.iterations``, summed over a
ladder's levels), the mean over the window's solves."""


def read(r):
    return sum(r.iterations) / len(r.iterations) if r.iterations else None
