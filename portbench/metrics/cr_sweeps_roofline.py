"""Kernels #4 + #5 + #6's share of their roofline on the finest level's CR
solve: a factor, an apply and a back-substitution sweep over the levels of
the chain of N + 1 blocks padded to a power of two, per LM step of that
level (the coarser levels run no CR kernel)."""

from portbench import roofline


def read(r):
    t = r.family_seconds_per_step("cr")
    return roofline.share(roofline.cr_sweeps_work(
        r.steps[-1][0] + 1, r.config["rhs"], r.config["chain_block"],
        r.width), t, r.width)
