"""Kernel #1's share of its roofline on the headline's KKT solve: the least
time of the work (``roofline.kkt_work`` at K = N + 1 blocks) over the
device time of the SPIKE family per LM step."""

from portbench import roofline


def read(r):
    t = r.family_seconds_per_step("spike")
    n = r.steps[-1][0]
    return roofline.share(roofline.kkt_work(n + 1, r.config["nq"],
                                            r.config["chain_block"], r.width),
                          t, r.width)
