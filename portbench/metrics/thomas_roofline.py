"""Kernel #7's share of its roofline on the batch's E chains of N + 1
blocks with r = 1 + nq right-hand sides."""

from portbench import roofline


def read(r):
    t = r.family_seconds_per_step("thomas")
    return roofline.share(roofline.chain_work(
        r.steps[-1][0] + 1, r.config["rhs"], r.config["chain_block"],
        r.width, chains=r.config["experiments"]), t, r.width)
