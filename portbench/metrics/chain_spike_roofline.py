"""Kernel #2's share of its roofline on the batch's concatenated chain of
E (N + 1) blocks with r = 1 + nq right-hand sides."""

from portbench import roofline


def read(r):
    t = r.family_seconds_per_step("spike")
    k = r.config["experiments"] * (r.steps[-1][0] + 1)
    return roofline.share(roofline.chain_work(k, r.config["rhs"],
                                              r.config["chain_block"],
                                              r.width), t, r.width)
