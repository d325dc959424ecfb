"""Percent of the captured solve's wall in which the device ran nothing:
1 - (device busy time of the profiled eager solve, the same kernels) /
(the mean window wall of the captured solves of the same data set)."""


def read(r):
    if r.summary is None or r.summary.busy_s <= 0 or r.captured_wall <= 0:
        return None
    return 100.0 * (1.0 - r.summary.busy_s / r.captured_wall)
