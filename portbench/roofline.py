"""The least time the chip could take for the block-tridiagonal solves the
cells run, from their shapes: the larger of the bytes over the HBM
bandwidth and the operations over the peak rate.  Bytes count each input
read once and each output written once, in values of ``width`` bytes (8 for
float64, 4 for float32); operations count block Thomas (a Cholesky, W =
S^-1 E and E^T W a block, and 6 b^2 r for r right-hand sides) or, for
cyclic reduction, the pair counts of each level.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at the 700 W
limit): 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores
and 67 TFLOP/s in float64 on the tensor cores (34 outside them; the higher
rate makes the bound the least time).  A share of this bound that is read
against a card set below 700 W is stated with the card's limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {4: 67e12, 8: 67e12}
# Cyclic reduction pads the chain to a power of two and reduces it while it
# has more than this many blocks (the port's solve/blocktri.py TAIL).
CR_TAIL = 8


def bound(nbytes: float, flops: float, width: int = 8):
    """(least seconds, what binds it: 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS_PER_S[width]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def thomas_flops(b: int, r: int, blocks: int) -> float:
    """Block Thomas on ``blocks`` blocks of b with r right-hand sides."""
    return blocks * (b ** 3 / 3 + 4 * b ** 3 + 6 * b * b * r)


def kkt_work(K: int, nq: int, b: int = 8, width: int = 8):
    """(bytes, operations) of kernel #1's KKT solve: D, E, G = [gx | B] and
    the Jacobi scales in, dx out, on a chain of K blocks; block Thomas with
    r = 1 + nq and the parameter Schur sums B^T X (2 b nq r a block)."""
    r = 1 + nq
    return (width * K * (2 * b * b + r * b + b + b),
            thomas_flops(b, r, K) + K * 2 * b * nq * r)


def chain_work(K: int, r: int, b: int = 8, width: int = 8, chains: int = 1):
    """(bytes, operations) of a chain solve (kernels #2 and #7): D, E, G in,
    X out, on ``chains`` chains of K blocks; block Thomas."""
    blocks = chains * K
    return width * blocks * (2 * b * b + 2 * r * b), thomas_flops(b, r, blocks)


def cr_pairs(K: int) -> int:
    """Pairs of blocks over the CR levels of a chain of K blocks, padded to
    a power of two and reduced to the tail."""
    kp = 1 << max(K - 1, 1).bit_length()
    pairs = 0
    while kp > CR_TAIL:
        kp //= 2
        pairs += kp
    return pairs


def cr_work(K: int, r: int, r_cov: int = 2, b: int = 8, width: int = 8):
    """{kernel: (bytes, operations)} of one CR solve of a chain of K blocks:
    #4 (factor), #5 (apply, r right-hand sides), #6 (back-substitution, r)
    and #3 (the fused level, r_cov).  Per pair: the odd block's Cholesky
    and four b x b products and solves (#4), 6 b^2 r for the right-hand
    sides (#5, #3) and 4 b^2 r for the back-substitution (#6)."""
    bb = b * b
    per_pair = {
        "cr_level_factor": (9 * bb, bb * b / 3 + 5 * 2 * bb * b),
        "cr_level_apply": (3 * bb + 4 * b * r, 6 * bb * r),
        "cr_level": (8 * bb + 4 * b * r_cov,
                     bb * b / 3 + 5 * 2 * bb * b + 6 * bb * r_cov),
        "cr_backsub": (2 * bb + 4 * b * r, 4 * bb * r),
    }
    pairs = cr_pairs(K)
    return {name: (width * elems * pairs, ops * pairs)
            for name, (elems, ops) in per_pair.items()}


def cr_sweeps_work(K: int, r: int, b: int = 8, width: int = 8):
    """(bytes, operations) of one KKT solve on the CR path: a factor, an
    apply and a back-substitution sweep (#4 + #5 + #6)."""
    work = cr_work(K, r, b=b, width=width)
    parts = [work[k] for k in ("cr_level_factor", "cr_level_apply",
                               "cr_backsub")]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def share(work, seconds_per_solve: float, width: int = 8):
    """Percent of the least time in the measured seconds of one solve, or
    None where nothing was measured."""
    if not seconds_per_solve or seconds_per_solve <= 0:
        return None
    least, _ = bound(*work, width=width)
    return 100.0 * least / seconds_per_solve
