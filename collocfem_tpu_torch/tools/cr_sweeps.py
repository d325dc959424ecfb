"""Times of the cyclic-reduction sweeps (kernels #3-#6) on one GPU.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 -m collocfem_tpu_torch.tools.cr_sweeps [--out DIR] [--solves]

On the headline's equilibrated, damped chain at N = 20,000 (K = 20,001
padded to 32,768 blocks of b = 8; 12 levels down to the tail's 8 blocks), in
float32 and float64, by CUDA events: the factor sweep (kernel #4) and the
apply sweep (kernel #5, r = 3), each as one library call, back to back (the
inputs stay in L2) and with the L2 cache flushed before every sweep; the
same levels through 12 per-level wrapper calls; kernel #3 (r = 2) through
its 12 per-level calls; the back-substitution sweep (kernel #6, r = 3) as
one library call with every level of at most ``small`` pairs in one launch,
for each ``small`` in BACKSUB_SMALLS (0: a launch per level), beside its 12
per-level calls.  By torch.profiler: each launch's device time and the span
of a sweep on the device from its first kernel's start to its last kernel's
end (the launch gaps included).  On the host clock, never waiting for the
device: what a factor, apply and back-substitution sweep cost the host, and
the factor sweep's pieces (the library call with its 12 launches, the
workspace's tensor views, the operand checks).  With --solves it also
profiles the
15-iteration fixed-work solve with method='cr' (chip_smoke.py phase 7) in
float32 and float64: device time by kernel, kernels per iteration, three
unprofiled walls and the device idle share of the best one.

Prints one line per measurement and, with --out, writes DIR/cr_sweeps.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from collocfem_tpu_torch.ops import _build, cr
from collocfem_tpu_torch.solve import blocktri as bt
from collocfem_tpu_torch.tools.spike_tiles import _cuda_ms, _device_us, _profile

ELEMENTS = 20000
LAM = 3e-6
FLUSH_BYTES = 256 << 20    # five times the H100's 50 MB L2
BACKSUB_SMALLS = (0, 16, 32, 64, 128, 256)


def _headline(dtype, dev):
    from collocfem_tpu_torch.headline import build_headline_problem
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.problem import EstimationProblem

    mesh, t_meas, y, u_nodes = build_headline_problem(ELEMENTS)
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=100.0, device=dev,
                                   dtype=dtype)
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    return prob, data, prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])


def _chain(dtype, dev):
    """The padded chain (Ds, Es, G3 = [gx | B], B) at the initial guess."""
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.solve.kkt import _equilibrate_soa

    prob, data, z0 = _headline(dtype, dev)
    s, _, _, _ = _equilibrate_soa(assemble_gn_soa(prob, z0, data), LAM)
    Ds, Es = bt._pad_pow2_soa(s.D, s.E)
    kp = Ds.shape[-1]
    G3 = torch.cat([s.gx[:, None, :], s.B], dim=1)
    return Ds, Es, bt._pad_rhs(G3, kp), bt._pad_rhs(s.B, kp)


def _cold_ms(fn, flush, reps=10):
    """Mean device time of fn() with the L2 cache overwritten before each
    call."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _backsub_inputs(Ds, Es, Gs):
    """What kernel #6's sweep takes on the main path: the tail's solution
    and every level's s_up, s_lo (the factor sweep's workspace) and s_g
    (the apply sweep's)."""
    (dt, et), facs = cr.cr_factor_sweep(Ds, Es, bt.TAIL)
    gt, s_g = cr.cr_apply_sweep(facs, Gs)
    X = bt._tail_solve(bt._tail_factor(dt, et), gt).contiguous()
    return X, *cr.factor_columns(facs), s_g


def _per_level_us(fn, key, levels, reps=10):
    """([device µs of each level's kernel], µs from the first kernel's start
    to the last one's end) of fn(), a sweep of ``levels`` launches of the
    kernel whose name holds ``key``, by torch.profiler; ([], 0.0) if the
    profiler does not show that many kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if key in e.name and _device_us(e)),
                 key=lambda e: e.time_range.start)
    if len(evs) != reps * levels:
        print(f"  profiler: {len(evs)} '{key}' kernels, expected "
              f"{reps * levels}")
        return [], 0.0
    per = [sum(_device_us(evs[i * levels + lv]) for i in range(reps)) / reps
           for lv in range(levels)]
    span = sum(evs[(i + 1) * levels - 1].time_range.end
               - evs[i * levels].time_range.start for i in range(reps)) / reps
    return per, span


def sweeps(dev, record):
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        Ds, Es, Gs, Bs = _chain(dtype, dev)
        levels = cr.sweep_levels(Ds.shape[-1], bt.TAIL)
        _, facs = cr.cr_factor_sweep(Ds, Es, bt.TAIL)

        def factor_calls():
            d, e = Ds, Es
            for _ in range(levels):
                (d, e), _ = cr.cr_level_factor(d, e)

        def apply_calls():
            g = Gs
            for fac in facs:
                g, _ = cr.cr_level_apply(fac, g)

        def level_calls():
            d, e, g = Ds, Es, Bs
            for _ in range(levels):
                (d, e, g), _ = cr.cr_level(d, e, g)

        runs = {
            "cr_level_factor": (lambda: cr.cr_factor_sweep(Ds, Es, bt.TAIL),
                                factor_calls, "factor_pairs"),
            "cr_level_apply": (lambda: cr.cr_apply_sweep(facs, Gs),
                               apply_calls, "apply_pairs"),
            "cr_level": (None, level_calls, "level_pairs"),
        }
        for kname, (sweep, calls, key) in runs.items():
            row = dict(dtype=name, levels=levels,
                       per_level_calls_ms=_cuda_ms(calls))
            timed = sweep or calls
            if sweep:
                row.update(sweep_ms=_cuda_ms(sweep),
                           sweep_cold_ms=_cold_ms(sweep, flush))
            per, span = _per_level_us(timed, key, levels)
            row.update(level_us=per, span_us=span)
            record.setdefault(kname, []).append(row)
            print(f"{kname} {name}, {levels} levels from {Ds.shape[-1]} "
                  "blocks: "
                  + (f"sweep {row['sweep_ms'] * 1e3:.1f} us back to back, "
                     f"{row['sweep_cold_ms'] * 1e3:.1f} us with L2 flushed; "
                     if sweep else "")
                  + f"{row['per_level_calls_ms'] * 1e3:.1f} us through "
                  f"{levels} per-level calls; on the device {sum(per):.1f} us "
                  f"of kernels in a span of {span:.1f} us; per level "
                  + " ".join(f"{v:.1f}" for v in per), flush=True)
        backsub(Ds, Es, Gs, name, flush, record)


def backsub(Ds, Es, Gs, name, flush, record):
    """Kernel #6's sweep for each ``small`` in BACKSUB_SMALLS, and its 12
    per-level calls."""
    X, s_up, s_lo, s_g = _backsub_inputs(Ds, Es, Gs)
    levels, h0 = len(s_g), Ds.shape[-1] // 2
    views = [list(a) for a in (s_up, s_lo, s_g)]

    def calls():
        x = X
        for lv in reversed(range(levels)):
            x = cr.cr_backsub(x, *(a[lv] for a in views))

    print(f"cr_backsub {name}: {_cuda_ms(calls) * 1e3:.1f} us through "
          f"{levels} per-level calls", flush=True)
    for small in BACKSUB_SMALLS:
        sweep = lambda: cr._backsub_levels(X, s_up, s_lo, s_g, small)
        n = cr.backsub_sweep_launches(h0, levels, small)
        per, span = _per_level_us(sweep, "backsub", n)
        row = dict(dtype=name, levels=levels, small_pairs=small, launches=n,
                   sweep_ms=_cuda_ms(sweep),
                   sweep_cold_ms=_cold_ms(sweep, flush), launch_us=per,
                   span_us=span, per_level_calls_ms=_cuda_ms(calls))
        record.setdefault("cr_backsub", []).append(row)
        print(f"cr_backsub {name}, levels of <= {small} pairs in one launch: "
              f"{n} launches; sweep {row['sweep_ms'] * 1e3:.1f} us back to "
              f"back, {row['sweep_cold_ms'] * 1e3:.1f} us with L2 flushed; on "
              f"the device {sum(per):.1f} us in a span of {span:.1f} us; per "
              "launch " + " ".join(f"{v:.1f}" for v in per), flush=True)


def _host_us(fn, reps=300):
    """Mean host time of fn() in µs; the device is not waited for between
    calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def host_pieces(dev, record):
    """Host cost of one float32 factor, apply and back-substitution sweep,
    and of the factor sweep's pieces."""
    Ds, Es, Gs, _ = _chain(torch.float32, dev)
    X, s_up, s_lo, s_g = _backsub_inputs(Ds, Es, Gs)
    b, h0 = Ds.shape[0], Ds.shape[-1] // 2
    levels = cr.sweep_levels(Ds.shape[-1], bt.TAIL)
    _, facs = cr.cr_factor_sweep(Ds, Es, bt.TAIL)
    fac0 = facs[0]
    starts, total = cr.sweep_layout(5, b * b, h0, levels)
    ws = Ds.new_empty(total)
    pointers = (Ds.data_ptr(), Es.data_ptr(), ws.data_ptr())
    pieces = {
        "factor sweep": lambda: cr.cr_factor_sweep(Ds, Es, bt.TAIL),
        "apply sweep": lambda: cr.cr_apply_sweep(facs, Gs),
        "library call, 12 levels": lambda: cr._launch(
            "cr_factor_sweep", Ds.dtype, dev, b, 0, *pointers, b, h0,
            levels),
        "library call, 1 level": lambda: cr._launch(
            "cr_factor_sweep", Ds.dtype, dev, b, 0, *pointers, b, h0, 1),
        "views of 12 levels": lambda: [
            cr._level_views(ws, start, 5, (b, b), h0 >> lv)
            for lv, start in enumerate(starts)],
        "workspace": lambda: Ds.new_empty(total),
        "operand checks": lambda: (
            _build.check_operands([("Ds", Ds, Ds.shape), ("Es", Es, Es.shape)]),
            cr._level_shape(Ds, 0)),
        "backsub sweep": lambda: cr.cr_backsub_sweep(X, s_up, s_lo, s_g),
        "one backsub call": lambda: cr.cr_backsub(
            Gs[..., :h0].contiguous(), fac0.s_up, fac0.s_lo,
            Gs[..., :h0].contiguous()),
    }
    record["host_us"] = {name: _host_us(fn) for name, fn in pieces.items()}
    print("host, float32, µs per call without waiting for the device: "
          + "; ".join(f"{k} {v:.1f}" for k, v in record["host_us"].items()),
          flush=True)


def solves(dev, record):
    """Profiles of the fixed-work solve with method='cr' at N = 20,000."""
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        prob, data, z0 = _headline(dtype, dev)
        solve = make_gn_solver(prob, SolverOptions(
            maxiter=15, gtol=0.0, ftol=0.0, xtol=0.0, kkt_refine=0, lam0=LAM,
            lam_max=1e30, method="cr"))
        label = f"cr fixed work {name}"
        _profile(label, lambda: solve(z0, data), record)
        print(f"{label}: {record[label]['device_kernels'] / 15:.1f} device "
              "kernels per LM iteration", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--solves", action="store_true",
                    help="also profile the fixed-work solves")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cr_sweeps: no CUDA device", file=sys.stderr)
        return 2
    import collocfem_tpu_torch  # noqa: F401  (applies the precision policy)

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    record = {"card": card}
    print(f"card {card}", flush=True)
    built = _build.load_all([cr.instance(8, r) for r in (0, 2, 3)])
    for inst, b in built.items():
        print(f"built {inst.name} in {b.seconds:.1f} s", flush=True)
        for ln in b.log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print("  " + ln.strip())
    sweeps(dev, record)
    host_pieces(dev, record)
    if args.solves:
        solves(dev, record)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "cr_sweeps.json"), "w") as fh:
            json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
