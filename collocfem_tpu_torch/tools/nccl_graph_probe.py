"""Whether CUDA graphs hold the sharded solves' collectives (the peer
all-reduce's kernel, ``parallel.peer``) on an NCCL world, at fixed work
and under the loop graph's WHILE conditional node.

Usage (on a machine with CUDA cards, one rank a card):

    python3 -m collocfem_tpu_torch.tools.nccl_graph_probe [--ranks N]
        [--solves] [--out FILE]

Spawns an NCCL world of N ranks (default 1; tcp://localhost rendezvous),
rank r on card r; NCCL carries the set-up's exchange of the ranks' IPC
handles and the plain version's all-reduce, the collectives of a step are
the peer kernel.  Each rank runs :func:`probe` on a body with one of each
kind of work a sharded LM step does (``parallel.sharded`` and
``parallel.batch``): kernel #2 on a seeded chain at (8, 3) (the SPIKE
interface shape), one ``meshes.all_sum`` of float64 partials, one halo
(``meshes.from_right``) and a ``done`` flag all-reduced by
``meshes.all_max`` from the step count, as the LM's accept inputs are;
every result written into static buffers.  The body runs eagerly, then
captured into one graph replayed step by step (``solve.graph._Plan.graph``,
the fixed-work schedule), then as the body of the loop graph's WHILE node
(``_Plan.loop``, ``csrc/graph_loop.cu``: the schedule of a solve with a
tolerance).  Each captured schedule must give the eager buffers bit for bit
and stop where the eager loop stops.

With --solves each rank then runs the sharded solvers at full size on the
(dp, sp) grid the ranks make (:func:`solves`): make_sp_gn_solver on the
headline at N = 9,999 (fixed work and to gtol 1e-10) at sp = N,
make_multi_experiment_solver on config 5 (1,024 experiments) at dp = N in
both layouts at fixed work and in the soa layout to gtol 1e-10, and with 4
ranks dp x sp = 2 x 2 (four experiments of 511 elements through
spike_chain_solver).  A solve to a tolerance runs its LM steps under the
WHILE node.  Each solve's first call (capture), a replay and ``.eager``
are timed (walls bracketed by torch.cuda.synchronize), its reads to the
host counted, and the three results compared bit for bit; a digest of the
result lets the ranks be compared with each other.  Then the peer kernel
against its plain version and NCCL's ``dist.all_reduce`` on the world
(``testing.peer_case``: bit for bit, ms a call).

Prints one JSON line per rank: for each schedule "ok" or the error (a
refused node in the WHILE body names the node types the step graph holds
besides kernels), and the step graph's non-kernel nodes (cudaGraphNodeType
numbers: 1 memcpy, 2 memset, 3 host, 4 child graph, 5 empty, 6 event wait,
7 event record, 10 memory allocation); with --solves, each solve's record
and the peer kernel's.  With --out, appends them to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import datetime
import hashlib
import json
import socket
import sys
import time
import traceback

import torch
import torch.distributed as dist

STOP_AT = 5      # the step at which the body's all-reduced flag sets done
MAXITER = 8      # the loop's cap (above STOP_AT: the flag ends the loop)
ELEMENTS_SP = 9999   # the headline's elements for --solves (K = 10,000)
N_EXP = 1024         # config 5's experiments for --solves


def probe(group, device) -> dict:
    """Run the probe body eagerly, at fixed work from one captured graph and
    under the loop graph's WHILE node; returns {"fixed": ..., "loop": ...,
    "loop_nodes": ..., "non_kernel_nodes": ...}, each schedule "ok" or its
    error.  Every rank of ``group`` must call it alike."""
    from torch.utils._pytree import tree_flatten

    from collocfem_tpu_torch.ops import _build, spike
    from collocfem_tpu_torch.parallel.meshes import (all_max, all_sum,
                                                      from_right)
    from collocfem_tpu_torch.solve import graph
    from collocfem_tpu_torch.solve.lm_core import LMState
    from collocfem_tpu_torch.testing import random_chain

    device = torch.device(device)
    _build.load(spike.chain_instance(8, 3))
    _build.load(graph.LOOP_INSTANCE)
    f64 = torch.float64
    rank = dist.get_rank(group)
    D, E, G = random_chain(64, 8, 3, seed=11 + rank, dtype=f64, device=device)
    halo_src = torch.arange(6, dtype=f64, device=device) + 10.0 * rank
    it = torch.zeros((), dtype=torch.int64, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    outs = dict(x=torch.empty_like(G), sums=torch.empty(2, dtype=f64,
                                                         device=device),
                halo=torch.empty_like(halo_src))

    def body():
        x = spike.blocktri_solve_spike_fused(D, E, G)
        s, n = all_sum(group, x.sum(), (x * x).sum())
        h = from_right(halo_src * (it + 1).double(), group)
        outs["x"].copy_(x)
        outs["sums"].copy_(torch.stack([s, n]))
        outs["halo"].copy_(h)
        it.add_(1)
        flag, = all_max(group, (it >= STOP_AT).double())
        done.copy_(flag > 0.5)

    def reset():
        it.zero_()
        done.fill_(False)
        for o in outs.values():
            o.fill_(float("nan"))

    def snapshot():
        torch.cuda.synchronize(device)
        return {k: v.clone() for k, v in outs.items()} | {
            "it": it.clone(), "done": done.clone()}

    def same(a, b):
        return all(torch.equal(a[k].view(torch.int64)
                               if a[k].dtype == f64 else a[k],
                               b[k].view(torch.int64)
                               if b[k].dtype == f64 else b[k]) for k in a)

    reset()
    for _ in range(STOP_AT):
        body()
    want = snapshot()
    report = {"rank": rank}
    plan = graph._Plan(*tree_flatten((D,)), capture=True)
    try:
        plan.warm_up(body)
        step = plan.graph(body)
        reset()
        for _ in range(STOP_AT):
            step()
        report["fixed"] = "ok" if same(snapshot(), want) else "DIFFERENT"
    except Exception as exc:    # the probe reports what the capture raised
        report["fixed"] = f"{type(exc).__name__}: {exc}"[:2000]
        report["fixed_trace"] = traceback.format_exc()[-3000:]
    try:
        state = LMState(None, None, None, None, None, it, done, None, None)
        run = plan.loop(body, state, MAXITER)
        reset()
        run()
        _build.settle()
        report["loop"] = "ok" if same(snapshot(), want) else "DIFFERENT"
        report["loop_nodes"] = plan.loop_nodes
        lib = graph._loop_library()
        buf = ctypes.create_string_buffer(1 << 14)
        lib.graph_loop_describe(plan._loop[1].raw_cuda_graph(), buf, len(buf))
        report["non_kernel_nodes"] = buf.value.decode().splitlines()
    except Exception as exc:    # the probe reports what the loop build raised
        report["loop"] = f"{type(exc).__name__}: {exc}"[:4000]
        report["loop_trace"] = traceback.format_exc()[-3000:]
    return report


def _digest(tree) -> str:
    """sha256 of every tensor leaf's bytes, in pytree order."""
    from torch.utils._pytree import tree_flatten

    h = hashlib.sha256()
    for x in tree_flatten(tree)[0]:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def solves(device) -> dict:
    """The sharded solvers on the grid of the world's ranks (module
    docstring): {case: {"same", "host_reads", "walls_s", "iterations",
    "p", "digest"} or {"error"}}, and "peer": the peer kernel's
    comparison."""
    from collocfem_tpu_torch.parallel import make_device_mesh
    from collocfem_tpu_torch.parallel.batch import (
        BatchDecision, make_multi_experiment_solver)
    from collocfem_tpu_torch.parallel.sharded import make_sp_gn_solver
    from collocfem_tpu_torch.parallel.spike import spike_chain_solver
    from collocfem_tpu_torch.problem import ProblemData
    from collocfem_tpu_torch.solve.graph import HostReads
    from collocfem_tpu_torch.solve.newton import SolverOptions
    from collocfem_tpu_torch.testing import (batch_inputs, bit_equal,
                                             estimation_inputs, peer_case)

    f64, n = torch.float64, dist.get_world_size()
    fixed = dict(maxiter=15, gtol=0.0, lam0=3e-6, lam_max=1e30)
    c5_fixed = dict(maxiter=15, gtol=0.0, lam0=1e-6, lam_max=1e30)
    converging = dict(maxiter=60, gtol=1e-10, xtol=1e-12)
    head = estimation_inputs(dict(kind="headline", elements=ELEMENTS_SP),
                             dtype=f64, device=device)

    def dp_share(dm, spec, options, **kw):
        prob, z0, data, p_prior, p_w = batch_inputs(spec, dtype=f64,
                                                    device=device)
        m = z0.V.shape[0] // dm.dp
        mine = lambda a: a[dm.dp_rank * m:(dm.dp_rank + 1) * m]
        return make_multi_experiment_solver(
            prob, SolverOptions(**options), dp_axis=dm.dp_group, **kw), (
            BatchDecision(V=mine(z0.V), p=z0.p),
            ProblemData(*(mine(x) for x in data)), p_prior, p_w)

    def cases():
        sp = make_device_mesh(1, n, device=device)
        for name, opts in (("fixed", fixed), ("converging", converging)):
            yield f"sp={n} {name}", lambda o=opts: (make_sp_gn_solver(
                head[0], sp, SolverOptions(**o)), head[1:])
        dp = make_device_mesh(n, 1, device=device)
        c5 = dict(kind="config5", n_exp=N_EXP, elements=10)
        for layout in ("soa", "blocks"):
            yield f"dp={n} {layout}", lambda lay=layout: dp_share(
                dp, c5, c5_fixed, layout=lay)
        yield f"dp={n} soa converging", lambda: dp_share(
            dp, c5, dict(c5_fixed, **converging), layout="soa")
        if n == 4:
            grid = make_device_mesh(2, 2, device=device)
            yield "dp x sp = 2 x 2", lambda: dp_share(
                grid, dict(kind="config5", n_exp=4, elements=511),
                dict(c5_fixed, maxiter=5), layout="blocks",
                chain_solver=spike_chain_solver(512, 2,
                                                group=grid.sp_group))

    report = {}
    for name, build in cases():
        try:
            solve, args = build()
            with HostReads("cuda") as reads:
                first, w_first = _wall(lambda: solve(*args))
            again, w_again = _wall(lambda: solve(*args))
            eager, w_eager = _wall(lambda: solve.eager(*args))
            st = first[1]
            report[name] = dict(
                same=bit_equal(first, again) and bit_equal(first, eager),
                host_reads=reads.count, walls_s=dict(
                    first_call=w_first, captured=w_again, eager=w_eager),
                iterations=int(st.iterations), p=first[0].p.tolist(),
                digest=_digest(first))
        except Exception as exc:    # the report says what the solve raised
            report[name] = {"error": f"{type(exc).__name__}: {exc}"[:3000],
                            "trace": traceback.format_exc()[-3000:]}
    try:
        peer = peer_case(mesh=(1, n), seed=3, sizes=(1, n * 2 * 8 * 19),
                         reps=200, device=device)
        report["peer"] = {f"{op} n={m}": v for (op, m), v in
                          ((k, v) for k, v in peer.items()
                           if k != "launches")}
    except Exception as exc:    # the report says what the comparison raised
        report["peer"] = {"error": f"{type(exc).__name__}: {exc}"[:3000]}
    return report


def _rank_main(rank, n, port, with_solves, out):
    from collocfem_tpu_torch.parallel import peer

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        report = probe(dist.group.WORLD, dev)
        if with_solves:
            report["solves"] = solves(dev)
        report.update(ranks=n, card=torch.cuda.get_device_name(dev),
                      torch=torch.__version__,
                      nccl=str(torch.cuda.nccl.version()))
        line = json.dumps(report)
        print(line, flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(line + "\n")
        peer.release()
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--solves", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < args.ranks:
        print(f"{args.ranks} ranks need as many cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(args.ranks, port, args.solves, args.out),
             nprocs=args.ranks, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
