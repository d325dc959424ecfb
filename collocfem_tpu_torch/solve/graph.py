"""CUDA graphs of the solve loops: the port's counterpart of ``jax.jit``.

The JAX package runs each solve as one compiled device program: ``@jax.jit``
on ``make_gn_solver``'s ``solve`` over the ``lax.while_loop`` of its LM core,
``jax.jit(solve)`` in ``make_multi_experiment_solver``, the jitted MHE
step, the jitted interior-point drivers of ``solve/bounds.py`` and
``solve/constrained.py`` (a ``lax.fori_loop`` of barrier subproblems) and
the jitted AL + barrier OCP solver of ``solve/auglag.py``
(``make_ocp_solver``: a ``lax.fori_loop`` of AL subproblems).  On
a CUDA device the port captures the same work as CUDA graphs and replays
them, so that a solve's kernels leave the device's queue back to back
instead of one Python launch at a time, and the device decides when an LM
loop stops.

A graph captures a plain function that reads static input buffers and
writes static output buffers.  :class:`CapturedSolve` wraps a solve given as
three such functions:

  * ``prelude(*inputs) -> LMState``: assemble at z0 and build the initial
    state (``lm_core.lm_init`` from constants the solver made once);
  * ``step(state, *inputs) -> LMState``: one ``lm_core.lm_step``;
  * ``finish(state) -> outputs``: what the solve returns, e.g. (z,
    SolveStats).

It keeps one :class:`_Plan` per key: the inputs' pytree structure and each
tensor's shape, dtype, device and broadcast dimensions (a new key captures
anew, as ``jit`` retraces on a new shape).  A plan holds static input buffers
(each call copies its inputs into them with ``copy_``), state buffers
allocated outside every graph, and graphs sharing one memory pool: the
*prelude* (prelude, its state copied into the state buffers) and the
*iteration* (one step from the state buffers, written back into them in
place).  The first call of a key warms up on a side stream (one prelude and
one step, which builds the kernels and creates the cuBLAS and cuSOLVER
handles), then captures.  At fixed work (every tolerance 0) a call replays
the prelude once and the iteration ``maxiter`` times, back to back.  With a
tolerance set the iteration is the body of a WHILE conditional node
(:meth:`_Plan.loop`, built by ``csrc/graph_loop.cu``): the device tests
``~done & (it < maxiter)`` before each step, ``lax.while_loop``'s
condition, and one launch runs the whole loop, so the host reads nothing
during the solve (the sharded solves too: their collectives are the peer
all-reduce's kernel nodes, ``parallel.peer``).  ``lm_core.lm_step`` leaves
a finished state as it is, so every schedule gives ``lm_core.lm_loop``'s
iteration count, history and result bit for bit.  The outputs are clones:
a later call never overwrites an earlier result.  :class:`CapturedFunction`
is the one-graph form, for a step's work before its solve (the MHE's
arrival cost).  :class:`CapturedOuterLoop` is the form of an outer loop
around inner LM solves (the barrier homotopy of ``make_bounded_solver`` and
``make_constrained_solver``, the AL homotopy of ``make_ocp_solver``): a
prelude, a *round* (begin, the inner loop on a WHILE node, end) replayed
once per outer iteration, and a finish.

The kernel wrappers count their launches in Python, which a replay does not
run.  So the warm-up and the capture count nothing
(``ops._build.counts_held``), every replay adds its graph's share of the
counts (``ops._build.add_counts``), and a loop graph adds the number of
steps it ran to a counter on the device, which ``ops._build.settle`` reads
when the counts are read (``ops._build.snapshot``), not during the solve.

With device marks on (``utils.profiling.recording(device_marks=True)``)
a key captures a marked plan beside the unmarked one (:func:`_key`): its
graphs hold the ``trace_mark`` kernels of the device spans the captured
functions open.  A call is a host ``solve`` span; its loads and its output
clones are the device spans ``solve.load`` and ``solve.outputs``.  A plan's
warm-up, captures and instantiations are the host spans ``graph.warmup``,
``graph.capture`` and ``graph.instantiate``, whose nanoseconds the counter
``graph_setup_ns`` sums with recording off too.

A capture or a replay that fails raises: nothing falls back to the eager
loop or to a host-read loop (a solve's schedule is fixed when it is made).
On the CPU a call runs the eager function.  ``stepwise`` runs the captured
functions there in replay order on the static buffers, with no graph,
which is how the CPU tests hold the captured path against the eager loop
bit for bit; it runs a loop's step ``maxiter`` times with no read of
``done``, a step after ``done`` leaving the state as it is, and counts the
steps as the device does.  ``.eager`` is the eager function on any device.
:class:`HostReads` counts the reads to the host of a block.
"""

from __future__ import annotations

import ctypes
import gc
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from collocfem_tpu_torch.ops import _build
from collocfem_tpu_torch.utils import profiling
from collocfem_tpu_torch.utils.profiling import device_span, span, spanned

LOOP_INSTANCE = _build.Instance("graph_loop", 0, 0)


def _device(leaves) -> torch.device:
    devices = {x.device for x in leaves if torch.is_tensor(x)}
    if len(devices) != 1:
        raise ValueError(f"the inputs must lie on one device, not {devices}")
    return devices.pop()


def _broadcast_dims(x) -> tuple:
    """The dimensions of ``x`` that an ``expand`` made (stride 0, size > 1)."""
    return tuple(d for d in range(x.dim())
                 if x.stride(d) == 0 and x.shape[d] > 1)


def _compact(x, dims):
    for d in dims:
        x = x.narrow(d, 0, 1)
    return x


def _key(leaves, spec):
    return (spec, profiling.marks_on(), tuple(
        (tuple(x.shape), x.dtype, x.device, _broadcast_dims(x))
        if torch.is_tensor(x) else ("value", x) for x in leaves))


def _like(x):
    return torch.empty_like(x) if torch.is_tensor(x) else x


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


def _write(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into the same leaf of ``dst``."""
    for d, s in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
        if torch.is_tensor(d):
            d.copy_(s)


class _Plan:
    """One key's static input buffers, memory pool, side stream and graphs.

    ``args`` are the inputs as the captured functions read them: each
    tensor a static buffer, a broadcast tensor the ``expand`` of a buffer
    that holds one slice (the eager function reads the same strides).
    With ``capture`` False (the CPU) :meth:`graph` returns the body itself.
    """

    def __init__(self, leaves, spec, capture: bool):
        self.capture = capture
        self.device = _device(leaves)
        self._loads, views = [], []
        for x in leaves:
            if torch.is_tensor(x):
                dims = _broadcast_dims(x)
                buf = torch.empty_like(_compact(x, dims))
                self._loads.append((buf, dims))
                views.append(buf.expand(x.shape) if dims else buf)
            else:
                views.append(x)
        self.args = tree_unflatten(views, spec)
        if capture:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()

    def load(self, leaves) -> None:
        """Copy a call's inputs into the static buffers."""
        tensors = [x for x in leaves if torch.is_tensor(x)]
        with device_span("solve.load", self.device):
            for (buf, dims), x in zip(self._loads, tensors):
                buf.copy_(_compact(x, dims))

    def warm_up(self, fn):
        """fn() with every count held, on the side stream when capturing."""
        with span("graph.warmup", "graph_setup_ns"), _build.counts_held():
            if not self.capture:
                return fn()
            current = torch.cuda.current_stream(self._stream.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = fn()
            current.wait_stream(self._stream)
            return out

    def _capture(self, body, keep: bool = False):
        """(``body`` captured into a CUDA graph, its share of the counts);
        with ``keep`` the graph is left uninstantiated, for
        :meth:`loop`."""
        profiling.count("graph_captures")
        g = torch.cuda.CUDAGraph(keep_graph=keep)
        # No garbage collection inside the capture (torch.cuda.graph
        # collects before it): a plan freed there would destroy its graphs
        # mid-capture, which invalidates the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with span("graph.capture", "graph_setup_ns"), \
                    _build.counts_held() as share:
                with torch.cuda.graph(g, pool=self._pool,
                                      stream=self._stream):
                    body()
        finally:
            if collecting:
                gc.enable()
        return g, share

    def graph(self, body):
        """Capture ``body`` into a CUDA graph; returns a function that
        replays it and adds its launches to the counts."""
        if not self.capture:
            return body
        g, share = self._capture(body)
        launch = _first_instantiates(g.replay)

        def replay():
            launch()
            _build.add_counts(share)

        return replay

    def loop(self, step, state, maxiter: int, before=None, after=None):
        """A function that runs ``before``, then ``step`` while ``~done &
        (it < maxiter)`` of ``state`` (the :class:`~lm_core.LMState` of
        static buffers that ``step`` writes in place), then ``after``.

        On a CUDA device the three are captured (uninstantiated) and cloned
        into one graph around a WHILE conditional node (``csrc/
        graph_loop.cu``); a call is one launch of it, and the device, not
        the host, reads ``done``.  ``before`` and ``after`` add their
        shares of the counts per call; the graph adds the steps it ran to
        the device counter ``self.steps`` (``self.tally``), which
        :func:`_build.settle` reads.  On the CPU the three run through
        :meth:`graph` and the step runs ``maxiter`` times, with no read of
        ``done``: a step after ``done`` leaves the state as it is
        (``lm_core.lm_step``'s ``keep``), so the result is the loop's, and
        the counts take one step's share per step the state counted
        (``it``), as on the device.
        """
        if state.done.dtype != torch.bool or state.it.dtype != torch.int64:
            raise ValueError("the loop reads a bool done and an int64 it")
        self.steps = torch.zeros((), dtype=torch.int64,
                                 device=state.it.device)
        self.tally = None

        def count_steps():
            if after is not None:
                after()
            self.steps.add_(state.it)

        if not self.capture:
            return self._cpu_loop(
                self.graph(step), maxiter,
                None if before is None else self.graph(before),
                self.graph(count_steps))
        (g_before, before_share), (g_step, step_share), (g_after,
                                                         after_share) = (
            (None, {}) if before is None else self._capture(before, keep=True),
            self._capture(step, keep=True),
            self._capture(count_steps, keep=True))
        lib = _loop_library()
        graph, execu, stage = ctypes.c_void_p(), ctypes.c_void_p(), \
            ctypes.c_int()
        device = state.it.device
        with torch.cuda.device(device), \
                span("graph.instantiate", "graph_setup_ns"):
            rc = lib.graph_loop_build(
                g_before.raw_cuda_graph() if g_before else None,
                g_step.raw_cuda_graph(), g_after.raw_cuda_graph(),
                state.done.data_ptr(), state.it.data_ptr(), maxiter,
                ctypes.byref(graph), ctypes.byref(execu), ctypes.byref(stage))
        if rc != 0:
            # At stage 9 (instantiation) the WHILE body is the likely
            # culprit: a node the body refuses fails there.
            names = {3: "before", 6: "step", 8: "after", 9: "step"}
            failed = dict(before=g_before, step=g_step, after=g_after).get(
                names.get(stage.value))
            where = ""
            if failed is not None:
                buf = ctypes.create_string_buffer(1 << 14)
                lib.graph_loop_describe(failed.raw_cuda_graph(), buf,
                                        len(buf))
                where = (f"; the {names[stage.value]} graph's nodes that are "
                         f"not kernels:\n{buf.value.decode()}")
            raise RuntimeError(
                f"the loop graph failed at stage {stage.value}: "
                + lib.graph_loop_error_string(rc).decode() + where)
        self.loop_nodes = {
            name: lib.graph_loop_node_count(g.raw_cuda_graph())
            for name, g in (("before", g_before), ("step", g_step),
                            ("after", g_after)) if g is not None}
        # The captured graphs stay alive with the plan: their memory in the
        # pool is what the loop graph's clones of them use.
        self._loop = (g_before, g_step, g_after)
        # Destroyed with the plan; at exit the process frees them.
        weakref.finalize(self, lib.graph_loop_destroy, graph,
                         execu).atexit = False
        self.tally = _build.Tally(self.steps, step_share)

        def launch():
            with torch.cuda.device(device):
                return lib.graph_loop_launch(
                    execu, torch.cuda.current_stream(device).cuda_stream)

        launch = _first_instantiates(launch)

        def run():
            rc = launch()
            if rc != 0:
                raise RuntimeError("the loop graph's launch failed: "
                                   + lib.graph_loop_error_string(rc).decode())
            _build.add_counts(before_share)
            _build.add_counts(after_share)
            _build.pending(self.tally)

        return run

    def _cpu_loop(self, step, maxiter, before, after):
        def run():
            if before is not None:
                before()
            for _ in range(maxiter):
                with _build.counts_held() as share:
                    step()
                if self.tally is None:
                    self.tally = _build.Tally(self.steps, share)
            after()
            if self.tally is not None:
                _build.pending(self.tally)

        return run


def _first_instantiates(launch):
    """``launch`` whose first call (which uploads the instantiated graph)
    is timed as a ``graph.instantiate`` span."""
    first = [True]

    def run():
        if first:
            first.clear()
            with span("graph.instantiate", "graph_setup_ns"):
                return launch()
        return launch()

    return run


def _loop_library():
    """``csrc/graph_loop.cu``, built at its first use and loaded."""
    lib = _build.load(LOOP_INSTANCE).lib
    ptr = ctypes.c_void_p
    lib.graph_loop_build.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                     ctypes.c_longlong, ptr, ptr, ptr]
    lib.graph_loop_build.restype = ctypes.c_int
    lib.graph_loop_launch.argtypes = [ptr, ptr]
    lib.graph_loop_launch.restype = ctypes.c_int
    lib.graph_loop_destroy.argtypes = [ptr, ptr]
    lib.graph_loop_destroy.restype = None
    lib.graph_loop_node_count.argtypes = [ptr]
    lib.graph_loop_node_count.restype = ctypes.c_longlong
    lib.graph_loop_describe.argtypes = [ptr, ctypes.c_char_p, ctypes.c_int]
    lib.graph_loop_describe.restype = None
    lib.graph_loop_error_string.argtypes = [ctypes.c_int]
    lib.graph_loop_error_string.restype = ctypes.c_char_p
    return lib


class _Captured:
    """What :class:`CapturedSolve` and :class:`CapturedFunction` share: the
    plan cache and the dispatch on the inputs' device.

    ``refused``: why the functions cannot be captured where the solver was
    made to run (``parallel.meshes.capture_refusal``: collectives over a
    group whose ranks cannot map each other's memory), or None.  A call
    and ``stepwise`` then raise ValueError with it."""

    def __init__(self, eager, refused=None):
        self._eager = eager
        self.eager = spanned("solve")(eager)
        self.refused = refused
        self._plans: dict = {}

    def _refuse(self):
        if self.refused is not None:
            raise ValueError(self.refused)

    def _make_plan(self, leaves, spec, capture):
        raise NotImplementedError

    def _plan(self, leaves, spec, device):
        """The plan of these inputs' key, made (and on a CUDA device
        captured) at the key's first call."""
        key = _key(leaves, spec)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._make_plan(leaves, spec, device.type == "cuda")
            self._plans[key] = plan
        return plan

    def __call__(self, *args):
        """On a CUDA device: replay the captured graphs (capturing them at
        the first call of a key).  On the CPU: the eager function."""
        self._refuse()
        leaves, spec = tree_flatten(args)
        device = _device(leaves)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"no CUDA graph for tensors on {device}")
        with span("solve"):
            if device.type == "cpu":
                return self._eager(*args)
            return self._run(self._plan(leaves, spec, device), leaves)

    def stepwise(self, *args):
        """On the CPU: the captured functions in replay order on the static
        buffers, with no graph."""
        self._refuse()
        leaves, spec = tree_flatten(args)
        device = _device(leaves)
        if device.type != "cpu":
            raise ValueError(f"stepwise runs on the CPU, not on {device}")
        with span("solve"):
            return self._run(self._plan(leaves, spec, device), leaves)


class CapturedSolve(_Captured):
    """An LM solve that replays CUDA graphs on a CUDA device.

    ``solve(*inputs)`` returns ``finish`` of the final state, as clones;
    ``solve.eager(*inputs)`` is the eager loop that gives the same result.
    ``maxiter`` bounds the iterations.  With ``early_exit`` (a tolerance is
    set) the iterations run on the device as one loop graph
    (:meth:`_Plan.loop`) that stops at ``done``; without, the iteration
    graph is replayed ``maxiter`` times.  ``refused``: see
    :class:`_Captured`.
    """

    def __init__(self, prelude, step, finish, eager, *, maxiter: int,
                 early_exit: bool, refused=None):
        super().__init__(eager, refused)
        self.prelude, self.step, self.finish = prelude, step, finish
        self.maxiter, self.early_exit = maxiter, early_exit

    def _make_plan(self, leaves, spec, capture):
        plan = _Plan(leaves, spec, capture)
        plan.load(leaves)
        args = plan.args

        def warm():
            st = self.prelude(*args)
            if capture:
                self.step(st, *args)
            return st

        plan.state = tree_map(_like, plan.warm_up(warm))

        def prelude():
            with device_span("lm.prelude", plan.device):
                _write(plan.state, self.prelude(*args))

        def step():
            with device_span("lm.step", plan.device):
                _write(plan.state, self.step(plan.state, *args))

        plan.run_prelude = plan.graph(prelude)
        if self.early_exit:
            plan.run_loop = plan.loop(step, plan.state, self.maxiter)
        else:
            run_step = plan.graph(step)

            def steps():
                for _ in range(self.maxiter):
                    run_step()

            plan.run_loop = steps
        return plan

    def _run(self, plan, leaves):
        plan.load(leaves)
        plan.run_prelude()
        plan.run_loop()
        out = self.finish(plan.state)
        with device_span("solve.outputs", plan.device):
            return tree_map(_clone, out)


class CapturedFunction(_Captured):
    """A function of tensors that replays one CUDA graph on a CUDA device.

    ``fn(*inputs)`` returns the graph's own output tensors, which the next
    call overwrites (clone what must outlive it); on the CPU, ``fn.eager``'s
    result.
    """

    def _make_plan(self, leaves, spec, capture):
        plan = _Plan(leaves, spec, capture)
        plan.load(leaves)
        if capture:
            plan.warm_up(lambda: self._eager(*plan.args))
        plan.out = None

        def body():
            plan.out = self._eager(*plan.args)

        plan.run_body = plan.graph(body)
        return plan

    def _run(self, plan, leaves):
        plan.load(leaves)
        plan.run_body()
        return plan.out


class CapturedOuterLoop(_Captured):
    """An outer loop of inner LM solves that replays CUDA graphs on a CUDA
    device: the interior-point drivers' barrier homotopy and the OCP
    solver's AL homotopy, each outer iteration one inner solve.

    Five functions of static buffers, each captured:

      * ``prelude(*inputs) -> carry``: the outer carry at the start (for
        the drivers: z, the barrier parameter, the warm-start damping, the
        history and the outer index as a device counter; for the OCP
        solver also the multipliers, the penalty and the last violation);
      * ``begin(carry, *inputs) -> inner``: the inner solve's initial
        state, a pair (:class:`~lm_core.LMState`, what the steps read
        besides the carry, e.g. the inner gtol);
      * ``step(inner, carry, *inputs) -> inner``: one ``lm_core.lm_step``;
      * ``end(inner, carry, *inputs) -> carry``: the outer update after an
        inner solve;
      * ``finish(carry, *inputs) -> outputs``: what the solve returns.

    Begin, the steps and end make one *round* graph (:meth:`_Plan.loop`:
    the steps on a WHILE node that stops at the inner state's ``done`` or
    at ``maxiter`` steps).  A call replays the prelude, the round
    ``n_outer`` times and the finish, and reads nothing to the host: the
    eager loop's schedule (``lm_core.lm_loop`` with a tolerance set, inside
    a Python loop over the outer iterations) decided on the device, so the
    iteration counts, histories and launches are the eager loop's.  The
    outputs are clones.
    """

    def __init__(self, prelude, begin, step, end, finish, eager, *,
                 n_outer: int, maxiter: int):
        super().__init__(eager)
        self.prelude, self.begin, self.step = prelude, begin, step
        self.end, self.finish = end, finish
        self.n_outer, self.maxiter = n_outer, maxiter

    def _make_plan(self, leaves, spec, capture):
        plan = _Plan(leaves, spec, capture)
        plan.load(leaves)
        args = plan.args

        def warm():
            carry = self.prelude(*args)
            inner = self.begin(carry, *args)
            if capture:
                inner = self.step(inner, carry, *args)
                carry = self.end(inner, carry, *args)
            return carry, inner, self.finish(carry, *args)

        plan.carry, plan.inner, plan.out = tree_map(_like,
                                                    plan.warm_up(warm))
        plan.run_prelude = plan.graph(
            lambda: _write(plan.carry, self.prelude(*args)))

        def step():
            with device_span("lm.step", plan.device):
                _write(plan.inner, self.step(plan.inner, plan.carry, *args))

        plan.run_round = plan.loop(
            step, plan.inner[0], self.maxiter,
            before=lambda: _write(plan.inner, self.begin(plan.carry, *args)),
            after=lambda: _write(plan.carry,
                                 self.end(plan.inner, plan.carry, *args)))
        plan.run_finish = plan.graph(
            lambda: _write(plan.out, self.finish(plan.carry, *args)))
        return plan

    def _run(self, plan, leaves):
        plan.load(leaves)
        plan.run_prelude()
        for _ in range(self.n_outer):
            plan.run_round()
        plan.run_finish()
        with device_span("solve.outputs", plan.device):
            return tree_map(_clone, plan.out)


class HostReads(TorchDispatchMode):
    """Count the reads to the host of a block: ``with HostReads() as reads:
    solve(...)``, then ``reads.count``.  A read is ``aten._local_scalar_dense``
    (``.item()``, ``bool(t)``, ``int(t)``, indexing by a 0-d tensor) of a
    tensor on ``device`` (any device if None: on the CPU, what would be a
    read on the card) or a copy of a CUDA tensor to the CPU; on a CUDA
    device each makes the host wait for the device.  ``reads.where`` holds
    the innermost frames of each read."""

    def __init__(self, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device).type
        self.count = 0
        self.where = []

    def _read(self):
        self.count += 1
        self.where.append("".join(traceback.format_stack(limit=8)[:-2]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.aten._local_scalar_dense.default:
            if self.device in (None, args[0].device.type):
                self._read()
        elif func in (torch.ops.aten._to_copy.default,
                      torch.ops.aten.copy_.default):
            src = args[1] if func is torch.ops.aten.copy_.default else args[0]
            dst = args[0] if func is torch.ops.aten.copy_.default else out
            if (torch.is_tensor(src) and src.device.type == "cuda"
                    and dst.device.type == "cpu"):
                self._read()
        return out
