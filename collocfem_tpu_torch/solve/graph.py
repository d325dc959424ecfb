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
instead of one Python launch at a time.

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
allocated outside both graphs, and two graphs sharing one memory pool: the
*prelude* (prelude, its state copied into the state buffers) and the
*iteration* (one step from the state buffers, written back into them in
place).  The first call of a key warms up on a side stream (one prelude and
one step, which builds the kernels and creates the cuBLAS and cuSOLVER
handles), then captures.  A call replays the prelude once and the iteration
up to ``maxiter`` times: back to back at fixed work (every tolerance 0), or
with one read of ``done`` before each replay when a tolerance is set.  That
is ``lm_core.lm_loop``'s schedule, so a call's iteration count, history and
kernel launches are the eager loop's.  Its outputs are clones: a later call
never overwrites an earlier result.  :class:`CapturedFunction` is the
one-graph form, for a step's work before its solve (the MHE's arrival cost).
:class:`CapturedOuterLoop` is the form of an outer loop around inner LM
solves (the barrier homotopy of ``make_bounded_solver`` and
``make_constrained_solver``, the AL homotopy of ``make_ocp_solver``): five
graphs on one plan, the outer carry and the inner state in buffers,
replayed on the eager loop's schedule.

The kernel wrappers count their launches in Python, which a replay does not
run.  So the warm-up and the capture count nothing
(``ops._build.counts_held``), and every replay adds its graph's share of the
counts (``ops._build.add_counts``).

A capture or a replay that fails raises: nothing falls back to the eager
loop.  On the CPU a call runs the eager function.  ``stepwise`` runs the
captured functions there in replay order on the static buffers, with no
graph, which is how the CPU tests hold the captured path against the eager
loop bit for bit.  ``.eager`` is the eager function on any device.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from collocfem_tpu_torch.ops import _build


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
    return (spec, tuple(
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
            device = _device(leaves)
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()

    def load(self, leaves) -> None:
        """Copy a call's inputs into the static buffers."""
        tensors = [x for x in leaves if torch.is_tensor(x)]
        for (buf, dims), x in zip(self._loads, tensors):
            buf.copy_(_compact(x, dims))

    def warm_up(self, fn):
        """fn() with every count held, on the side stream when capturing."""
        with _build.counts_held():
            if not self.capture:
                return fn()
            current = torch.cuda.current_stream(self._stream.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = fn()
            current.wait_stream(self._stream)
            return out

    def graph(self, body):
        """Capture ``body`` into a CUDA graph; returns a function that
        replays it and adds its launches to the counts."""
        if not self.capture:
            return body
        g = torch.cuda.CUDAGraph()
        with _build.counts_held() as share:
            with torch.cuda.graph(g, pool=self._pool, stream=self._stream):
                body()

        def replay():
            g.replay()
            _build.add_counts(share)

        return replay


class _Captured:
    """What :class:`CapturedSolve` and :class:`CapturedFunction` share: the
    plan cache and the dispatch on the inputs' device."""

    def __init__(self, eager):
        self.eager = eager
        self._plans: dict = {}

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
        leaves, spec = tree_flatten(args)
        device = _device(leaves)
        if device.type == "cpu":
            return self.eager(*args)
        if device.type != "cuda":
            raise ValueError(f"no CUDA graph for tensors on {device}")
        return self._run(self._plan(leaves, spec, device), leaves)

    def stepwise(self, *args):
        """On the CPU: the captured functions in replay order on the static
        buffers, with no graph."""
        leaves, spec = tree_flatten(args)
        device = _device(leaves)
        if device.type != "cpu":
            raise ValueError(f"stepwise runs on the CPU, not on {device}")
        return self._run(self._plan(leaves, spec, device), leaves)


class CapturedSolve(_Captured):
    """An LM solve that replays CUDA graphs on a CUDA device.

    ``solve(*inputs)`` returns ``finish`` of the final state, as clones;
    ``solve.eager(*inputs)`` is the eager loop that gives the same result.
    ``maxiter`` bounds the iteration replays; with ``early_exit`` (a
    tolerance is set) the host reads ``done`` before each one.
    """

    def __init__(self, prelude, step, finish, eager, *, maxiter: int,
                 early_exit: bool):
        super().__init__(eager)
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
        plan.run_prelude = plan.graph(
            lambda: _write(plan.state, self.prelude(*args)))
        plan.run_step = plan.graph(
            lambda: _write(plan.state, self.step(plan.state, *args)))
        return plan

    def _run(self, plan, leaves):
        plan.load(leaves)
        plan.run_prelude()
        for _ in range(self.maxiter):
            if self.early_exit and bool(plan.state.done):
                break
            plan.run_step()
        return tree_map(_clone, self.finish(plan.state))


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
            plan.warm_up(lambda: self.eager(*plan.args))
        plan.out = None

        def body():
            plan.out = self.eager(*plan.args)

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

    Five functions of static buffers, each captured as one graph:

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

    A call replays the prelude; then ``n_outer`` times: begin, up to
    ``maxiter`` steps, each after a read of the inner state's ``done`` on
    the host that stops the inner solve, and end; then finish.  That is the
    eager loop's schedule (``lm_core.lm_loop`` with a tolerance set, inside
    a Python loop over the outer iterations): the host reads the values the
    eager loop reads, so the iteration counts, histories and launches are
    the eager loop's.  The outputs are clones.
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
        plan.run_begin = plan.graph(
            lambda: _write(plan.inner, self.begin(plan.carry, *args)))
        plan.run_step = plan.graph(lambda: _write(
            plan.inner, self.step(plan.inner, plan.carry, *args)))
        plan.run_end = plan.graph(lambda: _write(
            plan.carry, self.end(plan.inner, plan.carry, *args)))
        plan.run_finish = plan.graph(
            lambda: _write(plan.out, self.finish(plan.carry, *args)))
        return plan

    def _run(self, plan, leaves):
        plan.load(leaves)
        plan.run_prelude()
        for _ in range(self.n_outer):
            plan.run_begin()
            for _ in range(self.maxiter):
                if bool(plan.inner[0].done):
                    break
                plan.run_step()
            plan.run_end()
        plan.run_finish()
        return tree_map(_clone, plan.out)
