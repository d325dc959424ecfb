"""Captured scans: the port's counterpart of ``lax.scan`` for the Kalman tier.

The JAX package writes every filter and smoother as a jitted ``lax.scan``
and differentiates the likelihood by reverse-mode AD through it.
:class:`Scan` does the same on a CUDA device.  ``Scan(step)`` runs
``step(carry, x_k, consts) -> (carry, y_k)`` over the leading axis of the
pytree ``xs`` and returns ``(carry_T, ys)`` with ``ys`` stacked over k, in
reverse order of k when ``reverse`` is set, as ``lax.scan`` does.
``consts`` are the tensors that every step reads (the parameters, the noise
densities): the JAX step closes over them, but a captured graph must read
them from static buffers.  Statics, such as the number of RK4 substeps or the
model, live in the step function itself.

On a CUDA device the first call of a key captures two CUDA graphs of one
step each.  The key is the inputs' pytree structure, each tensor's shape,
dtype and broadcast dimensions, ``reverse``, and whether a gradient is
wanted.  The graphs share one memory pool and are captured after a warm-up
on a side stream (``solve.graph._Plan``):

  * the forward step reads x_k at a device index that the graph advances,
    runs ``step``, and writes y_k and the carry it started from into
    preallocated (T, ...) stacks;
  * the backward step recomputes the step from that saved carry, applies
    ``torch.func.vjp`` to it, writes the cotangent of x_k and adds that of
    ``consts`` into an accumulator.

A call replays the forward graph T times and returns clones of the final
carry and of the stacks.  When a gradient is wanted it runs as an autograd
Function, which keeps the T carries and replays the backward graph T times
in the opposite order: the counterpart of scan's transpose.  A differentiated
scan thus costs 2T replays.  One step a graph: a replay costs the host a few
microseconds, while a step is tens to hundreds of small kernels, and a
graph of one step serves every T.

On the CPU the same step bodies run in a Python loop on the same static
buffers, so the CPU tests run the code that the card replays.
:meth:`Scan.eager` runs them so on any device, and the captured call equals
it bit for bit.  :meth:`Scan.plain` is the reference: ``step`` in a Python
loop whose every operation autograd records.  A capture that fails raises;
nothing falls back to a loop.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable
from torch.utils._pytree import tree_flatten, tree_unflatten

from collocfem_tpu_torch.solve.graph import _device, _key, _Plan


def _length(xs_leaves) -> int:
    lengths = {x.shape[0] for x in xs_leaves}
    if len(lengths) != 1 or 0 in lengths:
        raise ValueError(f"xs must share one nonzero leading length, not "
                         f"{sorted(lengths)}")
    return lengths.pop()


def _at(stack, k):
    """stack[k] for a device index tensor k of shape (1,)."""
    return stack.index_select(0, k)[0]


class _ScanPlan:
    """One key's static buffers and its forward and backward step bodies,
    captured as graphs when ``capture`` is set."""

    def __init__(self, step, carry0, xs, consts, *, reverse, capture, grad):
        c_leaves, self.carry_spec = tree_flatten(carry0)
        io_leaves, io_spec = tree_flatten((xs, consts))
        x_leaves, self.xs_spec = tree_flatten(xs)
        self.step, self.grad = step, grad
        self.n_carry, self.n_xs = len(c_leaves), len(x_leaves)
        self.T = _length(x_leaves)
        self.first = self.T - 1 if reverse else 0
        self.stride = -1 if reverse else 1
        self.io = _Plan(io_leaves, io_spec, capture)
        self.io.load(io_leaves)
        xs_b, self.consts = self.io.args
        self.xs = tree_flatten(xs_b)[0]
        self.carry = [torch.zeros_like(c, memory_format=torch.contiguous_format)
                      for c in c_leaves]
        self.k = torch.zeros(1, dtype=torch.long, device=_device(io_leaves))

        def trace():
            with torch.no_grad():
                return step(carry0, tree_unflatten(
                    [x[self.first] for x in self.xs], self.xs_spec),
                    self.consts)

        new_carry, y = self.io.warm_up(trace)
        if [(c.shape, c.dtype) for c in tree_flatten(new_carry)[0]] != [
                (c.shape, c.dtype) for c in c_leaves]:
            raise ValueError("step must return a carry of the shapes and "
                             "dtypes of carry0")
        y_leaves, self.y_spec = tree_flatten(y)
        self.ys = [v.new_zeros((self.T, *v.shape)) for v in y_leaves]
        if grad:
            self.saved = [c.new_zeros((self.T, *c.shape)) for c in self.carry]
            self.g_carry = [torch.zeros_like(c) for c in self.carry]
            self.g_ys = [torch.zeros_like(s) for s in self.ys]
            self.g_xs = [x.new_zeros(x.shape) for x in self.xs]
            self.g_consts = [torch.zeros_like(c)
                             for c in tree_flatten(self.consts)[0]]
        if capture:
            def warm():
                self.k.fill_(self.first)
                self._forward_step()
                if grad:
                    self.k.fill_(self.first)
                    self._backward_step()
            self.io.warm_up(warm)
        self.run_forward = self.io.graph(self._forward_step)
        self.run_backward = self.io.graph(self._backward_step) if grad \
            else None

    # -- the bodies that are captured ------------------------------------
    def _forward_step(self):
        k = self.k
        x = tree_unflatten([_at(b, k) for b in self.xs], self.xs_spec)
        new_carry, y = self.step(tree_unflatten(self.carry, self.carry_spec),
                                 x, self.consts)
        if self.grad:
            for s, c in zip(self.saved, self.carry):
                s.index_copy_(0, k, c[None])
        for s, v in zip(self.ys, tree_flatten(y)[0]):
            s.index_copy_(0, k, v[None])
        for c, v in zip(self.carry, tree_flatten(new_carry)[0]):
            c.copy_(v)
        k.add_(self.stride)

    def _backward_step(self):
        k = self.k
        x = tree_unflatten([_at(b, k) for b in self.xs], self.xs_spec)
        carry = tree_unflatten([_at(s, k) for s in self.saved],
                               self.carry_spec)
        cot = (tree_unflatten(self.g_carry, self.carry_spec),
               tree_unflatten([_at(s, k) for s in self.g_ys], self.y_spec))
        _, vjp = torch.func.vjp(self.step, carry, x, self.consts)
        g_carry, g_x, g_consts = vjp(cot)
        for s, g in zip(self.g_xs, tree_flatten(g_x)[0]):
            s.index_copy_(0, k, g[None])
        for a, g in zip(self.g_consts, tree_flatten(g_consts)[0]):
            a.add_(g)
        for c, g in zip(self.g_carry, tree_flatten(g_carry)[0]):
            c.copy_(g)
        k.sub_(self.stride)

    # -- a call -----------------------------------------------------------
    def forward(self, leaves):
        """(carry_T leaves + ys leaves, the saved carries) as clones."""
        self.io.load(leaves[self.n_carry:])
        for c, v in zip(self.carry, leaves[:self.n_carry]):
            c.copy_(v)
        self.k.fill_(self.first)
        for _ in range(self.T):
            self.run_forward()
        out = [c.clone() for c in self.carry] + [s.clone() for s in self.ys]
        return out, [s.clone() for s in self.saved] if self.grad else None

    def backward(self, leaves, saved, grads):
        """The cotangents of carry0, xs and consts, as clones."""
        self.io.load(leaves[self.n_carry:])
        for b, v in zip(self.saved, saved):
            b.copy_(v)
        for b, g in zip(self.g_carry + self.g_ys, grads):
            b.copy_(g)
        for a in self.g_consts:
            a.zero_()
        self.k.fill_(self.first + self.stride * (self.T - 1))
        for _ in range(self.T):
            self.run_backward()
        return [g.clone() for g in self.g_carry + self.g_xs + self.g_consts]


class _ScanFunction(torch.autograd.Function):
    """A scan's forward replays, with its backward replays as the
    gradient."""

    @staticmethod
    def forward(ctx, plan, *leaves):
        out, ctx.saved = plan.forward(leaves)
        ctx.plan = plan
        ctx.save_for_backward(*leaves)
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        g = ctx.plan.backward(ctx.saved_tensors, ctx.saved, grads)
        return (None, *(gi if need else None
                        for gi, need in zip(g, ctx.needs_input_grad[1:])))


class Scan:
    """``lax.scan`` of one step function, captured per key on a CUDA
    device (see the module docstring).

    ``Scan(step)(carry0, xs, consts=(), reverse=False) -> (carry_T, ys)``;
    ``step(carry, x_k, consts) -> (carry, y_k)`` must be a pure function of
    tensors that reads nothing back to the host.  Differentiable with
    respect to carry0, xs and consts.
    """

    def __init__(self, step):
        self.step = step
        self._plans: dict = {}

    def __call__(self, carry0, xs, consts=(), *, reverse: bool = False):
        """Captured graphs on a CUDA device, the step bodies in a loop on
        the CPU."""
        return self._run(True, carry0, xs, consts, reverse)

    def eager(self, carry0, xs, consts=(), *, reverse: bool = False):
        """The step bodies in a loop with no graph, on any device."""
        return self._run(False, carry0, xs, consts, reverse)

    def plain(self, carry0, xs, consts=(), *, reverse: bool = False):
        """The reference: ``step`` in a Python loop, recorded by
        autograd."""
        x_leaves, xs_spec = tree_flatten(xs)
        T = _length(x_leaves)
        ys = [None] * T
        carry = carry0
        for k in (range(T - 1, -1, -1) if reverse else range(T)):
            carry, ys[k] = self.step(
                carry, tree_unflatten([x[k] for x in x_leaves], xs_spec),
                consts)
        cols = [tree_flatten(y)[0] for y in ys]
        return carry, tree_unflatten([torch.stack(c) for c in zip(*cols)],
                                     tree_flatten(ys[0])[1])

    def _run(self, capture, carry0, xs, consts, reverse):
        leaves, spec = tree_flatten((carry0, xs, consts))
        if not all(torch.is_tensor(x) for x in leaves):
            raise TypeError("a scan's carry0, xs and consts must be tensors")
        device = _device(leaves)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"no scan for tensors on {device}")
        capture = capture and device.type == "cuda"
        grad = torch.is_grad_enabled() and any(x.requires_grad
                                               for x in leaves)
        key = (capture, reverse, grad, _key(leaves, spec))
        plan = self._plans.get(key)
        if plan is None:
            plan = _ScanPlan(self.step, carry0, xs, consts, reverse=reverse,
                             capture=capture, grad=grad)
            self._plans[key] = plan
        if grad:
            out = _ScanFunction.apply(plan, *leaves)
        else:
            out, _ = plan.forward(leaves)
        carry = tree_unflatten(list(out[:plan.n_carry]), plan.carry_spec)
        return carry, tree_unflatten(list(out[plan.n_carry:]), plan.y_spec)
